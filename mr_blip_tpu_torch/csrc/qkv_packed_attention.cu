// Self-attention straight off the packed (B, N, 3*H*D) QKV projection.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_qkv_packed_kernel (the
// EVA ViT-g self-attention: 240 images x 257 tokens, H=16, D=88, bf16).
//
// Bound on this card: the math (4*N*N*D flops per image and head: 89 GFLOP
// per ViT layer at 240 images) against ~0.5 GB of q/k/v read and written;
// at N=257 the whole key range is 5 tiles of 64, so the kernel is
// compute-bound. This version reaches ~46 TFLOP/s (H100 SXM, 700 W): the
// fp32 softmax on the CUDA cores and the unpipelined K/V tile loads sit
// between the tensor-core products.
//
// Design: grid (query tile, head, image); each block reads its head's q, k
// and v columns straight from the packed row (stride 3*H*D) with 16-byte
// loads, pads D=88 to 96 in shared memory only, and writes its output at
// column h*D of the (B, N, H*D) result, so neither the q/k/v split nor a
// head transpose is ever copied in device memory. Keys >= n_valid are
// masked (-inf), as the Pallas kernel's n_valid does. The tile itself is
// attention_tile.cuh.
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace mrb {

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
qkv_packed_kernel(const bf16* qkv, bf16* out, int n, int h, int d,
                  int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const long hd = long(h) * d;
  const bf16* base = qkv + long(b) * n * 3 * hd + long(head) * d;
  AttnArgs a;
  a.q = base;
  a.k = base + hd;
  a.v = base + 2 * hd;
  a.q_row = a.k_row = a.v_row = 3 * hd;
  a.o = out + long(b) * n * hd + long(head) * d;
  a.o_row = hd;
  a.kv_mask = nullptr;
  a.n_q = n;
  a.n_k = n;
  a.n_valid_k = n_valid;
  a.d = d;
  a.scale = scale;
  attention_tile<DP>(a, blockIdx.x * BQ, smem);
}

template <int DP>
struct QkvLaunch {
  static cudaError_t run(const bf16* qkv, bf16* out, int b, int n, int h,
                         int d, int n_valid, float scale,
                         cudaStream_t stream) {
    const size_t bytes = TileLayout<DP>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        qkv_packed_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(bytes));
    if (err != cudaSuccess) return err;
    dim3 grid((n + BQ - 1) / BQ, h, b);
    qkv_packed_kernel<DP><<<grid, NTHREADS, bytes, stream>>>(
        qkv, out, n, h, d, n_valid, scale);
    return cudaGetLastError();
  }
};

}  // namespace mrb

extern "C" int mrb_qkv_packed_attention_bf16(const void* qkv, void* out,
                                             int b, int n, int h, int d,
                                             int n_valid, float scale,
                                             void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535) {
    return int(cudaErrorInvalidValue);
  }
  const int nv = (n_valid > 0 && n_valid < n) ? n_valid : n;
  return int(mrb::dispatch_head_dim<mrb::QkvLaunch>(
      d, static_cast<const mrb::bf16*>(qkv), static_cast<mrb::bf16*>(out), b,
      n, h, d, nv, scale, static_cast<cudaStream_t>(stream)));
}
