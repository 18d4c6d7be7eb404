// Flash attention with an additive (1, H, N, M) bias and a (B, M) key mask.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_flash_bias_kernel and
// _flash_bias_kernel_mh (the T5 encoder self-attention with the rel-pos
// bias: B=4, N=M~2049-2056, H=32, D=64, bf16). The _mh variant is TPU head
// blocking only, so one kernel covers both.
//
// Bound on this card: per (batch row, head) the math is 4*N*M*D flops
// (~1.1 GFLOP at N=M=2056) against the bias tile, which is the largest
// stream: N*M bf16 per head (~8.5 MB), read once per batch row, where q, k
// and v are ~0.8 MB together; ~0.3 GB per call in all, so the math bounds
// it. This version reaches ~39 TFLOP/s (H100 SXM, 700 W), held back by the
// fp32 softmax and bias work on the CUDA cores and the unpipelined tile
// loads between the tensor-core products.
//
// Design: grid (query tile, head, batch row). q/k/v are read strided in the
// caller's (B, N, H, D) layout (row stride H*D, head offset h*D), so there
// are no transposes; K/V and the bias stream in tiles of 64 keys with the
// online-softmax recurrence of the Pallas kernel (fp32 m, l and
// accumulator, isfinite guards, output acc / max(l, 1e-30)). The ragged
// tail is exact: key tiles past M are zero-filled and -inf'd in shared
// memory, never read from device memory. The tile is attention_tile.cuh.
//
// Also replaces _flash_bias_stats_kernel (_flash_bias_fwd_stats, the
// forward of the custom VJP when a gradient is needed): the same launch with
// an fp32 (B, H, N) logsumexp output, through its own C entry
// mrb_flash_bias_fwd_stats_bf16. The extra store is 4 bytes per query row.
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace mrb {

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_bias_kernel(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* bias, const int8_t* kv_mask, bf16* out,
                  float* lse, int n, int m, int h, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const long hd = long(h) * d;
  AttnArgs a;
  a.q = q + long(b) * n * hd + long(head) * d;
  a.k = k + long(b) * m * hd + long(head) * d;
  a.v = v + long(b) * m * hd + long(head) * d;
  a.o = out + long(b) * n * hd + long(head) * d;
  a.q_row = a.k_row = a.v_row = a.o_row = hd;
  a.bias = bias + long(head) * n * m;
  a.bias_row = m;
  a.kv_mask = kv_mask + long(b) * m;
  a.n_q = n;
  a.n_k = m;
  a.n_valid_k = m;
  a.d = d;
  a.scale = scale;
  if (lse != nullptr) a.lse = lse + (long(b) * h + head) * n;
  attention_tile<DP>(a, blockIdx.x * BQ, smem);
}

template <int DP>
struct FlashBiasLaunch {
  static cudaError_t run(const bf16* q, const bf16* k, const bf16* v,
                         const bf16* bias, const int8_t* kv_mask, bf16* out,
                         float* lse, int b, int n, int m, int h, int d,
                         float scale, cudaStream_t stream) {
    const size_t bytes = TileLayout<DP>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bias_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(bytes));
    if (err != cudaSuccess) return err;
    dim3 grid((n + BQ - 1) / BQ, h, b);
    flash_bias_kernel<DP><<<grid, NTHREADS, bytes, stream>>>(
        q, k, v, bias, kv_mask, out, lse, n, m, h, d, scale);
    return cudaGetLastError();
  }
};

}  // namespace mrb

namespace {

int launch_flash_bias(const void* q, const void* k, const void* v,
                      const void* bias, const void* kv_mask, void* out,
                      float* lse, int b, int n, int m, int h, int d,
                      float scale, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || h <= 0 || b > 65535 || h > 65535) {
    return int(cudaErrorInvalidValue);
  }
  using mrb::bf16;
  return int(mrb::dispatch_head_dim<mrb::FlashBiasLaunch>(
      d, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bias),
      static_cast<const int8_t*>(kv_mask), static_cast<bf16*>(out), lse, b,
      n, m, h, d, scale, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int mrb_flash_bias_attention_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const void* kv_mask, void* out,
                                             int b, int n, int m, int h,
                                             int d, float scale,
                                             void* stream) {
  return launch_flash_bias(q, k, v, bias, kv_mask, out, nullptr, b, n, m, h,
                           d, scale, stream);
}

// As above, plus the (B, H, N) fp32 row logsumexp in `lse`.
extern "C" int mrb_flash_bias_fwd_stats_bf16(const void* q, const void* k,
                                             const void* v, const void* bias,
                                             const void* kv_mask, void* out,
                                             void* lse, int b, int n, int m,
                                             int h, int d, float scale,
                                             void* stream) {
  if (lse == nullptr) return int(cudaErrorInvalidValue);
  return launch_flash_bias(q, k, v, bias, kv_mask, out,
                           static_cast<float*>(lse), b, n, m, h, d, scale,
                           stream);
}
