// Flash attention with an additive (1, H, N, M) bias and a (B, M) key mask.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_flash_bias_kernel and
// _flash_bias_kernel_mh (the T5 encoder self-attention with the rel-pos
// bias: B=4, N=M~2049-2056, H=32, D=64, bf16). The _mh variant is TPU head
// blocking only, so one kernel covers both. Also _flash_bias_stats_kernel
// (_flash_bias_fwd_stats, the forward of the custom VJP when a gradient is
// needed): the same launch with an fp32 (B, H, N) logsumexp output, through
// its own C entry mrb_flash_bias_fwd_stats_bf16 (4 more bytes a query row).
//
// Bound on this card: per (batch row, head) the math is 4*N*M*D flops
// (~1.1 GFLOP at N=M=2056, 0.14 ms for all 128 at the bf16 peak); the bias is
// the largest stream, N*M bf16 per head (~8.5 MB), and q, k, v ~0.8 MB
// together. Read once per head, the bias is 0.27 GB (0.08 ms at 3.35 TB/s),
// so the math bounds the kernel; read once per batch row, it is four times
// that, and at 4 x 8,000 (4.1 GB a batch row) the bytes come near the math.
//
// Design: the Hopper tile of attention_tile_sm90.cuh (warp-specialised
// blocks of 128 queries, `wgmma` for both products, K/V and the bias tile
// brought by TMA into a ring of up to 4 stages awaited on mbarriers; the bias
// element by element when M % 8 != 0). One persistent block per SM walks
// the work items (batch row, query block, head) with the batch row fastest,
// so the four blocks that read one bias tile run side by side and three of
// them find it in the 50 MB L2: the bias comes from device memory once per
// head, not once per batch row. q/k/v are read strided in the caller's (B, N, H, D) layout (row stride
// H*D, head offset h*D), with the online-softmax recurrence of the Pallas
// kernel (fp32 m, l and accumulator, isfinite guards, output acc / max(l,
// 1e-30)). The ragged tail is exact: rows and keys past the end are
// zero-filled or -inf'd in shared memory, never read from device memory.
//
// The fp32 instantiations (parity mode) are the CUDA-core kernel of
// flash_attention.cu with the bias tile and the key mask (C entries
// mrb_flash_bias_attention_f32 and mrb_flash_bias_fwd_stats_f32 there).
#include <cuda_runtime.h>

#include "attention_tile_sm90.cuh"

namespace mrb {

using sm90::bf16;

// One launch: a work item is (batch row, query block of 128, head), batch
// row fastest, so the blocks that read one bias tile run side by side.
struct BiasProblem {
  sm90::Maps maps;
  const bf16* bias;
  const int8_t* kv_mask;
  bf16* out;
  float* lse;
  int batch, n, m, h, d, n_qt, items;
  float scale;
  bool bias_aligned;

  __device__ void at(int item, sm90::Args& a, int& q0) const {
    a.b = item % batch;
    const int rest = item / batch;
    a.head = rest / n_qt;
    q0 = (rest % n_qt) * sm90::BQ;
    const long hd = long(h) * d;
    a.o = out + long(a.b) * n * hd + long(a.head) * d;
    a.o_row = hd;
    a.bias = bias + long(a.head) * n * m;
    a.bias_row = m;
    a.bias_aligned = bias_aligned;
    a.kv_mask = kv_mask + long(a.b) * m;
    a.n_q = n;
    a.n_k = m;
    a.d = d;
    a.scale = scale;
    a.lse = lse != nullptr ? lse + (long(a.b) * h + a.head) * n : nullptr;
  }
};

template <int DP>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
flash_bias_kernel(const __grid_constant__ BiasProblem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90::attention_persistent<DP, true, false>(p, smem);
}

template <int DP>
struct FlashBiasLaunch {
  static cudaError_t run(const BiasProblem& p, cudaStream_t stream) {
    return sm90::launch(flash_bias_kernel<DP>, sm90::Layout<DP, true>::alloc,
                        stream, p);
  }
};

}  // namespace mrb

namespace {

int launch_flash_bias(const void* q, const void* k, const void* v,
                      const void* bias, const void* kv_mask, void* out,
                      float* lse, int b, int n, int m, int h, int d,
                      float scale, void* stream) {
  const long n_qt = (n + mrb::sm90::BQ - 1) / mrb::sm90::BQ;
  if (b <= 0 || n <= 0 || m <= 0 || h <= 0 || long(b) * n_qt * h > 0x7fffffffL) {
    return int(cudaErrorInvalidValue);
  }
  using mrb::bf16;
  mrb::BiasProblem p{};
  const long hd = long(h) * d;
  cudaError_t err = mrb::sm90::encode_qkv(&p.maps.q, q, b, n, h, d, n * hd, hd, d);
  if (err == cudaSuccess) {
    err = mrb::sm90::encode_qkv(&p.maps.k, k, b, m, h, d, m * hd, hd, d);
  }
  if (err == cudaSuccess) {
    err = mrb::sm90::encode_qkv(&p.maps.v, v, b, m, h, d, m * hd, hd, d);
  }
  // Bias rows 16-byte aligned come in as TMA boxes; others element-wise.
  p.bias_aligned = m % 8 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  if (err == cudaSuccess && p.bias_aligned) {
    err = mrb::sm90::encode_bias(&p.maps.bias, bias, h, n, m);
  }
  if (err != cudaSuccess) return int(err);
  p.bias = static_cast<const bf16*>(bias);
  p.kv_mask = static_cast<const int8_t*>(kv_mask);
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.batch = b;
  p.n = n;
  p.m = m;
  p.h = h;
  p.d = d;
  p.n_qt = int(n_qt);
  p.items = int(b * n_qt * h);
  p.scale = scale;
  return int(mrb::sm90::dispatch_head_dim<mrb::FlashBiasLaunch>(
      d, p, static_cast<cudaStream_t>(stream)));
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
