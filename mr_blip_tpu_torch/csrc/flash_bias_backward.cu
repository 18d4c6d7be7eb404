// Backward of the biased flash attention (T5 encoder self-attention with the
// (1, H, N, M) rel-pos bias and a (B, M) key mask), head dim 64, bf16 and
// fp32.
//
// Replaces, in mr_blip_tpu/ops/flash_attention.py:
//  * _flash_bias_bwd_dq_kernel (pallas_call :752) -> kernel 6 (dq);
//  * _flash_bias_bwd_dq_dbias_kernel (:735)       -> kernel 7 (dq, dbias);
//  * _flash_bias_bwd_dkv_kernel (:762)            -> kernel 8 (dk, dv).
//
// Each recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's saved row logsumexp, then with
// δ = rowsum(dO∘O) (computed outside, in fp32):
//   dp = dO·vᵀ,  ds = p∘(dp - δ),  dq = ds·k·scale,  dk = dsᵀ·q·scale,
//   dv = pᵀ·dO,  dbias = Σ_b ds.
//
// Bound on this card: per (batch row, head) the dq pass does 3 and the
// dk/dv pass 4 products of 2·N·M·D flops (69.3 GFLOP a product in all at
// B=4, N=M=2056, H=32: 0.21 and 0.28 ms at the bf16 peak); the bias is
// N·M bf16 per head (8.5 MB, 270 MB for 32 heads), and the fp32 dbias of the
// dq+dbias pass 17 MB per head. So the math bounds kernels 6 and 8, and the
// dbias bytes kernel 7.
//
//  * bf16: the Hopper tile of backward_tile_sm90.cuh (persistent
//    warp-specialised blocks of 128 rows, `wgmma` for every product, the
//    streamed tiles and the bias brought by TMA into a ring of 4 stages on
//    mbarriers, the batch row fastest so that the bias is read once per
//    head). Kernel 7's items are (head, 128 queries), each walking the batch
//    rows in order, the first storing its fp32 ds into dbias and each later
//    one adding to it: every dbias element is owned by one thread of one
//    block, so the sum is deterministic with no atomics. Summing the batch
//    rows before a single store would need the B rows' Q, dO and dq
//    accumulators of an item at once (B x 48 KB for 128 queries: 192 KB at
//    B=4 beside a 132 KB ring), past the 227 KB of a block, so the dbias
//    traffic stays (2B - 1) reads and writes of 541 MB at B=4.
//  * fp32 (the parity mode): the CUDA-core bodies of backward_f32.cuh
//    (shared with the rel-pos kernels 10-12), no TF32, as the fp32 forward
//    kernels 3-5: one owned query (dq) or key (dk/dv) row a thread, the other
//    operand streaming through shared memory; kernel 7's thread also owns its
//    dbias row and walks the batch rows in order.
// Ragged lengths are exact with no padded copy: rows past the end are
// zero-filled in shared memory, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p is 0 too.
#include <cuda_runtime.h>

#include "backward_f32.cuh"
#include "backward_tile_sm90.cuh"

namespace mrb {

namespace {

using sm90::bf16;
constexpr int D = sm90bwd::D;

// ------------------------------------------------------------------- bf16
template <bool DKV, bool DBIAS>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
flash_bias_bwd_kernel(const __grid_constant__ sm90bwd::Problem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90bwd::backward_persistent<DKV, sm90::kBiasTile, DBIAS>(p, smem);
}

enum class Pass { kDq, kDqDbias, kDkv };

struct Operands {
  const void *q, *k, *v, *bias, *kv_mask, *dout, *lse, *delta;
  void *dq, *dk, *dv, *dbias;
  int b, n, m, h, d;
  float scale;
};

bool bad_shape(const Operands& o) {
  return o.b <= 0 || o.n <= 0 || o.m <= 0 || o.h <= 0 || o.b > 65535 ||
         o.h > 65535 || o.d != D;
}

int launch_bf16(Pass pass, const Operands& o, cudaStream_t stream) {
  if (bad_shape(o)) return int(cudaErrorInvalidValue);
  const bool dkv = pass == Pass::kDkv;
  const long n_blk = ((dkv ? o.m : o.n) + sm90bwd::BITEM - 1) / sm90bwd::BITEM;
  const long items = (pass == Pass::kDqDbias ? 1L : long(o.b)) * o.h * n_blk;
  if (items > 0x7fffffffL) return int(cudaErrorInvalidValue);
  sm90bwd::Problem p{};
  const long hd = long(o.h) * D;
  const int b = o.b, n = o.n, m = o.m, h = o.h;
  cudaError_t err = sm90::encode_qkv(&p.maps.q, o.q, b, n, h, D, n * hd, hd, D);
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.dout, o.dout, b, n, h, D, n * hd, hd, D);
  }
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.k, o.k, b, m, h, D, m * hd, hd, D);
  }
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.v, o.v, b, m, h, D, m * hd, hd, D);
  }
  // Bias rows 16-byte aligned come in as TMA boxes; others element-wise.
  p.bias_aligned = m % 8 == 0 && reinterpret_cast<uintptr_t>(o.bias) % 16 == 0;
  if (err == cudaSuccess && p.bias_aligned) {
    err = sm90::encode_bias(&p.maps.bias, o.bias, h, n, m, sm90bwd::BR);
  }
  if (err != cudaSuccess) return int(err);
  p.bias = static_cast<const bf16*>(o.bias);
  p.kv_mask = static_cast<const int8_t*>(o.kv_mask);
  p.lse = static_cast<const float*>(o.lse);
  p.delta = static_cast<const float*>(o.delta);
  p.dq = static_cast<bf16*>(o.dq);
  p.dk = static_cast<bf16*>(o.dk);
  p.dv = static_cast<bf16*>(o.dv);
  p.dbias = static_cast<float*>(o.dbias);
  p.batch = b;
  p.n = n;
  p.m = m;
  p.h = h;
  p.n_blk = int(n_blk);
  p.items = int(items);
  p.subs = pass == Pass::kDqDbias ? b : 1;
  p.scale = o.scale;
  const size_t bytes = sm90bwd::Layout<sm90::kBiasTile, false>::alloc;  // all three
  switch (pass) {
    case Pass::kDq:
      return int(sm90::launch(flash_bias_bwd_kernel<false, false>, bytes, stream, p));
    case Pass::kDqDbias:
      return int(sm90::launch(flash_bias_bwd_kernel<false, true>, bytes, stream, p));
    default:
      return int(sm90::launch(flash_bias_bwd_kernel<true, false>, bytes, stream, p));
  }
}

// ------------------------------------------------------------------- fp32
int launch_f32(Pass pass, const Operands& o, cudaStream_t stream) {
  if (bad_shape(o)) return int(cudaErrorInvalidValue);
  bwd32::Args f{static_cast<const float*>(o.q),    static_cast<const float*>(o.k),
                static_cast<const float*>(o.v),    static_cast<const float*>(o.bias),
                static_cast<const float*>(o.dout), static_cast<const float*>(o.lse),
                static_cast<const float*>(o.delta), static_cast<const int8_t*>(o.kv_mask),
                static_cast<float*>(o.dq),         static_cast<float*>(o.dk),
                static_cast<float*>(o.dv),         static_cast<float*>(o.dbias),
                o.b, o.n, o.m, o.h, o.scale};
  return int(pass == Pass::kDqDbias ? bwd32::launch<false, true>(false, f, stream)
                                    : bwd32::launch<false, false>(pass == Pass::kDkv,
                                                                  f, stream));
}

Operands operands(const void* q, const void* k, const void* v, const void* bias,
                  const void* kv_mask, const void* dout, const void* lse,
                  const void* delta, int b, int n, int m, int h, int d,
                  float scale) {
  return Operands{q,       k,       v,       bias, kv_mask, dout, lse, delta,
                  nullptr, nullptr, nullptr, nullptr, b,   n,    m,   h,
                  d,       scale};
}

int run(bool fp32, Pass pass, const Operands& o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32 ? launch_f32(pass, o, s) : launch_bf16(pass, o, s);
}

}  // namespace

}  // namespace mrb

// q, k, v, dout (B, N|M, H, D), bias (1, H, N, M) of the entry's dtype, all
// contiguous; kv_mask (B, M) int8; lse, delta (B, H, N) fp32.
// dq (B, N, H, D): kernel 6.
extern "C" int mrb_flash_bias_bwd_dq_bf16(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* kv_mask,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int b,
                                          int n, int m, int h, int d,
                                          float scale, void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dq = dq;
  return mrb::run(false, mrb::Pass::kDq, o, stream);
}

// dq as above plus dbias (1, H, N, M) fp32 = Σ_b ds: kernel 7.
extern "C" int mrb_flash_bias_bwd_dq_dbias_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* kv_mask, const void* dout, const void* lse, const void* delta,
    void* dq, void* dbias, int b, int n, int m, int h, int d, float scale,
    void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dq = dq;
  o.dbias = dbias;
  return mrb::run(false, mrb::Pass::kDqDbias, o, stream);
}

// dk, dv (B, M, H, D): kernel 8.
extern "C" int mrb_flash_bias_bwd_dkv_bf16(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           const void* kv_mask,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int b, int n, int m,
                                           int h, int d, float scale,
                                           void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dk = dk;
  o.dv = dv;
  return mrb::run(false, mrb::Pass::kDkv, o, stream);
}

// The same three in fp32 (the parity mode's CUDA-core bodies).
extern "C" int mrb_flash_bias_bwd_dq_f32(const void* q, const void* k, const void* v,
                                         const void* bias, const void* kv_mask,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dq, int b, int n,
                                         int m, int h, int d, float scale,
                                         void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dq = dq;
  return mrb::run(true, mrb::Pass::kDq, o, stream);
}

extern "C" int mrb_flash_bias_bwd_dq_dbias_f32(
    const void* q, const void* k, const void* v, const void* bias,
    const void* kv_mask, const void* dout, const void* lse, const void* delta,
    void* dq, void* dbias, int b, int n, int m, int h, int d, float scale,
    void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dq = dq;
  o.dbias = dbias;
  return mrb::run(true, mrb::Pass::kDqDbias, o, stream);
}

extern "C" int mrb_flash_bias_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                          const void* bias, const void* kv_mask,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv,
                                          int b, int n, int m, int h, int d,
                                          float scale, void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, bias, kv_mask, dout, lse, delta, b, n, m,
                                  h, d, scale);
  o.dk = dk;
  o.dv = dv;
  return mrb::run(true, mrb::Pass::kDkv, o, stream);
}
