// Backward of the flash self-attention with the T5 relative-position bias
// computed inside the kernel (long-context T5 encoder, relpos_in_kernel),
// head dim 64, bf16 and fp32. No (1, H, N, N) bias or dbias exists anywhere.
//
// Replaces, in mr_blip_tpu/ops/flash_attention.py:
//  * _flash_relpos_bwd_dq_kernel (pallas_call :1366)      -> kernel 10 (dq);
//  * _flash_relpos_bwd_dq_dtab_kernel (:1347)             -> kernel 11 (dq, and
//                                                            dtable with
//                                                            relpos_dtable_reduce_kernel);
//  * _flash_relpos_bwd_dkv_kernel (:1376)                 -> kernel 12 (dk, dv).
//
// Each recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's saved row logsumexp, with
// bias = table[head][bucket(key - query)], then with δ = rowsum(dO∘O)
// (computed outside, in fp32):
//   dp = dO·vᵀ,  ds = p∘(dp - δ),  dq = ds·k·scale,  dk = dsᵀ·q·scale,
//   dv = pᵀ·dO,  dtable[head][u] = Σ ds over (b, i, j) with bucket(j - i) = u.
//
// Bound on this card: the dq pass does 3 and the dk/dv pass 4 products of
// 2·B·H·N·N·D flops (0.80 and 1.06 ms at the bf16 peak at 1 x 8,000 x H 32)
// against q, k, v, dO and the outputs moved once and no bias traffic at all,
// so the tensor-core math bounds all three.
//
// bf16: the Hopper backward tile of backward_tile_sm90.cuh in its rel-pos
// kind, the tile of kernels 6-8 (persistent warp-specialised blocks of 128
// rows, `wgmma` for every product with P and dS kept in registers, the
// fixed operands of a work item in two slots and the streamed ones in a
// 4-stage ring, all by TMA), with work items 128-row block fastest so the
// blocks of one (batch row, head) re-read its K/V or Q/dO from L2. The
// bias depends only on clamp(key - query, -maxd, maxd): the wrapper hands in
// the bucket of each of those 2*maxd + 1 relative positions (the bit-exact
// host bucket function: no device logf can flip a bucket) and the far
// thresholds, the producer builds table[head][bucket[c]] per work item, and
// a consumer's 64 x 64 tile past a far threshold (one bucket) adds one value
// without index arithmetic while only the tiles near the diagonal look a
// value up per score, in both passes. dtable (kernel 11) repeats bit for bit
// without atomics: far tiles sum ds in registers, near tiles into
// per-thread shared bins, each consumer writes one partial per (batch row,
// 64-row block, head) in thread order, and relpos_dtable_reduce_kernel sums
// the partials in block order. Ragged N is exact with no padded copy: TMA
// zero-fills rows past the end, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p and ds are 0 and they
// add nothing to dtable.
//
// fp32 (the parity mode): the CUDA-core bodies of backward_f32.cuh that
// serve kernels 6-8 in fp32, with the bias looked up the same way (blocks of
// 128 owned rows; dtable through the same per-thread bins, per-block
// partials and second pass in block order).
#include <cuda_runtime.h>

#include "backward_f32.cuh"
#include "backward_tile_sm90.cuh"

namespace mrb {

namespace {

using sm90::bf16;
constexpr int D = sm90bwd::D;
constexpr int MAX_BUCKETS = sm90bwd::MAX_BUCKETS;

// Kernels 10 (DKV false, DTAB false), 11 (false, true) and 12 (true, false).
template <bool DKV, bool DTAB>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
flash_relpos_bwd_kernel(const __grid_constant__ sm90bwd::Problem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90bwd::backward_persistent<DKV, sm90::kRelpos, DTAB>(p, smem);
}

// dtable[head][u] = the partials of every (batch row, row block) block,
// summed in block order. Grid (head), one thread per bucket.
__global__ void relpos_dtable_reduce_kernel(const float* partial,
                                            float* dtable, long n_blocks,
                                            int h, int nb) {
  const int head = blockIdx.x;
  const int u = threadIdx.x;
  if (u >= nb) return;
  float sum = 0.f;
  for (long i = 0; i < n_blocks; ++i) {
    sum += partial[(i * h + head) * nb + u];
  }
  dtable[long(head) * nb + u] = sum;
}

bool bad_shape(int b, int n, int h, int d, int nb, int maxd) {
  return b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535 || d != D ||
         nb <= 0 || nb > MAX_BUCKETS || maxd <= 0 ||
         maxd > sm90::MAX_REL_DISTANCE;
}

struct Operands {
  const void *q, *k, *v, *table, *lut, *kv_mask, *dout, *lse, *delta;
  void *dq, *dk, *dv, *dtable, *partial;
  int b, n, h, d, nb, maxd, past, future;
  float scale;
};

Operands operands(const void* q, const void* k, const void* v, const void* table,
                  const void* lut, const void* kv_mask, const void* dout,
                  const void* lse, const void* delta, int b, int n, int h, int d,
                  int nb, int maxd, int past, int future, float scale) {
  return Operands{q,       k,       v,       table,   lut,     kv_mask, dout, lse,
                  delta,   nullptr, nullptr, nullptr, nullptr, nullptr, b,    n,
                  h,       d,       nb,      maxd,    past,    future,  scale};
}

// One bf16 launch: the dK/dV pass (dkv), else the dQ pass, with dtable when
// o.dtable is set.
int launch_bf16(bool dkv, const Operands& o, cudaStream_t stream) {
  const bool dtab = o.dtable != nullptr;
  const long n_blk = (o.n + sm90bwd::BITEM - 1) / sm90bwd::BITEM;
  if (bad_shape(o.b, o.n, o.h, o.d, o.nb, o.maxd) || o.past < -o.maxd ||
      o.future > o.maxd || long(o.b) * o.h * n_blk > 0x7fffffffL) {
    return int(cudaErrorInvalidValue);
  }
  sm90bwd::Problem p{};
  const long hd = long(o.h) * D;
  const int b = o.b, n = o.n, h = o.h;
  cudaError_t err = sm90::encode_qkv(&p.maps.q, o.q, b, n, h, D, n * hd, hd, D);
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.dout, o.dout, b, n, h, D, n * hd, hd, D);
  }
  if (err == cudaSuccess) err = sm90::encode_qkv(&p.maps.k, o.k, b, n, h, D, n * hd, hd, D);
  if (err == cudaSuccess) err = sm90::encode_qkv(&p.maps.v, o.v, b, n, h, D, n * hd, hd, D);
  if (err != cudaSuccess) return int(err);
  p.kv_mask = static_cast<const int8_t*>(o.kv_mask);
  p.lse = static_cast<const float*>(o.lse);
  p.delta = static_cast<const float*>(o.delta);
  p.dq = static_cast<bf16*>(o.dq);
  p.dk = static_cast<bf16*>(o.dk);
  p.dv = static_cast<bf16*>(o.dv);
  p.table = static_cast<const float*>(o.table);
  p.lut = static_cast<const int*>(o.lut);
  p.partial = static_cast<float*>(o.partial);
  p.batch = b;
  p.n = n;
  p.m = n;
  p.h = h;
  p.n_blk = int(n_blk);
  p.items = int(long(b) * h * n_blk);
  p.subs = 1;
  p.scale = o.scale;
  p.nb = o.nb;
  p.maxd = o.maxd;
  p.past = o.past;
  p.future = o.future;
  using L = sm90bwd::Layout<sm90::kRelpos, false>;
  using L11 = sm90bwd::Layout<sm90::kRelpos, true>;
  if (dkv) return int(sm90::launch(flash_relpos_bwd_kernel<true, false>, L::alloc, stream, p));
  if (!dtab) return int(sm90::launch(flash_relpos_bwd_kernel<false, false>, L::alloc, stream, p));
  err = sm90::launch(flash_relpos_bwd_kernel<false, true>, L11::alloc, stream, p);
  if (err != cudaSuccess) return int(err);
  // One partial per 64-row half of every item: 2 * n_blk a batch row.
  relpos_dtable_reduce_kernel<<<h, MAX_BUCKETS, 0, stream>>>(
      p.partial, static_cast<float*>(o.dtable), long(b) * 2 * n_blk, h, o.nb);
  return int(cudaGetLastError());
}

}  // namespace

}  // namespace mrb

// q, k, v, dout (B, N, H, 64) bf16 contiguous, table (H, nb) fp32, lut
// (2*maxd + 1,) int32 with values in [0, nb), kv_mask (B, N) int8, lse and
// delta (B, H, N) fp32. past / future: the far thresholds (every key - query
// <= past has the bucket lut[0], every key - query >= future the bucket
// lut[2*maxd]; -maxd and maxd always qualify).
// dq (B, N, H, D) bf16: kernel 10.
extern "C" int mrb_flash_relpos_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int n, int h, int d, int nb, int maxd,
    int past, int future, float scale, void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, table, lut, kv_mask, dout, lse, delta, b, n,
                                  h, d, nb, maxd, past, future, scale);
  o.dq = dq;
  return mrb::launch_bf16(false, o, static_cast<cudaStream_t>(stream));
}

// dq as above plus dtable (H, nb) fp32: kernel 11. `partial` is a workspace
// of B * 2 * ceil(N / 128) * H * nb floats: the kernel writes one partial
// sum per (batch row, 64-row half of a 128-row block, head, bucket), zeros
// for a half that holds no row (N <= 64, or the last block's second half).
extern "C" int mrb_flash_relpos_bwd_dq_dtable_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, void* dtable, void* partial, int b, int n,
    int h, int d, int nb, int maxd, int past, int future, float scale,
    void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, table, lut, kv_mask, dout, lse, delta, b, n,
                                  h, d, nb, maxd, past, future, scale);
  o.dq = dq;
  o.dtable = dtable;
  o.partial = partial;
  return mrb::launch_bf16(false, o, static_cast<cudaStream_t>(stream));
}

// dk, dv (B, N, H, D) bf16: kernel 12.
extern "C" int mrb_flash_relpos_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int n, int h, int d, int nb,
    int maxd, int past, int future, float scale, void* stream) {
  mrb::Operands o = mrb::operands(q, k, v, table, lut, kv_mask, dout, lse, delta, b, n,
                                  h, d, nb, maxd, past, future, scale);
  o.dk = dk;
  o.dv = dv;
  return mrb::launch_bf16(true, o, static_cast<cudaStream_t>(stream));
}

namespace {

// The fp32 entries' operands (kernels 10-12 in the parity mode).
mrb::bwd32::Args f32_args(const void* q, const void* k, const void* v,
                          const void* table, const void* lut, const void* kv_mask,
                          const void* dout, const void* lse, const void* delta,
                          int b, int n, int h, int nb, int maxd, float scale) {
  mrb::bwd32::Args f{static_cast<const float*>(q),    static_cast<const float*>(k),
                     static_cast<const float*>(v),    nullptr,
                     static_cast<const float*>(dout), static_cast<const float*>(lse),
                     static_cast<const float*>(delta), static_cast<const int8_t*>(kv_mask),
                     nullptr, nullptr, nullptr, nullptr, b, n, n, h, scale};
  f.table = static_cast<const float*>(table);
  f.lut = static_cast<const int*>(lut);
  f.nb = nb;
  f.maxd = maxd;
  return f;
}

}  // namespace

// The same three in fp32, with the same argument lists; dq + dtable's
// `partial` holds B * ceil(N / 128) * H * nb floats (the bf16 entry's
// workspace is larger and serves).
extern "C" int mrb_flash_relpos_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int n, int h, int d, int nb, int maxd,
    float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::bwd32::Args f = f32_args(q, k, v, table, lut, kv_mask, dout, lse, delta, b,
                                n, h, nb, maxd, scale);
  f.dq = static_cast<float*>(dq);
  return int(mrb::bwd32::launch<true, false>(false, f,
                                             static_cast<cudaStream_t>(stream)));
}

extern "C" int mrb_flash_relpos_bwd_dq_dtable_f32(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, void* dtable, void* partial, int b, int n,
    int h, int d, int nb, int maxd, float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::bwd32::Args f = f32_args(q, k, v, table, lut, kv_mask, dout, lse, delta, b,
                                n, h, nb, maxd, scale);
  f.dq = static_cast<float*>(dq);
  f.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = mrb::bwd32::launch<true, true>(false, f, s);
  if (err != cudaSuccess) return int(err);
  const long n_blocks = long(b) * mrb::bwd32::blocks(n);
  mrb::relpos_dtable_reduce_kernel<<<h, mrb::MAX_BUCKETS, 0, s>>>(
      f.partial, static_cast<float*>(dtable), n_blocks, h, nb);
  return int(cudaGetLastError());
}

extern "C" int mrb_flash_relpos_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int n, int h, int d, int nb,
    int maxd, float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::bwd32::Args f = f32_args(q, k, v, table, lut, kv_mask, dout, lse, delta, b,
                                n, h, nb, maxd, scale);
  f.dk = static_cast<float*>(dk);
  f.dv = static_cast<float*>(dv);
  return int(mrb::bwd32::launch<true, false>(true, f,
                                             static_cast<cudaStream_t>(stream)));
}
