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
//  * fp32 (the parity mode): CUDA-core FMAs, no TF32, as the fp32 forward
//    kernels 3-5. The dq pass owns one query row a thread (128 a block, the
//    q and dO rows in shared memory, dq in registers; kernel 7's thread also
//    owns its dbias row), K and V streaming through shared memory in tiles of
//    32 keys read as broadcasts; the dk/dv pass owns one key row a thread (dk
//    and dv in registers), Q, dO, lse and δ streaming in tiles of 32
//    queries. The loads are not overlapped with the math.
// Ragged lengths are exact with no padded copy: rows past the end are
// zero-filled in shared memory, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p is 0 too.
#include <cuda_runtime.h>

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
  sm90bwd::backward_persistent<DKV, DBIAS>(p, smem);
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
  const size_t bytes = sm90bwd::Layout::alloc;
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
constexpr int F32_ROWS = 128;  // owned rows (= threads) per block
constexpr int F32_TILE = 32;   // streamed rows per shared-memory tile
constexpr int LQ = D + 4;      // owned-row stride: a 16-byte load phase hits 32 banks
// Two owned 128-row operands, two streamed 32-row tiles, two 32-float vectors.
constexpr size_t F32_SMEM =
    (size_t(2) * F32_ROWS * LQ + size_t(2) * F32_TILE * D + 2 * F32_TILE) * 4;

struct F32Args {
  const float *q, *k, *v, *bias, *dout, *lse, *delta;
  const int8_t* kv_mask;
  float *dq, *dk, *dv, *dbias;
  int b, n, m, h;
  float scale;
};

// 128 rows [r0, r0 + 128) of a (rows, H, D) operand, times `mul`, into a
// shared block of stride LQ; rows past n_rows are zero.
__device__ __forceinline__ void load_owned(float* dst, const float* src, long hd,
                                           int r0, int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < F32_ROWS * (D / 4); idx += F32_ROWS) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) {
      val = *reinterpret_cast<const float4*>(src + long(r0 + r) * hd + c);
      val.x *= mul;
      val.y *= mul;
      val.z *= mul;
      val.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LQ + c) = val;
  }
}

// F32_TILE rows [r0, ...) of two (rows, H, D) operands, times `mul_a` for
// the first, into dense shared tiles; rows past n_rows are zero.
__device__ __forceinline__ void load_tiles(float* da, float* db, const float* a,
                                           const float* b, long hd, int r0,
                                           int n_rows, float mul_a) {
  for (int idx = threadIdx.x; idx < F32_TILE * (D / 4); idx += F32_ROWS) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vb = va;
    if (r0 + r < n_rows) {
      va = *reinterpret_cast<const float4*>(a + long(r0 + r) * hd + c);
      vb = *reinterpret_cast<const float4*>(b + long(r0 + r) * hd + c);
      va.x *= mul_a;
      va.y *= mul_a;
      va.z *= mul_a;
      va.w *= mul_a;
    }
    *reinterpret_cast<float4*>(da + r * D + c) = va;
    *reinterpret_cast<float4*>(db + r * D + c) = vb;
  }
}

// acc[j] += x · y[j] over the head dim, for `J` rows y[j] of a dense tile.
template <int J>
__device__ __forceinline__ void dots(float (&acc)[J], const float* x, const float* y) {
  // Unrolled 4 deep, not 16: fully unrolled, ptxas hoists the 256 loads of
  // the two calls a step and spills them.
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + c);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(y + j * D + c);
      acc[j] = fmaf(xv.x, yv.x, acc[j]);
      acc[j] = fmaf(xv.y, yv.y, acc[j]);
      acc[j] = fmaf(xv.z, yv.z, acc[j]);
      acc[j] = fmaf(xv.w, yv.w, acc[j]);
    }
  }
}

// out += Σ_j w[j] · y[j] for `J` rows y[j] of a dense tile.
template <int J>
__device__ __forceinline__ void axpys(float (&out)[D], const float (&w)[J],
                                      const float* y) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(y + j * D + c);
      out[c] = fmaf(w[j], yv.x, out[c]);
      out[c + 1] = fmaf(w[j], yv.y, out[c + 1]);
      out[c + 2] = fmaf(w[j], yv.z, out[c + 2]);
      out[c + 3] = fmaf(w[j], yv.w, out[c + 3]);
    }
  }
}

__device__ __forceinline__ void store_row(float* dst, const float (&acc)[D], float mul) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(dst + c) =
        make_float4(acc[c] * mul, acc[c + 1] * mul, acc[c + 2] * mul, acc[c + 3] * mul);
  }
}

// Kernels 6 and 7 in fp32: grid (query block, head, batch row), or for
// DBIAS (query block, head) with the batch rows walked in order.
template <bool DBIAS>
__global__ void __launch_bounds__(F32_ROWS)
flash_bias_bwd_dq_f32_kernel(F32Args f) {
  constexpr int CH = 16;  // keys per step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + F32_ROWS * LQ;
  float* sK = sDO + F32_ROWS * LQ;
  float* sV = sK + F32_TILE * D;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * F32_ROWS;
  const int row = q0 + threadIdx.x;
  const long hd = long(f.h) * D;
  // This thread's bias row (the last one for rows past the end, which
  // compute nothing that is stored) and dbias row.
  const float* brow = f.bias + (long(head) * f.n + min(row, f.n - 1)) * f.m;
  float* dbrow = DBIAS ? f.dbias + (long(head) * f.n + row) * f.m : nullptr;
  // A warp whose first row lies past the end has no row to compute.
  const bool warp_active = q0 + (threadIdx.x & ~31) < f.n;
  const int b_end = DBIAS ? f.b : int(blockIdx.z) + 1;
  for (int b = DBIAS ? 0 : int(blockIdx.z); b < b_end; ++b) {
    const long qoff = long(b) * f.n * hd + long(head) * D;
    const long koff = long(b) * f.m * hd + long(head) * D;
    const int8_t* mask = f.kv_mask + long(b) * f.m;
    const long srow = (long(b) * f.h + head) * f.n + row;
    const float lse = row < f.n ? f.lse[srow] : INFINITY;
    const float delta = row < f.n ? f.delta[srow] : 0.f;
    __syncthreads();  // the previous batch row's readers are done
    load_owned(sQ, f.q + qoff, hd, q0, f.n, f.scale);
    load_owned(sDO, f.dout + qoff, hd, q0, f.n, 1.f);
    float dq[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dq[c] = 0.f;
    const float* qrow = sQ + threadIdx.x * LQ;
    const float* orow = sDO + threadIdx.x * LQ;
    for (int k0 = 0; k0 < f.m; k0 += F32_TILE) {
      __syncthreads();  // every warp is done with the previous tile
      load_tiles(sK, sV, f.k + koff, f.v + koff, hd, k0, f.m, 1.f);
      __syncthreads();
      if (!warp_active) continue;
      for (int c0 = 0; c0 < F32_TILE && k0 + c0 < f.m; c0 += CH) {
        float s[CH] = {}, dp[CH] = {};
        dots(s, qrow, sK + c0 * D);
        dots(dp, orow, sV + c0 * D);
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int key = k0 + c0 + j;
          const bool ok = key < f.m && mask[key] != 0;
          const float p = ok ? expf(s[j] + brow[key] - lse) : 0.f;
          s[j] = p * (dp[j] - delta);
          if (DBIAS && row < f.n && key < f.m) {
            dbrow[key] = b == 0 ? s[j] : dbrow[key] + s[j];
          }
        }
        axpys(dq, s, sK + c0 * D);
      }
    }
    if (row < f.n) store_row(f.dq + qoff + long(row) * hd, dq, f.scale);
  }
}

// Kernel 8 in fp32: grid (key block, head, batch row), one key row a thread.
__global__ void __launch_bounds__(F32_ROWS)
flash_bias_bwd_dkv_f32_kernel(F32Args f) {
  constexpr int CH = 8;  // queries per step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + F32_ROWS * LQ;
  float* sQ = sV + F32_ROWS * LQ;
  float* sDO = sQ + F32_TILE * D;
  float* sLse = sDO + F32_TILE * D;
  float* sDelta = sLse + F32_TILE;

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * F32_ROWS;
  const int key = k0 + threadIdx.x;
  const long hd = long(f.h) * D;
  const long qoff = long(b) * f.n * hd + long(head) * D;
  const long koff = long(b) * f.m * hd + long(head) * D;
  const long soff = (long(b) * f.h + head) * f.n;
  const float* bcol = f.bias + long(head) * f.n * f.m + key;
  const bool key_ok = key < f.m && f.kv_mask[long(b) * f.m + key] != 0;
  const bool warp_active = k0 + (threadIdx.x & ~31) < f.m;

  load_owned(sK, f.k + koff, hd, k0, f.m, 1.f);
  load_owned(sV, f.v + koff, hd, k0, f.m, 1.f);
  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;
  const float* krow = sK + threadIdx.x * LQ;
  const float* vrow = sV + threadIdx.x * LQ;
  for (int q0 = 0; q0 < f.n; q0 += F32_TILE) {
    __syncthreads();  // k and v are stored; every warp is done with the last tile
    // q pre-scaled, so q·k is the scaled score and Σ ds·q is dk.
    load_tiles(sQ, sDO, f.q + qoff, f.dout + qoff, hd, q0, f.n, f.scale);
    if (threadIdx.x < F32_TILE) {
      const int qi = q0 + threadIdx.x;
      sLse[threadIdx.x] = qi < f.n ? f.lse[soff + qi] : INFINITY;
      sDelta[threadIdx.x] = qi < f.n ? f.delta[soff + qi] : 0.f;
    }
    __syncthreads();
    if (!warp_active) continue;
    for (int c0 = 0; c0 < F32_TILE && q0 + c0 < f.n; c0 += CH) {
      float st[CH] = {}, dpt[CH] = {};
      dots(st, krow, sQ + c0 * D);
      dots(dpt, vrow, sDO + c0 * D);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int qi = q0 + c0 + j;
        const float p = key_ok && qi < f.n
                            ? expf(st[j] + bcol[long(qi) * f.m] - sLse[c0 + j])
                            : 0.f;
        st[j] = p;
        dpt[j] = p * (dpt[j] - sDelta[c0 + j]);
      }
      axpys(dv, st, sDO + c0 * D);
      axpys(dk, dpt, sQ + c0 * D);
    }
  }
  if (key < f.m) {
    store_row(f.dk + koff + long(key) * hd, dk, 1.f);
    store_row(f.dv + koff + long(key) * hd, dv, 1.f);
  }
}

int launch_f32(Pass pass, const Operands& o, cudaStream_t stream) {
  if (bad_shape(o)) return int(cudaErrorInvalidValue);
  F32Args f{static_cast<const float*>(o.q),    static_cast<const float*>(o.k),
            static_cast<const float*>(o.v),    static_cast<const float*>(o.bias),
            static_cast<const float*>(o.dout), static_cast<const float*>(o.lse),
            static_cast<const float*>(o.delta), static_cast<const int8_t*>(o.kv_mask),
            static_cast<float*>(o.dq),         static_cast<float*>(o.dk),
            static_cast<float*>(o.dv),         static_cast<float*>(o.dbias),
            o.b, o.n, o.m, o.h, o.scale};
  void (*kernel)(F32Args) = flash_bias_bwd_dkv_f32_kernel;
  dim3 grid((o.m + F32_ROWS - 1) / F32_ROWS, o.h, o.b);
  if (pass != Pass::kDkv) {
    kernel = pass == Pass::kDq ? flash_bias_bwd_dq_f32_kernel<false>
                               : flash_bias_bwd_dq_f32_kernel<true>;
    grid = dim3((o.n + F32_ROWS - 1) / F32_ROWS, o.h, pass == Pass::kDq ? o.b : 1);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(F32_SMEM));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, F32_ROWS, F32_SMEM, stream>>>(f);
  return int(cudaGetLastError());
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
