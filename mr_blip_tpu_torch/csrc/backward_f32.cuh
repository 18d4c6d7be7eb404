// The fp32 (parity-mode) bodies of the flash backward kernels, head dim 64:
// kernels 6-8 (flash_bias_backward.cu: the bias read from a (1, H, N, M)
// tensor) and kernels 10-12 (flash_relpos_backward.cu: the bias looked up
// from the (H, num_buckets) table through the clamped bucket lut).
//
// Each recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's row logsumexp, then with δ = rowsum(dO∘O):
//   dp = dO·vᵀ,  ds = p∘(dp - δ),  dq = ds·k·scale,  dk = dsᵀ·q·scale,
//   dv = pᵀ·dO,  dbias = Σ_b ds,  dtable[h][u] = Σ ds over bucket(j - i) = u.
//
// CUDA-core FMAs, no TF32: fp32 is the model's parity mode, and a TF32
// product would round the operands to 10 bits. The dq pass owns one query
// row a thread (128 a block, the q and dO rows in shared memory, dq in
// registers), K and V streaming through shared memory in tiles of 32 keys
// read as broadcasts; the dk/dv pass owns one key row a thread (dk and dv in
// registers), Q, dO, lse and δ streaming in tiles of 32 queries. The loads
// are not overlapped with the math.
//  * dbias (kernel 7): grid (query block, head), the batch rows walked in
//    order by the thread that owns the dbias row: the first stores its ds,
//    each later one adds to it (deterministic, no atomics).
//  * dtable (kernel 11): grid (query block, head, batch row). Every thread
//    owns num_buckets bins in shared memory (bin u of thread t at
//    [u * 128 + t]: a warp's adds never share a bank) and adds each ds, in
//    key order, to the bin of its bucket; the block sums each bucket's 128
//    bins in thread order into a per-block partial, and a second pass
//    (flash_relpos_backward.cu) sums the partials in block order. Every sum
//    has a fixed order and there are no atomics, so dtable repeats bit for
//    bit.
// Ragged lengths are exact with no padded copy: rows past the end are
// zero-filled in shared memory, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p and ds are 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mrb {
namespace bwd32 {

constexpr int D = 64;          // the only head dim (T5 d_kv)
constexpr int ROWS = 128;      // owned rows (= threads) per block
constexpr int TILE = 32;       // streamed rows per shared-memory tile
constexpr int LQ = D + 4;      // owned-row stride: a 16-byte load phase hits 32 banks
constexpr int MAX_BUCKETS = 32;
constexpr int MAX_REL = 2047;  // 2 * maxd + 1 entries of the rel tables
// Two owned 128-row operands, two streamed 32-row tiles, two 32-float vectors.
constexpr size_t SMEM = (size_t(2) * ROWS * LQ + size_t(2) * TILE * D + 2 * TILE) * 4;
// The rel-pos kernels: also the bias by clamped relative position; dtable:
// also the bucket lut and the per-thread bins.
constexpr size_t SMEM_REL = SMEM + size_t(MAX_REL + 1) * 4;
constexpr size_t SMEM_DTABLE = SMEM_REL + size_t(MAX_REL + 1) * 4 +
                               size_t(MAX_BUCKETS) * ROWS * 4;

struct Args {
  const float *q, *k, *v, *bias, *dout, *lse, *delta;
  const int8_t* kv_mask;
  float *dq, *dk, *dv, *dbias;
  int b, n, m, h;
  float scale;
  // The rel-pos kernels (n == m): the (H, nb) table, the (2*maxd + 1,) lut
  // and, for dtable, the (blocks, H, nb) partial sums.
  const float* table = nullptr;
  const int* lut = nullptr;
  float* partial = nullptr;
  int nb = 0, maxd = 0;
};

// 128 rows [r0, r0 + 128) of a (rows, H, D) operand, times `mul`, into a
// shared block of stride LQ; rows past n_rows are zero.
__device__ __forceinline__ void load_owned(float* dst, const float* src, long hd,
                                           int r0, int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * (D / 4); idx += ROWS) {
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

// TILE rows [r0, ...) of two (rows, H, D) operands, times `mul_a` for the
// first, into dense shared tiles; rows past n_rows are zero.
__device__ __forceinline__ void load_tiles(float* da, float* db, const float* a,
                                           const float* b, long hd, int r0,
                                           int n_rows, float mul_a) {
  for (int idx = threadIdx.x; idx < TILE * (D / 4); idx += ROWS) {
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

// Index of key - query into the rel tables.
__device__ __forceinline__ int rel_at(int key, int query, int maxd) {
  return min(max(key - query, -maxd), maxd) + maxd;
}

// sRel[c] = table[head][lut[c]] (and sLut[c] = lut[c]) for c in [0, 2*maxd],
// by the whole block; read after the caller's next __syncthreads().
__device__ __forceinline__ void load_rel(float* sRel, int* sLut, const Args& f,
                                         int head) {
  for (int c = threadIdx.x; c <= 2 * f.maxd; c += ROWS) {
    const int u = f.lut[c];
    sRel[c] = f.table[long(head) * f.nb + u];
    if (sLut != nullptr) sLut[c] = u;
  }
}

// dq: kernels 6 (RELPOS false, GRAD false), 7 (false, true: dbias), 10
// (true, false) and 11 (true, true: dtable partials). Grid (query block,
// head, batch row), or for kernel 7 (query block, head) with the batch rows
// walked in order.
template <bool RELPOS, bool GRAD>
__global__ void __launch_bounds__(ROWS) bwd_dq_kernel(Args f) {
  constexpr int CH = 16;  // keys per step
  constexpr bool DBIAS = GRAD && !RELPOS;
  constexpr bool DTABLE = GRAD && RELPOS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + ROWS * LQ;
  float* sK = sDO + ROWS * LQ;
  float* sV = sK + TILE * D;
  float* sRel = reinterpret_cast<float*>(smem_raw + SMEM);
  int* sLut = reinterpret_cast<int*>(smem_raw + SMEM_REL);
  float* sBins = reinterpret_cast<float*>(smem_raw + SMEM_REL + size_t(MAX_REL + 1) * 4);

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * ROWS;
  const int row = q0 + threadIdx.x;
  const long hd = long(f.h) * D;
  // This thread's bias row (the last one for rows past the end, which
  // compute nothing that is stored) and dbias row.
  const float* brow =
      RELPOS ? nullptr : f.bias + (long(head) * f.n + min(row, f.n - 1)) * f.m;
  float* dbrow = DBIAS ? f.dbias + (long(head) * f.n + row) * f.m : nullptr;
  if constexpr (RELPOS) {
    load_rel(sRel, DTABLE ? sLut : nullptr, f, head);
    if constexpr (DTABLE) {
      for (int u = 0; u < f.nb; ++u) sBins[u * ROWS + threadIdx.x] = 0.f;
    }
  }
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
    for (int k0 = 0; k0 < f.m; k0 += TILE) {
      __syncthreads();  // every warp is done with the previous tile
      load_tiles(sK, sV, f.k + koff, f.v + koff, hd, k0, f.m, 1.f);
      __syncthreads();
      if (!warp_active) continue;
      for (int c0 = 0; c0 < TILE && k0 + c0 < f.m; c0 += CH) {
        // Kernel 7, batch rows after the first: the chunk's dbias sums so
        // far, loaded before the products so that their latency is hidden.
        const int n_keys = min(CH, f.m - (k0 + c0));
        float* dst = DBIAS ? dbrow + k0 + c0 : nullptr;
        float prev[CH] = {};
        if (DBIAS && b > 0 && row < f.n) {
#pragma unroll
          for (int j = 0; j < CH; ++j) prev[j] = j < n_keys ? dst[j] : 0.f;
        }
        float s[CH] = {}, dp[CH] = {};
        dots(s, qrow, sK + c0 * D);
        dots(dp, orow, sV + c0 * D);
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int key = k0 + c0 + j;
          const bool ok = key < f.m && mask[key] != 0;
          float p;
          if constexpr (RELPOS) {
            p = ok ? expf(s[j] + sRel[rel_at(key, row, f.maxd)] - lse) : 0.f;
          } else {
            p = ok ? expf(s[j] + brow[key] - lse) : 0.f;
          }
          s[j] = p * (dp[j] - delta);
          if (DTABLE && key < f.m) {
            sBins[sLut[rel_at(key, row, f.maxd)] * ROWS + threadIdx.x] += s[j];
          }
        }
        if (DBIAS && row < f.n) {
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            if (j < n_keys) dst[j] = b == 0 ? s[j] : prev[j] + s[j];
          }
        }
        axpys(dq, s, sK + c0 * D);
      }
    }
    if (row < f.n) store_row(f.dq + qoff + long(row) * hd, dq, f.scale);
  }
  if constexpr (DTABLE) {
    __syncthreads();
    if (threadIdx.x < f.nb) {
      float sum = 0.f;
      for (int i = 0; i < ROWS; ++i) sum += sBins[threadIdx.x * ROWS + i];
      const long block = long(blockIdx.z) * gridDim.x + blockIdx.x;
      f.partial[(block * f.h + head) * f.nb + threadIdx.x] = sum;
    }
  }
}

// dk, dv: kernels 8 and 12. Grid (key block, head, batch row), one key row
// a thread.
template <bool RELPOS>
__global__ void __launch_bounds__(ROWS) bwd_dkv_kernel(Args f) {
  constexpr int CH = 8;  // queries per step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + ROWS * LQ;
  float* sQ = sV + ROWS * LQ;
  float* sDO = sQ + TILE * D;
  float* sLse = sDO + TILE * D;
  float* sDelta = sLse + TILE;
  float* sRel = reinterpret_cast<float*>(smem_raw + SMEM);

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * ROWS;
  const int key = k0 + threadIdx.x;
  const long hd = long(f.h) * D;
  const long qoff = long(b) * f.n * hd + long(head) * D;
  const long koff = long(b) * f.m * hd + long(head) * D;
  const long soff = (long(b) * f.h + head) * f.n;
  const float* bcol = RELPOS ? nullptr : f.bias + long(head) * f.n * f.m + key;
  const bool key_ok = key < f.m && f.kv_mask[long(b) * f.m + key] != 0;
  const bool warp_active = k0 + (threadIdx.x & ~31) < f.m;

  if constexpr (RELPOS) load_rel(sRel, nullptr, f, head);
  load_owned(sK, f.k + koff, hd, k0, f.m, 1.f);
  load_owned(sV, f.v + koff, hd, k0, f.m, 1.f);
  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;
  const float* krow = sK + threadIdx.x * LQ;
  const float* vrow = sV + threadIdx.x * LQ;
  for (int q0 = 0; q0 < f.n; q0 += TILE) {
    __syncthreads();  // k and v are stored; every warp is done with the last tile
    // q pre-scaled, so q·k is the scaled score and Σ ds·q is dk.
    load_tiles(sQ, sDO, f.q + qoff, f.dout + qoff, hd, q0, f.n, f.scale);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      sLse[threadIdx.x] = qi < f.n ? f.lse[soff + qi] : INFINITY;
      sDelta[threadIdx.x] = qi < f.n ? f.delta[soff + qi] : 0.f;
    }
    __syncthreads();
    if (!warp_active) continue;
    for (int c0 = 0; c0 < TILE && q0 + c0 < f.n; c0 += CH) {
      float st[CH] = {}, dpt[CH] = {};
      dots(st, krow, sQ + c0 * D);
      dots(dpt, vrow, sDO + c0 * D);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int qi = q0 + c0 + j;
        float p = 0.f;
        if (key_ok && qi < f.n) {
          const float bias =
              RELPOS ? sRel[rel_at(key, qi, f.maxd)] : bcol[long(qi) * f.m];
          p = expf(st[j] + bias - sLse[c0 + j]);
        }
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

// Query (or key) blocks of one batch row.
inline int blocks(int rows) { return (rows + ROWS - 1) / ROWS; }

// Launch one of the kernels above: `dkv` picks bwd_dkv_kernel, else
// bwd_dq_kernel<RELPOS, GRAD>.
template <bool RELPOS, bool GRAD>
inline cudaError_t launch(bool dkv, const Args& f, cudaStream_t stream) {
  void (*kernel)(Args) = bwd_dkv_kernel<RELPOS>;
  size_t smem = RELPOS ? SMEM_REL : SMEM;
  dim3 grid(blocks(f.m), f.h, f.b);
  if (!dkv) {
    kernel = bwd_dq_kernel<RELPOS, GRAD>;
    grid = dim3(blocks(f.n), f.h, GRAD && !RELPOS ? 1 : f.b);
    if (GRAD && RELPOS) smem = SMEM_DTABLE;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, ROWS, smem, stream>>>(f);
  return cudaGetLastError();
}

}  // namespace bwd32
}  // namespace mrb
