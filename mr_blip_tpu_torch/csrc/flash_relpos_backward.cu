// Backward of the flash self-attention with the T5 relative-position bias
// computed inside the kernel (long-context T5 encoder, relpos_in_kernel),
// head dim 64, bf16. No (1, H, N, N) bias or dbias exists anywhere.
//
// Replaces, in mr_blip_tpu/ops/flash_attention.py:
//  * _flash_relpos_bwd_dq_kernel (pallas_call :1366)      -> relpos_bwd_dq_kernel<false>;
//  * _flash_relpos_bwd_dq_dtab_kernel (:1347)             -> relpos_bwd_dq_kernel<true>
//                                                            + relpos_dtable_reduce_kernel;
//  * _flash_relpos_bwd_dkv_kernel (:1376)                 -> relpos_bwd_dkv_kernel.
//
// Each recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's saved row logsumexp, with
// bias = table[head][bucket(key - query)], then with δ = rowsum(dO∘O)
// (computed outside, in fp32):
//   dp = dO·vᵀ,  ds = p∘(dp - δ),  dq = ds·k·scale,  dk = dsᵀ·q·scale,
//   dv = pᵀ·dO,  dtable[head][u] = Σ ds over (b, i, j) with bucket(j - i) = u.
//
// Bound on this card: the dq pass does 3 and the dk/dv pass 4 products of
// 2·B·H·N·N·D flops against q, k, v, dO and the outputs moved once and no
// bias traffic at all, so the tensor-core math bounds all three.
//
// Design: the tiles of flash_bias_backward.cu (4 warps, 16 rows a warp in
// registers, mma.sync m16n8k16, ds and p never leave registers) with the
// bias tile replaced by a lookup. The bucket depends only on
// clamp(key - query, -maxd, maxd); the caller hands in the bucket of each of
// those 2*maxd + 1 relative positions (from the bit-exact host-side bucket
// function: no device logf) and each block keeps table[head][bucket[c]] in
// shared memory, so a score's bias is one clamp and one shared load where
// the TPU kernel walks a num_buckets-way select. One code path serves near
// and far tiles.
//  * dq: grid (query tile, head, batch row), key tiles of 64 streamed.
//  * dq + dtable: the same grid. Every thread owns num_buckets bins in
//    shared memory (bin u of thread t at [u * 128 + t], so a warp's
//    accesses never share a bank) and adds each ds to the bin of its
//    bucket; a tile wholly beyond maxd on one side has one bucket, so its
//    32 values per thread are summed in registers and added once at the
//    end. The block then sums each bucket's 128 bins in thread order and
//    writes the num_buckets partial sums to a workspace; a second kernel
//    sums the partials of all (batch row, query tile) blocks in index
//    order. Every sum has a fixed order and there are no atomics, so dtable
//    repeats bit for bit (the TPU kernel gets that from its sequential
//    grid).
//  * dk/dv: grid (key tile, head, batch row), query tiles of 64 streamed in
//    two halves of 32 with their lse and δ.
// Ragged N is exact with no padded copy: tile rows past the end are
// zero-filled in shared memory, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p and ds are 0 and they
// add nothing to dtable. No cp.async pipeline, wgmma or TMA yet.
#include <cuda_runtime.h>

#include "backward_tile.cuh"

namespace mrb {

namespace {

using namespace bwd;

constexpr int MAX_BUCKETS = 32;
// bias_by_rel (and, for dtable, the bucket lut): 2 * maxd + 1 <= 2047 entries.
constexpr size_t REL_BYTES = size_t(2048) * 4;
constexpr size_t VEC_BYTES = 2 * 64 * 4;  // two 64-float vectors
// Four 64 x D tiles, bias_by_rel and the two vectors.
constexpr size_t SMEM_BYTES = 4 * TILE_BYTES + REL_BYTES + VEC_BYTES;
// dq + dtable: also the bucket lut and the per-thread bins.
constexpr size_t BINS_BYTES = size_t(MAX_BUCKETS) * NTHREADS * 4;
constexpr size_t SMEM_BYTES_DTAB = SMEM_BYTES + REL_BYTES + BINS_BYTES;

struct RelposBwdArgs {
  const bf16* q;          // (B, N, H, D)
  const bf16* k;          // (B, N, H, D)
  const bf16* v;          // (B, N, H, D)
  const bf16* dout;       // (B, N, H, D)
  const float* table;     // (H, nb)
  const int* lut;         // (2 * maxd + 1,), values in [0, nb)
  const int8_t* kv_mask;  // (B, N), 0 = masked
  const float* lse;       // (B, H, N)
  const float* delta;     // (B, H, N)
  bf16* dq;               // (B, N, H, D)
  bf16* dk;               // (B, N, H, D)
  bf16* dv;               // (B, N, H, D)
  float* partial;         // (B * query tiles, H, nb) fp32, dq + dtable only
  float* dtable;          // (H, nb) fp32, dq + dtable only
  int b, n, h, nb, maxd;
  float scale;
};

template <bool DTAB>
__global__ void __launch_bounds__(NTHREADS)
relpos_bwd_dq_kernel(RelposBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * TILE_BYTES);
  float* sBiasByRel = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* sKeyOk = reinterpret_cast<float*>(smem + 4 * TILE_BYTES + REL_BYTES);
  int* sLut = reinterpret_cast<int*>(smem + SMEM_BYTES);
  float* sBins = reinterpret_cast<float*>(smem + SMEM_BYTES + REL_BYTES);

  const int bi = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const long hd = long(a.h) * D;
  const long off = long(bi) * a.n * hd + long(head) * D;
  const int8_t* kv_mask = a.kv_mask + long(bi) * a.n;
  const long soff = (long(bi) * a.h + head) * a.n;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8

  load_tile<D>(sQ, a.q + off, hd, q0, a.n, D);
  load_tile<D>(sDO, a.dout + off, hd, q0, a.n, D);
  load_bias_by_rel(sBiasByRel, a.table + long(head) * a.nb, a.lut, a.maxd);
  if (DTAB) {
    for (int c = tid; c <= 2 * a.maxd; c += NTHREADS) sLut[c] = a.lut[c];
    for (int u = 0; u < a.nb; ++u) sBins[u * NTHREADS + tid] = 0.f;
  }
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags(qf, sQ, r0, t);
  load_a_frags(df, sDO, r0, t);
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    lse[hh] = row < a.n ? a.lse[soff + row] : INFINITY;
    delta[hh] = row < a.n ? a.delta[soff + row] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float far_past = 0.f, far_future = 0.f;  // DTAB: sums of the far tiles' ds

  for (int k0 = 0; k0 < a.n; k0 += 64) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, a.k + off, hd, k0, a.n, D);
    load_tile<D>(sV, a.v + off, hd, k0, a.n, D);
    for (int j = tid; j < 64; j += NTHREADS) {
      const int key = k0 + j;
      sKeyOk[j] = (key < a.n && kv_mask[key] != 0) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<8>(s, qf, sK, 0, g, t);
    mma_abt<8>(dp, df, sV, 0, g, t);
    // The whole tile on one side of the clamp: key - query >= maxd, or
    // <= -maxd, for every pair in it.
    const bool tile_future = k0 - (q0 + 63) >= a.maxd;
    const bool tile_past = (k0 + 63) - q0 <= -a.maxd;
    float tile_sum = 0.f;
    // s[j][0..1]: row r0, keys 8j+2t, 8j+2t+1; s[j][2..3]: row r0 + 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        const int rel = rel_index(k0 + col, q0 + row, a.maxd);
        float p = 0.f;
        if (sKeyOk[col] != 0.f) {
          p = expf(s[j][e] * a.scale + sBiasByRel[rel] - lse[e >> 1]);
        }
        const float ds = p * (dp[j][e] - delta[e >> 1]);
        s[j][e] = ds;
        if (DTAB) {
          if (tile_future || tile_past) {
            tile_sum += ds;
          } else {
            sBins[sLut[rel] * NTHREADS + tid] += ds;
          }
        }
      }
    }
    if (DTAB) {
      if (tile_future) far_future += tile_sum;
      if (tile_past) far_past += tile_sum;
    }
    // dq += ds · k, 16 keys at a time.
#pragma unroll
    for (int c = 0; c < 4; ++c) mma_sx(dq, s[2 * c], s[2 * c + 1], sK, c * 16, g, t);
  }
  store_rows(a.dq + off, hd, dq, q0, a.n, r0, t, a.scale);

  if (DTAB) {
    sBins[sLut[0] * NTHREADS + tid] += far_past;
    sBins[sLut[2 * a.maxd] * NTHREADS + tid] += far_future;
    __syncthreads();
    if (tid < a.nb) {
      float sum = 0.f;
      for (int i = 0; i < NTHREADS; ++i) sum += sBins[tid * NTHREADS + i];
      const long block = long(bi) * gridDim.x + blockIdx.x;
      a.partial[(block * a.h + head) * a.nb + tid] = sum;
    }
  }
}

// dtable[head][u] = the partials of every (batch row, query tile) block,
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

__global__ void __launch_bounds__(NTHREADS)
relpos_bwd_dkv_kernel(RelposBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * TILE_BYTES);
  float* sBiasByRel = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_BYTES + REL_BYTES);
  float* sDelta = sLse + 64;

  const int bi = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const long hd = long(a.h) * D;
  const long off = long(bi) * a.n * hd + long(head) * D;
  const long soff = (long(bi) * a.h + head) * a.n;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's keys k0 + r0 and + r0 + 8

  load_tile<D>(sK, a.k + off, hd, k0, a.n, D);
  load_tile<D>(sV, a.v + off, hd, k0, a.n, D);
  load_bias_by_rel(sBiasByRel, a.table + long(head) * a.nb, a.lut, a.maxd);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags(kf, sK, r0, t);
  load_a_frags(vf, sV, r0, t);
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r0 + 8 * hh;
    key_ok[hh] = key < a.n && a.kv_mask[long(bi) * a.n + key] != 0;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.n; q0 += 64) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<D>(sQ, a.q + off, hd, q0, a.n, D);
    load_tile<D>(sDO, a.dout + off, hd, q0, a.n, D);
    for (int i = threadIdx.x; i < 64; i += NTHREADS) {
      const int row = q0 + i;
      sLse[i] = row < a.n ? a.lse[soff + row] : INFINITY;
      sDelta[i] = row < a.n ? a.delta[soff + row] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // Transposed scores: st[j][0..1] are key r0, queries
      // half*32 + 8j + 2t and + 1; st[j][2..3] key r0 + 8.
      float st[4][4], dpt[4][4];
      mma_abt<4>(st, kf, sQ, half * 32, g, t);
      mma_abt<4>(dpt, vf, sDO, half * 32, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = half * 32 + j * 8 + 2 * t + (e & 1);
          const int kr = r0 + 8 * (e >> 1);
          float p = 0.f;
          if (key_ok[e >> 1]) {
            p = expf(st[j][e] * a.scale +
                     sBiasByRel[rel_index(k0 + kr, q0 + qi, a.maxd)] -
                     sLse[qi]);
          }
          dpt[j][e] = p * (dpt[j][e] - sDelta[qi]);
          st[j][e] = p;
        }
      }
      // dv += pᵀ · dO and dk += dsᵀ · q, 16 queries at a time.
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mma_sx(dv, st[2 * c], st[2 * c + 1], sDO, half * 32 + c * 16, g, t);
        mma_sx(dk, dpt[2 * c], dpt[2 * c + 1], sQ, half * 32 + c * 16, g, t);
      }
    }
  }
  store_rows(a.dk + off, hd, dk, k0, a.n, r0, t, a.scale);
  store_rows(a.dv + off, hd, dv, k0, a.n, r0, t, 1.f);
}

cudaError_t launch(void (*kernel)(RelposBwdArgs), size_t smem_bytes,
                   const RelposBwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.n + 63) / 64, a.h, a.b), NTHREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int b, int n, int h, int d, int nb, int maxd) {
  return b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535 || d != D ||
         nb <= 0 || nb > MAX_BUCKETS || maxd <= 0 ||
         maxd > MAX_RELPOS_DISTANCE;
}

RelposBwdArgs make_args(const void* q, const void* k, const void* v,
                        const void* table, const void* lut,
                        const void* kv_mask, const void* dout,
                        const void* lse, const void* delta, int b, int n,
                        int h, int nb, int maxd, float scale) {
  RelposBwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.table = static_cast<const float*>(table);
  a.lut = static_cast<const int*>(lut);
  a.kv_mask = static_cast<const int8_t*>(kv_mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.b = b;
  a.n = n;
  a.h = h;
  a.nb = nb;
  a.maxd = maxd;
  a.scale = scale;
  return a;
}

}  // namespace

}  // namespace mrb

// dq (B, N, H, D) bf16, over (query tile, head, batch row).
extern "C" int mrb_flash_relpos_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, int b, int n, int h, int d, int nb, int maxd,
    float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::RelposBwdArgs a = mrb::make_args(q, k, v, table, lut, kv_mask, dout,
                                        lse, delta, b, n, h, nb, maxd, scale);
  a.dq = static_cast<mrb::bf16*>(dq);
  return int(mrb::launch(mrb::relpos_bwd_dq_kernel<false>, mrb::SMEM_BYTES, a,
                         static_cast<cudaStream_t>(stream)));
}

// dq as above plus dtable (H, nb) fp32. `partial` is a workspace of
// B * ceil(N / 64) * H * nb floats.
extern "C" int mrb_flash_relpos_bwd_dq_dtable_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dq, void* dtable, void* partial, int b, int n,
    int h, int d, int nb, int maxd, float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::RelposBwdArgs a = mrb::make_args(q, k, v, table, lut, kv_mask, dout,
                                        lse, delta, b, n, h, nb, maxd, scale);
  a.dq = static_cast<mrb::bf16*>(dq);
  a.partial = static_cast<float*>(partial);
  a.dtable = static_cast<float*>(dtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = mrb::launch(mrb::relpos_bwd_dq_kernel<true>,
                                mrb::SMEM_BYTES_DTAB, a, s);
  if (err != cudaSuccess) return int(err);
  const long n_blocks = long(b) * ((n + 63) / 64);
  mrb::relpos_dtable_reduce_kernel<<<h, mrb::MAX_BUCKETS, 0, s>>>(
      a.partial, a.dtable, n_blocks, h, nb);
  return int(cudaGetLastError());
}

// dk, dv (B, N, H, D) bf16, over (key tile, head, batch row).
extern "C" int mrb_flash_relpos_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int b, int n, int h, int d, int nb,
    int maxd, float scale, void* stream) {
  if (mrb::bad_shape(b, n, h, d, nb, maxd)) return int(cudaErrorInvalidValue);
  mrb::RelposBwdArgs a = mrb::make_args(q, k, v, table, lut, kv_mask, dout,
                                        lse, delta, b, n, h, nb, maxd, scale);
  a.dk = static_cast<mrb::bf16*>(dk);
  a.dv = static_cast<mrb::bf16*>(dv);
  return int(mrb::launch(mrb::relpos_bwd_dkv_kernel, mrb::SMEM_BYTES, a,
                         static_cast<cudaStream_t>(stream)));
}
