// Backward of the biased flash attention (T5 encoder self-attention with the
// (1, H, N, M) rel-pos bias and a (B, M) key mask), head dim 64, bf16.
//
// Replaces, in mr_blip_tpu/ops/flash_attention.py:
//  * _flash_bias_bwd_dq_kernel (pallas_call :752) -> flash_bias_bwd_dq_kernel;
//  * _flash_bias_bwd_dq_dbias_kernel (:735)       -> flash_bias_bwd_dq_dbias_kernel;
//  * _flash_bias_bwd_dkv_kernel (:762)            -> flash_bias_bwd_dkv_kernel.
//
// Each recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's saved row logsumexp, then with
// δ = rowsum(dO∘O) (computed outside, in fp32):
//   dp = dO·vᵀ,  ds = p∘(dp - δ),  dq = ds·k·scale,  dk = dsᵀ·q·scale,
//   dv = pᵀ·dO,  dbias = Σ_b ds.
//
// Bound on this card: per (batch row, head) the dq pass does 3 and the
// dk/dv pass 4 products of 2·N·M·D flops (~2.5 and ~3.5 GFLOP in all per
// layer at B=4, N=M=2056, H=32); the largest stream is the bias, N·M bf16
// per head (~8.5 MB), read once per batch row by each pass, and the fp32
// dbias (~17 MB per head) read and written once per batch row by the
// dq+dbias pass. So the math bounds the dq and dk/dv passes, and the dbias
// traffic bounds the dq+dbias pass.
//
// Design (first version, right and simple): blocks of 4 warps, each warp
// owning 16 rows of a 64-row tile in registers; mma.sync m16n8k16 bf16
// products with fp32 accumulation, accumulator layouts reused as A operands
// (ds and p never leave registers), the tile helpers of attention_tile.cuh
// and backward_tile.cuh.
//  * dq: grid (query tile, head, batch row); key tiles of 64 stream through
//    shared memory with their bias tile.
//  * dq + dbias: grid (query tile, head); the block walks the batch rows in
//    order, the first row storing its fp32 ds tile into dbias and each later
//    row adding to it. Each dbias element is owned by one thread of one
//    block, so there are no atomics and the sum is deterministic (the TPU
//    kernel accumulates the same way in VMEM, batch innermost).
//  * dk/dv: grid (key tile, head, batch row); query tiles of 64 (two halves
//    of 32, to keep the transposed score tiles in fewer registers) stream
//    with their bias tile, lse and δ.
// Ragged lengths are exact with no padded copy: tile rows past the end are
// zero-filled in shared memory, keys past the end or masked get p = 0, and
// query rows past the end get lse = +inf, so their p is 0 too (the TPU
// wrapper pads with lse = +1e30 for the same effect). No cp.async pipeline,
// wgmma or TMA yet.
#include <cuda_runtime.h>

#include "backward_tile.cuh"

namespace mrb {

namespace {

using namespace bwd;

constexpr size_t BIAS_BYTES = size_t(64) * 64 * 2;
// Four 64 x D tiles, the 64 x 64 bias tile and two 64-float vectors.
constexpr size_t SMEM_BYTES = 4 * TILE_BYTES + BIAS_BYTES + 2 * 64 * 4;

struct BwdArgs {
  const bf16* q;        // (B, N, H, D)
  const bf16* k;        // (B, M, H, D)
  const bf16* v;        // (B, M, H, D)
  const bf16* dout;     // (B, N, H, D)
  const bf16* bias;     // (1, H, N, M)
  const int8_t* kv_mask;  // (B, M), 0 = masked
  const float* lse;     // (B, H, N)
  const float* delta;   // (B, H, N)
  bf16* dq;             // (B, N, H, D)
  bf16* dk;             // (B, M, H, D)
  bf16* dv;             // (B, M, H, D)
  float* dbias;         // (1, H, N, M) fp32, dq + dbias pass only
  int b, n, m, h;
  float scale;
};

// Rows [row0, row0 + 64) x cols [col0, col0 + 64) of a row-major bf16
// matrix into a dense 64 x 64 shared tile; entries past n_rows or n_cols
// are zero.
__device__ __forceinline__ void load_bias_tile(bf16* dst, const bf16* src,
                                               long row_stride, int row0,
                                               int col0, int n_rows,
                                               int n_cols) {
  for (int idx = threadIdx.x; idx < 64 * 64; idx += NTHREADS) {
    const int r = row0 + idx / 64;
    const int c = col0 + idx % 64;
    dst[idx] = (r < n_rows && c < n_cols) ? src[long(r) * row_stride + c]
                                          : __float2bfloat16(0.f);
  }
}

// dq for query tile q0 of (batch row bi, head); with DBIAS, ds also goes
// into dbias: stored when `first`, added otherwise.
template <bool DBIAS>
__device__ void dq_tile(const BwdArgs& a, int bi, int head, int q0,
                        bool first, unsigned char* smem) {
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * TILE_BYTES);
  bf16* sBias = reinterpret_cast<bf16*>(smem + 4 * TILE_BYTES);
  float* sKeyOk = reinterpret_cast<float*>(smem + 4 * TILE_BYTES + BIAS_BYTES);

  const long hd = long(a.h) * D;
  const long qoff = long(bi) * a.n * hd + long(head) * D;
  const long koff = long(bi) * a.m * hd + long(head) * D;
  const bf16* bias = a.bias + long(head) * a.n * a.m;
  const int8_t* kv_mask = a.kv_mask + long(bi) * a.m;
  const long soff = (long(bi) * a.h + head) * a.n;
  float* dbias = DBIAS ? a.dbias + long(head) * a.n * a.m : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8

  __syncthreads();  // the previous batch row's readers are done with smem
  load_tile<D>(sQ, a.q + qoff, hd, q0, a.n, D);
  load_tile<D>(sDO, a.dout + qoff, hd, q0, a.n, D);
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

  for (int k0 = 0; k0 < a.m; k0 += 64) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, a.k + koff, hd, k0, a.m, D);
    load_tile<D>(sV, a.v + koff, hd, k0, a.m, D);
    load_bias_tile(sBias, bias, a.m, q0, k0, a.n, a.m);
    for (int j = threadIdx.x; j < 64; j += NTHREADS) {
      const int key = k0 + j;
      sKeyOk[j] = (key < a.m && kv_mask[key] != 0) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<8>(s, qf, sK, 0, g, t);
    mma_abt<8>(dp, df, sV, 0, g, t);
    // s[j][0..1]: row r0, keys 8j+2t, 8j+2t+1; s[j][2..3]: row r0 + 8.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        float p = 0.f;
        if (sKeyOk[col] != 0.f) {
          p = expf(s[j][e] * a.scale + __bfloat162float(sBias[row * 64 + col]) -
                   lse[e >> 1]);
        }
        const float ds = p * (dp[j][e] - delta[e >> 1]);
        s[j][e] = ds;
        if (DBIAS) {
          const int qr = q0 + row;
          const int key = k0 + col;
          if (qr < a.n && key < a.m) {
            float* slot = dbias + long(qr) * a.m + key;
            *slot = first ? ds : *slot + ds;
          }
        }
      }
    }
    // dq += ds · k, 16 keys at a time.
#pragma unroll
    for (int c = 0; c < 4; ++c) mma_sx(dq, s[2 * c], s[2 * c + 1], sK, c * 16, g, t);
  }
  store_rows(a.dq + qoff, hd, dq, q0, a.n, r0, t, a.scale);
}

__global__ void __launch_bounds__(NTHREADS)
flash_bias_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_tile<false>(a, blockIdx.z, blockIdx.y, blockIdx.x * 64, true, smem);
}

__global__ void __launch_bounds__(NTHREADS)
flash_bias_bwd_dq_dbias_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int bi = 0; bi < a.b; ++bi) {
    dq_tile<true>(a, bi, blockIdx.y, blockIdx.x * 64, bi == 0, smem);
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_bias_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * TILE_BYTES);
  bf16* sBias = reinterpret_cast<bf16*>(smem + 4 * TILE_BYTES);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_BYTES + BIAS_BYTES);
  float* sDelta = sLse + 64;

  const int bi = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const long hd = long(a.h) * D;
  const long qoff = long(bi) * a.n * hd + long(head) * D;
  const long koff = long(bi) * a.m * hd + long(head) * D;
  const bf16* bias = a.bias + long(head) * a.n * a.m;
  const long soff = (long(bi) * a.h + head) * a.n;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's keys k0 + r0 and + r0 + 8

  load_tile<D>(sK, a.k + koff, hd, k0, a.m, D);
  load_tile<D>(sV, a.v + koff, hd, k0, a.m, D);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags(kf, sK, r0, t);
  load_a_frags(vf, sV, r0, t);
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r0 + 8 * hh;
    key_ok[hh] = key < a.m && a.kv_mask[long(bi) * a.m + key] != 0;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.n; q0 += 64) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<D>(sQ, a.q + qoff, hd, q0, a.n, D);
    load_tile<D>(sDO, a.dout + qoff, hd, q0, a.n, D);
    load_bias_tile(sBias, bias, a.m, q0, k0, a.n, a.m);
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
                     __bfloat162float(sBias[qi * 64 + kr]) - sLse[qi]);
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
  store_rows(a.dk + koff, hd, dk, k0, a.m, r0, t, a.scale);
  store_rows(a.dv + koff, hd, dv, k0, a.m, r0, t, 1.f);
}

cudaError_t launch(void (*kernel)(BwdArgs), dim3 grid, const BwdArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int b, int n, int m, int h, int d) {
  return b <= 0 || n <= 0 || m <= 0 || h <= 0 || b > 65535 || h > 65535 ||
         d != D;
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* bias, const void* kv_mask, const void* dout,
                  const void* lse, const void* delta, int b, int n, int m,
                  int h, float scale) {
  BwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.bias = static_cast<const bf16*>(bias);
  a.kv_mask = static_cast<const int8_t*>(kv_mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.b = b;
  a.n = n;
  a.m = m;
  a.h = h;
  a.scale = scale;
  return a;
}

}  // namespace

}  // namespace mrb

// dq (B, N, H, D) bf16. Launches _bwd_dq over (query tile, head, batch row).
extern "C" int mrb_flash_bias_bwd_dq_bf16(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* kv_mask,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int b,
                                          int n, int m, int h, int d,
                                          float scale, void* stream) {
  if (mrb::bad_shape(b, n, m, h, d)) return int(cudaErrorInvalidValue);
  mrb::BwdArgs a = mrb::make_args(q, k, v, bias, kv_mask, dout, lse, delta,
                                  b, n, m, h, scale);
  a.dq = static_cast<mrb::bf16*>(dq);
  return int(mrb::launch(mrb::flash_bias_bwd_dq_kernel,
                         dim3((n + 63) / 64, h, b), a,
                         static_cast<cudaStream_t>(stream)));
}

// dq as above plus dbias (1, H, N, M) fp32 = Σ_b ds, over (query tile, head).
extern "C" int mrb_flash_bias_bwd_dq_dbias_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    const void* kv_mask, const void* dout, const void* lse, const void* delta,
    void* dq, void* dbias, int b, int n, int m, int h, int d, float scale,
    void* stream) {
  if (mrb::bad_shape(b, n, m, h, d)) return int(cudaErrorInvalidValue);
  mrb::BwdArgs a = mrb::make_args(q, k, v, bias, kv_mask, dout, lse, delta,
                                  b, n, m, h, scale);
  a.dq = static_cast<mrb::bf16*>(dq);
  a.dbias = static_cast<float*>(dbias);
  return int(mrb::launch(mrb::flash_bias_bwd_dq_dbias_kernel,
                         dim3((n + 63) / 64, h, 1), a,
                         static_cast<cudaStream_t>(stream)));
}

// dk, dv (B, M, H, D) bf16, over (key tile, head, batch row).
extern "C" int mrb_flash_bias_bwd_dkv_bf16(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           const void* kv_mask,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int b, int n, int m,
                                           int h, int d, float scale,
                                           void* stream) {
  if (mrb::bad_shape(b, n, m, h, d)) return int(cudaErrorInvalidValue);
  mrb::BwdArgs a = mrb::make_args(q, k, v, bias, kv_mask, dout, lse, delta,
                                  b, n, m, h, scale);
  a.dk = static_cast<mrb::bf16*>(dk);
  a.dv = static_cast<mrb::bf16*>(dv);
  return int(mrb::launch(mrb::flash_bias_bwd_dkv_kernel,
                         dim3((m + 63) / 64, h, b), a,
                         static_cast<cudaStream_t>(stream)));
}
