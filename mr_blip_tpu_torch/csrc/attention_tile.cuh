// One 64-query tile of softmax attention for one (image or batch row, head),
// shared by qkv_packed_attention.cu (kernel 2) and flash_relpos_attention.cu
// (kernel 9); the helpers also serve int8_attn_block.cu. Kernels 3, 4 and 5
// run on the Hopper tile of attention_tile_sm90.cuh.
//
// Design (first version for Hopper, sm_90a):
//  * a block of 4 warps owns 64 query rows; each warp owns 16 of them and
//    keeps everything about them in registers: its q fragments, the scores
//    of the current key tile, the online-softmax state (running max m and
//    denominator l, two rows per thread) and the fp32 output accumulator;
//  * keys stream through shared memory in tiles of 64 with the online-
//    softmax recurrence; q·kᵀ and p·v run on the tensor cores as
//    mma.sync m16n8k16 bf16 products with fp32 accumulation, and the
//    scores' accumulator layout is reused as the p operand of p·v, so
//    probabilities never leave registers;
//  * the head dim is zero-padded to a multiple of 16 (DP) in SHARED memory
//    only (D=88 -> 96): device memory is read in the caller's layout, with
//    the caller's row strides, so no split, transpose or pad copy exists;
//  * ragged edges (the last query tile, the last key tile) are handled by
//    zero-filling the tile rows past the end and giving their keys -inf,
//    so any N and M are exact;
//  * fully masked rows keep m = -inf and l = 0 and come out as zeros, as the
//    Pallas kernels' isfinite guards make them;
//  * with ``lse`` set, the tile also stores each row's logsumexp m + log(l)
//    in fp32 (the statistics the backward kernels recompute p from); a
//    fully masked row stores log(1e-30), as _flash_bias_stats_kernel does;
//  * with RELPOS the additive bias is not read from device memory: the block
//    keeps bias_by_rel[c] = table[lut[c]] for the 2*maxd + 1 clamped
//    relative positions in shared memory (in place of the bias tile) and
//    adds bias_by_rel[clamp(key - query, -maxd, maxd) + maxd].
// K/V loads are not yet overlapped with the math (no cp.async pipeline);
// wgmma, TMA and warp specialisation are left for later versions.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mrb {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

// Shared-memory carve-up for a padded head dim DP (a multiple of 16). Rows
// are padded by 8 elements so the fragment loads hit 32 distinct banks.
template <int DP>
struct TileLayout {
  static constexpr int LD = DP + 8;   // bf16 q/k/v row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LD * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LD * 2;
  static constexpr size_t bias_off = v_off + size_t(BK) * LD * 2;
  static constexpr size_t keyok_off = bias_off + size_t(BQ) * BK * 2;
  static constexpr size_t bytes = keyok_off + size_t(BK) * 4;
};

// One (row block, head) problem, every pointer already offset to it.
struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long q_row, k_row, v_row, o_row;  // row strides in elements
  const int8_t* kv_mask;            // (n_k,) 0 = masked, or null
  int n_q, n_k;
  int n_valid_k;                    // keys >= n_valid_k are masked
  int d;
  float scale;
  float* lse = nullptr;             // (n_q,) row logsumexp out, or null
  // RELPOS only: this head's (num_buckets,) bias table, the bucket of every
  // clamped relative position (2 * relpos_maxd + 1 entries), and the clamp.
  const float* relpos_table = nullptr;
  const int* relpos_lut = nullptr;
  int relpos_maxd = 0;
};

// Largest clamp the shared bias_by_rel array holds (it takes the bias tile's
// room: 64 * 64 bf16 = 2048 floats).
constexpr int MAX_RELPOS_DISTANCE = 1023;

// bias_by_rel[c] = table[lut[c]] for c in [0, 2 * maxd], by the whole block.
__device__ __forceinline__ void load_bias_by_rel(float* dst, const float* table,
                                                 const int* lut, int maxd) {
  for (int c = threadIdx.x; c <= 2 * maxd; c += blockDim.x) {
    dst[c] = table[lut[c]];
  }
}

// Index of key - query into bias_by_rel (or the bucket lut).
__device__ __forceinline__ int rel_index(int key, int query, int maxd) {
  return min(max(key - query, -maxd), maxd) + maxd;
}

// Copy rows [row0, row0 + 64) x [0, d) of a bf16 matrix into a (64, DP)
// shared tile, 16 bytes per thread per step; rows past n_rows and columns
// past d are zero. Needs d % 8 == 0, row_stride % 8 == 0, 16-byte base.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long row_stride, int row0,
                                          int n_rows, int d) {
  constexpr int LD = TileLayout<DP>::LD;
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + long(row) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// d += a·b for one 16x8x16 tile: a is 16x16 row-major, b 16x8 col-major,
// bf16 in and fp32 accumulate (PTX ISA, mma.sync.m16n8k16 fragment layouts).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 as one 32-bit fragment register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Max and sum over the 4 threads of a quad (the threads sharing a row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP, bool RELPOS = false>
__device__ void attention_tile(const AttnArgs& a, int q0, unsigned char* smem) {
  using L = TileLayout<DP>;
  constexpr int LD = L::LD;
  constexpr int NT = BK / 8;    // 8-key score tiles per key tile
  constexpr int ND = DP / 8;    // 8-column output tiles
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sKeyOk = reinterpret_cast<float*>(smem + L::keyok_off);
  float* sBiasByRel = reinterpret_cast<float*>(smem + L::bias_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  // This thread's two rows of the warp's 16 (local to the block tile).
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;

  load_tile<DP>(sQ, a.q, a.q_row, q0, a.n_q, a.d);
  if constexpr (RELPOS) {
    load_bias_by_rel(sBiasByRel, a.relpos_table, a.relpos_lut, a.relpos_maxd);
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    qf[kk][0] = load_u32(sQ + r0 * LD + kk * 16 + 2 * t);
    qf[kk][1] = load_u32(sQ + r1 * LD + kk * 16 + 2 * t);
    qf[kk][2] = load_u32(sQ + r0 * LD + kk * 16 + 2 * t + 8);
    qf[kk][3] = load_u32(sQ + r1 * LD + kk * 16 + 2 * t + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.n_k; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(sK, a.k, a.k_row, k0, a.n_k, a.d);
    load_tile<DP>(sV, a.v, a.v_row, k0, a.n_k, a.d);
    for (int j = threadIdx.x; j < BK; j += NTHREADS) {
      const int key = k0 + j;
      const bool ok = key < a.n_valid_k &&
                      (a.kv_mask == nullptr || a.kv_mask[key] != 0);
      sKeyOk[j] = ok ? 1.f : 0.f;
    }
    __syncthreads();

    // s = q·kᵀ: s[j][0..1] are row r0, keys 8j+2t and 8j+2t+1; [2..3] row r1.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = sK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        mma_16816(s[j], qf[kk], load_u32(krow + kk * 16),
                  load_u32(krow + kk * 16 + 8));
      }
    }

    // Scale, bias, mask; online softmax per row, fp32 throughout.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float v = s[j][e] * a.scale;
        if constexpr (RELPOS) {
          v += sBiasByRel[rel_index(k0 + col, q0 + row, a.relpos_maxd)];
        }
        if (sKeyOk[col] == 0.f) v = -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2], m_safe[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      m_safe[h] = isfinite(m_new) ? m_new : 0.f;
      corr[h] = isfinite(m_run[h]) ? expf(m_run[h] - m_safe[h]) : 0.f;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[j][e];
        const float p = isfinite(v) ? expf(v - m_safe[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + quad_sum(psum[h]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p·v: the score tiles 2c and 2c+1 form the A fragment of keys
    // 16c..16c+15; v is read column-wise (two keys per register).
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const bf16* v0 = sV + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vp = v0 + n * 8;
        mma_16816(o[n], pa, pack_bf16(vp[0], vp[LD]),
                  pack_bf16(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

  // o[n][0..1] are row r0, columns 8n+2t and 8n+2t+1; [2..3] row r1.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + (h == 0 ? r0 : r1);
    if (qr >= a.n_q) continue;
    const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
    bf16* orow = a.o + long(qr) * a.o_row;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      }
    }
    // l_run is the same in the 4 threads of the quad: one stores it.
    if (a.lse != nullptr && t == 0) {
      const float m_safe = isfinite(m_run[h]) ? m_run[h] : 0.f;
      a.lse[qr] = m_safe + logf(fmaxf(l_run[h], 1e-30f));
    }
  }
}

// Instantiate `launch<DP>` for the smallest padded head dim that holds d:
// 64 (the T5 heads) or 96 (the ViT heads of 88).
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_head_dim(int d, Args... args) {
  if (d <= 0 || d % 8 != 0 || d > 96) return cudaErrorInvalidValue;
  if (d <= 64) return Launch<64>::run(args...);
  return Launch<96>::run(args...);
}

}  // namespace mrb
