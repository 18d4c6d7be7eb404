// Pieces shared by the backward kernels of the biased flash attention
// (flash_bias_backward.cu) and of the in-kernel rel-pos flash attention
// (flash_relpos_backward.cu): head dim 64, bf16, blocks of 4 warps, each warp
// owning 16 rows of a 64-row tile in registers, mma.sync m16n8k16 products
// with fp32 accumulation, accumulator layouts reused as A operands.
#pragma once

#include "attention_tile.cuh"

namespace mrb {
namespace bwd {

constexpr int D = 64;                  // the only head dim (T5 d_kv)
constexpr int LDS = TileLayout<D>::LD;  // padded bf16 row stride in smem
constexpr size_t TILE_BYTES = size_t(64) * LDS * 2;

// A fragments (16 rows of the warp, 4 steps of 16 columns) of a 64 x D
// shared tile.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const bf16* tile, int r0, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    f[kk][0] = load_u32(tile + r0 * LDS + kk * 16 + 2 * t);
    f[kk][1] = load_u32(tile + r1 * LDS + kk * 16 + 2 * t);
    f[kk][2] = load_u32(tile + r0 * LDS + kk * 16 + 2 * t + 8);
    f[kk][3] = load_u32(tile + r1 * LDS + kk * 16 + 2 * t + 8);
  }
}

// acc[j] += A · X[row j*8 .. j*8+7]ᵀ for NT tiles of 8 rows of a shared
// tile X (rows are the n dimension, the D columns the k dimension).
template <int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* x, int row_base, int g,
                                        int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* xrow = x + (row_base + j * 8 + g) * LDS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_16816(acc[j], a[kk], load_u32(xrow + kk * 16),
                load_u32(xrow + kk * 16 + 8));
    }
  }
}

// out[n] += S · X for the 16 rows of X starting at row `row0` of a shared
// tile: s2 holds two 8-column score tiles (columns = X's rows) in the
// accumulator layout, repacked as the A operand.
__device__ __forceinline__ void mma_sx(float (&out)[D / 8][4],
                                       const float (&s0)[4],
                                       const float (&s1)[4], const bf16* x,
                                       int row0, int g, int t) {
  const uint32_t a[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                         pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
  const bf16* x0 = x + (row0 + 2 * t) * LDS + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const bf16* xp = x0 + n * 8;
    mma_16816(out[n], a, pack_bf16(xp[0], xp[LDS]),
              pack_bf16(xp[8 * LDS], xp[9 * LDS]));
  }
}

// Store a warp's 16 x D fp32 accumulator (times `mul`) as bf16 rows
// row_base + r0 and + r1 of a (rows, H, D) tensor already offset to the head.
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           const float (&acc)[D / 8][4],
                                           int row_base, int n_rows, int r0,
                                           int t, float mul) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row_base + r0 + 8 * hh;
    if (row >= n_rows) continue;
    bf16* out = dst + long(row) * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * hh] * mul,
                                acc[n][2 * hh + 1] * mul);
    }
  }
}

}  // namespace bwd
}  // namespace mrb
