// The mma.sync helpers of the first Hopper tiles (sm_90a), left to
// int8_attn_block.cu (kernel 16, its two-pass attention):
//  * TileLayout: 64-row Q, K and V tiles with the head dim zero-padded to a
//    multiple of 16 (DP) in shared memory only (D = 88 -> 96), rows padded by
//    8 elements so that fragment loads hit 32 distinct banks; load_tile fills
//    one from device memory in the caller's layout and row stride,
//    zero-filling the rows past the end;
//  * mma_16816 (mma.sync m16n8k16, bf16 in, fp32 accumulate) and the
//    fragment helpers (pack_bf16, load_u32, quad_max, quad_sum).
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
  static constexpr size_t bytes = v_off + size_t(BK) * LD * 2;
};

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

// Instantiate `launch<DP>` for the smallest padded head dim that holds d:
// 64 (the T5 heads) or 96 (the ViT heads of 88).
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_head_dim(int d, Args... args) {
  if (d <= 0 || d % 8 != 0 || d > 96) return cudaErrorInvalidValue;
  if (d <= 64) return Launch<64>::run(args...);
  return Launch<96>::run(args...);
}

}  // namespace mrb
