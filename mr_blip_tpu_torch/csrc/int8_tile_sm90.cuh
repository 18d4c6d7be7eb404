// The Hopper (sm_90a) int8 tiles of the W8A8 kernels: the first product of
// either MLP with the hidden activation's requantization in its epilogue
// (fc1 of the GELU MLP, kernel 14, int8_matmul.cu::mrb_w8a8_mlp; gate and
// up of the gated-GELU MLP, kernel 15, mrb_w8a8_mlp_gated), and the GEMM
// tile that runs both MLPs' second product over the hidden chunks, the W8A8
// linear (kernel 13, mrb_w8a8_linear) and both products of the fused
// attention block (kernel 16, int8_attn_block.cu). Built on the primitives
// of attention_tile_sm90.cuh (TMA, mbarriers, `wgmma` descriptors),
// included, not copied.
//
// What bounds them on this card: the int8 operations, 2 M K N a product
// (1.067 TOP in the GELU MLP at 61,680 x 1,408 x 6,144, 0.517 in the gated
// MLP at 8,224 x 2,048 x 5,120, 0.267 in the linear at 61,680 x 1,408 x
// 1,536), at 1,979 TOP/s only through `wgmma`; the tiles that reach each
// SM's shared memory come to K (1/BM + 1/TN) bytes an output element, and
// fc1's epilogue is ~45 instructions an element (tanhf, __fdiv_rn), about
// as long on the card as its products at the peak. The first version
// (int8_tile.cuh) ran `mma.sync` m16n8k32 fed by a 2-stage cp.async ring,
// at 11-18% of the int8 peak. Here:
//
//  * a block is consumer warpgroups of 64 rows each (three in fc1 and in the
//    unsegmented GEMM: a 192-row tile, setmaxnreg 160/24; two in the
//    segmented GEMM (the MLPs' second product), whose fp32 sums take the
//    registers: 128 rows, 232/40) and a producer warpgroup, whose registers
//    go to the consumers;
//    one of its threads keeps a ring of STAGES stages in flight with TMA,
//    128 bytes of K a stage (the activation tile and the weight tile, TN
//    rows; both K-major, so `wgmma.mma_async m64nTNk32.s32.s8.s8` reads both
//    from shared memory). A row of a stage is 128 bytes in the 128-byte
//    swizzle: the byte layout of a bf16 tile of 64 columns, so the tensor
//    maps are the bf16 maps of attention_tile_sm90.cuh over the int8
//    matrices seen as bf16 pairs, and the descriptors step 32 bytes per k32
//    step as the bf16 tile steps per k16 step. TMA zero-fills rows past M,
//    weight rows past N and K past its end, so every shape with K % 16 == 0
//    and N % 8 == 0 runs on the tile;
//  * fc1's blocks that share a row tile and a hidden chunk of block_h = TH
//    x cluster columns form a thread-block cluster (TH = 192 for the GELU
//    MLP; 80 for the gated MLP, whose weight tile is 80 rows of wi_0 then
//    the same 80 rows of wi_1, two TMA boxes in one stage, so that one
//    m64n160k32 `wgmma` covers gate and up: a chunk of 640 is a cluster of
//    8). The epilogue (12 warps), in registers, in the order and roundings
//    of int8_tile.cuh: dequantize (acc * (sa[m] * s1[h])), add b1,
//    tanh-GELU; or, gated, the GELU of the dequantized gate times the
//    dequantized up sum, which the thread holds at the same register
//    position TH / 2 registers on. Then each row's |max| over the block's
//    TH columns; each block writes its partial maxima into every block's
//    shared memory (distributed shared memory, `st.shared::cluster`), and
//    after one cluster barrier every block has the chunk's row maxima (max
//    is exact in any order: the scale equals the plain version's). Each
//    block then quantizes its registers and writes int8 hq through a shared
//    staging tile, 16 bytes a thread-step; the cluster's first block writes
//    the (row, chunk) scale sh. The fp32 hidden never reaches device memory;
//  * both kernels are persistent: a block (fc1: a cluster) walks its items,
//    and its producer loads the next item's first stages while the
//    consumers run the epilogue, so the epilogue overlaps the loads. fc1's
//    cluster barrier of an item is passed by the producer after those
//    loads, and its maxima are double-buffered by item parity;
//  * the GEMM tile's items are (row tile, column tile), column fastest, so
//    the blocks that run together share their activation rows in L2; the
//    column tile is 192 or 176 wide (ops/int8_matmul.py::_linear_plan: 192
//    where it divides N, else 176 where that does, else 192 with a ragged
//    last tile that is zero-filled and not stored). Unsegmented, the
//    epilogue dequantizes acc * (sa[m] * sb[n]), adds the bias and the
//    residual and rounds once to bf16, in the order and roundings of
//    int8_tile.cuh's int8_gemm: the output is bit-equal to the first
//    version's. Segmented (the MLPs' second product), K runs in the hidden
//    chunks: at each chunk's end (after wgmma_wait<0>) the int32 sums fold
//    into an fp32 sum as acc * (sh[m, chunk] * s2[d]), in chunk order,
//    before the same epilogue.
// Measured and left out (PERF.md): multicasting the activation tile across
// fc1's cluster (its cluster-scope barriers and remote arrives cost more
// than it saved), 96-column fc1 tiles at two blocks an SM (more bytes an
// output element), deeper rings (no gain), fc1's GELU run from a
// shared-memory copy of the tile between the next item's `wgmma` issue and
// wait (slower), and fc1 on two consumer warpgroups (slower than three).
// For the unsegmented GEMM: 128-row items (slower than 192), a ring of 3 or
// 2 stages (equal; slower), its item's scales, bias and residual staged in
// shared memory by the producer warpgroup (1-6% faster, not worth the
// barriers), and a ping-pong schedule, each consumer warpgroup on its own
// 128-row item so that one's epilogue runs beside the other's products (no
// faster; slower with a residual). At the 700 W limit the card runs these
// products at its power limit (PERF.md).
#pragma once

#include "attention_tile_sm90.cuh"
#include "int8_tile.cuh"

namespace mrb {
namespace i8sm90 {

using sm90::make_desc;
using sm90::mbar_arrive;
using sm90::mbar_arrive_expect;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::quad_max;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int KT = 128;                 // bytes of K a stage
constexpr int FC1_TN = 192;             // fc1 columns a block
constexpr int GATED_TH = 80;            // hidden columns a block of the gated fc1
constexpr int FC2_TN = 176;             // fc2 columns a block (1,408 = 8 x 176)
constexpr int MAX_CLUSTER = 8;
constexpr int GEMM_STAGES = 4;

// A block: WGS consumer warpgroups of 64 rows each beside a producer
// warpgroup, and the registers a thread keeps after setmaxnreg.
template <int WGS>
struct Block {
  static constexpr int BM = 64 * WGS;  // rows of a block tile
  static constexpr int CONSUMER_THREADS = 128 * WGS;
  static constexpr int THREADS = CONSUMER_THREADS + 128;
  static constexpr int A_BYTES = BM * KT;
  static constexpr int PRODUCER_REGS = WGS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = WGS == 2 ? 232 : 160;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMER_THREADS <= 65536,
                "registers of an SM");
};
// fc1 and the unsegmented GEMM: three consumer warpgroups (192 rows: fewer
// weight bytes an output element, 12 warps for fc1's epilogue); the
// segmented GEMM (the MLPs' second product) two (its fp32 sums need the
// registers).
using Fc1Block = Block<3>;
template <bool SEG>
struct GemmBlockOf {
  using type = Block<3>;
};
template <>
struct GemmBlockOf<true> {
  using type = Block<2>;
};
template <bool SEG>
using GemmBlock = typename GemmBlockOf<SEG>::type;

// Shared memory from a 1024-byte aligned base: the ring (each stage the
// activation tile, then the TN weight rows), the barriers, and for fc1
// (TH > 0: the hidden columns a block writes) the cluster's row maxima (two
// sets, by item parity) and the int8 staging tile.
template <int TN, int STAGES_, int TH, class B>
struct Layout {
  using Blk = B;
  static constexpr int STAGES = STAGES_;
  static constexpr int STAGE = B::A_BYTES + TN * KT;  // a multiple of 1024
  static constexpr int full_off = STAGES * STAGE;
  static constexpr int empty_off = full_off + STAGES * 8;
  static constexpr int red_off = empty_off + STAGES * 8;
  static constexpr int RED_SET = MAX_CLUSTER * B::BM * 4;
  static constexpr int out_off = red_off + (TH > 0 ? 2 * RED_SET : 0);
  // A staged hq row: an odd number of 16-byte units, so that the 8 rows of
  // a warp's store fall in distinct banks.
  static constexpr int OUT_STRIDE = ((TH / 16 + 1) | 1) * 16;
  static constexpr int bytes = out_off + (TH > 0 ? B::BM * OUT_STRIDE : 0);
  static constexpr int alloc = bytes + 1024;  // room to align the base
  static_assert(STAGE % 1024 == 0 && alloc <= 232448, "shared memory of a block");
};

// The two requantizing fc1 tiles: kernel 14's (w1, a bias, tanh-GELU: TN =
// TH = 192 hidden columns a block) and kernel 15's (gate and up: the TH = 80
// rows of wi_0 then the same 80 rows of wi_1 in one weight tile, so that one
// `wgmma` of TN = 160 columns covers both; no bias). In the m64nTN
// accumulator layout a thread holds gate column c and up column c at the
// same register position of column groups c / 8 and TH / 8 + c / 8, so the
// gated epilogue multiplies them in the thread.
template <bool GATED>
struct Fc1Kind {
  static constexpr int TH = GATED ? GATED_TH : FC1_TN;
  static constexpr int TN = GATED ? 2 * GATED_TH : FC1_TN;
  using L = Layout<TN, GATED ? 4 : 3, TH, Fc1Block>;
};
template <int TN, bool SEG>
using GemmLayout = Layout<TN, GEMM_STAGES, 0, GemmBlock<SEG>>;

struct Fc1Args {
  CUtensorMap map_a;  // xq (M, D) as bf16 pairs, boxes of 64 x 192
  CUtensorMap map_b;  // w1, or the gated MLP's wi_0: (H, D) as bf16 pairs, boxes of 64 x TH
  CUtensorMap map_u;  // the gated MLP's wi_1, as map_b
  const float* sa;    // (M)
  const float* s1;    // (H): w1's or wi_0's scales
  const float* su;    // (H): wi_1's scales (gated)
  const float* b1;    // (H): w1's bias (GELU)
  int8_t* hq;         // (M, H) out
  float* sh;          // (M, H / block_h) out
  int m, d, hdim, n_seg;
  int items;          // row tiles x chunks
};

// out (M, N) = A (M, K) · Bᵀ dequantized, + bias + residual: kernel 14's
// fc2 (A = hq, B = w2, sa = sh), kernel 13 and kernel 16's products.
struct GemmTileArgs {
  CUtensorMap map_a;     // A (M, K) as bf16 pairs, boxes of 64 x BM
  CUtensorMap map_b;     // B (N, K) as bf16 pairs, boxes of 64 x TN
  const float* sa;       // (M, n_seg): a row scale per K segment
  const float* sb;       // (N)
  const float* bias;     // (N) or null
  const bf16* residual;  // (M, N) or null
  bf16* out;             // (M, N)
  int m, n, k, n_seg, seg_tiles;
  int col_tiles, items;  // column tiles; row tiles x column tiles
};

// ------------------------------------------------------ cluster primitives
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster; orders the shared-memory
// writes before it (local and remote) before the reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of the same shared-memory location in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f32(uint32_t cluster_addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ wgmma
// d (64 x 160, int32) (+)= A·Bᵀ, both int8 and K-major in shared memory
// (m64n160k32); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n160(int (&d)[80], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 176, int32) (+)= A·Bᵀ, both int8 and K-major in shared memory
// (m64n176k32); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n176(int (&d)[88], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87"
      "}, %88, %89, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 192, int32) (+)= A·Bᵀ, both int8 and K-major in shared memory
// (m64n192k32); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int TN>
__device__ __forceinline__ void wgmma_s8(int (&d)[TN / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(TN == 160 || TN == 176 || TN == 192, "instantiated widths");
  if constexpr (TN == 160) wgmma_s8_n160(d, da, db, accumulate);
  if constexpr (TN == 176) wgmma_s8_n176(d, da, db, accumulate);
  if constexpr (TN == 192) wgmma_s8_n192(d, da, db, accumulate);
}

// ---------------------------------------------------------------- the ring
// Stage g of a block's sequence of K tiles (it runs on across fc1's items)
// lives in slot g % STAGES, in its (g / STAGES)-th round.
template <class L>
__device__ __forceinline__ void init_ring(uint32_t sbase) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(sbase + L::full_off + s * 8, 1);  // the producer; then the TMA bytes
      mbar_init(sbase + L::empty_off + s * 8, L::Blk::CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Load stage g: wait until its slot is free, expect its bytes, load the
// activation tile (rows m0..) and the weight tile (rows n0..) of K tile kt;
// with map_u (the gated fc1), the weight tile is map_b's box of rows n0..
// and then map_u's box of the same rows.
template <class L>
__device__ __forceinline__ void load_stage(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b,
                                           const CUtensorMap* map_u, uint32_t sbase,
                                           int g, int kt, int m0, int n0) {
  const int s = g % L::STAGES;
  const uint32_t full = sbase + L::full_off + s * 8;
  mbar_wait(sbase + L::empty_off + s * 8, ((g / L::STAGES) & 1) ^ 1);
  mbar_arrive_expect(full, L::STAGE);
  const uint32_t stage = sbase + s * L::STAGE;
  const uint32_t weights = stage + L::Blk::A_BYTES;
  tma_load_2d(stage, map_a, full, kt * 64, m0);
  tma_load_2d(weights, map_b, full, kt * 64, n0);
  if (map_u != nullptr) {
    tma_load_2d(weights + (L::STAGE - L::Blk::A_BYTES) / 2, map_u, full, kt * 64, n0);
  }
}

// A consumer warpgroup's products over k_tiles K tiles from stage g0 on:
// acc = the int32 sums of its 64 rows x TN columns. One group of four k32
// steps a stage stays in flight while the next stage's is issued; a stage
// goes back to the producer when its group is done. K runs in segments of
// seg_tiles stages (seg_tiles divides k_tiles); at each segment's end the
// group is drained and `fold(segment)` reads acc (the next segment's first
// step overwrites it). Nothing in the inner loop writes acc but the
// products: a register write there (even fence_regs in a branch) makes
// ptxas drain every group at the loop's back-edge (C7517), and a divergent
// branch near `wgmma` makes it serialize them all (C7518).
template <int TN, class L, class Fold>
__device__ __forceinline__ void consume(int (&acc)[TN / 2], uint32_t sbase, int wg,
                                        int g0, int k_tiles, int seg_tiles, Fold fold) {
  auto release = [&](int g) { mbar_arrive(sbase + L::empty_off + (g % L::STAGES) * 8); };
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  for (int seg = 0; seg * seg_tiles < k_tiles; ++seg) {
    const int k0 = seg * seg_tiles;
    for (int j = 0; j < seg_tiles; ++j) {
      const int g = g0 + k0 + j;
      const int s = g % L::STAGES;
      mbar_wait(sbase + L::full_off + s * 8, (g / L::STAGES) & 1);
      const uint32_t a = sbase + s * L::STAGE + wg * 64 * KT;
      const uint32_t b = sbase + s * L::STAGE + L::Blk::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 32; ++ks) {
        wgmma_s8<TN>(acc, make_desc(a + ks * 32, 0), make_desc(b + ks * 32, 0),
                     j > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0) release(g - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(g0 + k0 + seg_tiles - 1);
    fold(seg);
  }
}

// -------------------------------------------------------------------- fc1
// The hidden values of this thread's two rows from its accumulators, and
// their |max| (max_a: row rl, max_b: row rl + 8): h[4j + 2hh + e] is row rl
// + 8hh, column c0 + 8j + e (c0 = n0 + 2t), in the order and roundings of
// int8_tile.cuh's int8_gemm epilogues.
//  * GELU MLP: gelu(acc * (sa * s1) + b1) (EPI_GELU_F32);
//  * gated: gelu(acc_gate * (sa * s0)) (EPI_GELU_F32 with no bias), times
//    acc_up * (sa * s1) (EPI_MUL_F32), the up sum of column c TH / 2
//    registers after the gate's.
template <bool GATED>
__device__ __forceinline__ void fc1_hidden(const Fc1Args& p,
                                           const int (&acc)[Fc1Kind<GATED>::TN / 2],
                                           float (&h)[Fc1Kind<GATED>::TH / 2], int c0,
                                           float sa_a, float sa_b, float& max_a,
                                           float& max_b) {
  constexpr int TH = Fc1Kind<GATED>::TH;
#pragma unroll
  for (int j = 0; j < TH / 8; ++j) {
    const int col = c0 + 8 * j;
    // GELU: w1's scales and bias; gated: the scales of wi_0 and of wi_1
    // (scalar loads: the vectors need only 4-byte alignment).
    float w0[2], w1[2];
    if constexpr (GATED) {
      w0[0] = p.s1[col];
      w0[1] = p.s1[col + 1];
      w1[0] = p.su[col];
      w1[1] = p.su[col + 1];
    } else {
      const float2 sc = *reinterpret_cast<const float2*>(p.s1 + col);
      const float2 bc = *reinterpret_cast<const float2*>(p.b1 + col);
      w0[0] = sc.x;
      w0[1] = sc.y;
      w1[0] = bc.x;
      w1[1] = bc.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sa = e < 2 ? sa_a : sa_b;
      const float x = __fmul_rn(float(acc[4 * j + e]), __fmul_rn(sa, w0[e & 1]));
      float v;
      if constexpr (GATED) {
        const float u = __fmul_rn(float(acc[TH / 2 + 4 * j + e]), __fmul_rn(sa, w1[e & 1]));
        v = __fmul_rn(gelu_tanh(x), u);
      } else {
        v = gelu_tanh(__fadd_rn(x, w1[e & 1]));
      }
      h[4 * j + e] = v;
      if (e < 2) {
        max_a = fmaxf(max_a, fabsf(v));
      } else {
        max_b = fmaxf(max_b, fabsf(v));
      }
    }
  }
}

// hq (M, H) int8 and sh (M, H / block_h) = the requantized hidden of either
// MLP (fc1_hidden). Item i of a cluster is row tile i / n_chunks and hidden
// chunk i % n_chunks; block `rank` of the cluster owns the chunk's columns
// TH rank... The consumers' part of one item: products, epilogue, the
// cluster's exchange of row maxima, int8 out.
// The q-th item of this block's cluster; what the item needs is derived from
// q, the launch and the special registers, not kept live across the loop:
// 160 registers a consumer thread hold the accumulators and then the hidden
// values (GELU: 96 and 96; gated: 80 and 40), with little to spare.
template <bool GATED>
__device__ __forceinline__ void fc1_item(const Fc1Args& p, unsigned char* base,
                                         uint32_t sbase, int q) {
  using K = Fc1Kind<GATED>;
  using L = typename K::L;
  constexpr int TN = K::TN, TH = K::TH;
  constexpr int BM = L::Blk::BM;
  constexpr int CONSUMER_THREADS = L::Blk::CONSUMER_THREADS;
  uint32_t cluster_dim;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(cluster_dim));
  const int cluster = int(cluster_dim);
  const uint32_t rank = cluster_rank();
  const int item = blockIdx.x / cluster + q * (gridDim.x / cluster);
  const int k_tiles = (p.d + KT - 1) / KT;
  const int g0 = q * k_tiles, parity = q & 1;
  const int m0 = (item / p.n_seg) * BM;
  const int chunk = item % p.n_seg;
  const int n0 = chunk * TH * cluster + int(rank) * TH;
  const int wg = sm90::warpgroup_index();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;  // this thread's rows: rl, rl + 8
  const int row_a = m0 + rl, row_b = row_a + 8;
  int acc[TN / 2];
  consume<TN, L>(acc, sbase, wg, g0, k_tiles, k_tiles, [](int) {});

  // acc[4j + 2h + e] is row rl + 8h, column 8j + 2t + e of the weight tile.
  const float sa_a = row_a < p.m ? p.sa[row_a] : 0.f;
  const float sa_b = row_b < p.m ? p.sa[row_b] : 0.f;
  float h[TH / 2];
  float max_a = 0.f, max_b = 0.f;
  fc1_hidden<GATED>(p, acc, h, n0 + 2 * t, sa_a, sa_b, max_a, max_b);
  max_a = quad_max(max_a);
  max_b = quad_max(max_b);
  const uint32_t red = sbase + L::red_off + parity * L::RED_SET;
  if (t == 0) {
    for (int c = 0; c < cluster; ++c) {
      st_cluster_f32(map_rank(red + (rank * BM + rl) * 4, uint32_t(c)), max_a);
      st_cluster_f32(map_rank(red + (rank * BM + rl + 8) * 4, uint32_t(c)), max_b);
    }
  }
  cluster_sync();
  const float* maxima =
      reinterpret_cast<const float*>(base + L::red_off + parity * L::RED_SET);
  float chunk_a = 0.f, chunk_b = 0.f;
  for (int c = 0; c < cluster; ++c) {
    chunk_a = fmaxf(chunk_a, maxima[c * BM + rl]);
    chunk_b = fmaxf(chunk_b, maxima[c * BM + rl + 8]);
  }
  const float s_a = quant_scale(chunk_a), s_b = quant_scale(chunk_b);
  if (rank == 0 && t == 0) {
    if (row_a < p.m) p.sh[long(row_a) * p.n_seg + chunk] = s_a;
    if (row_b < p.m) p.sh[long(row_b) * p.n_seg + chunk] = s_b;
  }

  // Quantize into the staging tile, then 16 bytes a thread-step out. The
  // last item's copy-out is done before this one's writes: the cluster
  // barrier above comes after it in every consumer thread. The gated tile
  // divides through the scale's reciprocal (quant_value_rcp, the same
  // quotient), the GELU tile as its first version did.
  const float r_a = __frcp_rn(s_a), r_b = __frcp_rn(s_b);
  int8_t* stage = reinterpret_cast<int8_t*>(base + L::out_off);
#pragma unroll
  for (int j = 0; j < TH / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float s = hh == 0 ? s_a : s_b, r = hh == 0 ? r_a : r_b;
      const float v0 = h[4 * j + 2 * hh], v1 = h[4 * j + 2 * hh + 1];
      char2 q;
      q.x = (signed char)(GATED ? quant_value_rcp(v0, s, r) : quant_value(v0, s));
      q.y = (signed char)(GATED ? quant_value_rcp(v1, s, r) : quant_value(v1, s));
      *reinterpret_cast<char2*>(stage + (rl + 8 * hh) * L::OUT_STRIDE + 8 * j + 2 * t) = q;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
  constexpr int CHUNKS = TH / 16;
  for (int idx = threadIdx.x; idx < BM * CHUNKS; idx += CONSUMER_THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    if (m0 + r < p.m) {
      *reinterpret_cast<uint4*>(p.hq + long(m0 + r) * p.hdim + n0 + 16 * c) =
          *reinterpret_cast<const uint4*>(stage + r * L::OUT_STRIDE + 16 * c);
    }
  }
}

// A persistent block: barrier set-up, then the producer warpgroup and the
// consumer warpgroups apart (one if-else, so that setmaxnreg takes effect),
// over the items cluster id, + number of clusters, ... Every thread passes
// one cluster barrier an item: the consumers in the epilogue, the producer
// after loading the next item's first stages (or at the end). Internal
// linkage, as the launchers that name it: two sources include this header.
template <bool GATED>
static __global__ void __launch_bounds__(Fc1Block::THREADS, 1)
fc1_requant_kernel(const __grid_constant__ Fc1Args p) {
  using K = Fc1Kind<GATED>;
  using L = typename K::L;
  using B = Fc1Block;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sbase - raw);
  uint32_t cluster_dim;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(cluster_dim));
  const int cluster = int(cluster_dim);
  const uint32_t rank = cluster_rank();
  const int first = blockIdx.x / cluster, stride = gridDim.x / cluster;
  const int n_chunks = p.n_seg;
  const int k_tiles = (p.d + KT - 1) / KT;
  init_ring<L>(sbase);
  cluster_sync();  // barriers ready before any peer writes this block's maxima
  if (sm90::warpgroup_index() == B::CONSUMER_THREADS / 128) {
    setmaxnreg_dec<B::PRODUCER_REGS>();
    const bool leader = threadIdx.x == B::CONSUMER_THREADS;
    const int ahead = k_tiles < L::STAGES ? k_tiles : L::STAGES;
    int g = 0;
    bool owed = false;  // the last item's cluster barrier is still to pass
    for (int item = first; item < p.items; item += stride) {
      const int m0 = (item / n_chunks) * B::BM;
      const int n0 = (item % n_chunks) * K::TH * cluster + int(rank) * K::TH;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        if (owed && kt == ahead) {
          __syncwarp();
          cluster_sync();
          owed = false;
        }
        if (leader) {
          load_stage<L>(&p.map_a, &p.map_b, GATED ? &p.map_u : nullptr, sbase, g, kt,
                        m0, n0);
        }
      }
      if (owed) {
        __syncwarp();
        cluster_sync();
      }
      owed = true;
    }
    if (owed) {
      __syncwarp();
      cluster_sync();
    }
  } else {
    setmaxnreg_inc<B::CONSUMER_REGS>();
    const int n_items = (p.items - first + stride - 1) / stride;
    for (int q = 0; q < n_items; ++q) fc1_item<GATED>(p, base, sbase, q);
  }
}

// ------------------------------------------------------------- GEMM tile
// The consumers' part of one item: the 64-row slices of out rows m0.. and
// columns n0 .. n0 + TN of this block's warpgroups.
template <int TN, bool SEG, class L>
__device__ __forceinline__ void gemm_item(const GemmTileArgs& p, uint32_t sbase, int m0,
                                          int n0, int g0, int k_tiles) {
  const int wg = sm90::warpgroup_index();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = m0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  int acc[TN / 2];
  float accf[SEG ? TN / 2 : 1];
  if constexpr (SEG) {
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) accf[i] = 0.f;
  }
  consume<TN, L>(acc, sbase, wg, g0, k_tiles, SEG ? p.seg_tiles : k_tiles, [&](int seg) {
    if constexpr (SEG) {
      const float sh_a = row_a < p.m ? p.sa[long(row_a) * p.n_seg + seg] : 0.f;
      const float sh_b = row_b < p.m ? p.sa[long(row_b) * p.n_seg + seg] : 0.f;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 sc = col < p.n ? *reinterpret_cast<const float2*>(p.sb + col)
                                    : make_float2(0.f, 0.f);
        const float sw[2] = {sc.x, sc.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = __fmul_rn(e < 2 ? sh_a : sh_b, sw[e & 1]);
          accf[4 * j + e] = __fadd_rn(accf[4 * j + e], __fmul_rn(float(acc[4 * j + e]), s));
        }
      }
    }
  });

  // acc[4j + 2h + e] is row row_a + 8h, column n0 + 8j + 2t + e. The
  // epilogue runs in groups of JB column blocks: a group's scales, bias and
  // residual are all loaded before its first store (a load after a store to
  // device memory waits for it: the compiler cannot tell them apart).
  constexpr int JB = 6;
  const float sa_a = !SEG && row_a < p.m ? p.sa[row_a] : 0.f;
  const float sa_b = !SEG && row_b < p.m ? p.sa[row_b] : 0.f;
#pragma unroll
  for (int j0 = 0; j0 < TN / 8; j0 += JB) {
    float2 sw[JB], bias[JB];
    __nv_bfloat162 res[JB][2];
#pragma unroll
    for (int jj = 0; jj < JB && j0 + jj < TN / 8; ++jj) {
      const int col = n0 + 8 * (j0 + jj) + 2 * t;
      const bool in = col < p.n;
      // Scalar loads: the vectors need only 4-byte alignment.
      sw[jj] = !SEG && in ? make_float2(p.sb[col], p.sb[col + 1]) : make_float2(0.f, 0.f);
      bias[jj] = p.bias != nullptr && in ? make_float2(p.bias[col], p.bias[col + 1])
                                         : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = hh == 0 ? row_a : row_b;
        res[jj][hh] = __floats2bfloat162_rn(0.f, 0.f);
        if (p.residual != nullptr && in && row < p.m) {
          res[jj][hh] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
              p.residual + long(row) * p.n + col));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB && j0 + jj < TN / 8; ++jj) {
      const int j = j0 + jj;
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.n) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = hh == 0 ? row_a : row_b;
        if (row >= p.m) continue;
        float v0, v1;
        if constexpr (SEG) {
          v0 = accf[4 * j + 2 * hh];
          v1 = accf[4 * j + 2 * hh + 1];
        } else {
          const float sa = hh == 0 ? sa_a : sa_b;
          v0 = __fmul_rn(float(acc[4 * j + 2 * hh]), __fmul_rn(sa, sw[jj].x));
          v1 = __fmul_rn(float(acc[4 * j + 2 * hh + 1]), __fmul_rn(sa, sw[jj].y));
        }
        if (p.bias != nullptr) {
          v0 = __fadd_rn(v0, bias[jj].x);
          v1 = __fadd_rn(v1, bias[jj].y);
        }
        if (p.residual != nullptr) {
          v0 = __fadd_rn(v0, __low2float(res[jj][hh]));
          v1 = __fadd_rn(v1, __high2float(res[jj][hh]));
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + long(row) * p.n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A persistent block over the items blockIdx.x, + gridDim.x, ...: the
// producer's leader runs the ring on across them, the consumers take them in
// the same order.
template <int TN, bool SEG>
__global__ void __launch_bounds__(GemmBlock<SEG>::THREADS, 1)
gemm_tile_kernel(const __grid_constant__ GemmTileArgs p) {
  using L = GemmLayout<TN, SEG>;
  using B = GemmBlock<SEG>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const int k_tiles = (p.k + KT - 1) / KT;
  init_ring<L>(sbase);
  __syncthreads();
  if (sm90::warpgroup_index() == B::CONSUMER_THREADS / 128) {
    setmaxnreg_dec<B::PRODUCER_REGS>();
    if (threadIdx.x == B::CONSUMER_THREADS) {
      int g = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int m0 = (item / p.col_tiles) * B::BM;
        const int n0 = (item % p.col_tiles) * TN;
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          load_stage<L>(&p.map_a, &p.map_b, nullptr, sbase, g, kt, m0, n0);
        }
      }
    }
  } else {
    setmaxnreg_inc<B::CONSUMER_REGS>();
    int g0 = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, g0 += k_tiles) {
      gemm_item<TN, SEG, L>(p, sbase, (item / p.col_tiles) * B::BM,
                            (item % p.col_tiles) * TN, g0, k_tiles);
    }
  }
}

// ------------------------------------------------------------- launchers
// In a launcher: return the first step's error code, if any.
#define I8_TRY(expr)                           \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

// An int8 (rows, k) matrix, k % 16 == 0, as a bf16 tensor map of boxes of
// 64 pairs (128 bytes) x `box_rows` rows.
inline cudaError_t encode_int8(CUtensorMap* map, const void* base, int rows, int k,
                               int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(k / 2), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(k)};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  return sm90::encode_map(map, base, 2, dims, strides, box);
}

// fc1's launch in clusters of `cluster` blocks, after opting in to its
// shared memory.
template <bool GATED>
static inline cudaError_t fc1_config(int cluster, cudaLaunchConfig_t* cfg,
                                     cudaLaunchAttribute* attr) {
  constexpr int alloc = Fc1Kind<GATED>::L::alloc;
  I8_TRY(cudaFuncSetAttribute(fc1_requant_kernel<GATED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, alloc));
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(cluster));
  cfg->blockDim = dim3(Fc1Block::THREADS);
  cfg->dynamicSmemBytes = size_t(alloc);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// *active: the clusters of `cluster` fc1 blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), 0 for a size it cannot co-schedule;
// asked once per kind, size and process (one card a process).
template <bool GATED>
static inline cudaError_t fc1_active_clusters(int cluster, int* active) {
  static int known[MAX_CLUSTER + 1] = {};  // 0: not asked yet
  *active = 0;
  if (cluster < 1 || cluster > MAX_CLUSTER) return cudaSuccess;
  if (known[cluster] == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int n = 0;
    I8_TRY(fc1_config<GATED>(cluster, &cfg, &attr));
    I8_TRY(cudaOccupancyMaxActiveClusters(&n, fc1_requant_kernel<GATED>, &cfg));
    known[cluster] = n > 0 ? n : -1;
  }
  *active = known[cluster] > 0 ? known[cluster] : 0;
  return cudaSuccess;
}

inline cudaError_t sm_count(int* sms) {
  static int known = 0;
  if (known == 0) {
    int dev = 0;
    I8_TRY(cudaGetDevice(&dev));
    I8_TRY(cudaDeviceGetAttribute(&known, cudaDevAttrMultiProcessorCount, dev));
  }
  *sms = known;
  return cudaSuccess;
}

template <int TN, bool SEG>
inline cudaError_t launch_gemm_items(GemmTileArgs& p, cudaStream_t stream) {
  using B = GemmBlock<SEG>;
  constexpr int alloc = GemmLayout<TN, SEG>::alloc;
  const long row_tiles = (long(p.m) + B::BM - 1) / B::BM;
  p.col_tiles = (p.n + TN - 1) / TN;
  if (row_tiles * p.col_tiles > 0x7fffffffL) return cudaErrorInvalidValue;
  p.items = int(row_tiles * p.col_tiles);
  int sms = 0;
  I8_TRY(sm_count(&sms));
  I8_TRY(cudaFuncSetAttribute(gemm_tile_kernel<TN, SEG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, alloc));
  const int grid = p.items < sms ? p.items : sms;
  gemm_tile_kernel<TN, SEG><<<grid, B::THREADS, alloc, stream>>>(p);
  return cudaGetLastError();
}

// out (M, N) bf16 = a (M, K) int8 · b (N, K)ᵀ int8 * (sa * sb), + bias +
// residual, on the GEMM tile with column tiles of tn (192 or 176). With
// seg_k < K, K runs in segments of seg_k (a multiple of 128), each with its
// own row scale: sa is (M, K / seg_k) (kernel 14's fc2, tn 176).
inline cudaError_t launch_gemm_tile(const int8_t* a, const float* sa, const int8_t* b,
                                    const float* sb, const float* bias,
                                    const bf16* residual, bf16* out, int m, int n, int k,
                                    int seg_k, int tn, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 != 0 || n % 8 != 0 || seg_k <= 0 ||
      k % seg_k != 0) {
    return cudaErrorInvalidValue;
  }
  const bool seg = seg_k != k;
  if (seg && (seg_k % KT != 0 || tn != FC2_TN)) return cudaErrorInvalidValue;
  GemmTileArgs p{};
  I8_TRY(encode_int8(&p.map_a, a, m, k, seg ? GemmBlock<true>::BM : GemmBlock<false>::BM));
  I8_TRY(encode_int8(&p.map_b, b, n, k, tn));
  p.sa = sa;
  p.sb = sb;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.n_seg = k / seg_k;
  p.seg_tiles = seg_k / KT;
  if (seg) return launch_gemm_items<FC2_TN, true>(p, stream);
  if (tn == 192) return launch_gemm_items<192, false>(p, stream);
  if (tn == 176) return launch_gemm_items<176, false>(p, stream);
  return cudaErrorInvalidValue;
}

// fc1 then fc2 of either MLP on xq/sa (from norm_quant_rows), through
// hq/sh. fc1 covers a chunk of block_h = TH x cluster columns with one
// cluster (TH: 192 for the GELU MLP, w1 with s1 and b1; 80 for the gated
// MLP, wi_0 with s1 and wi_1 with su, no bias); fc2 (w2, s2, b2) is the
// GEMM tile over the chunks, column tiles of FC2_TN (a partial last tile
// masked).
template <bool GATED>
static inline cudaError_t launch_mlp_products(
    const int8_t* xq, const float* sa, const int8_t* w1, const float* s1,
    const float* b1, const int8_t* wu, const float* su, const int8_t* w2,
    const float* s2, const float* b2, const bf16* residual, bf16* out, int8_t* hq,
    float* sh, int m, int d, int hdim, int block_h, int cluster, cudaStream_t stream) {
  using K = Fc1Kind<GATED>;
  if (m <= 0 || d <= 0 || d % 16 != 0 || block_h <= 0 || hdim % block_h != 0 ||
      block_h != K::TH * cluster || cluster < 1 || cluster > MAX_CLUSTER) {
    return cudaErrorInvalidValue;
  }
  const int n_seg = hdim / block_h;
  const long fc1_items = (long(m) + Fc1Block::BM - 1) / Fc1Block::BM * n_seg;
  if (fc1_items > 0x7fffffffL || (n_seg > 1 && block_h % KT != 0)) {
    return cudaErrorInvalidValue;
  }

  Fc1Args a1{};
  I8_TRY(encode_int8(&a1.map_a, xq, m, d, Fc1Block::BM));
  I8_TRY(encode_int8(&a1.map_b, w1, hdim, d, K::TH));
  if (GATED) I8_TRY(encode_int8(&a1.map_u, wu, hdim, d, K::TH));
  a1.sa = sa;
  a1.s1 = s1;
  a1.su = su;
  a1.b1 = b1;
  a1.hq = hq;
  a1.sh = sh;
  a1.m = m;
  a1.d = d;
  a1.hdim = hdim;
  a1.n_seg = n_seg;
  a1.items = int(fc1_items);
  int active = 0;
  I8_TRY(fc1_active_clusters<GATED>(cluster, &active));
  if (active == 0) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  I8_TRY(fc1_config<GATED>(cluster, &cfg, &attr));
  const int clusters = active < a1.items ? active : a1.items;
  cfg.gridDim = dim3(unsigned(clusters * cluster));
  cfg.stream = stream;
  I8_TRY(cudaLaunchKernelEx(&cfg, fc1_requant_kernel<GATED>, a1));
  I8_TRY(cudaGetLastError());

  return launch_gemm_tile(hq, sh, w2, s2, b2, residual, out, m, d, hdim,
                          n_seg > 1 ? block_h : hdim, FC2_TN, stream);
}

#undef I8_TRY

}  // namespace i8sm90
}  // namespace mrb
