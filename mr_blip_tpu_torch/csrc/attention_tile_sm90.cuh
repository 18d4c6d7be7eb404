// One 128-query block of softmax attention for one (batch row, head) on
// Hopper (sm_90a), shared by flash_bias_attention.cu (kernels 3 and 5), the
// bf16 path of flash_attention.cu (kernel 4), flash_relpos_attention.cu
// (kernel 9) and the streaming path of qkv_packed_attention.cu (kernel 2),
// whose resident path (its work item and producer below) takes the
// primitives, as kernel 16's attention (int8_attn_block.cu) does.
//
// What bounds a flash forward on this card is the tensor cores when they are
// fed: at D = 64 one 64 x 64 key tile is 2 x 64 x 64 x 64 multiply-adds per
// 64 queries, and the card does 989 TFLOP/s only through `wgmma`. The first
// tile (attention_tile.cuh) lost 4x to the library for three reasons: its
// K/V/bias loads stood between two __syncthreads() with the tensor cores
// idle, the bias came in one 2-byte element per thread-step, and its
// products were `mma.sync` m16n8k16 on 64 queries per block. Here:
//
//  * warp specialisation: a block is three warpgroups. Warpgroups 0 and 1
//    consume, 64 query rows each; warpgroup 2 produces. The producer brings
//    key tile j+1 (K, V and, for the biased kernels, the 128 x 64 bias tile)
//    into a ring of STAGES shared-memory stages with TMA
//    (`cp.async.bulk.tensor`) while the consumers compute on tile j, and
//    stores the 64 key-mask flags itself. Completion goes to one `mbarrier`
//    per stage ("full": the TMA bytes through complete_tx, the producer's
//    own stores through a plain arrive); the consumers hand a stage back
//    through its "empty" barrier once the product that reads it is done.
//    The block is persistent: it walks work items (batch row, head, 128
//    query rows) and the producer loads the next item's Q into a second slot
//    while the current one runs;
//  * both products are `wgmma.mma_async` with fp32 accumulation. S = Q·Kᵀ
//    reads Q and K from shared memory, K-major as they stand in device
//    memory (m64n64k16). O += P·V takes P from registers, the accumulator
//    layout of S reused as the A fragment, so probabilities never leave
//    registers, and V from shared memory through the transpose bit
//    (m64nDk16, D = 64 or 96);
//  * Q, K and V tiles are stored in the 128-byte swizzle `wgmma` reads
//    without bank conflicts (TMA's SWIZZLE_128B): a row is 128 bytes (64
//    bf16) of a "panel", the 16-byte chunk c of row r sits at chunk
//    c ^ (r % 8), and a head dim of 96 (the ViT's 88 padded) is two panels,
//    one TMA box each. The tensor maps carry the caller's strides (the ViT's
//    q/k/v are views of the packed projection) and the true extents, so the
//    pad columns 88-127 and the rows past the end are zero-filled by TMA:
//    nothing is padded in device memory;
//  * the fp32 online softmax stays in registers: m, l and the accumulator
//    per row, exp2 with log2(e) folded into the scale, and the guards that
//    keep a fully masked row at zeros (m_safe = 0 when m = -inf, so every
//    exp2 of -inf is 0); with `lse` set the row's logsumexp is stored, and
//    log(1e-30) for a fully masked row, as the Pallas kernels store it;
//  * the bias tile comes as one TMA box when its rows are 16-byte aligned
//    (M % 8 == 0: every length the port's encoders produce), and element by
//    element from the producer warpgroup's own loads otherwise (a ragged M
//    such as 2,049, where a tensor map cannot be made); the consumers read
//    the same swizzled layout either way;
//  * the rel-pos mode (kernel 9) reads no bias bytes at all: per work item
//    the producer warpgroup builds the head's 2*maxd + 1 values
//    rel[c] = table[lut[c]] (c = clamp(key - query, -maxd, maxd) + maxd)
//    beside the item's Q slot, and a consumer's 64 x 64 tile whose every
//    key - query lies past the wrapper's far thresholds (all in the bucket of
//    -maxd, or all in that of +maxd) adds one scalar; only the tiles near the
//    diagonal look a value up per score (the TPU kernel's far/near split).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mrb {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;               // consumer warpgroups per block
constexpr int BM = 64;                     // query rows per consumer
constexpr int BQ = BM * CONSUMERS;         // query rows per block
constexpr int BK = 64;                     // keys per tile
constexpr int NTHREADS = WG_THREADS * (CONSUMERS + 1);
constexpr int PANEL_BYTES = BK * 128;      // 64 rows of one 128-byte panel
constexpr float LOG2E = 1.4426950408889634f;
// Largest rel-pos clamp the rel table beside a Q slot holds.
constexpr int MAX_REL_DISTANCE = 1023;

// What a tile adds to its scores (the BIAS template argument): nothing
// (kernels 2 and 4), a bias tile from device memory with the key mask
// (kernels 3 and 5), or the rel-pos bias looked up with the key mask
// (kernel 9).
enum BiasKind : int { kNoBias = 0, kBiasTile = 1, kRelpos = 2 };

// Shared-memory carve-up for a padded head dim DP (64 or 96), from a
// 1024-byte aligned base (the swizzle repeats every 8 rows of 128 bytes).
template <int DP, int BIAS>
struct Layout {
  static_assert(DP == 64 || DP == 96, "head dims 64 and 96 only");
  static constexpr int PANELS = (DP + 63) / 64;
  static constexpr int TILE = PANELS * PANEL_BYTES;
  static constexpr int BIAS_BYTES = BIAS == kBiasTile ? BQ * 128 : 0;  // 128 rows x 64
  static constexpr int KEYOK_BYTES = BIAS != kNoBias ? BK : 0;
  static constexpr int k_off = 0;                // within a stage
  static constexpr int v_off = TILE;
  static constexpr int bias_off = 2 * TILE;
  static constexpr int keyok_off = bias_off + BIAS_BYTES;
  static constexpr int STAGE = (keyok_off + KEYOK_BYTES + 1023) / 1024 * 1024;
  // Two slots of the block's 128 query rows (one 64-row tile a consumer):
  // the next work item's rows load while the current one runs; in the
  // rel-pos mode each slot has its item's rel table beside it.
  static constexpr int Q_SLOT = CONSUMERS * TILE;
  static constexpr int q_off = 0;
  static constexpr int REL_SLOT = BIAS == kRelpos ? (2 * MAX_REL_DISTANCE + 2) * 4 : 0;
  static constexpr int rel_off = 2 * Q_SLOT;
  static constexpr int stage_off = rel_off + 2 * REL_SLOT;
  // As many ring stages as the 227 KB of a block hold, at most 4.
  static constexpr int SMEM_MAX = 232448 - 1024 - 128;
  static constexpr int STAGES =
      (SMEM_MAX - stage_off) / STAGE < 4 ? (SMEM_MAX - stage_off) / STAGE : 4;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
  // mbarriers: K/V full[STAGES], K/V empty[STAGES], Q full[2], Q empty[2].
  static constexpr int bar_off = stage_off + STAGES * STAGE;
  static constexpr int kv_full = bar_off;
  static constexpr int kv_empty = bar_off + STAGES * 8;
  static constexpr int q_full = bar_off + 2 * STAGES * 8;
  static constexpr int q_empty = q_full + 2 * 8;
  static constexpr int bytes = q_empty + 2 * 8;
  static constexpr int alloc = bytes + 1024;     // room to align the base
};

// One work item's (batch row, head) problem. q, k, v (and the bias when its
// rows are 16-byte aligned) come in through the launch's tensor maps at
// coordinates (column, head, row, batch row) and (key, query, head); the
// pointers below are offset to the item. Strides in elements.
struct Args {
  int b, head;             // tensor-map coordinates of the item
  bf16* o;
  long o_row;
  const bf16* bias;        // (n_q, n_k) rows of bias_row elements, or null
  long bias_row;
  bool bias_aligned;       // bias rows 16-byte aligned: through its tensor map
  const int8_t* kv_mask;   // (n_k,) 0 = masked (with the bias only)
  int n_q, n_k, d;
  float scale;             // D^-1/2
  float* lse;              // (n_q,) natural-log row logsumexp out, or null
  // kRelpos only: this head's (num_buckets,) table, the bucket of every
  // clamped relative position (2 * rel_maxd + 1 entries), the clamp, and the
  // far thresholds: every key - query <= rel_past has the bucket of -maxd,
  // every key - query >= rel_future that of +maxd.
  const float* rel_table = nullptr;
  const int* rel_lut = nullptr;
  int rel_maxd = 0, rel_past = 0, rel_future = 0;
};

// The tensor maps of one launch: q, k, v as (d, h, rows, batch) bf16 with the
// caller's strides, boxes of 64 columns x 64 rows; the bias as (keys,
// queries, heads), boxes of 64 keys x 128 queries; all in the 128-byte
// swizzle, out-of-range elements zero-filled.
struct Maps {
  CUtensorMap q, k, v, bias;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) with a box of `box`, 128-byte swizzle, zero fill.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank),
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k or v of shape (batch, rows, heads, d) at `base` with the given strides
// (elements; 16-byte multiples), as (d, h, rows, batch).
inline cudaError_t encode_qkv(CUtensorMap* map, const void* base, int batch,
                              int rows, int heads, int d, long s_b, long s_n,
                              long s_h) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(rows),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 2, cuuint64_t(s_n) * 2,
                                 cuuint64_t(s_b) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// A contiguous (1, heads, n, m) bias as (m, n, heads), boxes of 64 keys x
// `rows` queries (128 for the forward's tile, 64 for the backward's panels);
// m % 8 == 0.
inline cudaError_t encode_bias(CUtensorMap* map, const void* base, int heads,
                               int n, int m, int rows = 128) {
  const cuuint64_t dims[3] = {cuuint64_t(m), cuuint64_t(n), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(m) * 2, cuuint64_t(n) * m * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  return encode_map(map, base, 3, dims, strides, box);
}

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This thread's warpgroup, broadcast from lane 0 so that the compiler knows
// it is warp-uniform: the shared-memory descriptors derived from it are then
// computed in uniform registers, with no per-thread copy moved into them
// (R2UR) before each `wgmma`.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, int(threadIdx.x) / WG_THREADS, 0);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One TMA box global -> shared, completion counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma (the hardware writes the accumulator, and reads the A
// fragment, after the instruction has issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset `lbo` (between 64-column panels along MN for the transposed V
// operand; unused for the K-major ones), stride byte offset 1024 (between
// groups of 8 rows of 128 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s (64 x 64, fp32) = A·Bᵀ, both K-major in shared memory (m64n64k16);
// `accumulate` 0 overwrites s (whose old values are then never read).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// As above for a 64 x 16 tile (m64n16k16): the narrow key tail of kernel 2.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// o (64 x 64) += P·V: P from registers (4 x 32 bits a thread), V from
// shared memory MN-major (the transpose bit), m64n64k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As above at N = 96 (the ViT's head dim of 88, padded), m64n96k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Key tiles a work item walks: keys [0, n_k) or, with CAUSAL, up to the last
// key a query of its 128 rows sees (top-left aligned).
template <bool CAUSAL>
__device__ __forceinline__ int tiles_of(const Args& a, int q0) {
  const int k_end = CAUSAL ? min(a.n_k, q0 + BQ) : a.n_k;
  return (k_end + BK - 1) / BK;
}

// ---------------------------------------------------------------- producer
// The producer warpgroup walks the block's work items ahead of the
// consumers: an item's 128 query rows into a free Q slot, then its key tiles
// into the ring, whose position (`tile`) runs on across items. One thread
// issues the TMA boxes (K and V: one box a 64-column panel; the bias tile);
// the warpgroup stores what TMA cannot bring: the 64 key-mask flags, when
// its rows are not 16-byte aligned the bias element by element, and in the
// rel-pos mode the item's rel table beside its Q slot.
template <int DP, int BIAS, bool CAUSAL, class Problem>
__device__ __forceinline__ void produce(const Problem& p, unsigned char* base,
                                        uint32_t sbase) {
  using L = Layout<DP, BIAS>;
  const int tid = threadIdx.x - CONSUMERS * WG_THREADS;
  const bool leader = tid == 0;
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    Args a;
    int q0;
    p.at(item, a, q0);
    const int slot = round % 2;
    if (leader) {
      const uint32_t full = sbase + L::q_full + slot * 8;
      mbar_wait(sbase + L::q_empty + slot * 8, ((round / 2) & 1) ^ 1);
      mbar_arrive_expect(full, L::Q_SLOT);
      const uint32_t sq = sbase + L::q_off + slot * L::Q_SLOT;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
        for (int pn = 0; pn < L::PANELS; ++pn) {
          tma_load_4d(sq + w * L::TILE + pn * PANEL_BYTES, &p.maps.q, full, pn * 64,
                      a.head, q0 + w * BM, a.b);
        }
      }
    }
    if constexpr (BIAS == kRelpos) {
      // rel[c] = table[lut[c]]; the slot's consumers are done with the last
      // item's table once the slot is empty.
      mbar_wait(sbase + L::q_empty + slot * 8, ((round / 2) & 1) ^ 1);
      float* rel = reinterpret_cast<float*>(base + L::rel_off + slot * L::REL_SLOT);
      for (int c = tid; c <= 2 * a.rel_maxd; c += WG_THREADS) {
        rel[c] = a.rel_table[a.rel_lut[c]];
      }
      mbar_arrive(sbase + L::q_full + slot * 8);  // these stores (release)
    }
    const int n_tiles = tiles_of<CAUSAL>(a, q0);
    for (int j = 0; j < n_tiles; ++j, ++tile) {
      const int st = tile % L::STAGES;
      const uint32_t full = sbase + L::kv_full + st * 8;
      mbar_wait(sbase + L::kv_empty + st * 8, ((tile / L::STAGES) & 1) ^ 1);
      const int k0 = j * BK;
      const uint32_t stage = sbase + L::stage_off + st * L::STAGE;
      if (leader) {
        const bool bias_box = BIAS == kBiasTile && a.bias_aligned;
        mbar_arrive_expect(full, 2 * L::TILE + (bias_box ? L::BIAS_BYTES : 0));
#pragma unroll
        for (int pn = 0; pn < L::PANELS; ++pn) {
          tma_load_4d(stage + L::k_off + pn * PANEL_BYTES, &p.maps.k, full, pn * 64,
                      a.head, k0, a.b);
          tma_load_4d(stage + L::v_off + pn * PANEL_BYTES, &p.maps.v, full, pn * 64,
                      a.head, k0, a.b);
        }
        if (bias_box) {
          tma_load_3d(stage + L::bias_off, &p.maps.bias, full, k0, q0, a.head);
        }
      }
      if constexpr (BIAS != kNoBias) {
        unsigned char* gstage = base + L::stage_off + st * L::STAGE;
        if (BIAS == kBiasTile && !a.bias_aligned) {
          // Element by element into the swizzled layout TMA would give, a
          // warp on 32 consecutive keys of one row.
          for (int idx = tid; idx < BQ * BK; idx += WG_THREADS) {
            const int r = idx / BK;
            const int c = idx % BK;
            *reinterpret_cast<bf16*>(gstage + L::bias_off + r * 128 +
                                     (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
                (q0 + r < a.n_q && k0 + c < a.n_k)
                    ? a.bias[long(q0 + r) * a.bias_row + k0 + c]
                    : __float2bfloat16(0.f);
          }
        }
        if (tid < BK) {
          const int key = k0 + tid;
          gstage[L::keyok_off + tid] = key < a.n_k && a.kv_mask[key] != 0;
        }
      }
      mbar_arrive(full);  // this thread's stores (release)
    }
  }
}

// ---------------------------------------------------------------- consumer
// The consumer's view of one key tile: scores to probabilities. The row
// state is kept in the units of the tile's values v: the raw scores q·kᵀ for
// kernel 4, the natural-log logits q·kᵀ·scale + bias for the biased kernels;
// `unit` turns v into base-2 exponents, so p = exp2(v·unit - m·unit) is one
// FFMA and one ex2 a score.
struct RowState {
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0, r0+8
  float l[2] = {0.f, 0.f};              // running denominator
};

// s (this thread's 4 * NCOL scores of a 64 x 8 * NCOL tile: 64 keys, or
// kernel 2's narrow tail of 16) -> the P fragments of its 16-key steps, with
// the bias and masks applied and the row state advanced; `corr` is the factor
// the output accumulated so far must take. s[4n + 2h + e] is row r0 + 8h,
// key 8n + 2t + e of the tile. `rel` is the item's rel table (kRelpos only).
template <int DP, int BIAS, bool CAUSAL, int NCOL = 8>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NCOL * 4], uint32_t (&pa)[NCOL / 2][4], RowState& st,
    float (&corr)[2], const Args& a, const unsigned char* stage, int k0,
    int row_wg, int wg, int r0, int t, const float* rel = nullptr) {
  using L = Layout<DP, BIAS>;
  const float unit = BIAS != kNoBias ? LOG2E : a.scale * LOG2E;
  // Masks are needed on a tile with keys past the end (or, causal, past the
  // diagonal of some row); the biased kernels always read the key mask.
  const bool masked = BIAS != kNoBias || k0 + NCOL * 8 > a.n_k ||
                      (CAUSAL && k0 + NCOL * 8 - 1 > row_wg);
  // The scores' natural-log logits are s * t_mul + t_add: s is already the
  // logit (t_mul 1, t_add 0) but on a far rel-pos tile, which adds its one
  // bias value through the exponent's FFMA and the tile max (t_mul is the
  // scale > 0, so the max of the raw scores maps to the max of the logits).
  float t_mul = 1.f, t_add = 0.f;
  // kRelpos: the tile is far when every key - query of its 64 rows lies at
  // or past a far threshold (one bucket: one value added to every score),
  // else near (a lookup per score). The branch is uniform across the
  // warpgroup, and the far tiles run no index arithmetic at all.
  if constexpr (BIAS == kRelpos) {
    const int rel_hi = k0 + NCOL * 8 - 1 - row_wg;
    const int rel_lo = k0 - (row_wg + BM - 1);
    if (rel_hi > a.rel_past && rel_lo < a.rel_future) {
      const int maxd = a.rel_maxd;
      // key - query of score s[4n + 2h + e]: base + 8n - 8h + e
      const int base = k0 + 2 * t - (row_wg + r0);
#pragma unroll
      for (int n = 0; n < NCOL; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = base + 8 * n - 8 * h + e;
            s[4 * n + 2 * h + e] =
                fmaf(s[4 * n + 2 * h + e], a.scale, rel[min(max(rr, -maxd), maxd) + maxd]);
          }
        }
      }
    } else {
      t_mul = a.scale;
      t_add = rel_hi <= a.rel_past ? rel[0] : rel[2 * a.rel_maxd];
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NCOL; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float v0 = s[4 * n + 2 * h];
      float v1 = s[4 * n + 2 * h + 1];
      if constexpr (BIAS == kBiasTile) {
        const int r = wg * BM + row;  // 16-byte chunk n of row r, swizzled
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
            stage + L::bias_off + r * 128 + ((n ^ (r & 7)) << 4) + 4 * t);
        v0 = fmaf(v0, a.scale, __low2float(b2));
        v1 = fmaf(v1, a.scale, __high2float(b2));
      }
      if (masked) {
        bool ok0, ok1;
        if constexpr (BIAS != kNoBias) {
          ok0 = stage[L::keyok_off + col] != 0;
          ok1 = stage[L::keyok_off + col + 1] != 0;
        } else {
          ok0 = k0 + col < a.n_k;
          ok1 = k0 + col + 1 < a.n_k;
        }
        if constexpr (CAUSAL) {
          ok0 = ok0 && k0 + col <= row_wg + row;
          ok1 = ok1 && k0 + col + 1 <= row_wg + row;
        }
        v0 = ok0 ? v0 : -INFINITY;
        v1 = ok1 ? v1 : -INFINITY;
      }
      s[4 * n + 2 * h] = v0;
      s[4 * n + 2 * h + 1] = v1;
      mx[h] = fmaxf(mx[h], fmaxf(v0, v1));
    }
  }
  float neg_m[2], psum[2] = {0.f, 0.f};
  const float s_unit = unit * t_mul;  // exponent per raw score
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // -inf * t_mul + t_add stays -inf.
    const float m_new = fmaxf(st.m[h], fmaf(quad_max(mx[h]), t_mul, t_add));
    // A row with no valid key yet keeps m = -inf: exp2 of -inf is 0.
    neg_m[h] = m_new == -INFINITY ? 0.f : -m_new * unit;
    corr[h] = exp2_approx(fmaf(st.m[h], unit, neg_m[h]));
    st.m[h] = m_new;
    neg_m[h] = fmaf(t_add, unit, neg_m[h]);
  }
#pragma unroll
  for (int n = 0; n < NCOL; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = exp2_approx(fmaf(s[4 * n + 2 * h], s_unit, neg_m[h]));
      const float p1 = exp2_approx(fmaf(s[4 * n + 2 * h + 1], s_unit, neg_m[h]));
      psum[h] += p0 + p1;
      pa[n / 2][(n % 2) * 2 + h] = pack_bf16x2(p0, p1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * corr[h] + quad_sum(psum[h]);
}

// s = q·kᵀ over the head dim, 16 columns a step, issued (not waited for).
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq,
                                         uint32_t sk) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(s, make_desc(sq + off, PANEL_BYTES),
                 make_desc(sk + off, PANEL_BYTES), kk > 0);
  }
  wgmma_commit();
}

// o += p·v, 16 keys a step (V rows 16c..16c+15: two 8-row groups), issued
// and committed (the caller fences first).
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N], const uint32_t (&pa)[4][4],
                                         uint32_t sv) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wgmma_rs(o, pa[c], make_desc(sv + c * 2048, PANEL_BYTES));
  }
  wgmma_commit();
}

// The consumer warpgroup's loop over the block's work items, each one
// software-pipelined so that the tensor cores compute q·kᵀ of tile j+1 and
// p·v of tile j while this warpgroup turns the scores of tile j+1 into
// probabilities:
//   issue S(j+1); issue O += P(j)·V(j); wait S(j+1); softmax(j+1) -> P(j+1);
//   wait O; hand stage j back; O *= corr(j+1).
template <int DP, int BIAS, bool CAUSAL, class Problem>
__device__ __forceinline__ void consume(const Problem& p, unsigned char* base,
                                        uint32_t sbase) {
  using L = Layout<DP, BIAS>;
  constexpr int ND = DP / 8;         // 8-column blocks of the output
  const int wg = warpgroup_index();
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8

  auto stage_addr = [&](int i) {
    return sbase + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto stage_ptr = [&](int i) {
    return base + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto wait_full = [&](int i) {
    mbar_wait(sbase + L::kv_full + (i % L::STAGES) * 8, (i / L::STAGES) & 1);
  };
  auto release = [&](int i) {
    mbar_arrive(sbase + L::kv_empty + (i % L::STAGES) * 8);
  };

  float s[32] = {}, corr[2];
  // The P fragments in ping-pong: the tile whose p·v is in flight reads one
  // set while the softmax of the next tile writes the other. A copy from
  // one set to the other lets the register allocator merge them, and then
  // the softmax would overwrite registers an issued `wgmma` still reads:
  // ptxas serializes every `wgmma` of the kernel (C7513) to stay correct.
  uint32_t pa0[4][4], pa1[4][4];
  int tile = 0;  // ring position of the item's first key tile
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    Args a;
    int q0;
    p.at(item, a, q0);
    const int n_tiles = tiles_of<CAUSAL>(a, q0);
    const int row_wg = q0 + wg * BM;  // first query row of this warpgroup
    const int slot = round % 2;
    mbar_wait(sbase + L::q_full + slot * 8, (round / 2) & 1);
    const uint32_t sq = sbase + L::q_off + slot * L::Q_SLOT + wg * L::TILE;
    const float* rel =
        reinterpret_cast<const float*>(base + L::rel_off + slot * L::REL_SLOT);

    float o[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) o[i] = 0.f;
    RowState row;

    // Prologue: the probabilities of tile 0.
    wait_full(tile);
    issue_qk<DP>(s, sq, stage_addr(tile) + L::k_off);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<DP, BIAS, CAUSAL>(s, pa0, row, corr, a, stage_ptr(tile), 0,
                                   row_wg, wg, r0, t, rel);

    // Tile j's p·v from `pin` beside tile j+1's q·kᵀ, whose probabilities go
    // to `pout`.
    auto step = [&](uint32_t (&pin)[4][4], uint32_t (&pout)[4][4], int j) {
      const int i = tile + j;
      wait_full(i + 1);
      // Every register the two products touch is final before they issue.
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(pin[c]);
      issue_qk<DP>(s, sq, stage_addr(i + 1) + L::k_off);
      issue_pv(o, pin, stage_addr(i) + L::v_off);
      wgmma_wait<1>();  // q·kᵀ of tile j+1 is done; p·v of tile j may run on
      fence_regs(s);
      softmax_tile<DP, BIAS, CAUSAL>(s, pout, row, corr, a, stage_ptr(i + 1),
                                     (j + 1) * BK, row_wg, wg, r0, t, rel);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(pin[c]);
      release(i);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    };
    // The last tile's p·v; then the item's stage and Q slot are free.
    auto last_pv = [&](uint32_t (&pin)[4][4]) {
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(pin[c]);
      wgmma_fence();
      issue_pv(o, pin, stage_addr(tile + n_tiles - 1) + L::v_off);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(pin[c]);
    };
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {
      step(pa0, pa1, j);
      step(pa1, pa0, j + 1);
    }
    if (j + 1 < n_tiles) {
      step(pa0, pa1, j);
      last_pv(pa1);
    } else {
      last_pv(pa0);
    }
    release(tile + n_tiles - 1);
    mbar_arrive(sbase + L::q_empty + slot * 8);
    tile += n_tiles;

    // o[4n + 2h + e] is row r0 + 8h, column 8n + 2t + e.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = row_wg + r0 + 8 * h;
      if (qr >= a.n_q) continue;
      const float inv = 1.f / fmaxf(row.l[h], 1e-30f);
      bf16* orow = a.o + long(qr) * a.o_row;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < a.d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * n + 2 * h] * inv,
                                    o[4 * n + 2 * h + 1] * inv);
        }
      }
      if (a.lse != nullptr && t == 0) {  // the biased kernels: m is natural
        const float m_safe = row.m[h] == -INFINITY ? 0.f : row.m[h];
        a.lse[qr] = m_safe + logf(fmaxf(row.l[h], 1e-30f));
      }
    }
  }
}

// The problem of the bias-free kernels (kernel 4 and kernel 2's streaming
// path): a work item is (query block of 128, head, image), query block
// fastest, so the blocks of one (image, head) run together and share its K/V
// in L2; keys [0, m) of n_q = n queries; the output (B, N, H, D) contiguous.
struct NoBiasProblem {
  Maps maps;
  bf16* out;
  int n, m, h, d, n_qt, items;
  float scale;

  __device__ void at(int item, Args& a, int& q0) const {
    const int rest = item / n_qt;
    a.head = rest % h;
    a.b = rest / h;
    q0 = (item % n_qt) * BQ;
    const long hd = long(h) * d;
    a.o = out + long(a.b) * n * hd + long(a.head) * d;
    a.o_row = hd;
    a.bias = nullptr;
    a.bias_row = 0;
    a.bias_aligned = false;
    a.kv_mask = nullptr;
    a.n_q = n;
    a.n_k = m;
    a.d = d;
    a.scale = scale;
    a.lse = nullptr;
  }
};

// A persistent block: barrier set-up, then the producer warpgroup and the
// two consumer warpgroups run apart to the end, over the work items
// blockIdx.x, blockIdx.x + gridDim.x, ... of `p` (p.items of them;
// p.at(item, args, q0) names one: a (batch row, head) and 128 query rows).
template <int DP, int BIAS, bool CAUSAL, class Problem>
__device__ __forceinline__ void attention_persistent(const Problem& p,
                                                     unsigned char* smem_raw) {
  using L = Layout<DP, BIAS>;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sbase - raw);
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::STAGES; ++st) {
      // full: every producer thread (its stores) and the leader's
      // expect-tx arrival; then the TMA bytes
      mbar_init(sbase + L::kv_full + st * 8, WG_THREADS + 1);
      // empty: every consumer thread
      mbar_init(sbase + L::kv_empty + st * 8, CONSUMERS * WG_THREADS);
    }
    for (int slot = 0; slot < 2; ++slot) {
      // the leader and its TMA bytes; in the rel-pos mode also every
      // producer thread (its rel-table stores)
      mbar_init(sbase + L::q_full + slot * 8,
                1 + (BIAS == kRelpos ? WG_THREADS : 0));
      mbar_init(sbase + L::q_empty + slot * 8, CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    produce<DP, BIAS, CAUSAL>(p, base, sbase);
  } else {
    consume<DP, BIAS, CAUSAL>(p, base, sbase);
  }
}

// ------------------------------------------------------- resident K/V
// The resident path of kernel 2 (qkv_packed_attention.cu), whose work item
// and producer kernel 16's attention (int8_attn_block.cu) takes too: a work
// item is one (image, head) of packed (B, N, 3*H*D) rows, its K and V are
// loaded by TMA once and stay in shared memory while its query tiles of 64
// rows go through the two consumer warpgroups in turns.
constexpr int KV_TILES = 5;  // the most key tiles the resident path holds

// One launch: a work item is (image, head), head fastest, so the blocks
// that run together read neighbouring heads of the same packed rows.
struct ResidentProblem {
  Maps maps;
  bf16* out;
  int n, n_valid, h, d, items;
  int passes;      // query tiles of 64 an item
  int key_tiles;   // key tiles of 64 an item (<= KV_TILES)
  bool narrow;     // the last key tile holds <= 16 keys
  float scale;
};

// Shared memory from a 1024-byte aligned base: the item's K tiles and V
// tiles, then two Q slots a consumer; mbarriers K/V full[KV_TILES], K/V
// empty[KV_TILES], Q full[consumer][slot], Q empty[consumer][slot].
template <int DP>
struct ResidentLayout {
  using L = Layout<DP, kNoBias>;
  static constexpr int TILE = L::TILE;
  static constexpr int k_off = 0;
  static constexpr int v_off = KV_TILES * TILE;
  static constexpr int q_off = 2 * KV_TILES * TILE;
  static constexpr int bar_off = q_off + 2 * CONSUMERS * TILE;
  static constexpr int kv_full = bar_off;
  static constexpr int kv_empty = kv_full + KV_TILES * 8;
  static constexpr int q_full = kv_empty + KV_TILES * 8;
  static constexpr int q_empty = q_full + 2 * CONSUMERS * 8;
  static constexpr int bytes = q_empty + 2 * CONSUMERS * 8;
  static constexpr int alloc = bytes + 1024;
  static_assert(alloc <= 232448, "the resident K/V do not fit a block");
};

// Pass g of the block's sequence (its items' query tiles in order) belongs to
// consumer g % 2; the producer and both consumers walk the same sequence.

// The producer's leader thread: per item the Q tiles of its first two
// passes, then its K/V tiles (each once both consumers are done with the
// last item's), then the Q tiles of the other passes. A Q tile waits for its
// consumer's slot to free, which the same consumer's pass two before does:
// for the first two passes a pass of the last item (whose K/V are in), for
// the others one of this item (whose K/V were issued before): no cycle.
template <int DP>
__device__ __forceinline__ void produce_resident(const ResidentProblem& p,
                                                 uint32_t sbase) {
  using RL = ResidentLayout<DP>;
  constexpr int PANELS = RL::L::PANELS;
  int mine0 = 0, mine1 = 0;  // Q tiles issued to consumers 0 and 1
  int g0 = 0;                // the item's first pass
  int round = 0;
  auto load_q = [&](int b, int head, int lp) {
    const int w = (g0 + lp) % CONSUMERS;
    const int mine = w == 0 ? mine0 : mine1;
    const int slot = mine % 2;
    const uint32_t full = sbase + RL::q_full + (w * 2 + slot) * 8;
    mbar_wait(sbase + RL::q_empty + (w * 2 + slot) * 8, ((mine / 2) & 1) ^ 1);
    mbar_arrive_expect(full, RL::TILE);
    const uint32_t dst = sbase + RL::q_off + (w * 2 + slot) * RL::TILE;
#pragma unroll
    for (int pn = 0; pn < PANELS; ++pn) {
      tma_load_4d(dst + pn * PANEL_BYTES, &p.maps.q, full, pn * 64, head, lp * BM, b);
    }
    if (w == 0) {
      ++mine0;
    } else {
      ++mine1;
    }
  };
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    const int head = item % p.h;
    const int b = item / p.h;
    const int early = p.passes < 2 ? p.passes : 2;
    for (int lp = 0; lp < early; ++lp) load_q(b, head, lp);
    for (int j = 0; j < p.key_tiles; ++j) {
      const uint32_t full = sbase + RL::kv_full + j * 8;
      mbar_wait(sbase + RL::kv_empty + j * 8, (round & 1) ^ 1);
      mbar_arrive_expect(full, 2 * RL::TILE);
#pragma unroll
      for (int pn = 0; pn < PANELS; ++pn) {
        tma_load_4d(sbase + RL::k_off + j * RL::TILE + pn * PANEL_BYTES, &p.maps.k,
                    full, pn * 64, head, j * BK, b);
        tma_load_4d(sbase + RL::v_off + j * RL::TILE + pn * PANEL_BYTES, &p.maps.v,
                    full, pn * 64, head, j * BK, b);
      }
    }
    for (int lp = early; lp < p.passes; ++lp) load_q(b, head, lp);
    g0 += p.passes;
  }
}

// The barriers of a resident block (thread 0, before the block's first
// __syncthreads).
template <int DP>
__device__ __forceinline__ void init_resident(uint32_t sbase) {
  using RL = ResidentLayout<DP>;
  if (threadIdx.x == 0) {
    for (int j = 0; j < KV_TILES; ++j) {
      mbar_init(sbase + RL::kv_full + j * 8, 1);  // the leader; TMA bytes
      mbar_init(sbase + RL::kv_empty + j * 8, CONSUMERS * WG_THREADS);
    }
    for (int i = 0; i < 2 * CONSUMERS; ++i) {
      mbar_init(sbase + RL::q_full + i * 8, 1);
      mbar_init(sbase + RL::q_empty + i * 8, WG_THREADS);  // its consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The three tensor maps over the packed row: q with n rows, k and v with
// n_valid rows (TMA zero-fills the keys past n_valid).
inline cudaError_t encode_packed(Maps& maps, const bf16* qkv, int b, int n,
                                 int n_valid, int h, int d) {
  const long hd = long(h) * d;
  const long row = 3 * hd;
  cudaError_t err = encode_qkv(&maps.q, qkv, b, n, h, d, n * row, row, d);
  if (err == cudaSuccess) {
    err = encode_qkv(&maps.k, qkv + hd, b, n_valid, h, d, n * row, row, d);
  }
  if (err == cudaSuccess) {
    err = encode_qkv(&maps.v, qkv + 2 * hd, b, n_valid, h, d, n * row, row, d);
  }
  return err;
}

// Instantiate `Launch<DP>` for the smallest padded head dim that holds d.
template <template <int> class Launch, typename... A>
cudaError_t dispatch_head_dim(int d, A... args) {
  if (d <= 0 || d % 8 != 0 || d > 96) return cudaErrorInvalidValue;
  if (d <= 64) return Launch<64>::run(args...);
  return Launch<96>::run(args...);
}

// Opt in to the block's dynamic shared memory, then launch one persistent
// block per SM (fewer when there are fewer work items).
template <typename Kernel, typename Problem>
cudaError_t launch(Kernel kernel, size_t bytes, cudaStream_t stream,
                   const Problem& p) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const int grid = p.items < sms ? p.items : sms;
  kernel<<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace mrb
