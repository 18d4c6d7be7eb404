// Self-attention straight off the packed (B, N, 3*H*D) QKV projection.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_qkv_packed_kernel
// (pallas_call :1506; the EVA ViT-g self-attention at 224 pixels: 240
// images x 257 tokens, H=16, D=88, bf16; the ViT's 4 MiB gate sends it
// N <= 496 only).
//
// Bound on this card: the bytes. Per image and head 4*N*N*D flops (89 GFLOP
// a ViT layer at 240 x 257, 0.09 ms at the bf16 peak) against the packed
// tensor read once and the output written once (0.69 GB, 0.21 ms at 3.35
// TB/s). At N=257 the query and key ranges are 4 tiles of 64 and one row:
// padded to whole tiles, 46% of the products are waste.
//
// Design: the Hopper tile of attention_tile_sm90.cuh (`wgmma` for both
// products, TMA with the 128-byte swizzle, one producer and two consumer
// warpgroups, persistent blocks). The q, k and v tensor maps are strided
// views of the packed row (row stride 3*H*D, image stride N*3*H*D, head
// stride D, base offsets 0, H*D and 2*H*D); the K/V maps' row extent is
// n_valid, so TMA zero-fills the keys past it and the tile masks them: the
// Pallas kernel's n_valid with no key-flag array. The output goes to column
// h*D of the (B, N, H*D) result; nothing is split, transposed or padded in
// device memory. Two paths, chosen by the shape:
//  * resident (ceil(n_valid / 64) <= 5 key tiles: every length the ViT at
//    224 pixels gives): a work item is one (image, head). Its K and V (up to
//    320 rows, 160 KB at D = 88 -> 96) are loaded by TMA once into shared
//    memory and stay there while the item's query tiles of 64 rows go
//    through, the two consumer warpgroups
//    taking the block's query tiles in turns across items (so a 5-tile item
//    costs no idle warpgroup). The K/V of an item are read from L2 once, not
//    once per 128 queries, and the producer loads the next item's key tile t
//    as soon as both consumers are done with this item's tile t. A key tail
//    of at most 16 keys (1 at N = 257) takes an m64n16 product for q·kᵀ and
//    one 16-deep step of p·v, in place of a full 64-key tile. The query
//    tail (1 row at N = 257) still costs a 64-row pass;
//  * streaming (longer n_valid): kernel 4's persistent loop, work items
//    (query block of 128, head, image), K/V through a ring of 4 stages.
#include <cuda_runtime.h>

#include "attention_tile_sm90.cuh"

namespace mrb {

using sm90::bf16;
using sm90::BK;
using sm90::BM;
using sm90::CONSUMERS;
using sm90::PANEL_BYTES;
using sm90::WG_THREADS;

namespace {

// ------------------------------------------------------------- streaming
// Kernel 4's problem with keys [0, n_valid).
template <int DP>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
qkv_stream_kernel(const __grid_constant__ sm90::NoBiasProblem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90::attention_persistent<DP, sm90::kNoBias, false>(p, smem);
}

// One consumer warpgroup: its passes, each the online softmax of 64 query
// rows over the item's resident key tiles, software-pipelined as in
// sm90::consume (q·kᵀ of tile j+1 and p·v of tile j on the tensor cores
// while the scores of tile j+1 turn into probabilities). In its last pass of
// an item the warpgroup hands each key tile back once its p·v is done.
template <int DP>
__device__ __forceinline__ void consume_resident(const sm90::ResidentProblem& p,
                                                 uint32_t sbase) {
  using RL = sm90::ResidentLayout<DP>;
  constexpr int ND = DP / 8;
  const int wg = sm90::warpgroup_index();
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int T = p.key_tiles;
  const int n_full = p.narrow ? T - 1 : T;  // 64-key tiles; then the tail
  auto k_addr = [&](int j) { return sbase + RL::k_off + j * RL::TILE; };
  auto v_addr = [&](int j) { return sbase + RL::v_off + j * RL::TILE; };
  auto release = [&](int j) { sm90::mbar_arrive(sbase + RL::kv_empty + j * 8); };

  float s[32] = {}, s16[8] = {}, corr[2];
  // P fragments in ping-pong, as in sm90::consume (no copy between the set
  // an issued p·v reads and the set the next softmax writes).
  uint32_t pa0[4][4], pa1[4][4], pa16[1][4];
  int mine = 0;  // passes done by this warpgroup
  int g0 = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    const int head = item % p.h;
    const int b = item / p.h;
    const int first = g0 + ((g0 % CONSUMERS) != wg ? 1 : 0);
    if (first >= g0 + p.passes) {
      // No pass here: hand the tiles back once they are in, so that this
      // warpgroup's next wait on a full barrier is for the next item's phase.
      for (int j = 0; j < T; ++j) {
        sm90::mbar_wait(sbase + RL::kv_full + j * 8, round & 1);
        release(j);
      }
      g0 += p.passes;
      continue;
    }
    sm90::Args a;
    a.b = b;
    a.head = head;
    const long hd = long(p.h) * p.d;
    a.o = p.out + long(b) * p.n * hd + long(head) * p.d;
    a.o_row = hd;
    a.bias = nullptr;
    a.bias_row = 0;
    a.bias_aligned = false;
    a.kv_mask = nullptr;
    a.n_q = p.n;
    a.n_k = p.n_valid;
    a.d = p.d;
    a.scale = p.scale;
    a.lse = nullptr;
    for (int g = first; g < g0 + p.passes; g += CONSUMERS, ++mine) {
      const bool last = g + CONSUMERS >= g0 + p.passes;
      const int slot = mine % 2;
      sm90::mbar_wait(sbase + RL::q_full + (wg * 2 + slot) * 8, (mine / 2) & 1);
      const uint32_t sq = sbase + RL::q_off + (wg * 2 + slot) * RL::TILE;
      const int row_q = (g - g0) * BM;  // the pass's first query row
      auto wait_kv = [&](int j) {
        sm90::mbar_wait(sbase + RL::kv_full + j * 8, round & 1);
      };
      float o[ND * 4];
#pragma unroll
      for (int i = 0; i < ND * 4; ++i) o[i] = 0.f;
      sm90::RowState row;
      auto rescale = [&]() {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
      };

      // Prologue: the probabilities of tile 0 (a full tile: narrow needs
      // T >= 2).
      wait_kv(0);
      sm90::issue_qk<DP>(s, sq, k_addr(0));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::softmax_tile<DP, sm90::kNoBias, false>(s, pa0, row, corr, a, nullptr, 0,
                                                   row_q, 0, r0, t);
      // Full tile j's p·v from `pin` beside full tile j+1's q·kᵀ.
      auto step = [&](uint32_t (&pin)[4][4], uint32_t (&pout)[4][4], int j) {
        wait_kv(j + 1);
        sm90::fence_regs(o);
#pragma unroll
        for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
        sm90::issue_qk<DP>(s, sq, k_addr(j + 1));
        sm90::issue_pv(o, pin, v_addr(j));
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        sm90::softmax_tile<DP, sm90::kNoBias, false>(s, pout, row, corr, a, nullptr,
                                                     (j + 1) * BK, row_q, 0, r0, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
#pragma unroll
        for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
        if (last) release(j);
        rescale();
      };
      // The last full tile's p·v from `pin`, and the tail.
      auto finish = [&](uint32_t (&pin)[4][4]) {
        if (p.narrow) {
          // The tail's 16 keys: q·kᵀ as m64n16 beside the last full tile's
          // p·v.
          const int jt = T - 1;
          wait_kv(jt);
          sm90::fence_regs(o);
#pragma unroll
          for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
          sm90::fence_regs(s16);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
            sm90::wgmma_ss_n16(s16, sm90::make_desc(sq + off, PANEL_BYTES),
                               sm90::make_desc(k_addr(jt) + off, PANEL_BYTES), kk > 0);
          }
          sm90::wgmma_commit();
          sm90::issue_pv(o, pin, v_addr(jt - 1));
          sm90::wgmma_wait<1>();
          sm90::fence_regs(s16);
          sm90::softmax_tile<DP, sm90::kNoBias, false, 2>(s16, pa16, row, corr, a,
                                                          nullptr, jt * BK, row_q, 0,
                                                          r0, t);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
#pragma unroll
          for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
          if (last) release(jt - 1);
          rescale();
          // p·v over the tail's first 16 V rows (the probabilities past
          // n_valid are 0).
          sm90::fence_regs(o);
          sm90::fence_regs(pa16[0]);
          sm90::wgmma_fence();
          sm90::wgmma_rs(o, pa16[0], sm90::make_desc(v_addr(jt), PANEL_BYTES));
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          sm90::fence_regs(pa16[0]);
          if (last) release(jt);
        } else {
          sm90::fence_regs(o);
#pragma unroll
          for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
          sm90::wgmma_fence();
          sm90::issue_pv(o, pin, v_addr(T - 1));
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
#pragma unroll
          for (int c = 0; c < 4; ++c) sm90::fence_regs(pin[c]);
          if (last) release(T - 1);
        }
      };
      int j = 0;
      for (; j + 2 < n_full; j += 2) {
        step(pa0, pa1, j);
        step(pa1, pa0, j + 1);
      }
      if (j + 1 < n_full) {
        step(pa0, pa1, j);
        finish(pa1);
      } else {
        finish(pa0);
      }
      sm90::mbar_arrive(sbase + RL::q_empty + (wg * 2 + slot) * 8);

      // o[4n + 2h + e] is row r0 + 8h, column 8n + 2t + e.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = row_q + r0 + 8 * h;
        if (qr >= p.n) continue;
        const float inv = 1.f / fmaxf(row.l[h], 1e-30f);
        bf16* orow = a.o + long(qr) * a.o_row;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + 2 * t;
          if (col < p.d) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
          }
        }
      }
    }
    g0 += p.passes;
  }
}

template <int DP>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
qkv_resident_kernel(const __grid_constant__ sm90::ResidentProblem p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  sm90::init_resident<DP>(sbase);
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    if (threadIdx.x == CONSUMERS * WG_THREADS) sm90::produce_resident<DP>(p, sbase);
  } else {
    consume_resident<DP>(p, sbase);
  }
}

template <int DP>
struct QkvLaunch {
  static cudaError_t run(const bf16* qkv, bf16* out, int b, int n, int h,
                         int d, int n_valid, float scale,
                         cudaStream_t stream) {
    const int key_tiles = (n_valid + BK - 1) / BK;
    if (key_tiles <= sm90::KV_TILES) {
      sm90::ResidentProblem p{};
      cudaError_t err = sm90::encode_packed(p.maps, qkv, b, n, n_valid, h, d);
      if (err != cudaSuccess) return err;
      p.out = out;
      p.n = n;
      p.n_valid = n_valid;
      p.h = h;
      p.d = d;
      p.items = b * h;
      p.passes = (n + BM - 1) / BM;
      p.key_tiles = key_tiles;
      p.narrow = key_tiles >= 2 && n_valid - (key_tiles - 1) * BK <= 16;
      p.scale = scale;
      return sm90::launch(qkv_resident_kernel<DP>, sm90::ResidentLayout<DP>::alloc,
                          stream, p);
    }
    const long n_qt = (n + sm90::BQ - 1) / sm90::BQ;
    if (long(b) * h * n_qt > 0x7fffffffL) return cudaErrorInvalidValue;
    sm90::NoBiasProblem p{};
    cudaError_t err = sm90::encode_packed(p.maps, qkv, b, n, n_valid, h, d);
    if (err != cudaSuccess) return err;
    p.out = out;
    p.n = n;
    p.m = n_valid;
    p.h = h;
    p.d = d;
    p.n_qt = int(n_qt);
    p.items = int(long(b) * h * n_qt);
    p.scale = scale;
    return sm90::launch(qkv_stream_kernel<DP>, sm90::Layout<DP, sm90::kNoBias>::alloc,
                        stream, p);
  }
};

}  // namespace

}  // namespace mrb

// out (B, N, H*D) bf16 from the packed qkv (B, N, 3*H*D) bf16 (16-byte
// aligned; D a multiple of 8 up to 96); keys >= n_valid are masked
// (n_valid <= 0 or >= N: none). The path is a function of the shape alone:
// resident when ceil(n_valid / 64) <= 5, else streaming (mirrored on the host
// by ops/flash_attention.py::qkv_packed_path).
extern "C" int mrb_qkv_packed_attention_bf16(const void* qkv, void* out,
                                             int b, int n, int h, int d,
                                             int n_valid, float scale,
                                             void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      long(b) * h > 0x7fffffffL) {
    return int(cudaErrorInvalidValue);
  }
  const int nv = (n_valid > 0 && n_valid < n) ? n_valid : n;
  return int(mrb::sm90::dispatch_head_dim<mrb::QkvLaunch>(
      d, static_cast<const mrb::bf16*>(qkv), static_cast<mrb::bf16*>(out), b,
      n, h, d, nv, scale, static_cast<cudaStream_t>(stream)));
}
