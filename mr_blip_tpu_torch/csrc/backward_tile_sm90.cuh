// The backward of the biased flash attention on Hopper (sm_90a), bf16, head
// dim 64: the dQ pass (kernels 6 and 7) and the dK/dV pass (kernel 8) of
// flash_bias_backward.cu, on the primitives of attention_tile_sm90.cuh.
//
// Each pass recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's row logsumexp and, with δ = rowsum(dO∘O)
// computed outside in fp32: dp = dO·vᵀ, ds = p∘(dp - δ); the dQ pass
// accumulates dq = ds·k·scale (and, for kernel 7, dbias = Σ_b ds), the dK/dV
// pass dk = dsᵀ·q·scale and dv = pᵀ·dO. Two passes and no atomics, as the TPU
// kernels have it, so every output comes out the same from run to run.
//
// What bounds them on this card is the tensor cores: 3 (dQ) and 4 (dK/dV)
// products of 2·N·M·D flops per (batch row, head), against one read of the
// (1, H, N, M) bf16 bias per head. The `mma.sync` tile they replace
// (backward_tile.cuh) reached 4-8% of the bf16 peak: synchronous loads
// between two __syncthreads(), a bias read 2 bytes a thread-step and once per
// batch row, and B operands packed from scalar shared loads. Here, as in the
// forward's tile:
//
//  * a block is three warpgroups: warpgroup 2 produces, 0 and 1 consume 64
//    rows each of a 128-row work item. The block is persistent and walks its
//    items with the batch row fastest, so the blocks that read one bias box
//    run side by side and the bias comes from device memory once per head;
//  * a work item's fixed operands (dQ pass: Q and dO of 128 queries; dK/dV
//    pass: K and V of 128 keys) come by TMA into one of two slots, the next
//    item's while the current one runs. The streamed operands (dQ: K, V of 64
//    keys; dK/dV: Q, dO of 64 queries) and the bias come by TMA into a ring of
//    up to 4 stages on full/empty mbarriers. The producer also stores what
//    TMA cannot bring: the 64 key-mask flags (dQ) or -lse·log2(e) and δ of
//    the 64 queries (dK/dV), and the bias element by element when its rows
//    are not 16-byte aligned (M % 8 != 0);
//  * the bias arrives as two 64 x 64 panels a stage, one a consumer, 64
//    query rows of 128 bytes in the 128-byte swizzle: in the dQ pass the
//    consumer's queries by the tile's keys, in the dK/dV pass the tile's
//    queries by the consumer's keys (one tensor map, box 64 x 64, for both).
//    The dK/dV pass reads its panel transposed, one 2-byte element at the
//    swizzled address of (query, key): the 4 query rows a warp reads at once
//    land on distinct 16-byte chunks, so the reads are free of conflicts;
//  * every product is `wgmma.mma_async`, fp32 accumulation. S = Q·Kᵀ and
//    dP = dO·Vᵀ (dK/dV: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ) read both operands from
//    shared memory (m64n64k16). P and dS stay in registers: the accumulator
//    layout of S is reused as the A fragment of dQ += dS·K (dK/dV: dV += Pᵀ·dO
//    and dK += dSᵀ·Q), whose B operand is read through the transpose bit;
//  * each tile is software-pipelined as the forward's: the score products
//    of tile j+1 and the accumulating products of tile j are in flight
//    together while the consumer turns the scores of tile j+1 into P and dS;
//    empty register fences keep the compiler from moving register reads or
//    writes across an asynchronous `wgmma`. ptxas still reports C7513
//    (products serialized somewhere) for all three kernels, as for kernel
//    4's forward; pinning the operand descriptors and accumulators with more
//    fences did not clear it, and its log does not say where;
//  * p = exp2(s·scale·log2e + bias·log2e - lse·log2e): one ex2 and two FMAs
//    a score. Query rows past N get lse = +inf and keys past M or masked get
//    p = 0, so they add nothing; a batch row whose keys are all masked gives
//    zeros. Nothing is padded or copied in device memory: TMA zero-fills the
//    rows past the extents;
//  * setmaxnreg gives the consumers 232 registers a thread (the dK/dV
//    consumer holds Sᵀ, dPᵀ, dK and dV: 4 x 32 fp32, and the fragments of two
//    tiles) and the producer 40.
#pragma once

#include "attention_tile_sm90.cuh"

namespace mrb {
namespace sm90bwd {

using sm90::bf16;
using sm90::CONSUMERS;
using sm90::LOG2E;
using sm90::NTHREADS;
using sm90::PANEL_BYTES;
using sm90::WG_THREADS;

constexpr int D = 64;                 // the only head dim (T5 d_kv)
constexpr int BR = 64;                // rows a consumer owns
constexpr int BITEM = BR * CONSUMERS;  // rows of a work item
constexpr int BT = 64;                // streamed rows a tile
constexpr int TILE = BT * 128;        // one 64 x 64 bf16 tile, swizzled

// Shared-memory carve-up from a 1024-byte aligned base.
struct Layout {
  // Two slots of a work item's fixed operands: X (Q or K) of consumer w at
  // w * TILE, Y (dO or V) at (CONSUMERS + w) * TILE.
  static constexpr int SLOT = 2 * CONSUMERS * TILE;
  static constexpr int slot_off = 0;
  static constexpr int stage_off = 2 * SLOT;
  // A ring stage: U (K or Q) and W (V or dO) tiles, one bias panel a
  // consumer, then the 64 key flags (dQ) or -lse·log2e and δ (dK/dV).
  static constexpr int u_off = 0;
  static constexpr int w_off = TILE;
  static constexpr int bias_off = 2 * TILE;
  static constexpr int extra_off = bias_off + CONSUMERS * TILE;
  static constexpr int STAGE = (extra_off + 2 * BT * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM_MAX = 232448 - 1024 - 128;
  static constexpr int STAGES =
      (SMEM_MAX - stage_off) / STAGE < 4 ? (SMEM_MAX - stage_off) / STAGE : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
  // mbarriers: full[STAGES], empty[STAGES], slot full[2], slot empty[2].
  static constexpr int bar_off = stage_off + STAGES * STAGE;
  static constexpr int full = bar_off;
  static constexpr int empty = bar_off + STAGES * 8;
  static constexpr int slot_full = bar_off + 2 * STAGES * 8;
  static constexpr int slot_empty = slot_full + 2 * 8;
  static constexpr int bytes = slot_empty + 2 * 8;
  static constexpr int alloc = bytes + 1024;
};

// q, k, v and dO as (d, h, rows, batch), boxes of 64 columns x 64 rows; the
// bias as (keys, queries, heads), boxes of 64 x 64.
struct Maps {
  CUtensorMap q, k, v, dout, bias;
};

// One launch. A work item is (batch row, head, 128 rows) with the batch row
// fastest; with `subs` > 1 (kernel 7) it is (head, 128 rows) and the block
// walks the batch rows 0..subs-1 inside it, in order.
struct Problem {
  Maps maps;
  const bf16* bias;       // (1, H, N, M)
  const int8_t* kv_mask;  // (B, M), 0 = masked
  const float* lse;       // (B, H, N)
  const float* delta;     // (B, H, N)
  bf16* dq;               // (B, N, H, D)
  bf16* dk;               // (B, M, H, D)
  bf16* dv;               // (B, M, H, D)
  float* dbias;           // (1, H, N, M), kernel 7
  int batch, n, m, h, n_blk, items, subs;
  float scale;
  bool bias_aligned;      // bias rows 16-byte aligned: through its tensor map

  __device__ void unit(int item, int sub, int& b, int& head, int& row0) const {
    int rest = item;
    if (subs == 1) {
      b = item % batch;
      rest = item / batch;
    } else {
      b = sub;
    }
    head = rest / n_blk;
    row0 = (rest % n_blk) * BITEM;
  }
};

// ---------------------------------------------------------------- producer
// DKV: the dK/dV pass (fixed K, V; streamed Q, dO); else the dQ pass (fixed
// Q, dO; streamed K, V).
template <bool DKV>
__device__ __forceinline__ void produce(const Problem& p, unsigned char* base,
                                        uint32_t sbase) {
  using L = Layout;
  const int tid = threadIdx.x - CONSUMERS * WG_THREADS;
  const bool leader = tid == 0;
  const CUtensorMap* mx = DKV ? &p.maps.k : &p.maps.q;
  const CUtensorMap* my = DKV ? &p.maps.v : &p.maps.dout;
  const CUtensorMap* mu = DKV ? &p.maps.q : &p.maps.k;
  const CUtensorMap* mw = DKV ? &p.maps.dout : &p.maps.v;
  const int n_tiles = ((DKV ? p.n : p.m) + BT - 1) / BT;
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    for (int sub = 0; sub < p.subs; ++sub, ++round) {
      int b, head, row0;
      p.unit(item, sub, b, head, row0);
      const int slot = round % 2;
      if (leader) {
        const uint32_t full = sbase + L::slot_full + slot * 8;
        sm90::mbar_wait(sbase + L::slot_empty + slot * 8, ((round / 2) & 1) ^ 1);
        sm90::mbar_arrive_expect(full, L::SLOT);
        const uint32_t dst = sbase + L::slot_off + slot * L::SLOT;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          sm90::tma_load_4d(dst + w * TILE, mx, full, 0, head, row0 + w * BR, b);
          sm90::tma_load_4d(dst + (CONSUMERS + w) * TILE, my, full, 0, head,
                            row0 + w * BR, b);
        }
      }
      const bf16* bias = p.bias + long(head) * p.n * p.m;
      for (int j = 0; j < n_tiles; ++j, ++tile) {
        const int st = tile % L::STAGES;
        const uint32_t full = sbase + L::full + st * 8;
        sm90::mbar_wait(sbase + L::empty + st * 8, ((tile / L::STAGES) & 1) ^ 1);
        const int t0 = j * BT;
        const uint32_t stage = sbase + L::stage_off + st * L::STAGE;
        if (leader) {
          sm90::mbar_arrive_expect(
              full, 2 * TILE + (p.bias_aligned ? CONSUMERS * TILE : 0));
          sm90::tma_load_4d(stage + L::u_off, mu, full, 0, head, t0, b);
          sm90::tma_load_4d(stage + L::w_off, mw, full, 0, head, t0, b);
          if (p.bias_aligned) {
#pragma unroll
            for (int w = 0; w < CONSUMERS; ++w) {
              // (key, query) of the panel's first element
              sm90::tma_load_3d(stage + L::bias_off + w * TILE, &p.maps.bias, full,
                                DKV ? row0 + w * BR : t0, DKV ? t0 : row0 + w * BR,
                                head);
            }
          }
        }
        unsigned char* gstage = base + L::stage_off + st * L::STAGE;
        if (!p.bias_aligned) {
          // Element by element into the swizzled layout TMA would give, a
          // warp on 32 consecutive keys of one query row.
          for (int idx = tid; idx < CONSUMERS * BR * 64; idx += WG_THREADS) {
            const int w = idx / (BR * 64);
            const int r = (idx / 64) % BR;
            const int c = idx % 64;
            const int qi = (DKV ? t0 : row0 + w * BR) + r;
            const int kj = (DKV ? row0 + w * BR : t0) + c;
            *reinterpret_cast<bf16*>(gstage + L::bias_off + w * TILE + r * 128 +
                                     (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
                (qi < p.n && kj < p.m) ? bias[long(qi) * p.m + kj]
                                       : __float2bfloat16(0.f);
          }
        }
        if constexpr (DKV) {
          float* extra = reinterpret_cast<float*>(gstage + L::extra_off);
          if (tid < BT) {
            const int qi = t0 + tid;
            const long at = (long(b) * p.h + head) * p.n + qi;
            extra[tid] = qi < p.n ? -p.lse[at] * LOG2E : -INFINITY;
            extra[BT + tid] = qi < p.n ? p.delta[at] : 0.f;
          }
        } else if (tid < BT) {
          const int key = t0 + tid;
          gstage[L::extra_off + tid] =
              key < p.m && p.kv_mask[long(b) * p.m + key] != 0;
        }
        sm90::mbar_arrive(full);  // this thread's stores (release)
      }
    }
  }
}

// ---------------------------------------------------------------- consumer
// s = a1·b1ᵀ and d = a2·b2ᵀ over the head dim (m64n64k16, both operands
// K-major in shared memory), issued as one group.
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&d)[32],
                                             uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2) {
  sm90::fence_regs(s);
  sm90::fence_regs(d);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_ss_n64(s, sm90::make_desc(a1 + kk * 32, PANEL_BYTES),
                       sm90::make_desc(b1 + kk * 32, PANEL_BYTES), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_ss_n64(d, sm90::make_desc(a2 + kk * 32, PANEL_BYTES),
                       sm90::make_desc(b2 + kk * 32, PANEL_BYTES), kk > 0);
  }
  sm90::wgmma_commit();
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) sm90::fence_regs(f[c]);
}

__device__ __forceinline__ void copy_frags(uint32_t (&dst)[4][4],
                                           const uint32_t (&src)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[c][e] = src[c][e];
  }
}

// Store a consumer's 64 x 64 fp32 accumulator (times `mul`) as bf16 rows
// row_base + r0 and + 8 of a (rows, H, D) tensor already offset to the head.
__device__ __forceinline__ void store_rows(bf16* dst, long row_stride,
                                           const float (&acc)[32], int row_base,
                                           int n_rows, int r0, int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + r0 + 8 * h;
    if (row >= n_rows) continue;
    bf16* out = dst + long(row) * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * n + 2 * h] * mul,
                                acc[4 * n + 2 * h + 1] * mul);
    }
  }
}

// Kernel 7: this thread's 32 dbias values of the key tile at k0 (rows
// qw + r0 and + 8, in s's layout), as the earlier batch rows left them. All
// loads are issued before any is used, and before the products they overlap
// are waited for: the dbias traffic is latency, not bandwidth, bound.
__device__ __forceinline__ void load_dbias(float (&prev)[32], const float* dbias,
                                           int qw, int k0, int r0, int t, int n_q,
                                           int n_k) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = qw + r0 + 8 * h;
      const int key = k0 + n * 8 + 2 * t;
      const float* slot = dbias + long(qr) * n_k + key;
      if (qr < n_q && key + 1 < n_k && n_k % 2 == 0) {  // 8-byte aligned pair
        const float2 v = *reinterpret_cast<const float2*>(slot);
        prev[4 * n + 2 * h] = v.x;
        prev[4 * n + 2 * h + 1] = v.y;
      } else {
        prev[4 * n + 2 * h] = qr < n_q && key < n_k ? slot[0] : 0.f;
        prev[4 * n + 2 * h + 1] = qr < n_q && key + 1 < n_k ? slot[1] : 0.f;
      }
    }
  }
}

// The dQ pass's view of one key tile: s, dp -> the dS fragments of the four
// 16-key steps. s[4n + 2h + e] is query r0 + 8h of this consumer, key
// 8n + 2t + e of the tile. With DBIAS, prev + ds goes into dbias (row qw + r,
// key k0 + c); prev is 0 for the first batch row.
template <bool DBIAS>
__device__ __forceinline__ void ds_of_tile(
    const float (&s)[32], const float (&dp)[32], uint32_t (&da)[4][4],
    const unsigned char* stage, int wg, int r0, int t, float sl2,
    const float (&nl)[2], const float (&dl)[2], float* dbias,
    const float (&prev)[32], int qw, int k0, int n_q, int n_k) {
  using L = Layout;
  const unsigned char* panel = stage + L::bias_off + wg * TILE;
  const unsigned char* key_ok = stage + L::extra_off;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    const bool ok0 = key_ok[col] != 0;
    const bool ok1 = key_ok[col + 1] != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(
          panel + row * 128 + ((n ^ (row & 7)) << 4) + 4 * t);
      const float x0 = fmaf(s[4 * n + 2 * h], sl2, fmaf(__low2float(b2), LOG2E, nl[h]));
      const float x1 =
          fmaf(s[4 * n + 2 * h + 1], sl2, fmaf(__high2float(b2), LOG2E, nl[h]));
      const float p0 = ok0 ? sm90::exp2_approx(x0) : 0.f;
      const float p1 = ok1 ? sm90::exp2_approx(x1) : 0.f;
      const float ds0 = p0 * (dp[4 * n + 2 * h] - dl[h]);
      const float ds1 = p1 * (dp[4 * n + 2 * h + 1] - dl[h]);
      da[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(ds0, ds1);
      if constexpr (DBIAS) {
        const int qr = qw + row;
        const int key = k0 + col;
        if (qr < n_q) {
          float* slot = dbias + long(qr) * n_k + key;
          const float v0 = prev[4 * n + 2 * h] + ds0;
          const float v1 = prev[4 * n + 2 * h + 1] + ds1;
          if (key + 1 < n_k && n_k % 2 == 0) {
            *reinterpret_cast<float2*>(slot) = make_float2(v0, v1);
          } else {
            if (key < n_k) slot[0] = v0;
            if (key + 1 < n_k) slot[1] = v1;
          }
        }
      }
    }
  }
}

// Kernels 6 (DBIAS false) and 7: the dQ pass. Per key tile j, pipelined:
//   issue S, dP (j+1); issue dQ += dS(j)·K(j); wait S, dP; dS(j+1);
//   wait dQ; hand stage j back.
template <bool DBIAS>
__device__ __forceinline__ void consume_dq(const Problem& p, unsigned char* base,
                                           uint32_t sbase) {
  using L = Layout;
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int n_tiles = (p.m + BT - 1) / BT;
  const float sl2 = p.scale * LOG2E;
  const long hd = long(p.h) * D;

  auto stage_addr = [&](int i) {
    return sbase + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto stage_ptr = [&](int i) {
    return base + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto wait_full = [&](int i) {
    sm90::mbar_wait(sbase + L::full + (i % L::STAGES) * 8, (i / L::STAGES) & 1);
  };
  auto release = [&](int i) {
    sm90::mbar_arrive(sbase + L::empty + (i % L::STAGES) * 8);
  };

  float s[32] = {}, dp[32] = {}, dq[32], prev[32] = {};
  uint32_t da[4][4], da_next[4][4];
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    for (int sub = 0; sub < p.subs; ++sub, ++round) {
      int b, head, row0;
      p.unit(item, sub, b, head, row0);
      const int qw = row0 + wg * BR;  // first query row of this consumer
      const long srow = (long(b) * p.h + head) * p.n;
      float nl[2], dl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = qw + r0 + 8 * h;
        nl[h] = qr < p.n ? -p.lse[srow + qr] * LOG2E : -INFINITY;
        dl[h] = qr < p.n ? p.delta[srow + qr] : 0.f;
      }
      float* dbias = DBIAS ? p.dbias + long(head) * p.n * p.m : nullptr;
      const bool first = sub == 0;
      if (DBIAS && first) {  // no earlier batch row: prev + ds is ds
#pragma unroll
        for (int i = 0; i < 32; ++i) prev[i] = 0.f;
      }
      const int slot = round % 2;
      sm90::mbar_wait(sbase + L::slot_full + slot * 8, (round / 2) & 1);
      const uint32_t sq = sbase + L::slot_off + slot * L::SLOT + wg * TILE;
      const uint32_t sdo = sq + CONSUMERS * TILE;
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;

      // Prologue: dS of tile 0.
      wait_full(tile);
      issue_scores(s, dp, sq, stage_addr(tile) + L::u_off, sdo,
                   stage_addr(tile) + L::w_off);
      if (DBIAS && !first) load_dbias(prev, dbias, qw, 0, r0, t, p.n, p.m);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      ds_of_tile<DBIAS>(s, dp, da, stage_ptr(tile), wg, r0, t, sl2, nl, dl, dbias,
                        prev, qw, 0, p.n, p.m);

      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int i = tile + j;
        wait_full(i + 1);
        sm90::fence_regs(dq);
        fence_frags(da);
        issue_scores(s, dp, sq, stage_addr(i + 1) + L::u_off, sdo,
                     stage_addr(i + 1) + L::w_off);
        sm90::issue_pv(dq, da, stage_addr(i) + L::u_off);  // dq += ds·k
        if (DBIAS && !first) load_dbias(prev, dbias, qw, (j + 1) * BT, r0, t, p.n, p.m);
        sm90::wgmma_wait<1>();  // the scores of tile j+1 are done
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        ds_of_tile<DBIAS>(s, dp, da_next, stage_ptr(i + 1), wg, r0, t, sl2, nl, dl,
                          dbias, prev, qw, (j + 1) * BT, p.n, p.m);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        fence_frags(da);
        release(i);
        copy_frags(da, da_next);
      }
      const int last = tile + n_tiles - 1;
      sm90::fence_regs(dq);
      fence_frags(da);
      sm90::wgmma_fence();
      sm90::issue_pv(dq, da, stage_addr(last) + L::u_off);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      fence_frags(da);
      release(last);
      sm90::mbar_arrive(sbase + L::slot_empty + slot * 8);
      tile += n_tiles;

      store_rows(p.dq + long(b) * p.n * hd + long(head) * D, hd, dq, qw, p.n, r0, t,
                 p.scale);
    }
  }
}

// The dK/dV pass's view of one query tile: sᵀ, dpᵀ -> the Pᵀ and dSᵀ
// fragments of the four 16-query steps. st[4n + 2h + e] is key r0 + 8h of
// this consumer, query 8n + 2t + e of the tile; the bias panel is read
// transposed, (query, key) at its swizzled address.
__device__ __forceinline__ void pds_of_tile(const float (&st)[32],
                                            const float (&dpt)[32],
                                            uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                            const unsigned char* stage, int wg, int r0,
                                            int t, float sl2, const bool (&key_ok)[2]) {
  using L = Layout;
  const unsigned char* panel = stage + L::bias_off + wg * TILE;
  const float* extra = reinterpret_cast<const float*>(stage + L::extra_off);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int q = n * 8 + 2 * t;  // and q + 1
    const float2 nl = *reinterpret_cast<const float2*>(extra + q);
    const float2 dl = *reinterpret_cast<const float2*>(extra + BT + q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = r0 + 8 * h;
      const unsigned char* col = panel + (kr & 7) * 2;
      const float b0 = __bfloat162float(*reinterpret_cast<const bf16*>(
          col + q * 128 + (((kr >> 3) ^ (q & 7)) << 4)));
      const float b1 = __bfloat162float(*reinterpret_cast<const bf16*>(
          col + (q + 1) * 128 + (((kr >> 3) ^ ((q + 1) & 7)) << 4)));
      const float x0 = fmaf(st[4 * n + 2 * h], sl2, fmaf(b0, LOG2E, nl.x));
      const float x1 = fmaf(st[4 * n + 2 * h + 1], sl2, fmaf(b1, LOG2E, nl.y));
      const float p0 = key_ok[h] ? sm90::exp2_approx(x0) : 0.f;
      const float p1 = key_ok[h] ? sm90::exp2_approx(x1) : 0.f;
      pa[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(p0, p1);
      da[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(
          p0 * (dpt[4 * n + 2 * h] - dl.x), p1 * (dpt[4 * n + 2 * h + 1] - dl.y));
    }
  }
}

// Kernel 8: the dK/dV pass. Per query tile j, pipelined:
//   issue Sᵀ, dPᵀ (j+1); issue dV += Pᵀ(j)·dO(j), dK += dSᵀ(j)·Q(j);
//   wait Sᵀ, dPᵀ; Pᵀ, dSᵀ (j+1); wait dV, dK; hand stage j back.
__device__ __forceinline__ void consume_dkv(const Problem& p, unsigned char* base,
                                            uint32_t sbase) {
  using L = Layout;
  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int r0 = warp * 16 + lane / 4;  // this thread's keys: r0 and r0 + 8
  const int n_tiles = (p.n + BT - 1) / BT;
  const float sl2 = p.scale * LOG2E;
  const long hd = long(p.h) * D;

  auto stage_addr = [&](int i) {
    return sbase + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto stage_ptr = [&](int i) {
    return base + L::stage_off + (i % L::STAGES) * L::STAGE;
  };
  auto wait_full = [&](int i) {
    sm90::mbar_wait(sbase + L::full + (i % L::STAGES) * 8, (i / L::STAGES) & 1);
  };
  auto release = [&](int i) {
    sm90::mbar_arrive(sbase + L::empty + (i % L::STAGES) * 8);
  };
  // dv += pᵀ·dO and dk += dsᵀ·q over the query tile at `stage`.
  auto issue_dkv = [&](float (&dk)[32], float (&dv)[32], const uint32_t (&pa)[4][4],
                       const uint32_t (&da)[4][4], uint32_t stage) {
    sm90::issue_pv(dv, pa, stage + L::w_off);
    sm90::issue_pv(dk, da, stage + L::u_off);
  };

  float st[32] = {}, dpt[32] = {}, dk[32], dv[32];
  uint32_t pa[4][4], da[4][4], pa_next[4][4], da_next[4][4];
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    int b, head, row0;
    p.unit(item, 0, b, head, row0);
    const int kw = row0 + wg * BR;  // first key row of this consumer
    bool key_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw + r0 + 8 * h;
      key_ok[h] = key < p.m && p.kv_mask[long(b) * p.m + key] != 0;
    }
    const int slot = round % 2;
    sm90::mbar_wait(sbase + L::slot_full + slot * 8, (round / 2) & 1);
    const uint32_t sk = sbase + L::slot_off + slot * L::SLOT + wg * TILE;
    const uint32_t sv = sk + CONSUMERS * TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    wait_full(tile);
    issue_scores(st, dpt, sk, stage_addr(tile) + L::u_off, sv,
                 stage_addr(tile) + L::w_off);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    pds_of_tile(st, dpt, pa, da, stage_ptr(tile), wg, r0, t, sl2, key_ok);

    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int i = tile + j;
      wait_full(i + 1);
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pa);
      fence_frags(da);
      issue_scores(st, dpt, sk, stage_addr(i + 1) + L::u_off, sv,
                   stage_addr(i + 1) + L::w_off);
      issue_dkv(dk, dv, pa, da, stage_addr(i));
      sm90::wgmma_wait<2>();  // the scores of tile j+1 are done
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      pds_of_tile(st, dpt, pa_next, da_next, stage_ptr(i + 1), wg, r0, t, sl2, key_ok);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pa);
      fence_frags(da);
      release(i);
      copy_frags(pa, pa_next);
      copy_frags(da, da_next);
    }
    const int last = tile + n_tiles - 1;
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    fence_frags(pa);
    fence_frags(da);
    sm90::wgmma_fence();
    issue_dkv(dk, dv, pa, da, stage_addr(last));
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    fence_frags(pa);
    fence_frags(da);
    release(last);
    sm90::mbar_arrive(sbase + L::slot_empty + slot * 8);
    tile += n_tiles;

    const long off = long(b) * p.m * hd + long(head) * D;
    store_rows(p.dk + off, hd, dk, kw, p.m, r0, t, p.scale);
    store_rows(p.dv + off, hd, dv, kw, p.m, r0, t, 1.f);
  }
}

// A persistent block: barrier set-up, then the producer warpgroup and the
// two consumer warpgroups run apart to the end (one if-else, so that
// setmaxnreg takes effect), over the items blockIdx.x, + gridDim.x, ...
template <bool DKV, bool DBIAS>
__device__ __forceinline__ void backward_persistent(const Problem& p,
                                                    unsigned char* smem_raw) {
  using L = Layout;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sbase - raw);
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::STAGES; ++st) {
      // full: every producer thread (its stores) and the leader's
      // expect-tx arrival; then the TMA bytes
      sm90::mbar_init(sbase + L::full + st * 8, WG_THREADS + 1);
      sm90::mbar_init(sbase + L::empty + st * 8, CONSUMERS * WG_THREADS);
    }
    for (int slot = 0; slot < 2; ++slot) {
      sm90::mbar_init(sbase + L::slot_full + slot * 8, 1);  // the leader; TMA bytes
      sm90::mbar_init(sbase + L::slot_empty + slot * 8, CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce<DKV>(p, base, sbase);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if constexpr (DKV) {
      consume_dkv(p, base, sbase);
    } else {
      consume_dq<DBIAS>(p, base, sbase);
    }
  }
}

}  // namespace sm90bwd
}  // namespace mrb
