// The backward of the flash attention on Hopper (sm_90a), bf16, head dim 64,
// on the primitives of attention_tile_sm90.cuh, in two bias kinds:
//  * kBiasTile: the biased flash attention's dQ pass (kernels 6 and 7) and
//    dK/dV pass (kernel 8) of flash_bias_backward.cu, the bias read from a
//    (1, H, N, M) tensor;
//  * kRelpos: the in-kernel rel-pos flash attention's dQ pass (kernels 10
//    and 11) and dK/dV pass (kernel 12) of flash_relpos_backward.cu, the bias
//    looked up from the (H, num_buckets) table.
//
// Each pass recomputes p = exp(q·kᵀ·scale + bias - lse) on valid keys (0 on
// masked ones) from the forward's row logsumexp and, with δ = rowsum(dO∘O)
// computed outside in fp32: dp = dO·vᵀ, ds = p∘(dp - δ); the dQ pass
// accumulates dq = ds·k·scale (kernel 7 also dbias = Σ_b ds, kernel 11
// dtable[h][u] = Σ ds over bucket(key - query) = u), the dK/dV pass
// dk = dsᵀ·q·scale and dv = pᵀ·dO. Two passes and no atomics, as the TPU
// kernels have it, so every output comes out the same from run to run.
//
// What bounds them on this card is the tensor cores: 3 (dQ) and 4 (dK/dV)
// products of 2·N·M·D flops per (batch row, head), against one read of the
// (1, H, N, M) bf16 bias per head (kBiasTile) or none at all (kRelpos). The
// `mma.sync` tiles they replace reached 4-14% of the bf16 peak: synchronous
// loads between two __syncthreads(), B operands packed from scalar shared
// loads, 64-row blocks, and (kRelpos) a clamp and a lookup for every score.
// Here, as in the forward's tile:
//
//  * a block is three warpgroups: warpgroup 2 produces, 0 and 1 consume 64
//    rows each of a 128-row work item. The block is persistent. kBiasTile
//    walks its items with the batch row fastest, so the blocks that read one
//    bias box run side by side and the bias comes from device memory once
//    per head; kRelpos walks them with the 128-row block fastest, so the
//    blocks of one (batch row, head) run side by side and re-read its
//    streamed K/V or Q/dO from L2;
//  * a work item's fixed operands (dQ pass: Q and dO of 128 queries; dK/dV
//    pass: K and V of 128 keys) come by TMA into one of two slots, the next
//    item's while the current one runs. The streamed operands (dQ: K, V of 64
//    keys; dK/dV: Q, dO of 64 queries) and the bias come by TMA into a ring of
//    up to 4 stages on full/empty mbarriers. The producer also stores what
//    TMA cannot bring: the 64 key-mask flags (dQ) or -lse·log2(e) and δ of
//    the 64 queries (dK/dV), and the bias element by element when its rows
//    are not 16-byte aligned (M % 8 != 0);
//  * kBiasTile: the bias arrives as two 64 x 64 panels a stage, one a
//    consumer, 64 query rows of 128 bytes in the 128-byte swizzle: in the dQ
//    pass the consumer's queries by the tile's keys, in the dK/dV pass the
//    tile's queries by the consumer's keys (one tensor map, box 64 x 64, for
//    both). The dK/dV pass reads its panel transposed, one 2-byte element at
//    the swizzled address of (query, key): the 4 query rows a warp reads at
//    once land on distinct 16-byte chunks, so the reads are free of conflicts;
//  * kRelpos: no bias bytes at all. A stage is the two streamed tiles and the
//    extras. Per work item the producer stores the head's 2*maxd + 1 values
//    rel[c] = table[lut[c]]·log2(e) (c = clamp(key - query, -maxd, maxd) +
//    maxd) beside the item's slot, and for kernel 11 once the bucket of each
//    c. A consumer's 64 x 64 tile whose every key - query lies at or past the
//    wrapper's far thresholds (all in the bucket of -maxd, or all in that of
//    +maxd) adds its one value to the exponent's FMA operand, with no index
//    arithmetic; only the tiles near the diagonal (at most 7 of 125 a row at
//    8,000 positions for T5's buckets) look a value up per score. Kernel 11
//    sums a far tile's ds in registers and adds it once per item to the
//    bucket of its side; a near tile's ds go into per-thread bins in shared
//    memory (bin u of consumer thread c at u * 256 + c: a warp never shares
//    a bank). At the end of an item each consumer warpgroup sums its bins in
//    thread order into one partial per (batch row, 64-row block, head, bucket)
//    - a consumer with no valid row writes zeros - and the second kernel of
//    flash_relpos_backward.cu sums the partials in block order;
//  * every product is `wgmma.mma_async`, fp32 accumulation. S = Q·Kᵀ and
//    dP = dO·Vᵀ (dK/dV: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ) read both operands from
//    shared memory (m64n64k16). P and dS stay in registers: the accumulator
//    layout of S is reused as the A fragment of dQ += dS·K (dK/dV: dV += Pᵀ·dO
//    and dK += dSᵀ·Q), whose B operand is read through the transpose bit;
//  * each tile is software-pipelined as the forward's: the score products
//    of tile j+1 and the accumulating products of tile j are in flight
//    together while the consumer turns the scores of tile j+1 into P and dS;
//    empty register fences keep the compiler from moving register reads or
//    writes across an asynchronous `wgmma`. The dS (dQ pass) and P/dS (dK/dV
//    pass) fragments alternate between two sets, the loop unrolled by two:
//    the tile whose products are in flight reads one set while the next
//    tile's values go to the other. A copy from one set to the other lets
//    the register allocator merge them, and ptxas then serializes every
//    `wgmma` of the kernel (C7513) to stay correct;
//  * p = exp2(s·scale·log2e + bias·log2e - lse·log2e): one ex2 and two FMAs
//    a score. Query rows past N get lse = +inf and keys past M or masked get
//    p = 0, so they add nothing; a batch row whose keys are all masked gives
//    zeros. Nothing is padded or copied in device memory: TMA zero-fills the
//    rows past the extents, and a consumer with no valid row still waits on
//    and arrives at every barrier;
//  * setmaxnreg gives the consumers 232 registers a thread (the dK/dV
//    consumer holds Sᵀ, dPᵀ, dK and dV: 4 x 32 fp32, and the fragments of two
//    tiles) and the producer 40.
#pragma once

#include "attention_tile_sm90.cuh"

namespace mrb {
namespace sm90bwd {

using sm90::bf16;
using sm90::CONSUMERS;
using sm90::kBiasTile;
using sm90::kRelpos;
using sm90::LOG2E;
using sm90::NTHREADS;
using sm90::PANEL_BYTES;
using sm90::WG_THREADS;

constexpr int D = 64;                 // the only head dim (T5 d_kv)
constexpr int BR = 64;                // rows a consumer owns
constexpr int BITEM = BR * CONSUMERS;  // rows of a work item
constexpr int BT = 64;                // streamed rows a tile
constexpr int TILE = BT * 128;        // one 64 x 64 bf16 tile, swizzled
constexpr int MAX_BUCKETS = 32;       // kernel 11's bins a thread
constexpr int BIN_STRIDE = CONSUMERS * WG_THREADS;  // between a thread's bins

// Shared-memory carve-up from a 1024-byte aligned base. GRAD under kRelpos
// (kernel 11) adds the bucket lut and the bins; under kBiasTile it changes
// nothing.
template <int BIAS, bool GRAD>
struct Layout {
  static constexpr bool REL = BIAS == kRelpos;
  // Two slots of a work item's fixed operands: X (Q or K) of consumer w at
  // w * TILE, Y (dO or V) at (CONSUMERS + w) * TILE.
  static constexpr int SLOT = 2 * CONSUMERS * TILE;
  static constexpr int slot_off = 0;
  // kRelpos: a slot's item's rel values (2 * maxd + 1 floats); kernel 11:
  // the bucket of each clamped relative position (uint8) and the bins.
  static constexpr int REL_SLOT = REL ? (2 * sm90::MAX_REL_DISTANCE + 2) * 4 : 0;
  static constexpr int rel_off = 2 * SLOT;
  static constexpr int LUT_BYTES = REL && GRAD ? 2 * sm90::MAX_REL_DISTANCE + 2 : 0;
  static constexpr int lut_off = rel_off + 2 * REL_SLOT;
  static constexpr int BINS_BYTES = REL && GRAD ? MAX_BUCKETS * BIN_STRIDE * 4 : 0;
  static constexpr int bins_off = lut_off + LUT_BYTES;
  static constexpr int stage_off = (bins_off + BINS_BYTES + 1023) / 1024 * 1024;
  // A ring stage: U (K or Q) and W (V or dO) tiles, kBiasTile one bias panel
  // a consumer, then the 64 key flags (dQ) or -lse·log2e and δ (dK/dV).
  static constexpr int u_off = 0;
  static constexpr int w_off = TILE;
  static constexpr int bias_off = 2 * TILE;
  static constexpr int extra_off = bias_off + (REL ? 0 : CONSUMERS * TILE);
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

// One launch. A work item is (batch row, head, 128 rows): kBiasTile with
// the batch row fastest, kRelpos (REL) with the 128-row block fastest; with
// `subs` > 1 (kernel 7) it is (head, 128 rows) and the block walks the batch
// rows 0..subs-1 inside it, in order.
struct Problem {
  Maps maps;
  const bf16* bias;       // (1, H, N, M), kBiasTile
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
  // kRelpos: the (H, nb) table, the bucket of each of the 2 * maxd + 1
  // clamped relative positions, the far thresholds (every key - query <=
  // past has the bucket lut[0], every one >= future the bucket lut[2 maxd])
  // and, for kernel 11, the (B * 2 * n_blk, H, nb) partial sums.
  const float* table;
  const int* lut;
  float* partial;
  int nb, maxd, past, future;

  template <bool REL>
  __device__ void unit(int item, int sub, int& b, int& head, int& row0) const {
    int rest = item;
    if (REL) {
      row0 = (item % n_blk) * BITEM;
      rest = item / n_blk;
      head = rest % h;
      b = rest / h;
      return;
    }
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
template <bool DKV, int BIAS, bool GRAD>
__device__ __forceinline__ void produce(const Problem& p, unsigned char* base,
                                        uint32_t sbase) {
  using L = Layout<BIAS, GRAD>;
  constexpr bool REL = BIAS == kRelpos;
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
      p.unit<REL>(item, sub, b, head, row0);
      const int slot = round % 2;
      const uint32_t slot_full = sbase + L::slot_full + slot * 8;
      // kRelpos: every producer thread stores into the slot's rel values,
      // which the consumers are done with once the slot is empty.
      if (REL || leader) {
        sm90::mbar_wait(sbase + L::slot_empty + slot * 8, ((round / 2) & 1) ^ 1);
      }
      if (leader) {
        sm90::mbar_arrive_expect(slot_full, L::SLOT);
        const uint32_t dst = sbase + L::slot_off + slot * L::SLOT;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) {
          sm90::tma_load_4d(dst + w * TILE, mx, slot_full, 0, head, row0 + w * BR, b);
          sm90::tma_load_4d(dst + (CONSUMERS + w) * TILE, my, slot_full, 0, head,
                            row0 + w * BR, b);
        }
      }
      if constexpr (REL) {
        float* rel = reinterpret_cast<float*>(base + L::rel_off + slot * L::REL_SLOT);
        const float* table = p.table + long(head) * p.nb;
        for (int c = tid; c <= 2 * p.maxd; c += WG_THREADS) {
          rel[c] = table[p.lut[c]] * LOG2E;
          // The buckets are the same for every item: stored once, before
          // the first slot's arrival.
          if (GRAD && round == 0) base[L::lut_off + c] = (unsigned char)p.lut[c];
        }
        sm90::mbar_arrive(slot_full);  // these stores (release)
      }
      const bf16* bias = REL ? nullptr : p.bias + long(head) * p.n * p.m;
      for (int j = 0; j < n_tiles; ++j, ++tile) {
        const int st = tile % L::STAGES;
        const uint32_t full = sbase + L::full + st * 8;
        sm90::mbar_wait(sbase + L::empty + st * 8, ((tile / L::STAGES) & 1) ^ 1);
        const int t0 = j * BT;
        const uint32_t stage = sbase + L::stage_off + st * L::STAGE;
        const bool bias_box = !REL && p.bias_aligned;
        if (leader) {
          sm90::mbar_arrive_expect(full, 2 * TILE + (bias_box ? CONSUMERS * TILE : 0));
          sm90::tma_load_4d(stage + L::u_off, mu, full, 0, head, t0, b);
          sm90::tma_load_4d(stage + L::w_off, mw, full, 0, head, t0, b);
          if (bias_box) {
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
        if (!REL && !p.bias_aligned) {
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

// The dQ pass's view of one key tile (kBiasTile): s, dp -> the dS fragments
// of the four 16-key steps. s[4n + 2h + e] is query r0 + 8h of this
// consumer, key 8n + 2t + e of the tile. With DBIAS, prev + ds goes into
// dbias (row qw + r, key k0 + c); prev is 0 for the first batch row.
template <bool DBIAS>
__device__ __forceinline__ void ds_of_tile(
    const float (&s)[32], const float (&dp)[32], uint32_t (&da)[4][4],
    const unsigned char* stage, int wg, int r0, int t, float sl2,
    const float (&nl)[2], const float (&dl)[2], float* dbias,
    const float (&prev)[32], int qw, int k0, int n_q, int n_k) {
  using L = Layout<kBiasTile, DBIAS>;
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

// A kRelpos work item's view of its bias: the slot's rel values (times
// log2e), the buckets and this thread's first bin (kernel 11), the far
// thresholds and the two far values, and kernel 11's sums of the far tiles'
// ds of this thread.
struct RelItem {
  const float* rel;
  const unsigned char* lut;
  float* bins;
  int maxd, past, future;
  float v_past, v_future;
  float sum_past, sum_future;
};

// The dQ pass's view of one key tile (kRelpos): as ds_of_tile, with the bias
// of a far tile one value and of a near one looked up per score; DTAB adds
// each ds to dtable's sums.
template <bool DTAB>
__device__ __forceinline__ void ds_of_tile_rel(
    const float (&s)[32], const float (&dp)[32], uint32_t (&da)[4][4],
    const unsigned char* stage, int r0, int t, float sl2, const float (&nl)[2],
    const float (&dl)[2], RelItem& ri, int qw, int k0) {
  using L = Layout<kRelpos, DTAB>;
  const unsigned char* key_ok = stage + L::extra_off;
  // key - query over the tile: [k0 - (qw + 63), k0 + 63 - qw]; uniform
  // across the warpgroup.
  const int hi = k0 + BT - 1 - qw;
  const int lo = k0 - (qw + BR - 1);
  if (hi <= ri.past || lo >= ri.future) {
    const bool past = hi <= ri.past;
    const float c = past ? ri.v_past : ri.v_future;
    const float nlc[2] = {nl[0] + c, nl[1] + c};
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t;
      const bool ok0 = key_ok[col] != 0;
      const bool ok1 = key_ok[col + 1] != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ok0 ? sm90::exp2_approx(fmaf(s[4 * n + 2 * h], sl2, nlc[h])) : 0.f;
        const float p1 =
            ok1 ? sm90::exp2_approx(fmaf(s[4 * n + 2 * h + 1], sl2, nlc[h])) : 0.f;
        const float ds0 = p0 * (dp[4 * n + 2 * h] - dl[h]);
        const float ds1 = p1 * (dp[4 * n + 2 * h + 1] - dl[h]);
        da[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(ds0, ds1);
        if constexpr (DTAB) sum += ds0 + ds1;
      }
    }
    if constexpr (DTAB) {
      if (past) {
        ri.sum_past += sum;
      } else {
        ri.sum_future += sum;
      }
    }
    return;
  }
  const int maxd = ri.maxd;
  // key - query of s[4n + 2h + e]: base + 8n - 8h + e
  const int base = k0 + 2 * t - (qw + r0);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    const bool ok0 = key_ok[col] != 0;
    const bool ok1 = key_ok[col + 1] != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = base + 8 * n - 8 * h;
      const int c0 = min(max(rr, -maxd), maxd) + maxd;
      const int c1 = min(max(rr + 1, -maxd), maxd) + maxd;
      const float p0 =
          ok0 ? sm90::exp2_approx(fmaf(s[4 * n + 2 * h], sl2, ri.rel[c0] + nl[h])) : 0.f;
      const float p1 =
          ok1 ? sm90::exp2_approx(fmaf(s[4 * n + 2 * h + 1], sl2, ri.rel[c1] + nl[h]))
              : 0.f;
      const float ds0 = p0 * (dp[4 * n + 2 * h] - dl[h]);
      const float ds1 = p1 * (dp[4 * n + 2 * h + 1] - dl[h]);
      da[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(ds0, ds1);
      if constexpr (DTAB) {
        ri.bins[ri.lut[c0] * BIN_STRIDE] += ds0;
        ri.bins[ri.lut[c1] * BIN_STRIDE] += ds1;
      }
    }
  }
}

// Kernel 11, at the end of an item: this consumer warpgroup's dtable sums
// (its far tiles' and its bins, in thread order) into the item's partial of
// its 64-row block, then its bins back to zero. `wg_tid` is the thread's
// index in its warpgroup.
__device__ __forceinline__ void flush_bins(const Problem& p, RelItem& ri, int wg,
                                           int wg_tid, int b, int head, int row0) {
  ri.bins[ri.lut[0] * BIN_STRIDE] += ri.sum_past;
  ri.bins[ri.lut[2 * ri.maxd] * BIN_STRIDE] += ri.sum_future;
  // Named barrier 1 + wg over this warpgroup's 128 threads.
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG_THREADS) : "memory");
  // Bucket u is summed by lane 4 * (u % 8) of warp u / 8: the 128 bins of a
  // bucket share a bank, so 8 readers a warp rather than 32.
  const int lane = wg_tid % 32;
  const int u = (wg_tid / 32) * 8 + lane / 4;
  if (lane % 4 == 0 && u < p.nb) {
    const float* col = ri.bins - wg_tid + u * BIN_STRIDE;  // thread 0's bin u
    float sum = 0.f;
    for (int i = 0; i < WG_THREADS; ++i) sum += col[i];
    const long block = long(b) * 2 * p.n_blk + row0 / BR + wg;
    p.partial[(block * p.h + head) * p.nb + u] = sum;
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG_THREADS) : "memory");
  for (int u = 0; u < p.nb; ++u) ri.bins[u * BIN_STRIDE] = 0.f;
}

// Kernels 6 (kBiasTile, GRAD false), 7 (kBiasTile, dbias), 10 (kRelpos) and
// 11 (kRelpos, dtable): the dQ pass. Per key tile j, pipelined:
//   issue S, dP (j+1); issue dQ += dS(j)·K(j); wait S, dP; dS(j+1);
//   wait dQ; hand stage j back.
template <int BIAS, bool GRAD>
__device__ __forceinline__ void consume_dq(const Problem& p, unsigned char* base,
                                           uint32_t sbase) {
  using L = Layout<BIAS, GRAD>;
  constexpr bool REL = BIAS == kRelpos;
  constexpr bool DBIAS = GRAD && !REL;
  constexpr bool DTAB = GRAD && REL;
  const int wg = sm90::warpgroup_index();
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

  RelItem ri{};
  if constexpr (DTAB) {
    ri.lut = base + L::lut_off;
    ri.bins = reinterpret_cast<float*>(base + L::bins_off) + wg * WG_THREADS + tid;
    for (int u = 0; u < p.nb; ++u) ri.bins[u * BIN_STRIDE] = 0.f;
  }
  float s[32] = {}, dp[32] = {}, dq[32], prev[32] = {};
  // The dS fragments in ping-pong (see the header).
  uint32_t da0[4][4], da1[4][4];
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    for (int sub = 0; sub < p.subs; ++sub, ++round) {
      int b, head, row0;
      p.unit<REL>(item, sub, b, head, row0);
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
      if constexpr (REL) {
        ri.rel = reinterpret_cast<const float*>(base + L::rel_off + slot * L::REL_SLOT);
        ri.maxd = p.maxd;
        ri.past = p.past;
        ri.future = p.future;
        ri.v_past = ri.rel[0];
        ri.v_future = ri.rel[2 * p.maxd];
        ri.sum_past = ri.sum_future = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;

      // dS of the tile at ring position i (keys from k0) into `out`.
      auto ds_tile = [&](uint32_t (&out)[4][4], int i, int k0) {
        if constexpr (REL) {
          ds_of_tile_rel<DTAB>(s, dp, out, stage_ptr(i), r0, t, sl2, nl, dl, ri, qw, k0);
        } else {
          ds_of_tile<DBIAS>(s, dp, out, stage_ptr(i), wg, r0, t, sl2, nl, dl, dbias,
                            prev, qw, k0, p.n, p.m);
        }
      };

      // Prologue: dS of tile 0.
      wait_full(tile);
      issue_scores(s, dp, sq, stage_addr(tile) + L::u_off, sdo,
                   stage_addr(tile) + L::w_off);
      if (DBIAS && !first) load_dbias(prev, dbias, qw, 0, r0, t, p.n, p.m);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      ds_tile(da0, tile, 0);

      // Tile j's dq += ds·k from `din` beside tile j+1's scores, whose dS
      // go to `dout`.
      auto step = [&](uint32_t (&din)[4][4], uint32_t (&dout)[4][4], int j) {
        const int i = tile + j;
        wait_full(i + 1);
        sm90::fence_regs(dq);
        fence_frags(din);
        issue_scores(s, dp, sq, stage_addr(i + 1) + L::u_off, sdo,
                     stage_addr(i + 1) + L::w_off);
        sm90::issue_pv(dq, din, stage_addr(i) + L::u_off);  // dq += ds·k
        if (DBIAS && !first) load_dbias(prev, dbias, qw, (j + 1) * BT, r0, t, p.n, p.m);
        sm90::wgmma_wait<1>();  // the scores of tile j+1 are done
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        ds_tile(dout, i + 1, (j + 1) * BT);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        fence_frags(din);
        release(i);
      };
      auto last_dq = [&](uint32_t (&din)[4][4]) {
        sm90::fence_regs(dq);
        fence_frags(din);
        sm90::wgmma_fence();
        sm90::issue_pv(dq, din, stage_addr(tile + n_tiles - 1) + L::u_off);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        fence_frags(din);
      };
      int j = 0;
      for (; j + 2 < n_tiles; j += 2) {
        step(da0, da1, j);
        step(da1, da0, j + 1);
      }
      if (j + 1 < n_tiles) {
        step(da0, da1, j);
        last_dq(da1);
      } else {
        last_dq(da0);
      }
      release(tile + n_tiles - 1);
      sm90::mbar_arrive(sbase + L::slot_empty + slot * 8);
      tile += n_tiles;

      store_rows(p.dq + long(b) * p.n * hd + long(head) * D, hd, dq, qw, p.n, r0, t,
                 p.scale);
      if constexpr (DTAB) flush_bins(p, ri, wg, tid, b, head, row0);
    }
  }
}

// The dK/dV pass's view of one query tile (kBiasTile): sᵀ, dpᵀ -> the Pᵀ and
// dSᵀ fragments of the four 16-query steps. st[4n + 2h + e] is key r0 + 8h
// of this consumer, query 8n + 2t + e of the tile; the bias panel is read
// transposed, (query, key) at its swizzled address.
__device__ __forceinline__ void pds_of_tile(const float (&st)[32],
                                            const float (&dpt)[32],
                                            uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                            const unsigned char* stage, int wg, int r0,
                                            int t, float sl2, const bool (&key_ok)[2]) {
  using L = Layout<kBiasTile, false>;
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

// The dK/dV pass's view of one query tile (kRelpos): as pds_of_tile, with
// the bias of a far tile one value and of a near one looked up per score.
__device__ __forceinline__ void pds_of_tile_rel(const float (&st)[32],
                                                const float (&dpt)[32],
                                                uint32_t (&pa)[4][4],
                                                uint32_t (&da)[4][4],
                                                const unsigned char* stage, int r0,
                                                int t, float sl2,
                                                const bool (&key_ok)[2],
                                                const RelItem& ri, int kw, int t0) {
  using L = Layout<kRelpos, false>;
  const float* extra = reinterpret_cast<const float*>(stage + L::extra_off);
  // key - query over the tile: [kw - (t0 + 63), kw + 63 - t0]; uniform
  // across the warpgroup.
  const int hi = kw + BR - 1 - t0;
  const int lo = kw - (t0 + BT - 1);
  const bool far = hi <= ri.past || lo >= ri.future;
  const float c = hi <= ri.past ? ri.v_past : ri.v_future;
  const int maxd = ri.maxd;
  // key - query of st[4n + 2h + e]: base + 8h - 8n - e
  const int base = kw + r0 - t0 - 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int q = n * 8 + 2 * t;  // and q + 1
    const float2 nl = *reinterpret_cast<const float2*>(extra + q);
    const float2 dl = *reinterpret_cast<const float2*>(extra + BT + q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a0, a1;  // the exponent's operand: bias·log2e - lse·log2e
      if (far) {
        a0 = nl.x + c;
        a1 = nl.y + c;
      } else {
        const int rr = base + 8 * h - 8 * n;
        a0 = nl.x + ri.rel[min(max(rr, -maxd), maxd) + maxd];
        a1 = nl.y + ri.rel[min(max(rr - 1, -maxd), maxd) + maxd];
      }
      const float p0 =
          key_ok[h] ? sm90::exp2_approx(fmaf(st[4 * n + 2 * h], sl2, a0)) : 0.f;
      const float p1 =
          key_ok[h] ? sm90::exp2_approx(fmaf(st[4 * n + 2 * h + 1], sl2, a1)) : 0.f;
      pa[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(p0, p1);
      da[n / 2][(n % 2) * 2 + h] = sm90::pack_bf16x2(
          p0 * (dpt[4 * n + 2 * h] - dl.x), p1 * (dpt[4 * n + 2 * h + 1] - dl.y));
    }
  }
}

// Kernels 8 (kBiasTile) and 12 (kRelpos): the dK/dV pass. Per query tile j,
// pipelined:
//   issue Sᵀ, dPᵀ (j+1); issue dV += Pᵀ(j)·dO(j), dK += dSᵀ(j)·Q(j);
//   wait Sᵀ, dPᵀ; Pᵀ, dSᵀ (j+1); wait dV, dK; hand stage j back.
template <int BIAS>
__device__ __forceinline__ void consume_dkv(const Problem& p, unsigned char* base,
                                            uint32_t sbase) {
  using L = Layout<BIAS, false>;
  constexpr bool REL = BIAS == kRelpos;
  const int wg = sm90::warpgroup_index();
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

  RelItem ri{};
  float st[32] = {}, dpt[32] = {}, dk[32], dv[32];
  // The Pᵀ and dSᵀ fragments in ping-pong (see the header).
  uint32_t pa0[4][4], da0[4][4], pa1[4][4], da1[4][4];
  int tile = 0;
  int round = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++round) {
    int b, head, row0;
    p.unit<REL>(item, 0, b, head, row0);
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
    if constexpr (REL) {
      ri.rel = reinterpret_cast<const float*>(base + L::rel_off + slot * L::REL_SLOT);
      ri.maxd = p.maxd;
      ri.past = p.past;
      ri.future = p.future;
      ri.v_past = ri.rel[0];
      ri.v_future = ri.rel[2 * p.maxd];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    // Pᵀ and dSᵀ of the tile at ring position i (queries from t0).
    auto pds_tile = [&](uint32_t (&pout)[4][4], uint32_t (&dout)[4][4], int i, int t0) {
      if constexpr (REL) {
        pds_of_tile_rel(st, dpt, pout, dout, stage_ptr(i), r0, t, sl2, key_ok, ri, kw,
                        t0);
      } else {
        pds_of_tile(st, dpt, pout, dout, stage_ptr(i), wg, r0, t, sl2, key_ok);
      }
    };

    wait_full(tile);
    issue_scores(st, dpt, sk, stage_addr(tile) + L::u_off, sv,
                 stage_addr(tile) + L::w_off);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    pds_tile(pa0, da0, tile, 0);

    // Tile j's dV, dK from (pin, din) beside tile j+1's scores, whose Pᵀ
    // and dSᵀ go to (pout, dout).
    auto step = [&](uint32_t (&pin)[4][4], uint32_t (&din)[4][4],
                    uint32_t (&pout)[4][4], uint32_t (&dout)[4][4], int j) {
      const int i = tile + j;
      wait_full(i + 1);
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pin);
      fence_frags(din);
      issue_scores(st, dpt, sk, stage_addr(i + 1) + L::u_off, sv,
                   stage_addr(i + 1) + L::w_off);
      issue_dkv(dk, dv, pin, din, stage_addr(i));
      sm90::wgmma_wait<2>();  // the scores of tile j+1 are done
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      pds_tile(pout, dout, i + 1, (j + 1) * BT);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pin);
      fence_frags(din);
      release(i);
    };
    auto last_dkv = [&](uint32_t (&pin)[4][4], uint32_t (&din)[4][4]) {
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pin);
      fence_frags(din);
      sm90::wgmma_fence();
      issue_dkv(dk, dv, pin, din, stage_addr(tile + n_tiles - 1));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      fence_frags(pin);
      fence_frags(din);
    };
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {
      step(pa0, da0, pa1, da1, j);
      step(pa1, da1, pa0, da0, j + 1);
    }
    if (j + 1 < n_tiles) {
      step(pa0, da0, pa1, da1, j);
      last_dkv(pa1, da1);
    } else {
      last_dkv(pa0, da0);
    }
    release(tile + n_tiles - 1);
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
template <bool DKV, int BIAS, bool GRAD>
__device__ __forceinline__ void backward_persistent(const Problem& p,
                                                    unsigned char* smem_raw) {
  using L = Layout<BIAS, GRAD>;
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
      // the leader and its TMA bytes; kRelpos also every producer thread
      // (its rel-value stores)
      sm90::mbar_init(sbase + L::slot_full + slot * 8,
                      1 + (BIAS == kRelpos ? WG_THREADS : 0));
      sm90::mbar_init(sbase + L::slot_empty + slot * 8, CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce<DKV, BIAS, GRAD>(p, base, sbase);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if constexpr (DKV) {
      consume_dkv<BIAS>(p, base, sbase);
    } else {
      consume_dq<BIAS, GRAD>(p, base, sbase);
    }
  }
}

}  // namespace sm90bwd
}  // namespace mrb
