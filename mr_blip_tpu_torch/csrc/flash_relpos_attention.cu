// Flash self-attention with the T5 bidirectional relative-position bias
// computed inside the kernel from the (H, num_buckets) table, a (B, N) key
// mask, and the fp32 row logsumexp. No (1, H, N, N) bias exists anywhere.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_flash_relpos_stats_kernel
// (_flash_relpos_fwd_stats, pallas_call :965): the T5 encoder self-attention
// of the long-context path (relpos_in_kernel), B=4, N=M~7,944 at 240 frames,
// H=32, D=64; the forward of the custom VJP and, with the lse unused, of
// inference.
//
// Bound on this card: 4*B*H*N*N*D flops (2.1 PFLOP at 4 x 8,000: 2.12 ms at
// the bf16 peak) against q, k, v and out read or written once (0.26 GB; the
// bias costs no device-memory traffic at all), so the tensor-core math
// bounds it at every length the dispatch sends here (N >= 256).
//
// Design (bf16): the Hopper tile of attention_tile_sm90.cuh in its rel-pos
// mode: warp-specialised persistent blocks of 128 queries, `wgmma` for both
// products, K/V by TMA into a ring of 4 stages, the 64 key-mask flags stored
// by the producer. Work items are (query block, head, batch row), query
// block fastest, so the blocks of one (batch row, head) share its K/V in L2
// (no bias tile to share across batch rows, as kernel 3's order does). The
// TPU kernel selects each bias value with a num_buckets-way compare; here the
// bias depends only on clamp(key - query, -maxd, maxd), so the wrapper hands
// in the bucket of each of those 2*maxd + 1 relative positions (the
// bit-exact host bucket function: no device logf can flip a bucket) and the
// producer builds table[head][bucket[c]] per work item beside its Q slot.
// The TPU kernel's far/near split carries over: a consumer's 64 x 64 tile
// whose every key - query lies at or past the wrapper's far thresholds (one
// bucket) adds one scalar; only the ~6 tiles of 125 near the diagonal look a
// value up per score. Ragged N is exact with no padded copy (TMA zero-fills
// the rows past the end; their keys are masked), and a row whose keys are all
// masked gives zeros and lse = log(1e-30).
//
// fp32 (the parity mode): the CUDA-core body of flash_attention.cu with the
// same lookup (C entry mrb_flash_relpos_fwd_stats_f32 there).
#include <cuda_runtime.h>

#include "attention_tile_sm90.cuh"

namespace mrb {

using sm90::bf16;

namespace {

constexpr int RELPOS_D = 64;  // the only head dim (T5 d_kv)

// One launch: a work item is (query block of 128, head, batch row), query
// block fastest.
struct RelposProblem {
  sm90::Maps maps;
  const float* table;
  const int* lut;
  const int8_t* kv_mask;
  bf16* out;
  float* lse;
  int n, h, nb, maxd, past, future, n_qt, items;
  float scale;

  __device__ void at(int item, sm90::Args& a, int& q0) const {
    q0 = (item % n_qt) * sm90::BQ;
    const int rest = item / n_qt;
    a.head = rest % h;
    a.b = rest / h;
    const long hd = long(h) * RELPOS_D;
    a.o = out + long(a.b) * n * hd + long(a.head) * RELPOS_D;
    a.o_row = hd;
    a.bias = nullptr;
    a.bias_row = 0;
    a.bias_aligned = false;
    a.kv_mask = kv_mask + long(a.b) * n;
    a.n_q = n;
    a.n_k = n;
    a.d = RELPOS_D;
    a.scale = scale;
    a.lse = lse + (long(a.b) * h + a.head) * n;
    a.rel_table = table + long(a.head) * nb;
    a.rel_lut = lut;
    a.rel_maxd = maxd;
    a.rel_past = past;
    a.rel_future = future;
  }
};

__global__ void __launch_bounds__(sm90::NTHREADS, 1)
flash_relpos_fwd_kernel(const __grid_constant__ RelposProblem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90::attention_persistent<RELPOS_D, sm90::kRelpos, false>(p, smem);
}

}  // namespace

}  // namespace mrb

// out (B, N, H, 64) bf16 and lse (B, H, N) fp32 from q, k, v (B, N, H, 64)
// bf16, table (H, nb) fp32, lut (2*maxd + 1,) int32 with values in [0, nb),
// kv_mask (B, N) int8. past / future: the far thresholds (every key - query
// <= past has the bucket lut[0], every key - query >= future the bucket
// lut[2*maxd]; -maxd and maxd always qualify).
extern "C" int mrb_flash_relpos_fwd_stats_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, void* out, void* lse, int b, int n,
    int h, int d, int nb, int maxd, int past, int future, float scale,
    void* stream) {
  using namespace mrb;
  const long n_qt = (n + sm90::BQ - 1) / sm90::BQ;
  if (b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      d != RELPOS_D || nb <= 0 || maxd <= 0 || maxd > sm90::MAX_REL_DISTANCE ||
      past < -maxd || future > maxd || lse == nullptr ||
      long(b) * h * n_qt > 0x7fffffffL) {
    return int(cudaErrorInvalidValue);
  }
  RelposProblem p{};
  const long hd = long(h) * RELPOS_D;
  cudaError_t err = sm90::encode_qkv(&p.maps.q, q, b, n, h, RELPOS_D, n * hd, hd,
                                     RELPOS_D);
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.k, k, b, n, h, RELPOS_D, n * hd, hd, RELPOS_D);
  }
  if (err == cudaSuccess) {
    err = sm90::encode_qkv(&p.maps.v, v, b, n, h, RELPOS_D, n * hd, hd, RELPOS_D);
  }
  if (err != cudaSuccess) return int(err);
  p.table = static_cast<const float*>(table);
  p.lut = static_cast<const int*>(lut);
  p.kv_mask = static_cast<const int8_t*>(kv_mask);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.n = n;
  p.h = h;
  p.nb = nb;
  p.maxd = maxd;
  p.past = past;
  p.future = future;
  p.n_qt = int(n_qt);
  p.items = int(long(b) * h * n_qt);
  p.scale = scale;
  return int(sm90::launch(flash_relpos_fwd_kernel,
                          sm90::Layout<RELPOS_D, sm90::kRelpos>::alloc,
                          static_cast<cudaStream_t>(stream), p));
}
