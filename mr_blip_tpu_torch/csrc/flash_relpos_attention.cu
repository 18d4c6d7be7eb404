// Flash self-attention with the T5 bidirectional relative-position bias
// computed inside the kernel from the (H, num_buckets) table, a (B, N) key
// mask, and the fp32 row logsumexp. No (1, H, N, N) bias exists anywhere.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_flash_relpos_stats_kernel
// (_flash_relpos_fwd_stats): the T5 encoder self-attention of the
// long-context path (relpos_in_kernel), B=4, N=M~7,944 at 240 frames, H=32,
// D=64, bf16; the forward of the custom VJP and, with the lse unused, of
// inference.
//
// Bound on this card: 4*B*H*N*N*D flops against q, k, v and out read or
// written once (the bias costs no device-memory traffic at all), so the
// tensor-core math bounds it at every length the dispatch sends here
// (N >= 256).
//
// Design: the tile of attention_tile.cuh in its RELPOS mode, grid (query
// tile, head, batch row). The TPU kernel selects each bias value with a
// num_buckets-way compare because its core has no gather, and evaluates the
// bucket's logarithm per element; here the bias depends only on
// clamp(key - query, -maxd, maxd), so the wrapper hands in the bucket of each
// of those 2*maxd + 1 relative positions (computed once on the host side by
// the bit-exact bucket function, so no device logf can flip a bucket at a
// boundary) and the block keeps table[head][bucket[c]] for every c in
// shared memory: one clamp and one shared load per score. Tiles wholly
// beyond maxd take the same path (the TPU kernel's far/near split is not
// needed for correctness). Ragged N is exact with no padded copy, and a row
// whose keys are all masked gives zeros and lse = log(1e-30).
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace mrb {

namespace {

constexpr int RELPOS_D = 64;  // the only head dim (T5 d_kv)

__global__ void __launch_bounds__(NTHREADS)
flash_relpos_fwd_kernel(const bf16* q, const bf16* k, const bf16* v,
                        const float* table, const int* lut,
                        const int8_t* kv_mask, bf16* out, float* lse, int n,
                        int h, int nb, int maxd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const long hd = long(h) * RELPOS_D;
  const long off = long(b) * n * hd + long(head) * RELPOS_D;
  AttnArgs a;
  a.q = q + off;
  a.k = k + off;
  a.v = v + off;
  a.o = out + off;
  a.q_row = a.k_row = a.v_row = a.o_row = hd;
  a.kv_mask = kv_mask + long(b) * n;
  a.n_q = n;
  a.n_k = n;
  a.n_valid_k = n;
  a.d = RELPOS_D;
  a.scale = scale;
  a.lse = lse + (long(b) * h + head) * n;
  a.relpos_table = table + long(head) * nb;
  a.relpos_lut = lut;
  a.relpos_maxd = maxd;
  attention_tile<RELPOS_D, true>(a, blockIdx.x * BQ, smem);
}

}  // namespace

}  // namespace mrb

// out (B, N, H, 64) bf16 and lse (B, H, N) fp32 from q, k, v (B, N, H, 64)
// bf16, table (H, nb) fp32, lut (2*maxd + 1,) int32 with values in [0, nb),
// kv_mask (B, N) int8.
extern "C" int mrb_flash_relpos_fwd_stats_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lut, const void* kv_mask, void* out, void* lse, int b, int n,
    int h, int d, int nb, int maxd, float scale, void* stream) {
  using namespace mrb;
  if (b <= 0 || n <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      d != RELPOS_D || nb <= 0 || maxd <= 0 || maxd > MAX_RELPOS_DISTANCE ||
      lse == nullptr) {
    return int(cudaErrorInvalidValue);
  }
  const size_t bytes = TileLayout<RELPOS_D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid((n + BQ - 1) / BQ, h, b);
  flash_relpos_fwd_kernel<<<grid, NTHREADS, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lut), static_cast<const int8_t*>(kv_mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), n, h, nb, maxd,
      scale);
  return int(cudaGetLastError());
}
