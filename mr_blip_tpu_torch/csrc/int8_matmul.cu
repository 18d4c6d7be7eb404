// W8A8 linear, GELU MLP and gated-GELU MLP: bf16 activations quantized per
// row inside the function, int8 weights with per-output-channel scales, int8
// products on the tensor cores, bf16 out.
//
// Replaces: mr_blip_tpu/ops/int8_matmul.py::_linear_kernel (Q-Former cross
// K/V (61,680 x 1,408 x 1,536), T5 encoder qkv (8,224 x 2,048 x 6,144, RMS
// pre-norm) and o (8,224 x 2,048 x 2,048, residual), and at 364 pixels the
// ViT's split route: qkv (162,480 x 1,408 x 4,224, LN pre-norm, bias) and
// proj (162,480 x 1,408 x 1,408, bias, residual)), ::_mlp_kernel (EVA ViT-g
// MLP, 61,680 x 1,408 x 6,144 x 1,408, LN pre-norm, residual) and
// ::_gated_mlp_kernel (T5 encoder FFN, 8,224 x 2,048 x 5,120 x 2,048, RMS
// pre-norm, residual).
//
// Bound on this card: the int8 operations (2 M K N per product) against the
// tensor cores' int8 rate at every main-path shape; the bytes of x, the
// weights and the output are 3 to 10 times cheaper.
//
// Design: each C entry runs device kernels in a row on the caller's stream,
// with the intermediates in a workspace the caller allocates. Each starts
// with norm_quant_rows (int8_tile.cuh: the pre-norm and the per-row int8,
// the row in registers at the widths of the paths). Then:
//  * linear: the GEMM tile of int8_tile_sm90.cuh (`wgmma` on a TMA ring,
//    persistent blocks; bias + residual -> bf16), column tiles of the
//    wrapper's plan (ops/int8_matmul.py::_linear_plan);
//  * MLP (int8_tile_sm90.cuh): fc1_requant (`wgmma`, persistent clusters of
//    192-column blocks; bias -> tanh-GELU -> the (row, chunk) maxima
//    exchanged in the cluster -> int8 hidden and its scales) -> the GEMM
//    tile over the hidden chunks, each chunk's int32 sum scaled by its own
//    row scale into an fp32 sum; bias + residual -> bf16. The fp32 hidden
//    never reaches device memory. A chunk width that no cluster of fc1
//    tiles covers (the tiny configs' hidden of 64, chunks of 128 or 640)
//    takes the chain route, mrb_w8a8_mlp_chain: int8_gemm (bias, gelu -> an
//    fp32 hidden) -> requant_chunks -> int8_gemm over the hidden chunks;
//  * gated MLP, the same two tiles: fc1_requant's gated kind (clusters of
//    80-column blocks; one `wgmma` product covers 80 columns of wi_0 and the
//    same 80 of wi_1; gelu(gate) * up -> the cluster's maxima -> int8
//    hidden and its scales) -> wo on the GEMM tile over the hidden chunks;
//    residual -> bf16. A chunk width that no cluster of 80-column blocks
//    covers (the tiny T5's chunks of 64 to 256, Flan-T5-base's 512) takes
//    the chain route, mrb_w8a8_mlp_gated_chain: int8_gemm wi_0 (gelu(g) as
//    an fp32 hidden) -> int8_gemm wi_1 (its dequantized product multiplied
//    in) -> requant_chunks -> int8_gemm wo over the hidden chunks.
// The wrapper names each MLP's route by the shape
// (ops/int8_matmul.py::_mlp_route). The hidden chunk width (`block_h`) is
// part of the function: every (row, chunk) has its own requantization
// scale, and the row maximum of a chunk must be known before any of it is
// quantized. The chain routes make the round trip of their fp32 hidden
// through device memory (M x H x 4 bytes written, read once by
// requant_chunks); both routes give the same output bit for bit.
#include "int8_tile.cuh"
#include "int8_tile_sm90.cuh"

namespace mrb {

// ------------------------------------------- requantize the hidden chunks
// h (M, H) fp32 -> hq (M, H) int8, sh (M, H / block_h) fp32: one scale per
// (row, chunk of block_h columns). block_h % 4 == 0.
__global__ void __launch_bounds__(QR_WARPS * 32)
requant_chunks_kernel(const float* __restrict__ h, int8_t* __restrict__ hq,
                      float* __restrict__ sh, long n_items, int hdim,
                      int block_h) {
  const int lane = threadIdx.x % 32;
  const long item = long(blockIdx.x) * QR_WARPS + threadIdx.x / 32;
  if (item >= n_items) return;
  const int num_h = hdim / block_h;
  const long row = item / num_h;
  const int chunk = int(item % num_h);
  const float* hr = h + row * hdim + long(chunk) * block_h;
  float max_abs = 0.f;
  for (int c = lane * 4; c < block_h; c += 128) {
    const float4 f = *reinterpret_cast<const float4*>(hr + c);
    max_abs = fmaxf(fmaxf(max_abs, fmaxf(fabsf(f.x), fabsf(f.y))),
                    fmaxf(fabsf(f.z), fabsf(f.w)));
  }
  const float s = quant_scale(warp_max(max_abs));
  if (lane == 0) sh[item] = s;
  int8_t* qr = hq + row * hdim + long(chunk) * block_h;
  for (int c = lane * 4; c < block_h; c += 128) {
    const float4 f = *reinterpret_cast<const float4*>(hr + c);
    char4 o;
    o.x = (signed char)quant_value(f.x, s);
    o.y = (signed char)quant_value(f.y, s);
    o.z = (signed char)quant_value(f.z, s);
    o.w = (signed char)quant_value(f.w, s);
    *reinterpret_cast<char4*>(qr + c) = o;
  }
}

inline cudaError_t launch_requant_chunks(const float* h, int8_t* hq, float* sh,
                                         int m, int hdim, int block_h,
                                         cudaStream_t stream) {
  if (m <= 0 || block_h <= 0 || block_h % 4 != 0 || hdim % block_h != 0) {
    return cudaErrorInvalidValue;
  }
  const long n_items = long(m) * (hdim / block_h);
  const long blocks = (n_items + QR_WARPS - 1) / QR_WARPS;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  requant_chunks_kernel<<<dim3((unsigned)blocks), QR_WARPS * 32, 0, stream>>>(
      h, hq, sh, n_items, hdim, block_h);
  return cudaGetLastError();
}

struct Stage {
  const bf16* x;
  const float* ls;
  const float* lb;
  int norm_kind;
  float eps;
  int8_t* xq;
  float* sa;
  int m, k;
};

static cudaError_t quantize_input(const Stage& s, cudaStream_t stream) {
  return launch_norm_quant_rows(s.x, s.ls, s.lb, s.norm_kind, s.eps, s.xq, s.sa,
                                s.m, s.k, stream);
}

}  // namespace mrb

// x (M, K) bf16; ls, lb (K) fp32 or null; norm_kind 0 none, 1 LayerNorm,
// 2 RMSNorm; wq (N, K) int8 (K contiguous); sw (N), bias (N) fp32 or null;
// residual (M, N) bf16 or null; out (M, N) bf16; workspace xq (M, K) int8,
// sa (M) fp32; tn: the GEMM tile's column width (192 or 176).
extern "C" int mrb_w8a8_linear(const void* x, const void* ls, const void* lb,
                               int norm_kind, float eps, const void* wq,
                               const void* sw, const void* bias,
                               const void* residual, void* out, void* xq,
                               void* sa, int m, int k, int n, int tn, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, k};
  MRB_TRY(quantize_input(in, st));
  MRB_TRY(i8sm90::launch_gemm_tile(
      in.xq, in.sa, static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<const bf16*>(residual),
      static_cast<bf16*>(out), m, n, k, k, tn, st));
  return 0;
}

// fc1: w1 (H, D) int8, s1, b1 (H); fc2: w2 (D, H) int8, s2, b2 (D). Hidden
// chunks of block_h columns, each covered by a cluster of fc1_cluster fc1
// blocks of 192 columns (192 x fc1_cluster == block_h). Workspace: xq (M, D)
// int8, sa (M), hq (M, H) int8, sh (M, H / block_h) fp32.
extern "C" int mrb_w8a8_mlp(const void* x, const void* ls, const void* lb,
                            int norm_kind, float eps, const void* w1,
                            const void* s1, const void* b1, const void* w2,
                            const void* s2, const void* b2,
                            const void* residual, void* out, void* xq, void* sa,
                            void* hq, void* sh, int m, int d, int hdim,
                            int block_h, int fc1_cluster, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, d};
  MRB_TRY(quantize_input(in, st));
  MRB_TRY(i8sm90::launch_mlp_products<false>(
      in.xq, in.sa, static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const bf16*>(residual), static_cast<bf16*>(out),
      static_cast<int8_t*>(hq), static_cast<float*>(sh), m, d, hdim, block_h,
      fc1_cluster, st));
  return 0;
}

// The GELU MLP's chain route, for a chunk width no fc1 cluster covers:
// arguments as mrb_w8a8_mlp's but the cluster; workspace xq (M, D) int8, sa
// (M), h32 (M, H) fp32, hq (M, H) int8, sh (M, H / block_h) fp32.
extern "C" int mrb_w8a8_mlp_chain(const void* x, const void* ls, const void* lb,
                                  int norm_kind, float eps, const void* w1,
                                  const void* s1, const void* b1, const void* w2,
                                  const void* s2, const void* b2,
                                  const void* residual, void* out, void* xq,
                                  void* sa, void* h32, void* hq, void* sh, int m,
                                  int d, int hdim, int block_h, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, d};
  MRB_TRY(quantize_input(in, st));
  GemmArgs up{in.xq, in.sa, static_cast<const int8_t*>(w1),
              static_cast<const float*>(s1), static_cast<const float*>(b1), nullptr,
              h32, m, hdim, d, d};
  MRB_TRY((launch_int8_gemm<EPI_GELU_F32, false>(up, st)));
  MRB_TRY(launch_requant_chunks(static_cast<const float*>(h32),
                                static_cast<int8_t*>(hq),
                                static_cast<float*>(sh), m, hdim, block_h, st));
  GemmArgs down{static_cast<const int8_t*>(hq), static_cast<const float*>(sh),
                static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
                static_cast<const float*>(b2), static_cast<const bf16*>(residual), out,
                m, d, hdim, block_h};
  MRB_TRY((launch_int8_gemm<EPI_BF16, true>(down, st)));
  return 0;
}

// How many clusters of `cluster` fc1 blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), into *active: 0 for a size it cannot
// co-schedule. gated 0: the GELU MLP's fc1, 1: the gated MLP's.
extern "C" int mrb_w8a8_mlp_active_clusters(int cluster, int gated, void* active) {
  using namespace mrb::i8sm90;
  int* n = static_cast<int*>(active);
  return int(gated ? fc1_active_clusters<true>(cluster, n)
                   : fc1_active_clusters<false>(cluster, n));
}

// wi_0, wi_1: (H, D) int8 with s0, s1 (H); wo (D, H) int8 with so (D); no
// bias. Hidden chunks of block_h columns, each covered by a cluster of
// `cluster` gated fc1 blocks of 80 columns (80 x cluster == block_h).
// Workspace: xq (M, D) int8, sa (M), hq (M, H) int8, sh (M, H / block_h)
// fp32.
extern "C" int mrb_w8a8_mlp_gated(const void* x, const void* ls, const void* lb,
                                  int norm_kind, float eps, const void* w0,
                                  const void* s0, const void* w1,
                                  const void* s1, const void* wo,
                                  const void* so, const void* residual,
                                  void* out, void* xq, void* sa, void* hq, void* sh,
                                  int m, int d, int hdim, int block_h, int cluster,
                                  void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, d};
  MRB_TRY(quantize_input(in, st));
  MRB_TRY(i8sm90::launch_mlp_products<true>(
      in.xq, in.sa, static_cast<const int8_t*>(w0), static_cast<const float*>(s0),
      nullptr, static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
      static_cast<const int8_t*>(wo), static_cast<const float*>(so), nullptr,
      static_cast<const bf16*>(residual), static_cast<bf16*>(out),
      static_cast<int8_t*>(hq), static_cast<float*>(sh), m, d, hdim, block_h, cluster,
      st));
  return 0;
}

// The gated MLP's chain route, for a chunk width no cluster of gated fc1
// blocks covers: arguments as mrb_w8a8_mlp_gated's but the cluster;
// workspace xq (M, D) int8, sa (M), h32 (M, H) fp32, hq (M, H) int8, sh (M,
// H / block_h) fp32.
extern "C" int mrb_w8a8_mlp_gated_chain(const void* x, const void* ls, const void* lb,
                                        int norm_kind, float eps, const void* w0,
                                        const void* s0, const void* w1,
                                        const void* s1, const void* wo,
                                        const void* so, const void* residual,
                                        void* out, void* xq, void* sa, void* h32,
                                        void* hq, void* sh, int m, int d, int hdim,
                                        int block_h, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, d};
  MRB_TRY(quantize_input(in, st));
  GemmArgs gate{in.xq, in.sa, static_cast<const int8_t*>(w0),
                static_cast<const float*>(s0), nullptr, nullptr, h32, m, hdim,
                d, d};
  MRB_TRY((launch_int8_gemm<EPI_GELU_F32, false>(gate, st)));
  GemmArgs up = gate;
  up.b = static_cast<const int8_t*>(w1);
  up.b_scale = static_cast<const float*>(s1);
  MRB_TRY((launch_int8_gemm<EPI_MUL_F32, false>(up, st)));
  MRB_TRY(launch_requant_chunks(static_cast<const float*>(h32),
                                static_cast<int8_t*>(hq),
                                static_cast<float*>(sh), m, hdim, block_h, st));
  GemmArgs down{static_cast<const int8_t*>(hq), static_cast<const float*>(sh),
                static_cast<const int8_t*>(wo), static_cast<const float*>(so),
                nullptr, static_cast<const bf16*>(residual), out, m, d, hdim,
                block_h};
  MRB_TRY((launch_int8_gemm<EPI_BF16, true>(down, st)));
  return 0;
}
