// W8A8 linear, GELU MLP and gated-GELU MLP: bf16 activations quantized per
// row inside the function, int8 weights with per-output-channel scales, int8
// products on the tensor cores, bf16 out.
//
// Replaces: mr_blip_tpu/ops/int8_matmul.py::_linear_kernel (Q-Former cross
// K/V (61,680 x 1,408 x 1,536), T5 encoder qkv (8,224 x 2,048 x 6,144, RMS
// pre-norm) and o (8,224 x 2,048 x 2,048, residual)), ::_mlp_kernel (EVA
// ViT-g MLP, 61,680 x 1,408 x 6,144 x 1,408, LN pre-norm, residual) and
// ::_gated_mlp_kernel (T5 encoder FFN, 8,224 x 2,048 x 5,120 x 2,048, RMS
// pre-norm, residual).
//
// Bound on this card: the int8 operations (2 M K N per product) against the
// tensor cores' int8 rate at every main-path shape; the bytes of x, the
// weights and the output are 3 to 10 times cheaper.
//
// Design: each C entry runs the device kernels of int8_tile.cuh in a row on
// the caller's stream, with the intermediates in a workspace the caller
// allocates:
//  * linear: norm_quant_rows -> int8_gemm (bias + residual -> bf16);
//  * MLP: norm_quant_rows -> int8_gemm fc1 (bias -> tanh-GELU -> fp32 hidden)
//    -> requant_chunks -> int8_gemm fc2 over the hidden chunks (each chunk's
//    int32 sum scaled by its own row scale into an fp32 sum; bias + residual
//    -> bf16);
//  * gated MLP: as the MLP with two first products: wi_0 writes gelu(g) as
//    fp32, wi_1 multiplies its dequantized product into it.
// The hidden chunk width (`block_h`) is part of the function: every (row,
// chunk) has its own requantization scale, and the row maximum of a chunk
// must be known before any of it is quantized. So the fp32 hidden makes one
// round trip through device memory (M x H x 4 bytes written, read once by
// requant_chunks; the second product reads M x H int8). On the TPU it stays
// in VMEM; keeping it on chip here needs a block that owns whole chunks of a
// few rows, which is left for a later version.
#include "int8_tile.cuh"

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
// sa (M) fp32.
extern "C" int mrb_w8a8_linear(const void* x, const void* ls, const void* lb,
                               int norm_kind, float eps, const void* wq,
                               const void* sw, const void* bias,
                               const void* residual, void* out, void* xq,
                               void* sa, int m, int k, int n, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, k};
  MRB_TRY(quantize_input(in, st));
  GemmArgs g{in.xq, in.sa, static_cast<const int8_t*>(wq),
             static_cast<const float*>(sw), static_cast<const float*>(bias),
             static_cast<const bf16*>(residual), out, m, n, k, k};
  MRB_TRY((launch_int8_gemm<EPI_BF16, false>(g, st)));
  return 0;
}

// fc1: w1 (H, D) int8, s1, b1 (H); fc2: w2 (D, H) int8, s2, b2 (D). Hidden
// chunks of block_h columns. Workspace: xq (M, D) int8, sa (M), h32 (M, H)
// fp32, hq (M, H) int8, sh (M, H / block_h) fp32.
extern "C" int mrb_w8a8_mlp(const void* x, const void* ls, const void* lb,
                            int norm_kind, float eps, const void* w1,
                            const void* s1, const void* b1, const void* w2,
                            const void* s2, const void* b2,
                            const void* residual, void* out, void* xq, void* sa,
                            void* h32, void* hq, void* sh, int m, int d,
                            int hdim, int block_h, void* stream) {
  using namespace mrb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Stage in{static_cast<const bf16*>(x), static_cast<const float*>(ls),
                 static_cast<const float*>(lb), norm_kind, eps,
                 static_cast<int8_t*>(xq), static_cast<float*>(sa), m, d};
  MRB_TRY(quantize_input(in, st));
  GemmArgs fc1{in.xq, in.sa, static_cast<const int8_t*>(w1),
               static_cast<const float*>(s1), static_cast<const float*>(b1),
               nullptr, h32, m, hdim, d, d};
  MRB_TRY((launch_int8_gemm<EPI_GELU_F32, false>(fc1, st)));
  MRB_TRY(launch_requant_chunks(static_cast<const float*>(h32),
                                static_cast<int8_t*>(hq),
                                static_cast<float*>(sh), m, hdim, block_h, st));
  GemmArgs fc2{static_cast<const int8_t*>(hq), static_cast<const float*>(sh),
               static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
               static_cast<const float*>(b2),
               static_cast<const bf16*>(residual), out, m, d, hdim, block_h};
  MRB_TRY((launch_int8_gemm<EPI_BF16, true>(fc2, st)));
  return 0;
}

// wi_0, wi_1: (H, D) int8 with s0, s1 (H); wo (D, H) int8 with so (D); no
// bias. Workspace as mrb_w8a8_mlp.
extern "C" int mrb_w8a8_mlp_gated(const void* x, const void* ls, const void* lb,
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
