// Building blocks of the W8A8 kernels (int8_matmul.cu, int8_attn_block.cu):
// the per-row quantization pass and the int8 tensor-core GEMM with its fused
// epilogues.
//
// Design (first version for Hopper, sm_90a). Every W8A8 function is a short
// chain of these device kernels behind one C entry, with the int8 operands
// and their fp32 scales in a workspace that the caller allocates:
//  * norm_quant_rows: one warp per row keeps the row in shared memory as
//    fp32, applies the optional LayerNorm / RMSNorm with fp32 statistics,
//    finds max |x| and writes the row as int8 with its scale;
//  * int8_gemm: C = A (M, K) x B (N, K)ᵀ, both int8 with K contiguous, on the
//    tensor cores as mma.sync m16n8k32 s8 x s8 -> s32. A block of 8 warps
//    owns a 128 x 128 tile (warp tile 64 x 32; 64 x 128 and 32 x 32 with K
//    segments); K streams through a 2-stage cp.async ring in tiles of 128
//    bytes; fragments come out of shared memory by ldmatrix (rows padded by
//    16 bytes: conflict-free). The int32 sums are
//    dequantized as acc * (s_a[m] * s_b[n]). With K cut into segments (the
//    hidden chunks of an MLP, each with its own row scale) the int32 sum of a
//    segment is folded into an fp32 accumulator at the segment's end
//    (a segment must be a multiple of 128).
//    Epilogues: bias + residual -> bf16; bias -> tanh-GELU -> fp32; multiply
//    into an fp32 matrix (the gate of a gated MLP);
//  * requant_chunks (int8_matmul.cu): one warp per (row, hidden chunk) reads
//    the fp32 hidden activation and writes it as int8 with the chunk's scale.
// The arithmetic that feeds a rounding to int8 uses the _rn intrinsics, so
// the compiler cannot contract it into fused multiply-adds: the plain
// PyTorch versions round after every operation, and a changed last bit
// flips a quantized value.
// Ragged M is exact with no padded copy: rows past M are zero-filled in
// shared memory and never stored. K must be a multiple of 16 (one cp.async
// chunk), N of 2. wgmma, TMA and a persistent schedule are left for later.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// In a C entry: return the first phase's error code, if any.
#define MRB_TRY(expr)                          \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return int(err_); \
  } while (0)

namespace mrb {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ quantization
__device__ __forceinline__ float quant_scale(float max_abs) {
  return __fdiv_rn(fmaxf(max_abs, 1e-6f), 127.0f);
}

// round-half-to-even(x / scale), clipped to [-127, 127].
__device__ __forceinline__ int quant_value(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return int(fminf(fmaxf(r, -127.0f), 127.0f));
}

// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), one rounding per step.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fadd_rn(x, __fmul_rn(0.044715f, x3));
  const float t = tanhf(__fmul_rn(0.7978845608028654f, inner));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------- norm + per-row quantize
constexpr int QR_WARPS = 4;
enum NormKind { NORM_NONE = 0, NORM_LN = 1, NORM_RMS = 2 };

// x (M, K) bf16 -> q (M, K) int8, scale (M) fp32. K % 8 == 0.
template <int NORM>
__global__ void __launch_bounds__(QR_WARPS * 32)
norm_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
                       const float* __restrict__ lb, float eps,
                       int8_t* __restrict__ q, float* __restrict__ scale,
                       int m, int k) {
  extern __shared__ __align__(16) float srow[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = long(blockIdx.x) * QR_WARPS + warp;
  if (row >= m) return;
  float* v = srow + size_t(warp) * k;
  const bf16* xr = x + row * k;
  float sum = 0.f;
  for (int c = lane * 8; c < k; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      v[c + i] = f;
      sum += (NORM == NORM_RMS) ? __fmul_rn(f, f) : f;
    }
  }
  __syncwarp();
  float max_abs = 0.f;
  if (NORM == NORM_LN) {
    const float mu = __fdiv_rn(warp_sum(sum), float(k));
    float sq = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float d = __fsub_rn(v[c], mu);
      sq += __fmul_rn(d, d);
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), float(k)), eps));
    for (int c = lane; c < k; c += 32) {
      const float y = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[c], mu), rstd), ls[c]), lb[c]);
      v[c] = y;
      max_abs = fmaxf(max_abs, fabsf(y));
    }
  } else if (NORM == NORM_RMS) {
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sum), float(k)), eps));
    for (int c = lane; c < k; c += 32) {
      const float y = __fmul_rn(__fmul_rn(v[c], rstd), ls[c]);
      v[c] = y;
      max_abs = fmaxf(max_abs, fabsf(y));
    }
  } else {
    for (int c = lane; c < k; c += 32) max_abs = fmaxf(max_abs, fabsf(v[c]));
  }
  __syncwarp();
  const float s = quant_scale(warp_max(max_abs));
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * k;
  for (int c = lane * 8; c < k; c += 256) {
    union { int8_t b[8]; uint2 u; } pack;
#pragma unroll
    for (int i = 0; i < 8; ++i) pack.b[i] = int8_t(quant_value(v[c + i], s));
    *reinterpret_cast<uint2*>(qr + c) = pack.u;
  }
}

inline cudaError_t launch_norm_quant_rows(const bf16* x, const float* ls,
                                          const float* lb, int norm_kind,
                                          float eps, int8_t* q, float* scale,
                                          int m, int k, cudaStream_t stream) {
  if (m <= 0 || k <= 0 || k % 8 != 0) return cudaErrorInvalidValue;
  const size_t bytes = size_t(QR_WARPS) * k * sizeof(float);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((m + QR_WARPS - 1) / QR_WARPS);
  cudaError_t err;
#define MRB_LAUNCH_QR(NORM)                                                    \
  err = cudaFuncSetAttribute(norm_quant_rows_kernel<NORM>,                     \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                             int(bytes));                                      \
  if (err != cudaSuccess) return err;                                          \
  norm_quant_rows_kernel<NORM><<<grid, QR_WARPS * 32, bytes, stream>>>(        \
      x, ls, lb, eps, q, scale, m, k)
  if (norm_kind == NORM_LN) {
    if (ls == nullptr || lb == nullptr) return cudaErrorInvalidValue;
    MRB_LAUNCH_QR(NORM_LN);
  } else if (norm_kind == NORM_RMS) {
    if (ls == nullptr) return cudaErrorInvalidValue;
    MRB_LAUNCH_QR(NORM_RMS);
  } else if (norm_kind == NORM_NONE) {
    MRB_LAUNCH_QR(NORM_NONE);
  } else {
    return cudaErrorInvalidValue;
  }
#undef MRB_LAUNCH_QR
  return cudaGetLastError();
}

// --------------------------------------------------------------- int8 GEMM
constexpr int GBN = 128;       // rows of B (output columns) per block
constexpr int GBK = 128;       // bytes of K per pipeline stage
constexpr int GLD = GBK + 16;  // shared row stride in bytes
constexpr int GSTAGES = 2;
constexpr int GTHREADS = 256;  // 8 warps, 2 (M) x 4 (N): warp tile 16 MI x 32
// 16-row tiles per warp: 4 (block tile 128 x 128), and 2 (64 x 128) for the
// segmented variant, whose second accumulator would otherwise take every
// register of the block (255 a thread, one block an SM; measured slower).
constexpr int PLAIN_MI = 4;
constexpr int SEG_MI = 2;

enum Epilogue { EPI_BF16 = 0, EPI_GELU_F32 = 1, EPI_MUL_F32 = 2 };

struct GemmArgs {
  const int8_t* a;       // (M, K)
  const float* a_scale;  // (M, K / seg_k): one scale per row and K segment
  const int8_t* b;       // (N, K): the weight with K contiguous
  const float* b_scale;  // (N)
  const float* bias;     // (N) fp32, or null
  const bf16* residual;  // (M, N) added before the rounding, or null
  void* out;             // (M, N): bf16 (EPI_BF16) or fp32
  int m, n, k, seg_k;
};

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* src,
                                            int src_bytes) {
  const uint32_t dst = uint32_t(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = uint32_t(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a·b for one 16x8x32 tile: a 16x32 row-major, b 32x8 col-major, int8
// in and int32 accumulate (PTX ISA, mma.sync.m16n8k32 fragment layouts).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MI: 16-row tiles per warp; the block owns 32 MI rows of A.
template <int EPI, bool SEGMENTED, int MI>
__global__ void __launch_bounds__(GTHREADS, 2)
int8_gemm_kernel(const GemmArgs p) {
  constexpr int GBM = 32 * MI;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(gemm_smem);
  int8_t* sB = sA + GSTAGES * GBM * GLD;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int k_tiles = (p.k + GBK - 1) / GBK;
  const int seg_tiles = (p.seg_k + GBK - 1) / GBK;
  const int n_seg = (p.k + p.seg_k - 1) / p.seg_k;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * GBK;
#pragma unroll
    for (int i = 0; i < ((GBM + GBN) * GBK / 16) / GTHREADS; ++i) {
      const int idx = tid + i * GTHREADS;
      const int r = idx / (GBK / 16);  // rows of A first, then rows of B
      const int c = (idx % (GBK / 16)) * 16;
      const bool k_ok = k0 + c < p.k;
      if (r < GBM) {
        const bool ok = k_ok && m0 + r < p.m;
        cp_async_16(sA + (stage * GBM + r) * GLD + c,
                    ok ? p.a + long(m0 + r) * p.k + k0 + c : p.a, ok ? 16 : 0);
      } else {
        const int rb = r - GBM;
        const bool ok = k_ok && n0 + rb < p.n;
        cp_async_16(sB + (stage * GBN + rb) * GLD + c,
                    ok ? p.b + long(n0 + rb) * p.k + k0 + c : p.b, ok ? 16 : 0);
      }
    }
  };

  int acc[MI][4][4];
  float accf[SEGMENTED ? MI : 1][SEGMENTED ? 4 : 1][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        if constexpr (SEGMENTED) accf[mi][ni][e] = 0.f;
      }

  // Dequantize the int32 sums of K segment `seg` into v[mi][ni][e].
  auto dequant = [&](int seg, int mi, int ni, int e) -> float {
    const int row = m0 + wm * (16 * MI) + mi * 16 + g + (e >> 1) * 8;
    const int col = n0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
    if (row >= p.m || col >= p.n) return 0.f;
    const float s = __fmul_rn(p.a_scale[long(row) * n_seg + seg], p.b_scale[col]);
    return __fmul_rn(float(acc[mi][ni][e]), s);
  };

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix lane addresses inside a stage (see the fragment layouts above).
  const int a_row = wm * (16 * MI) + (lane % 8) + ((lane / 8) % 2) * 8;
  const int a_col = (lane / 16) * 16;
  const int b_row = wn * 32 + (lane % 8) + (lane / 16) * 8;
  const int b_col = ((lane / 8) % 2) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    {
      const int next = kt + GSTAGES - 1;
      if (next < k_tiles) load_stage(next % GSTAGES, next);
      cp_async_commit();
    }
    const int8_t* tA = sA + (kt % GSTAGES) * GBM * GLD;
    const int8_t* tB = sB + (kt % GSTAGES) * GBN * GLD;
#pragma unroll
    for (int ks = 0; ks < GBK / 32; ++ks) {
      uint32_t bfrag[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        ldmatrix_x4(bfrag[nj], tB + (b_row + nj * 16) * GLD + ks * 32 + b_col);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t afrag[4];
        ldmatrix_x4(afrag, tA + (a_row + mi * 16) * GLD + ks * 32 + a_col);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8_16832(acc[mi][ni], afrag, bfrag[ni / 2][(ni % 2) * 2],
                       bfrag[ni / 2][(ni % 2) * 2 + 1]);
        }
      }
    }
    if constexpr (SEGMENTED) {
     if ((kt + 1) % seg_tiles == 0 || kt + 1 == k_tiles) {
      const int seg = kt / seg_tiles;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            accf[mi][ni][e] = __fadd_rn(accf[mi][ni][e], dequant(seg, mi, ni, e));
            acc[mi][ni][e] = 0;
          }
     }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (16 * MI) + mi * 16 + g + h * 8;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        if (row >= p.m || col >= p.n) continue;
        float v0, v1;
        if constexpr (SEGMENTED) {
          v0 = accf[mi][ni][2 * h];
          v1 = accf[mi][ni][2 * h + 1];
        } else {
          v0 = dequant(0, mi, ni, 2 * h);
          v1 = dequant(0, mi, ni, 2 * h + 1);
        }
        const long at = long(row) * p.n + col;
        if (EPI == EPI_MUL_F32) {
          float2* o = reinterpret_cast<float2*>(static_cast<float*>(p.out) + at);
          const float2 gate = *o;
          *o = make_float2(__fmul_rn(gate.x, v0), __fmul_rn(gate.y, v1));
          continue;
        }
        if (p.bias != nullptr) {
          v0 = __fadd_rn(v0, p.bias[col]);
          v1 = __fadd_rn(v1, p.bias[col + 1]);
        }
        if (EPI == EPI_GELU_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
              make_float2(gelu_tanh(v0), gelu_tanh(v1));
        } else {
          if (p.residual != nullptr) {
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(p.residual + at);
            v0 = __fadd_rn(v0, __bfloat162float(r.x));
            v1 = __fadd_rn(v1, __bfloat162float(r.y));
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int EPI, bool SEGMENTED>
inline cudaError_t launch_int8_gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.k % 16 != 0 || p.n % 2 != 0 ||
      p.seg_k <= 0) {
    return cudaErrorInvalidValue;
  }
  if (p.seg_k != p.k && (!SEGMENTED || p.seg_k % GBK != 0 || p.k % p.seg_k != 0)) {
    return cudaErrorInvalidValue;
  }
  constexpr int MI = SEGMENTED ? SEG_MI : PLAIN_MI;
  constexpr int GBM = 32 * MI;
  constexpr size_t smem = size_t(GSTAGES) * (GBM + GBN) * GLD;
  const dim3 grid((p.n + GBN - 1) / GBN, (p.m + GBM - 1) / GBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<EPI, SEGMENTED, MI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int8_gemm_kernel<EPI, SEGMENTED, MI><<<grid, GTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mrb
