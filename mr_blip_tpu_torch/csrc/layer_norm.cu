// LayerNorm over the last axis: bf16 in and out, fp32 weight and bias, fp32
// statistics.
//
// Replaces: mr_blip_tpu/ops/layer_norm.py::_ln_kernel (every LayerNormFP32
// on the generate path: EVA norm1/norm2 on (61,680, 1408) eps 1e-6,
// ln_vision eps 1e-5, the Q-Former's 31 norms on (7,680, 768) eps 1e-12;
// (162,480, 1408) at 364 pixels).
//
// Bound on this card: memory. Each element is read once from device memory
// and written once, 4 bytes in all, against ~10 flops; at (61,680, 1408)
// that is 347 MB, about 0.1 ms at the card's 3.35 TB/s.
//
// Design. The statistics are the reference's two passes, mean and then the
// centred variance, in fp32 (mr_blip_tpu/ops/layer_norm.py::_ln_reference).
//  * The widths of the card's paths (1408 and 768) have their own kernel,
//    the row held in registers: a warp owns ROWS rows, and each lane loads
//    its 16-byte chunks of all of them (chunk c of a row at lane c % 32, so a
//    warp's loads are contiguous) before the first reduction, so every load
//    of the warp is in flight at once; the mean, the variance and the output
//    come from those registers, and each element is read and written once.
//    Weight and bias come as float4, once per chunk for all ROWS rows.
//  * Other widths that are a multiple of 8 with 16-byte aligned rows take the
//    generic kernel (one warp a row, the row read three times through L1),
//    and the rest the scalar one. The wrapper names the kernel
//    (ops/layer_norm.py::_ln_plan); an entry that does not fit the shape or
//    the alignment is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;  // warps of a block, all kernels

enum Variant { ROW_1408 = 0, ROW_768 = 1, GENERIC_VEC8 = 2, GENERIC_SCALAR = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(e[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// D: the row width (a multiple of 8); ROWS: rows a warp owns.
template <int D, int ROWS>
__global__ void __launch_bounds__(32 * WARPS)
layer_norm_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ bias, bf16* __restrict__ y,
                       long rows, float eps) {
  constexpr int CHUNKS = D / 8;                 // 16-byte chunks of a row
  constexpr int PER_LANE = (CHUNKS + 31) / 32;  // chunk i of a lane: lane + 32 i
  const int lane = threadIdx.x % 32;
  const long row0 = (long(blockIdx.x) * WARPS + threadIdx.x / 32) * ROWS;
  if (row0 >= rows) return;

  uint4 raw[ROWS][PER_LANE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (row0 + r) * D);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int c = lane + 32 * i;
      if (row0 + r < rows && c < CHUNKS) {
        raw[r][i] = __ldcs(xr + c);
      } else {
        raw[r][i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  float mu[ROWS], rstd[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      float f[8];
      unpack8(raw[r][i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
    }
    mu[r] = warp_sum(s) / D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (lane + 32 * i < CHUNKS) {
        float f[8];
        unpack8(raw[r][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = f[e] - mu[r];
          ss += t * t;
        }
      }
    }
    rstd[r] = rsqrtf(warp_sum(ss) / D + eps);
  }

#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < CHUNKS) {
      const float4* w4 = reinterpret_cast<const float4*>(weight) + 2 * c;
      const float4* b4 = reinterpret_cast<const float4*>(bias) + 2 * c;
      const float4 wa = __ldg(w4), wb = __ldg(w4 + 1);
      const float4 ba = __ldg(b4), bb = __ldg(b4 + 1);
      const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (row0 + r < rows) {
          float f[8];
          unpack8(raw[r][i], f);
          uint4 out;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = __floats2bfloat162_rn(
                (f[2 * e] - mu[r]) * rstd[r] * w[2 * e] + b[2 * e],
                (f[2 * e + 1] - mu[r]) * rstd[r] * w[2 * e + 1] + b[2 * e + 1]);
          }
          __stcs(reinterpret_cast<uint4*>(y + (row0 + r) * D) + c, out);
        }
      }
    }
  }
}

// Any width: one warp a row, VEC elements per access (8: 16-byte loads, needs
// d % 8 == 0 and 16-byte aligned rows; or 1); the second and third reads of
// the row hit L1/L2.
template <int VEC>
__global__ void __launch_bounds__(32 * WARPS)
layer_norm_kernel(const bf16* x, const float* weight, const float* bias,
                  bf16* y, long rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long row = long(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* xr = x + row * d;
  bf16* yr = y + row * d;

  float vals[VEC];
  auto load = [&](int c) {
    if constexpr (VEC == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = __bfloat162float(e[i]);
    } else {
      vals[0] = __bfloat162float(xr[c]);
    }
  };

  float s = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    load(c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += vals[i];
  }
  const float mu = warp_sum(s) / d;

  float ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    load(c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float t = vals[i] - mu;
      ss += t * t;
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / d + eps);

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    load(c);
    if constexpr (VEC == 8) {
      uint4 raw;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = __float2bfloat16((vals[i] - mu) * rstd * weight[c + i] +
                                bias[c + i]);
      }
      *reinterpret_cast<uint4*>(yr + c) = raw;
    } else {
      yr[c] = __float2bfloat16((vals[0] - mu) * rstd * weight[c] + bias[c]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Two rows a warp at both widths (1, 2 and 4 were within a few percent on an
// H100; PERF.md).
constexpr int ROWS_PER_WARP = 2;

template <int D>
cudaError_t launch_rows(const bf16* x, const float* w, const float* b, bf16* y,
                        long rows, float eps, cudaStream_t s) {
  const long per_block = long(WARPS) * ROWS_PER_WARP;
  const long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  layer_norm_rows_kernel<D, ROWS_PER_WARP>
      <<<unsigned(blocks), 32 * WARPS, 0, s>>>(x, w, b, y, rows, eps);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 the 1408-wide register kernel, 1 the 768-wide one (both need
// 16-byte aligned x, y, weight and bias), 2 the generic 16-byte kernel
// (d % 8 == 0, x and y 16-byte aligned), 3 the scalar kernel (any d).
extern "C" int mrb_layer_norm_bf16(const void* x, const void* weight,
                                   const void* bias, void* y, long rows,
                                   int d, float eps, int variant, void* stream) {
  if (rows <= 0 || d <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* wp = static_cast<const float*>(weight);
  const float* bp = static_cast<const float*>(bias);
  bf16* yp = static_cast<bf16*>(y);
  const bool rows_aligned = aligned16(x) && aligned16(y);
  const bool params_aligned = aligned16(weight) && aligned16(bias);
  if (variant == ROW_1408 || variant == ROW_768) {
    const int width = variant == ROW_1408 ? 1408 : 768;
    if (d != width || !rows_aligned || !params_aligned) return int(cudaErrorInvalidValue);
    return int(width == 1408 ? launch_rows<1408>(xp, wp, bp, yp, rows, eps, s)
                             : launch_rows<768>(xp, wp, bp, yp, rows, eps, s));
  }
  const long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 2147483647L) return int(cudaErrorInvalidValue);
  if (variant == GENERIC_VEC8) {
    if (d % 8 != 0 || !rows_aligned) return int(cudaErrorInvalidValue);
    layer_norm_kernel<8><<<unsigned(blocks), 32 * WARPS, 0, s>>>(xp, wp, bp, yp,
                                                                 rows, d, eps);
  } else if (variant == GENERIC_SCALAR) {
    layer_norm_kernel<1><<<unsigned(blocks), 32 * WARPS, 0, s>>>(xp, wp, bp, yp,
                                                                 rows, d, eps);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
