// LayerNorm over the last axis: bf16 in and out, fp32 weight and bias, fp32
// statistics.
//
// Replaces: mr_blip_tpu/ops/layer_norm.py::_ln_kernel (every LayerNormFP32
// on the generate path: EVA norm1/norm2 on (61,680, 1408) eps 1e-6,
// ln_vision eps 1e-5, the Q-Former's 31 norms on (7,680, 768) eps 1e-12).
//
// Bound on this card: memory. Each element is read once from device memory
// and written once, 4 bytes in all, against ~10 flops; at (61,680, 1408)
// that is 347 MB, about 0.1 ms at the card's 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block. The statistics are
// the reference's two passes, mean and then the centred variance, in fp32
// (mr_blip_tpu/ops/layer_norm.py::_ln_reference); the second and third
// reads of the row hit L1/L2, so device memory sees the row once. When d
// is a multiple of 8 (768, 1408) each lane moves 16 bytes per access.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int ROWS_PER_BLOCK = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// VEC elements per access: 8 (16-byte loads, needs d % 8 == 0) or 1.
template <int VEC>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
layer_norm_kernel(const bf16* x, const float* weight, const float* bias,
                  bf16* y, long rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long row = long(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
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

}  // namespace

extern "C" int mrb_layer_norm_bf16(const void* x, const void* weight,
                                   const void* bias, void* y, long rows,
                                   int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return int(cudaErrorInvalidValue);
  const long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 2147483647L) return int(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* wp = static_cast<const float*>(weight);
  const float* bp = static_cast<const float*>(bias);
  bf16* yp = static_cast<bf16*>(y);
  if (d % 8 == 0 && aligned) {
    layer_norm_kernel<8><<<unsigned(blocks), 32 * ROWS_PER_BLOCK, 0, s>>>(
        xp, wp, bp, yp, rows, d, eps);
  } else {
    layer_norm_kernel<1><<<unsigned(blocks), 32 * ROWS_PER_BLOCK, 0, s>>>(
        xp, wp, bp, yp, rows, d, eps);
  }
  return int(cudaGetLastError());
}
