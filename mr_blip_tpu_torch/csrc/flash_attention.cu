// Flash attention with no bias and no key mask, optionally causal.
//
// Replaces: mr_blip_tpu/ops/flash_attention.py::_flash_fwd_kernel (the
// forward of flash_attention: the EVA ViT-g self-attention whenever the
// packed-QKV kernel does not take it: 240 images x 677 tokens at 364 pixels in
// bf16, 257 tokens at 224 pixels in fp32; H=16, D=88).
//
// Bound on this card: the math. Per (image, head) 4*N*M*D flops against
// (2*N + 2*M)*D elements read and written: at N=M=677 that is 339 flops a byte
// in bf16, above the card's ~295, and the fp32 instantiation runs on the CUDA
// cores, whose peak is 15 times lower than the tensor cores'.
//
// Design: grid (query tile, head, batch row). q, k and v come with their own
// batch, row and head strides (in elements; the innermost stride is 1), so the
// q/k/v views of a packed QKV projection go in without a copy; the output is
// contiguous (B, N, H, D). q_len != k_len is allowed, ragged lengths are exact
// (rows past the end are zero-filled in shared memory and their keys get
// -inf; nothing is padded in device memory), and a row with no key to attend
// to comes out as zeros. With `causal`, query i attends to keys j <= i
// (top-left aligned), and a query tile stops at the last key tile it can see.
//  * bf16: the tile of attention_tile.cuh (mma.sync m16n8k16, fp32 online
//    softmax in registers), as the packed-QKV and biased kernels use it.
//  * fp32: a single-pass TF32 product would round the operands to 10 bits, and
//    fp32 is this model's parity mode, so the products are fp32 FMAs on the
//    CUDA cores. A block of 128 threads owns 128 query rows, one row a
//    thread: the thread keeps its output row (and the scores of 16 keys) in
//    registers and its pre-scaled q row in shared memory; K and V stream
//    through shared memory in tiles of 32 keys, read by every thread of a warp
//    at the same address (a broadcast, 16 bytes a load, 4 FMAs a load). The
//    online-softmax state is rescaled once per 16 keys. A warp whose 32 rows
//    all lie past the end only helps with the loads.
// Neither instantiation overlaps its loads with its math yet.
#include <cuda_runtime.h>

#include "attention_tile.cuh"

namespace mrb {

// One launch's operands. Strides in elements.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long q_b, q_n, q_h;
  long k_b, k_n, k_h;
  long v_b, v_n, v_h;
  int n, m, h, d;
  float scale;
};

// ------------------------------------------------------------------- bf16
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS)
flash_bf16_kernel(FlashArgs f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  AttnArgs a;
  a.q = static_cast<const bf16*>(f.q) + b * f.q_b + head * f.q_h;
  a.k = static_cast<const bf16*>(f.k) + b * f.k_b + head * f.k_h;
  a.v = static_cast<const bf16*>(f.v) + b * f.v_b + head * f.v_h;
  a.q_row = f.q_n;
  a.k_row = f.k_n;
  a.v_row = f.v_n;
  const long hd = long(f.h) * f.d;
  a.o = static_cast<bf16*>(f.out) + long(b) * f.n * hd + long(head) * f.d;
  a.o_row = hd;
  a.bias = nullptr;
  a.bias_row = 0;
  a.kv_mask = nullptr;
  a.n_q = f.n;
  a.n_k = f.m;
  a.n_valid_k = f.m;
  a.d = f.d;
  a.scale = f.scale;
  attention_tile<DP, false, CAUSAL>(a, blockIdx.x * BQ, smem);
}

template <int DP, bool CAUSAL>
cudaError_t launch_bf16(const FlashArgs& f, int b, cudaStream_t stream) {
  const size_t bytes = TileLayout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((f.n + BQ - 1) / BQ, f.h, b);
  flash_bf16_kernel<DP, CAUSAL><<<grid, NTHREADS, bytes, stream>>>(f);
  return cudaGetLastError();
}

template <int DP>
struct FlashBf16Launch {
  static cudaError_t run(const FlashArgs& f, int b, bool causal,
                         cudaStream_t stream) {
    return causal ? launch_bf16<DP, true>(f, b, stream)
                  : launch_bf16<DP, false>(f, b, stream);
  }
};

// ------------------------------------------------------------------- fp32
constexpr int F32_ROWS = 128;   // query rows (= threads) per block
constexpr int F32_KEYS = 32;    // keys per shared-memory tile
constexpr int F32_CHUNK = 16;   // keys per online-softmax step

// Shared memory: q rows with a stride of DP + 4 floats (the 8 threads of a
// 16-byte load phase then hit 32 distinct banks), then the K and the V tile.
template <int DP>
struct F32Layout {
  static constexpr int LQ = DP + 4;
  static constexpr size_t k_off = size_t(F32_ROWS) * LQ;      // in floats
  static constexpr size_t v_off = k_off + size_t(F32_KEYS) * DP;
  static constexpr size_t bytes = (v_off + size_t(F32_KEYS) * DP) * 4;
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(F32_ROWS)
flash_f32_kernel(FlashArgs f) {
  using L = F32Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + L::k_off;
  float* sV = sQ + L::v_off;
  constexpr int CH = DP / 4;  // 16-byte chunks per row

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * F32_ROWS;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const float* qp = static_cast<const float*>(f.q) + b * f.q_b + head * f.q_h;
  const float* kp = static_cast<const float*>(f.k) + b * f.k_b + head * f.k_h;
  const float* vp = static_cast<const float*>(f.v) + b * f.v_b + head * f.v_h;

  // The block's q rows, pre-scaled; rows past n and columns past d are zero.
  for (int idx = tid; idx < F32_ROWS * CH; idx += F32_ROWS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < f.n && c < f.d) {
      val = *reinterpret_cast<const float4*>(qp + long(q0 + r) * f.q_n + c);
      val.x *= f.scale;
      val.y *= f.scale;
      val.z *= f.scale;
      val.w *= f.scale;
    }
    *reinterpret_cast<float4*>(sQ + r * L::LQ + c) = val;
  }

  float o[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) o[c] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;
  const float* qrow = sQ + tid * L::LQ;
  // A warp whose first row lies past the end has no row to compute.
  const bool warp_active = q0 + (tid & ~31) < f.n;
  const int k_end = CAUSAL ? min(f.m, q0 + F32_ROWS) : f.m;

  for (int k0 = 0; k0 < k_end; k0 += F32_KEYS) {
    __syncthreads();  // q is stored; every warp is done with the last tile
    for (int idx = tid; idx < F32_KEYS * CH; idx += F32_ROWS) {
      const int r = idx / CH;
      const int c = (idx % CH) * 4;
      const int key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (key < f.m && c < f.d) {
        kv = *reinterpret_cast<const float4*>(kp + long(key) * f.k_n + c);
        vv = *reinterpret_cast<const float4*>(vp + long(key) * f.v_n + c);
      }
      *reinterpret_cast<float4*>(sK + r * DP + c) = kv;
      *reinterpret_cast<float4*>(sV + r * DP + c) = vv;
    }
    __syncthreads();
    if (!warp_active) continue;

    for (int c0 = 0; c0 < F32_KEYS; c0 += F32_CHUNK) {
      if (k0 + c0 >= k_end) break;
      const float* kt = sK + c0 * DP;
      const float* vt = sV + c0 * DP;
      float s[F32_CHUNK];
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
        for (int j = 0; j < F32_CHUNK; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + j * DP + c);
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        const int key = k0 + c0 + j;
        if (key >= f.m || (CAUSAL && key > row)) s[j] = -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m_run) ? expf(m_run - m_safe) : 0.f;
      m_run = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < F32_CHUNK; ++j) {
        s[j] = isfinite(s[j]) ? expf(s[j] - m_safe) : 0.f;
        psum += s[j];
      }
      l_run = l_run * corr + psum;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        float4 acc = make_float4(o[c] * corr, o[c + 1] * corr, o[c + 2] * corr,
                                 o[c + 3] * corr);
#pragma unroll
        for (int j = 0; j < F32_CHUNK; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vt + j * DP + c);
          acc.x = fmaf(s[j], vv.x, acc.x);
          acc.y = fmaf(s[j], vv.y, acc.y);
          acc.z = fmaf(s[j], vv.z, acc.z);
          acc.w = fmaf(s[j], vv.w, acc.w);
        }
        o[c] = acc.x;
        o[c + 1] = acc.y;
        o[c + 2] = acc.z;
        o[c + 3] = acc.w;
      }
    }
  }

  if (row < f.n) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    float* orow = static_cast<float*>(f.out) +
                  (long(b) * f.n + row) * (long(f.h) * f.d) + long(head) * f.d;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < f.d) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            o[c] * inv, o[c + 1] * inv, o[c + 2] * inv, o[c + 3] * inv);
      }
    }
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch_f32(const FlashArgs& f, int b, cudaStream_t stream) {
  const size_t bytes = F32Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((f.n + F32_ROWS - 1) / F32_ROWS, f.h, b);
  flash_f32_kernel<DP, CAUSAL><<<grid, F32_ROWS, bytes, stream>>>(f);
  return cudaGetLastError();
}

template <int DP>
struct FlashF32Launch {
  static cudaError_t run(const FlashArgs& f, int b, bool causal,
                         cudaStream_t stream) {
    return causal ? launch_f32<DP, true>(f, b, stream)
                  : launch_f32<DP, false>(f, b, stream);
  }
};

}  // namespace mrb

// q (B, N, H, D), k and v (B, M, H, D) by their strides in elements (innermost
// stride 1), out (B, N, H, D) contiguous; `is_fp32` picks the instantiation.
// The bf16 kernel loads 8 elements at a time and the fp32 kernel 4: d, every
// stride and every base address must be multiples of 16 bytes.
extern "C" int mrb_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int b, int n, int m, int h, int d,
                                   long q_b, long q_n, long q_h, long k_b,
                                   long k_n, long k_h, long v_b, long v_n,
                                   long v_h, int causal, int is_fp32,
                                   float scale, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || h <= 0 || b > 65535 || h > 65535) {
    return int(cudaErrorInvalidValue);
  }
  const long unit = is_fp32 ? 4 : 8;
  const long strides[] = {q_b, q_n, q_h, k_b, k_n, k_h, v_b, v_n, v_h, long(d)};
  for (long s : strides) {
    if (s % unit != 0) return int(cudaErrorInvalidValue);
  }
  mrb::FlashArgs f{q,   k,   v,   out, q_b, q_n, q_h, k_b,  k_n,
                   k_h, v_b, v_n, v_h, n,   m,   h,   d,    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_fp32) {
    return int(mrb::dispatch_head_dim<mrb::FlashF32Launch>(d, f, b, causal != 0,
                                                           s));
  }
  return int(mrb::dispatch_head_dim<mrb::FlashBf16Launch>(d, f, b, causal != 0,
                                                          s));
}
