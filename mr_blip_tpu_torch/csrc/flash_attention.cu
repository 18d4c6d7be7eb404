// Flash attention with no bias and no key mask, optionally causal (kernel 4),
// and the fp32 parity-mode body of the biased kernels 3 and 5.
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
// Design: q, k and v come with their own batch, row and head strides (in
// elements; the innermost stride is 1), so the q/k/v views of a packed QKV
// projection go in without a copy; the output is contiguous (B, N, H, D).
// q_len != k_len is allowed, ragged lengths are exact (rows past the end are
// zero-filled in shared memory and their keys get -inf; nothing is padded in
// device memory), and a row with no key to attend to comes out as zeros. With
// `causal`, query i attends to keys j <= i (top-left aligned), and a query
// block stops at the last key tile it can see.
//  * bf16: the Hopper tile of attention_tile_sm90.cuh (warp-specialised
//    blocks of 128 queries, `wgmma` for both products, K/V brought by TMA
//    into a ring of 4 stages awaited on mbarriers). D = 88 is two 128-byte
//    swizzled panels, one TMA box each (64 + 24 columns of the tensor map's
//    88); the box's columns past 88 are zero-filled, so the K-depth 96 of
//    q·kᵀ adds nothing. One persistent block per SM walks
//    the work items (query block, head, image), query block fastest, so the
//    blocks of one (image, head) run together and share its K/V in L2.
//  * fp32: a single-pass TF32 product would round the operands to 10 bits, and
//    fp32 is this model's parity mode, so the products are fp32 FMAs on the
//    CUDA cores. A block of 128 threads owns 128 query rows, one row a
//    thread: the thread keeps its output row (and the scores of 16 keys) in
//    registers and its pre-scaled q row in shared memory; K and V stream
//    through shared memory in tiles of 32 keys, read by every thread of a warp
//    at the same address (a broadcast, 16 bytes a load, 4 FMAs a load). The
//    online-softmax state is rescaled once per 16 keys. A warp whose 32 rows
//    all lie past the end only helps with the loads. With a bias (kernels 3
//    and 5 in fp32) each thread adds its own row's bias to its 16 scores,
//    keys with a zero key-mask flag get -inf, and the row logsumexp can be
//    stored; those loads are not overlapped with the math.
#include <cuda_runtime.h>

#include "attention_tile_sm90.cuh"

namespace mrb {

using sm90::bf16;

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
  // The biased fp32 kernels only: (1, H, N, M) fp32 bias, (B, M) int8 key
  // mask (0 = masked) and the (B, H, N) row logsumexp out (or null).
  const float* bias = nullptr;
  const int8_t* kv_mask = nullptr;
  float* lse = nullptr;
};

// ------------------------------------------------------------------- bf16
// A work item is (query block of 128, head, image), query block fastest, so
// the blocks of one (image, head) run together and share its K/V in L2.
struct Bf16Problem {
  sm90::Maps maps;
  bf16* out;
  int n, m, h, d, n_qt, items;
  float scale;

  __device__ void at(int item, sm90::Args& a, int& q0) const {
    const int rest = item / n_qt;
    a.head = rest % h;
    a.b = rest / h;
    q0 = (item % n_qt) * sm90::BQ;
    const long hd = long(h) * d;
    a.o = out + long(a.b) * n * hd + long(a.head) * d;
    a.o_row = hd;
    a.bias = nullptr;
    a.bias_row = 0;
    a.bias_aligned = false;
    a.kv_mask = nullptr;
    a.n_q = n;
    a.n_k = m;
    a.d = d;
    a.scale = scale;
    a.lse = nullptr;
  }
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(sm90::NTHREADS, 1)
flash_bf16_kernel(const __grid_constant__ Bf16Problem p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  sm90::attention_persistent<DP, false, CAUSAL>(p, smem);
}

template <int DP>
struct FlashBf16Launch {
  static cudaError_t run(const FlashArgs& f, int b, bool causal,
                         cudaStream_t stream) {
    const long n_qt = (f.n + sm90::BQ - 1) / sm90::BQ;
    if (long(b) * f.h * n_qt > 0x7fffffffL) return cudaErrorInvalidValue;
    Bf16Problem p{};
    cudaError_t err = sm90::encode_qkv(&p.maps.q, f.q, b, f.n, f.h, f.d, f.q_b,
                                       f.q_n, f.q_h);
    if (err == cudaSuccess) {
      err = sm90::encode_qkv(&p.maps.k, f.k, b, f.m, f.h, f.d, f.k_b, f.k_n, f.k_h);
    }
    if (err == cudaSuccess) {
      err = sm90::encode_qkv(&p.maps.v, f.v, b, f.m, f.h, f.d, f.v_b, f.v_n, f.v_h);
    }
    if (err != cudaSuccess) return err;
    p.out = static_cast<bf16*>(f.out);
    p.n = f.n;
    p.m = f.m;
    p.h = f.h;
    p.d = f.d;
    p.n_qt = int(n_qt);
    p.items = int(b * f.h * n_qt);
    p.scale = f.scale;
    const size_t bytes = sm90::Layout<DP, false>::alloc;
    return causal ? sm90::launch(flash_bf16_kernel<DP, true>, bytes, stream, p)
                  : sm90::launch(flash_bf16_kernel<DP, false>, bytes, stream, p);
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

template <int DP, bool CAUSAL, bool BIAS>
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
  // BIAS: this thread's bias row (the last one for rows past the end, which
  // compute nothing that is stored) and the batch row's key mask.
  const float* brow = nullptr;
  const int8_t* mask = nullptr;
  if constexpr (BIAS) {
    brow = f.bias + (long(head) * f.n + min(row, f.n - 1)) * f.m;
    mask = f.kv_mask + long(b) * f.m;
  }

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
        bool ok = key < f.m && !(CAUSAL && key > row);
        if constexpr (BIAS) {
          ok = ok && mask[key] != 0;
          if (ok) s[j] += brow[key];
        }
        if (!ok) s[j] = -INFINITY;
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
    if (BIAS && f.lse != nullptr) {
      const float m_safe = isfinite(m_run) ? m_run : 0.f;
      f.lse[(long(b) * f.h + head) * f.n + row] =
          m_safe + logf(fmaxf(l_run, 1e-30f));
    }
  }
}

template <int DP, bool CAUSAL, bool BIAS>
cudaError_t launch_f32(const FlashArgs& f, int b, cudaStream_t stream) {
  const size_t bytes = F32Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP, CAUSAL, BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((f.n + F32_ROWS - 1) / F32_ROWS, f.h, b);
  flash_f32_kernel<DP, CAUSAL, BIAS><<<grid, F32_ROWS, bytes, stream>>>(f);
  return cudaGetLastError();
}

template <int DP>
struct FlashF32Launch {
  static cudaError_t run(const FlashArgs& f, int b, bool causal,
                         cudaStream_t stream) {
    return causal ? launch_f32<DP, true, false>(f, b, stream)
                  : launch_f32<DP, false, false>(f, b, stream);
  }
};

template <int DP>
struct FlashF32BiasLaunch {
  static cudaError_t run(const FlashArgs& f, int b, cudaStream_t stream) {
    return launch_f32<DP, false, true>(f, b, stream);
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
    return int(mrb::sm90::dispatch_head_dim<mrb::FlashF32Launch>(
        d, f, b, causal != 0, s));
  }
  return int(mrb::sm90::dispatch_head_dim<mrb::FlashBf16Launch>(
      d, f, b, causal != 0, s));
}

namespace {

// Kernels 3 and 5 in fp32: q (B, N, H, D), k and v (B, M, H, D) and out
// contiguous, bias (1, H, N, M) contiguous, kv_mask (B, M) int8, lse
// (B, H, N) or null.
int launch_flash_bias_f32(const void* q, const void* k, const void* v,
                          const void* bias, const void* kv_mask, void* out,
                          float* lse, int b, int n, int m, int h, int d,
                          float scale, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || h <= 0 || b > 65535 || h > 65535) {
    return int(cudaErrorInvalidValue);
  }
  const long hd = long(h) * d;
  mrb::FlashArgs f{q,      k,  v,  out, long(n) * hd, hd, d, long(m) * hd, hd,
                   d,      long(m) * hd, hd, d, n, m, h, d, scale,
                   static_cast<const float*>(bias),
                   static_cast<const int8_t*>(kv_mask), lse};
  return int(mrb::sm90::dispatch_head_dim<mrb::FlashF32BiasLaunch>(
      d, f, b, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int mrb_flash_bias_attention_f32(const void* q, const void* k,
                                            const void* v, const void* bias,
                                            const void* kv_mask, void* out,
                                            int b, int n, int m, int h, int d,
                                            float scale, void* stream) {
  return launch_flash_bias_f32(q, k, v, bias, kv_mask, out, nullptr, b, n, m,
                               h, d, scale, stream);
}

extern "C" int mrb_flash_bias_fwd_stats_f32(const void* q, const void* k,
                                            const void* v, const void* bias,
                                            const void* kv_mask, void* out,
                                            void* lse, int b, int n, int m,
                                            int h, int d, float scale,
                                            void* stream) {
  if (lse == nullptr) return int(cudaErrorInvalidValue);
  return launch_flash_bias_f32(q, k, v, bias, kv_mask, out,
                               static_cast<float*>(lse), b, n, m, h, d, scale,
                               stream);
}
