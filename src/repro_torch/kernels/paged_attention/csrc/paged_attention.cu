// Paged decode attention (one query token per sequence) through a block
// table, over fp pages or int8 pages with per-(page, head) scales, for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernels repro/kernels/paged_attention/kernel.py::
// paged_attention (_kernel, _flash_page_step) and ::paged_attention_quant
// (_kernel_quant), and computes what they compute: GQA (query head
// h*G + g reads kv head h, G = Hq / Hkv), a running max m, sum l and
// accumulator acc in fp32 across the sequence's pages, positions >= seq_len
// masked with -1e30 and their p set to 0 (so a zero-length row gives exact
// zeros), and out = acc / (l == 0 ? 1 : l) in q's dtype. The int8 variant
// dequantizes each page in registers, k = (float)q * scale[page, head], right
// after the load; no fp copy of the pool is made.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32): at the
// pager shape (yi-9b's KV geometry, Hq=32, Hkv=4, d=128, page=64, bf16; 16
// sequences of 2080 tokens) one call reads 68.2 MB of K and V pages plus 0.26
// MB of q and out, 20.4 us at the memory rate, against 0.545 GFLOP, 8.1 us in
// fp32. So it is bound by bytes, about 20 us per call; the int8 variant moves
// 34.3 MB, about 10.3 us.
//
// Design (simple and right first). The pool is read in place, (n_pages, page,
// Hkv, d) with page rows Hkv*d elements apart: the TPU kernel's per-call
// transposed copy of the pool and its 128-lane scale broadcast exist only for
// the TPU's block layout. One block of 256 threads per (batch, kv head), so
// the G query heads of a kv head share every page load; a loop over the
// sequence's pages inside the block takes the place of the TPU's sequential
// page grid axis, and it stops after ceil(seq_len / page) pages (the pages
// past that are wholly masked and would not change the result). Each page of
// K and V is loaded with 16-byte vector loads (four in flight per thread and
// array), widened (and in int8 mode scaled) to fp32 in shared memory, the
// K rows padded by one float so the per-key dot products hit distinct banks.
// Scores, softmax and p.v are fp32 FMAs (no TF32); m, l and acc live in shared
// memory. Row max and row sum of the softmax are one warp per query head.
//
// What it leaves on the table: 64 blocks for 132 SMs at the pager shape, no
// double-buffering of the page loads and no tensor cores. Splitting a
// sequence's pages across blocks (flash-decoding) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;      // 16-byte loads in flight per thread and array
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of page elements -> 16 / sizeof(T) floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* out) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
  }
};

struct Params {
  const void* q;          // (B, Hq, d), contiguous
  const void* k;          // (n_pages, page, Hkv, d), contiguous
  const void* v;
  const float* k_scales;  // (n_pages, Hkv); int8 pages only
  const float* v_scales;
  const int* table;       // (B, pps)
  const int* lens;        // (B,)
  void* o;                // (B, Hq, d), q's dtype
  int Hq, Hkv, D, page, pps;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ inline int smem_floats(int G, int D, int P) {
  // q, acc: G x D; k: P x (D+1); v: P x D; p: G x P; m, l, alpha: G
  return 2 * G * D + P * (D + 1) + P * D + G * P + 3 * G;
}

// grid (Hkv, B); KT is the page type (float, bf16, or int8 with scales)
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const Params p) {
  using V = Vec<KT>;
  const int G = p.Hq / p.Hkv;
  const int D = p.D, P = p.page, KS = D + 1;
  extern __shared__ float smem[];
  float* q_s = smem;               // G x D
  float* acc_s = q_s + G * D;      // G x D
  float* k_s = acc_s + G * D;      // P x KS
  float* v_s = k_s + P * KS;       // P x D
  float* p_s = v_s + P * D;        // G x P
  float* m_s = p_s + G * P;        // G
  float* l_s = m_s + G;            // G
  float* a_s = l_s + G;            // G

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long qo = (static_cast<long long>(b) * p.Hq +
                        static_cast<long long>(h) * G) * D;
  const QT* q = static_cast<const QT*>(p.q) + qo;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_float(q[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = MASKED;
    l_s[g] = 0.f;
  }

  const int len = p.lens[b];
  const int n_used = min(p.pps, (len + P - 1) / P);
  const long long row_stride = static_cast<long long>(p.Hkv) * D;
  const KT* kp = static_cast<const KT*>(p.k);
  const KT* vp = static_cast<const KT*>(p.v);
  const int CH = D / V::N;         // 16-byte chunks per page row
  const int n_ch = P * CH;

  for (int j = 0; j < n_used; ++j) {
    const long long pg = p.table[static_cast<long long>(b) * p.pps + j];
    float ks = 1.f, vs = 1.f;
    if (QUANT) {
      ks = p.k_scales[pg * p.Hkv + h];
      vs = p.v_scales[pg * p.Hkv + h];
    }
    const long long base = pg * P * row_stride + static_cast<long long>(h) * D;
    __syncthreads();  // the previous page's k_s, v_s and p_s are consumed

    for (int i0 = tid; i0 < n_ch; i0 += THREADS * UNROLL) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n_ch) {
          const long long off = base + (i / CH) * row_stride + (i % CH) * V::N;
          kr[u] = *reinterpret_cast<const uint4*>(kp + off);
          vr[u] = *reinterpret_cast<const uint4*>(vp + off);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n_ch) {
          const int r = i / CH, c = (i % CH) * V::N;
          float kf[V::N], vf[V::N];
          V::unpack(kr[u], kf);
          V::unpack(vr[u], vf);
#pragma unroll
          for (int e = 0; e < V::N; ++e) {
            k_s[r * KS + c + e] = QUANT ? kf[e] * ks : kf[e];
            v_s[r * D + c + e] = QUANT ? vf[e] * vs : vf[e];
          }
        }
      }
    }
    __syncthreads();

    // scores: one (query head, key) pair per thread and step
    for (int i = tid; i < G * P; i += THREADS) {
      const int g = i / P, r = i % P;
      const float* qr = q_s + g * D;
      const float* kr = k_s + r * KS;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      p_s[i] = (j * P + r < len) ? s * p.scale : MASKED;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* pr = p_s + g * P;
      float mx = MASKED;
      for (int r = lane; r < P; r += 32) mx = fmaxf(mx, pr[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int r = lane; r < P; r += 32) {
        const float e = (j * P + r < len) ? expf(pr[r] - m_new) : 0.f;
        pr[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v; each thread owns the same acc elements
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      const float* pr = p_s + g * P;
      float a = 0.f;
#pragma unroll 8
      for (int r = 0; r < P; ++r) a = fmaf(pr[r], v_s[r * D + c], a);
      acc_s[i] = acc_s[i] * a_s[g] + a;
    }
  }
  __syncthreads();

  QT* o = static_cast<QT*>(p.o) + qo;
  for (int i = tid; i < G * D; i += THREADS) {
    const float l = l_s[i / D];
    o[i] = from_float<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const int smem =
      smem_floats(G, p.D, p.page) * static_cast<int>(sizeof(float));
  auto kernel = paged_attention_kernel<QT, KT, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_scales, const void* v_scales,
                   const void* table, const void* lens, void* o, int Hq,
                   int Hkv, int D, int page, int pps, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.o = o;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.page = page;
  p.pps = pps;
  p.scale = scale;
  return p;
}

bool bad_shape(int B, int Hq, int Hkv, int D, int page, int pps) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D % 16 != 0 ||
         page <= 0 || pps <= 0 || B > 65535;
}

}  // namespace

// q_dtype, kv_dtype: 0 = float32, 1 = bfloat16. q, o (B, Hq, d); k, v
// (n_pages, page, Hkv, d); table (B, pps) int32; lens (B,) int32; all
// contiguous. Returns the CUDA error code of the launch (0 on success);
// allocates nothing, runs on the given stream and does not synchronise.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* table,
                                     const void* lens, void* o, int q_dtype,
                                     int kv_dtype, int B, int Hq, int Hkv,
                                     int D, int page, int pps, float scale,
                                     void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, pps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, nullptr, nullptr, table, lens, o, Hq,
                               Hkv, D, page, pps, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype * 2 + kv_dtype) {
    case 0: err = launch<float, float, false>(p, B, s); break;
    case 1: err = launch<float, __nv_bfloat16, false>(p, B, s); break;
    case 2: err = launch<__nv_bfloat16, float, false>(p, B, s); break;
    case 3: err = launch<__nv_bfloat16, __nv_bfloat16, false>(p, B, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As repro_paged_attention over int8 k, v with float32 k_scales, v_scales
// (n_pages, Hkv).
extern "C" int repro_paged_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* table, const void* lens, void* o,
    int q_dtype, int B, int Hq, int Hkv, int D, int page, int pps,
    float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, pps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, k_scales, v_scales, table, lens, o,
                               Hq, Hkv, D, page, pps, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch<float, int8_t, true>(p, B, s); break;
    case 1: err = launch<__nv_bfloat16, int8_t, true>(p, B, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
