// RMS norm (K9, with an optional residual add before it) and rotary position
// embeddings on q and k (K10), for Hopper (sm_90a), written by hand in CUDA
// C++. Two memory-bound elementwise kernels that take the model step's fp32
// chains (models/layers.py) into one read and one write each.
//
// They replace no TPU kernel: the reference's rmsnorm and apply_rope
// (src/repro/models/layers.py) are jnp expressions that XLA fuses. The
// port's plain versions (ref.py) run them op by op: rmsnorm as ~9 aten
// kernels (cast, square, mean, add, rsqrt, two products, two casts) that
// move ~40 bytes an element of a bf16 row, rope as ~12 a call (cast,
// angles, cos, sin, four products, sub, add, cat, cast) that move ~38,
// twice a layer. These kernels compute the same function and round where
// the plain versions round: every product and sum by the _rn intrinsics
// (no contraction into an FMA), cosf and sinf at full precision (decode
// angles reach hundreds of radians, past where __sinf is close), rsqrtf as
// torch's rsqrt calls it, and the output rounded once to the activation
// dtype. Rope is then bit-equal to its plain version; the norm differs only
// where its sum of squares, added in another order, rounds differently.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM): bytes. At yi-9b's
// prefill (32768 tokens, d 4096, bf16) the residual add and norm read x and
// a and write their sum and the normed rows, 1.07 GB (0.32 ms); rope reads
// q (32 heads of 128) and k (4) and writes them, 0.60 GB (0.18 ms). In
// decode (64 tokens) each is one launch of a few microseconds.
//
// K9: one row per group of `tpr` threads (a multiple of 32), `rpb` rows a
// block (blockDim (tpr, rpb)). A thread holds up to CH chunks of the row in
// registers between the reduction and the scaling: 16-byte vectors (8 bf16
// or 4 fp32) where the row width, pointers and row strides allow, else
// single elements. The sum of squares is fp32, reduced by warp shuffles and
// then over the row's warps through shared memory in a fixed order. With
// the add, s = x + a is rounded to x's dtype, written, and normed as
// written: the unfused `x = x + a; rmsnorm(x)` exactly.
//
// K10: one block per token (b, s) of q (B, S, Hq, D) and k (B, S, Hkv, D),
// read by their (B, S, H) strides with D contiguous (MLA's strided
// q[..., nope:] slice too). The block reads its position(s) by strides on
// the device (decode's expanded position has stride 0; M-RoPE's (3, B, S)
// positions pick the axis by frequency section), puts cos and sin of the
// half-width angles in shared memory once for all of q's and k's heads, and
// then turns 16-byte pieces of both halves of each head. No host read of a
// position, so a CUDA graph captured around a call replays at any position.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of T from p (16-byte pieces where N of them fill whole pieces;
// p is then 16-byte aligned, as the wrapper checks), widened to fp32
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* f) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / E; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < E; ++e) f[i * E + e] = to_f<T>(t[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = to_f<T>(p[e]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* __restrict__ p, const float* f) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / E; ++i) {
      uint4 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < E; ++e) t[e] = from_f<T>(f[i * E + e]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = from_f<T>(f[e]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// K9: out = rmsnorm(x [+ a]) * w, and sum = x + a with the add
// ---------------------------------------------------------------------------

constexpr int MAX_ROW_WARPS = 32;   // 1024 threads a row at most

// VEC elements a chunk (16 / sizeof(T) on the vector path, 1 otherwise);
// CH chunks a thread at most
template <typename T, typename W, int VEC, bool ADD>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ a,
                               const W* __restrict__ w, T* __restrict__ out,
                               T* __restrict__ sum, long long rows, int n,
                               long long x_rs, long long a_rs, float eps,
                               float inv_n) {
  constexpr int CH = VEC > 1 ? 4 : 8;
  __shared__ float part[MAX_ROW_WARPS];
  const int tpr = blockDim.x;
  const int warps = tpr / 32;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const int nchunk = n / VEC;
  float v[CH][VEC];
  float ss = 0.f;
  if (live) {
    const T* xr = x + row * x_rs;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = threadIdx.x + c * tpr;
      if (idx < nchunk) {
        load_f<T, VEC>(xr + (long long)idx * VEC, v[c]);
        if constexpr (ADD) {
          float av[VEC], sv[VEC];
          load_f<T, VEC>(a + row * a_rs + (long long)idx * VEC, av);
          // rounded to T, as `x + a` in T rounds it, and normed as written
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sv[e] = to_f<T>(from_f<T>(__fadd_rn(v[c][e], av[e])));
          store_f<T, VEC>(sum + row * n + (long long)idx * VEC, sv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[c][e] = sv[e];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += v[c][e] * v[c][e];
      }
    }
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x % 32;
  if (lane == 0) part[threadIdx.y * warps + threadIdx.x / 32] = ss;
  __syncthreads();
  if (!live) return;
  float total = 0.f;
  for (int i = 0; i < warps; ++i) total += part[threadIdx.y * warps + i];
  // mean (torch's mean: the sum times 1 / n), + eps, rsqrt
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_n), eps));
  T* orow = out + row * n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int idx = threadIdx.x + c * tpr;
    if (idx < nchunk) {
      float wv[VEC], o[VEC];
      load_f<W, VEC>(w + (long long)idx * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = __fmul_rn(__fmul_rn(v[c][e], r), wv[e]);
      store_f<T, VEC>(orow + (long long)idx * VEC, o);
    }
  }
}

template <typename T, typename W, int VEC>
cudaError_t launch_norm(const void* x, const void* a, const void* w,
                        void* out, void* sum, long long rows, int n,
                        long long x_rs, long long a_rs, int tpr, int rpb,
                        float eps, float inv_n, cudaStream_t s) {
  const dim3 block(tpr, rpb);
  const long long blocks = (rows + rpb - 1) / rpb;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  T* st = static_cast<T*>(sum);
  if (a != nullptr)
    rmsnorm_kernel<T, W, VEC, true><<<(unsigned)blocks, block, 0, s>>>(
        xt, at, wt, ot, st, rows, n, x_rs, a_rs, eps, inv_n);
  else
    rmsnorm_kernel<T, W, VEC, false><<<(unsigned)blocks, block, 0, s>>>(
        xt, at, wt, ot, st, rows, n, x_rs, a_rs, eps, inv_n);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_norm_vec(int vec, const void* x, const void* a,
                            const void* w, void* out, void* sum,
                            long long rows, int n, long long x_rs,
                            long long a_rs, int tpr, int rpb, float eps,
                            float inv_n, cudaStream_t s) {
  if (vec)
    return launch_norm<T, W, 16 / sizeof(T)>(x, a, w, out, sum, rows, n,
                                             x_rs, a_rs, tpr, rpb, eps,
                                             inv_n, s);
  return launch_norm<T, W, 1>(x, a, w, out, sum, rows, n, x_rs, a_rs, tpr,
                              rpb, eps, inv_n, s);
}

// ---------------------------------------------------------------------------
// K10: rope on q and k, split halves
// ---------------------------------------------------------------------------

struct RopeParams {
  const void* q;
  const void* k;
  void* qo;
  void* ko;
  const void* pos;
  const float* freqs;
  int pos_i64;
  int S, Hq, Hkv, half;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long p_sr, p_sb, p_ss;
  int sec0, sec1;   // frequencies of M-RoPE's t and h axes (w: the rest)
};

template <typename T, int VEC>
__global__ void rope_kernel(RopeParams p) {
  extern __shared__ float cs[];   // cos[half], then sin[half]
  const long long tok = blockIdx.x;
  const long long b = tok / p.S, s = tok % p.S;
  const int half = p.half;
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const int axis = j < p.sec0 ? 0 : (j < p.sec0 + p.sec1 ? 1 : 2);
    const long long off = axis * p.p_sr + b * p.p_sb + s * p.p_ss;
    const float pf = p.pos_i64
        ? (float)static_cast<const long long*>(p.pos)[off]
        : (float)static_cast<const int*>(p.pos)[off];
    const float ang = __fmul_rn(pf, p.freqs[j]);
    cs[j] = cosf(ang);
    cs[half + j] = sinf(ang);
  }
  __syncthreads();
  const int per_head = half / VEC;
  const int items = (p.Hq + p.Hkv) * per_head;
  const int D = 2 * half;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int h = it / per_head;
    const int c = (it - h * per_head) * VEC;
    const T* src;
    T* dst;
    if (h < p.Hq) {
      src = static_cast<const T*>(p.q) + b * p.q_sb + s * p.q_ss + h * p.q_sh;
      dst = static_cast<T*>(p.qo) + (tok * p.Hq + h) * D;
    } else {
      h -= p.Hq;
      src = static_cast<const T*>(p.k) + b * p.k_sb + s * p.k_ss + h * p.k_sh;
      dst = static_cast<T*>(p.ko) + (tok * p.Hkv + h) * D;
    }
    float x1[VEC], x2[VEC], o1[VEC], o2[VEC];
    load_f<T, VEC>(src + c, x1);
    load_f<T, VEC>(src + half + c, x2);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float co = cs[c + e], si = cs[half + c + e];
      o1[e] = __fsub_rn(__fmul_rn(x1[e], co), __fmul_rn(x2[e], si));
      o2[e] = __fadd_rn(__fmul_rn(x2[e], co), __fmul_rn(x1[e], si));
    }
    store_f<T, VEC>(dst + c, o1);
    store_f<T, VEC>(dst + half + c, o2);
  }
}

template <typename T>
cudaError_t launch_rope(const RopeParams& p, int vec, long long tokens,
                        int threads, cudaStream_t s) {
  const size_t smem = 2 * p.half * sizeof(float);
  if (vec)
    rope_kernel<T, 16 / sizeof(T)><<<(unsigned)tokens, threads, smem, s>>>(p);
  else
    rope_kernel<T, 1><<<(unsigned)tokens, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype / wdtype: 0 float32, 1 bfloat16. a == nullptr: no residual add (sum
// unused). vec: 16-byte chunks (the wrapper has checked width, alignment and
// strides). tpr threads a row, rpb rows a block.
extern "C" int repro_rmsnorm(const void* x, const void* a, const void* w,
                             void* out, void* sum, int dtype, int wdtype,
                             int vec, long long rows, int n, long long x_rs,
                             long long a_rs, int tpr, int rpb, float eps,
                             float inv_n, void* stream) {
  if (rows <= 0 || n <= 0 || tpr <= 0 || tpr % 32 || tpr > 1024 ||
      rpb <= 0 || tpr * rpb > 1024 || (a != nullptr && sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int which = dtype * 2 + wdtype;
  switch (which) {
    case 0: return static_cast<int>(launch_norm_vec<float, float>(
        vec, x, a, w, out, sum, rows, n, x_rs, a_rs, tpr, rpb, eps, inv_n, s));
    case 1: return static_cast<int>(launch_norm_vec<float, bf16>(
        vec, x, a, w, out, sum, rows, n, x_rs, a_rs, tpr, rpb, eps, inv_n, s));
    case 2: return static_cast<int>(launch_norm_vec<bf16, float>(
        vec, x, a, w, out, sum, rows, n, x_rs, a_rs, tpr, rpb, eps, inv_n, s));
    case 3: return static_cast<int>(launch_norm_vec<bf16, bf16>(
        vec, x, a, w, out, sum, rows, n, x_rs, a_rs, tpr, rpb, eps, inv_n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, S, Hq, 2 * half) and k (B, S, Hkv, 2 * half; k == nullptr: Hkv 0)
// by their (B, S, H) strides; qo, ko contiguous. pos: int64 (pos_i64) or
// int32, read at axis * p_sr + b * p_sb + s * p_ss, the axis of frequency j
// 0 below sec0, 1 below sec0 + sec1, else 2. freqs: half fp32.
extern "C" int repro_rope(const void* q, const void* k, void* qo, void* ko,
                          const void* pos, const void* freqs, int dtype,
                          int pos_i64, int vec, long long tokens, int S,
                          int Hq, int Hkv, int half, long long q_sb,
                          long long q_ss, long long q_sh, long long k_sb,
                          long long k_ss, long long k_sh, long long p_sr,
                          long long p_sb, long long p_ss, int sec0, int sec1,
                          int threads, void* stream) {
  if (tokens <= 0 || S <= 0 || Hq <= 0 || Hkv < 0 || half <= 0 ||
      threads <= 0 || threads > 1024 || (Hkv > 0 && k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RopeParams p;
  p.q = q;
  p.k = k;
  p.qo = qo;
  p.ko = ko;
  p.pos = pos;
  p.freqs = static_cast<const float*>(freqs);
  p.pos_i64 = pos_i64;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.half = half;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.p_sr = p_sr;
  p.p_sb = p_sb;
  p.p_ss = p_ss;
  p.sec0 = sec0;
  p.sec1 = sec1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_rope<float>(p, vec, tokens,
                                                       threads, s));
    case 1: return static_cast<int>(launch_rope<bf16>(p, vec, tokens,
                                                      threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
