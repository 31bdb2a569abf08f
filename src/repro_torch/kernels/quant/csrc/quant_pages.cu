// Blockwise int8 quantize and dequantize, for Hopper (sm_90a), written by
// hand in CUDA C++: the per-(page, kv_head) kernels of a KV page pool (K4, K5)
// and the flat 256-element-block kernels of gradient compression (K6, K7).
//
// Replaces the TPU kernels of repro/kernels/quant/kernel.py, which all run one
// row body (_quant_kernel, _dequant_kernel) over different row layouts:
// ::quantize_pages and ::dequantize_pages on a pool laid out (n_pages, page,
// Hkv, d), ::quantize and ::dequantize on a flat (N,) array cut into rows of
// 256. Per block:
//
//   quantize:   scale = max(absmax over the block, 1e-12) / 127;
//               q = clip(round_half_even(x / scale), -127, 127)
//   dequantize: out = (float)q * scale, cast to the output dtype
//
// Bit for bit with the plain PyTorch versions: the absmax is exact in any
// order, both divisions are IEEE (this file is built without --use_fast_math
// and uses neither __fdividef nor a reciprocal multiply), rintf rounds half to
// even, and bf16 input is widened to fp32 before anything else.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM): all four are pure streams.
// quantize_pages at one pager pool (536 pages of 64 x 4 x 128 bf16) reads
// 35.1 MB and writes 17.6 MB of int8 plus 8.6 KB of scales, 15.7 us at the
// memory rate; dequantize_pages of the 178 host pages reads 5.8 MB and writes
// 11.7 MB of bf16, 5.2 us. The flat quantize of yi-9b's largest gradient leaf
// (48 x 4096 x 11008 bf16, 2.16 G elements) reads 4.33 GB and writes 2.16 GB
// of int8 and 34 MB of scales, 1.95 ms; its dequantize reads 2.2 GB and writes
// 8.66 GB of fp32, 3.24 ms.
//
// Design. The TPU kernels transpose the pool to (n_pages*Hkv, page*d) rows and
// broadcast each scale over 128 lanes; both exist only for the TPU's block
// layout. Here quantize_pages runs one thread block per (page, head) and reads
// the strided rows in place (page rows Hkv*d elements apart, d contiguous): a
// block-wide absmax (warp shuffles, then one value per warp in shared memory),
// then a second pass over the same elements, which the block has just brought
// into L1/L2. The flat quantize runs one warp per 256-element block, 8 warps
// per thread block: each lane loads its 8 elements with 16-byte loads (two
// float4 or one 8 x bf16 vector, neighbouring lanes on neighbouring
// addresses), keeps them in registers through a warp-shuffle absmax, and
// stores its 8 int8 values. Both dequantize kernels are elementwise; the flat
// one reads 8 int8 values and writes two float4 per thread.
//
// dequantize_pages (K5) is a 16-byte stream: one thread per 16 consecutive
// int8 values, one 16-byte load and two 16-byte bf16 stores (four float4 for
// fp32), the grid sized to the work. Since d % 16 == 0 the 16 values share a
// scale, found once per thread from the d-row r as (r / (page*Hkv))*Hkv +
// r % Hkv in 32-bit arithmetic (64-bit past 2^31 elements). Its first design
// moved one byte per thread per step of a grid-stride loop with two 64-bit
// divisions per element, and ran near 10% of its bound. Shapes with d % 16 != 0
// and q or out not 16-byte aligned run that scalar kernel, so K5 takes every
// pool it took before.
//
// What they leave undone: no TMA bulk copies, and quantize_pages reads each
// (page, head) block twice (the second time mostly from L1/L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QUANT_THREADS = 256;
constexpr int DEQUANT_THREADS = 256;

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

// grid (n_pages, Hkv); one block per (page, head)
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
    quantize_pages_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scales, int page, int hkv,
                          int d) {
  __shared__ float warp_max[QUANT_THREADS / 32];
  __shared__ float scale_s;
  const long long pg = blockIdx.x;
  const int h = blockIdx.y;
  const long long row_stride = static_cast<long long>(hkv) * d;
  const long long base = pg * page * row_stride + static_cast<long long>(h) * d;
  const int n = page * d;

  float mx = 0.f;
  for (int i = threadIdx.x; i < n; i += QUANT_THREADS) {
    const int r = i / d, c = i % d;
    mx = fmaxf(mx, fabsf(to_float(x[base + r * row_stride + c])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < QUANT_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float s = fmaxf(m, 1e-12f) / 127.0f;
    scale_s = s;
    scales[pg * hkv + h] = s;
  }
  __syncthreads();
  const float s = scale_s;
  for (int i = threadIdx.x; i < n; i += QUANT_THREADS) {
    const int r = i / d, c = i % d;
    const long long off = base + r * row_stride + c;
    const float v = rintf(to_float(x[off]) / s);
    q[off] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

// Page dequantize (K5), the vector path: thread t turns the 16 int8 values
// at 16t into 16 outputs (one 16-byte load; two 16-byte stores of bf16 or
// four float4). d % 16 == 0, so the 16 lie in one d-row r = 16t / d of one
// (page, head) and share its scale. I is int when the pool has fewer than
// 2^31 elements.
template <typename T, typename I>
__global__ void __launch_bounds__(DEQUANT_THREADS)
    dequantize_pages_vec_kernel(const int8_t* __restrict__ q,
                                const float* __restrict__ scales,
                                T* __restrict__ out, I n16, int page_hkv,
                                int hkv, int d16) {
  const I t = static_cast<I>(blockIdx.x) * DEQUANT_THREADS + threadIdx.x;
  if (t >= n16) return;
  const I r = t / d16;
  const float s = scales[(r / page_hkv) * hkv + r % hkv];
  const int4 raw = reinterpret_cast<const int4*>(q)[t];
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(c[i]) * s;
  if constexpr (std::is_same_v<T, float>) {
    float4* o = reinterpret_cast<float4*>(out) + 4 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    __nv_bfloat162 h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * t;
    o[0] = *reinterpret_cast<const uint4*>(&h[0]);
    o[1] = *reinterpret_cast<const uint4*>(&h[4]);
  }
}

// Page dequantize (K5), the scalar path: any d, any alignment; one element
// per thread per step of a grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(DEQUANT_THREADS)
    dequantize_pages_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            T* __restrict__ out, long long n, int page,
                            int hkv, int d) {
  const long long page_elems = static_cast<long long>(page) * hkv * d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long pg = i / page_elems;
    const int h = static_cast<int>((i / d) % hkv);
    out[i] = from_float<T>(static_cast<float>(q[i]) * scales[pg * hkv + h]);
  }
}

// Flat quantize (K6): one warp per 256-element block, 8 warps per thread
// block. Lane l holds 8 elements: for fp32 the float4s at 4l and 128 + 4l, for
// bf16 the 8-vector at 8l (16-byte loads either way, the warp's loads
// contiguous).
constexpr int FLAT_BLOCK = 256;
constexpr int FLAT_WARPS = 8;

__device__ __forceinline__ void load8(const float* blk, int lane, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(blk)[lane];
  const float4 b = reinterpret_cast<const float4*>(blk + 128)[lane];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* blk, int lane,
                                      float v[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(blk)[lane];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(FLAT_WARPS * 32)
    quantize_flat_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long nb) {
  const long long b = static_cast<long long>(blockIdx.x) * FLAT_WARPS +
                      threadIdx.x / 32;
  if (b >= nb) return;
  const int lane = threadIdx.x % 32;
  float v[8];
  load8(x + b * FLAT_BLOCK, lane, v);
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float s = fmaxf(mx, 1e-12f) / 127.0f;
  int8_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    c[i] = static_cast<int8_t>(fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f));
  // store where the values were loaded from: 4 + 4 at 4l and 128 + 4l for
  // fp32, 8 at 8l for bf16
  int8_t* qblk = q + b * FLAT_BLOCK;
  const char4 lo = make_char4(c[0], c[1], c[2], c[3]);
  const char4 hi = make_char4(c[4], c[5], c[6], c[7]);
  if constexpr (std::is_same_v<T, float>) {
    reinterpret_cast<char4*>(qblk)[lane] = lo;
    reinterpret_cast<char4*>(qblk + 128)[lane] = hi;
  } else {
    reinterpret_cast<int2*>(qblk)[lane] =
        make_int2(*reinterpret_cast<const int*>(&lo),
                  *reinterpret_cast<const int*>(&hi));
  }
  if (lane == 0) scales[b] = s;
}

// Flat dequantize (K7): thread t of the grid-stride loop turns the 8 int8
// values at 8t into two float4; the 8 share one 256-element block's scale.
__global__ void __launch_bounds__(DEQUANT_THREADS)
    dequantize_flat_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           float* __restrict__ out, long long n8) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n8; t += stride) {
    const int2 raw = reinterpret_cast<const int2*>(q)[t];
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
    const float s = scales[t / (FLAT_BLOCK / 8)];
    float4* o = reinterpret_cast<float4*>(out) + 2 * t;
    o[0] = make_float4(static_cast<float>(c[0]) * s, static_cast<float>(c[1]) * s,
                       static_cast<float>(c[2]) * s, static_cast<float>(c[3]) * s);
    o[1] = make_float4(static_cast<float>(c[4]) * s, static_cast<float>(c[5]) * s,
                       static_cast<float>(c[6]) * s, static_cast<float>(c[7]) * s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x for quantize, of out for
// dequantize). All arrays are contiguous, x/q/out (n_pages, page, hkv, d) and
// scales (n_pages, hkv). Each returns the CUDA error code of its launch (0 on
// success); they allocate nothing, run on the given stream and do not
// synchronise.
extern "C" int repro_quantize_pages(const void* x, void* q, void* scales,
                                    int dtype, int n_pages, int page, int hkv,
                                    int d, void* stream) {
  if (n_pages <= 0 || page <= 0 || hkv <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_pages, hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      quantize_pages_kernel<float><<<grid, QUANT_THREADS, 0, s>>>(
          static_cast<const float*>(x), qo, so, page, hkv, d);
      break;
    case 1:
      quantize_pages_kernel<__nv_bfloat16><<<grid, QUANT_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), qo, so, page, hkv, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename T, typename I>
cudaError_t dequantize_pages_vec(const int8_t* q, const float* scales,
                                 T* out, long long n, int page, int hkv,
                                 int d, cudaStream_t s) {
  const long long n16 = n / 16;
  const long long blocks = (n16 + DEQUANT_THREADS - 1) / DEQUANT_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dequantize_pages_vec_kernel<T, I>
      <<<static_cast<unsigned>(blocks), DEQUANT_THREADS, 0, s>>>(
          q, scales, out, static_cast<I>(n16), page * hkv, hkv, d / 16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dequantize_pages_any(const int8_t* q, const float* scales,
                                 T* out, long long n, int page, int hkv,
                                 int d, cudaStream_t s) {
  const bool vec = d % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (vec && n < (1LL << 31))
    return dequantize_pages_vec<T, int>(q, scales, out, n, page, hkv, d, s);
  if (vec)
    return dequantize_pages_vec<T, long long>(q, scales, out, n, page, hkv,
                                              d, s);
  const long long want = (n + DEQUANT_THREADS - 1) / DEQUANT_THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  dequantize_pages_kernel<T><<<blocks, DEQUANT_THREADS, 0, s>>>(
      q, scales, out, n, page, hkv, d);
  return cudaGetLastError();
}

}  // namespace

// Runs the vector path when d % 16 == 0 and q and out are 16-byte aligned,
// the scalar path otherwise; the same function either way.
extern "C" int repro_dequantize_pages(const void* q, const void* scales,
                                      void* out, int dtype, int n_pages,
                                      int page, int hkv, int d,
                                      void* stream) {
  if (n_pages <= 0 || page <= 0 || hkv <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_pages) * page * hkv * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(scales);
  switch (dtype) {
    case 0:
      return static_cast<int>(dequantize_pages_any<float>(
          qi, si, static_cast<float*>(out), n, page, hkv, d, s));
    case 1:
      return static_cast<int>(dequantize_pages_any<__nv_bfloat16>(
          qi, si, static_cast<__nv_bfloat16*>(out), n, page, hkv, d, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// Flat blockwise quantize (K6): x (n,) float32 (dtype 0) or bfloat16 (dtype
// 1), n a multiple of 256, x 16-byte aligned -> q int8 (n,) (8-byte aligned),
// scales float32 (n / 256,). Returns the CUDA error code of the launch.
extern "C" int repro_quantize(const void* x, void* q, void* scales, int dtype,
                              long long n, void* stream) {
  if (n <= 0 || n % FLAT_BLOCK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = n / FLAT_BLOCK;
  const long long grid = (nb + FLAT_WARPS - 1) / FLAT_WARPS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      quantize_flat_kernel<float><<<static_cast<unsigned>(grid),
                                    FLAT_WARPS * 32, 0, s>>>(
          static_cast<const float*>(x), qo, so, nb);
      break;
    case 1:
      quantize_flat_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid),
                                            FLAT_WARPS * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), qo, so, nb);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Flat blockwise dequantize (K7): q int8 (n,) (8-byte aligned), scales
// float32 (n / 256,) -> out float32 (n,) (16-byte aligned), n a multiple of
// 256. Returns the CUDA error code of the launch.
extern "C" int repro_dequantize(const void* q, const void* scales, void* out,
                                long long n, void* stream) {
  if (n <= 0 || n % FLAT_BLOCK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  const long long want = (n8 + DEQUANT_THREADS - 1) / DEQUANT_THREADS;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  dequantize_flat_kernel<<<blocks, DEQUANT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}
