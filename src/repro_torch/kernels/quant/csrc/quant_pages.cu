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
// 8.66 GB of fp32, 3.24 ms. A quantize also issues, per element, an IEEE
// division (a reciprocal on the SM's quarter-rate pipe, a range check and a
// branch around the slow path, never hoisted out of the element loop),
// rintf (the same quarter-rate pipe) and a clamp: at the pager shape that
// issue time is of the order of the memory time, so a kernel that does not
// overlap it with its loads, or that adds conversions, is held well above
// its byte bound.
//
// quantize_pages (K4) has two paths; the wrapper (ops.quantize_pages_plan)
// picks one and passes its thread mapping in.
//
// The vector path, one read of device memory: one block per (page, head),
// whose page x d elements lie in d-rows Hkv*d apart. A chunk is 16 bytes of
// one d-row (8 bf16 or 4 fp32); chunk c is d-row c / cpr, columns
// VEC * (c % cpr), with cpr = d / VEC chunks per row, so neighbouring lanes
// read neighbouring chunks and a d-row of 128 bf16 is two whole 128-byte
// lines. Thread t holds chunks t + k * blockDim.x for k < CPT (a template
// parameter, 1-8): it issues all CPT 16-byte loads before it uses one, keeps
// the raw chunks in registers (4 per chunk; 16 at the pager shape, where 256
// threads hold 32 bf16 each), takes the absmax from them (on bf16 pairs,
// exact), reduces it with warp shuffles and then across warps through shared
// memory (each warp shuffles the warp maxima, so every thread has the
// block's maximum after one barrier), and quantizes the values it holds. Its
// int8 output goes out as one 8-byte (bf16) or 4-byte (fp32) store per
// chunk, where the chunk came from, packed by byte permutes from the clamped
// whole floats plus 1.5 * 2^23, without a float-to-int conversion. Row and
// column are found once per chunk from the thread index; no division per
// element. At most 256 threads a block (40 registers at the pager shape)
// keep six blocks resident on an SM, each with its whole (page, head) in
// flight.
//
// The general path (any d, any alignment, larger blocks) is the first
// design: 256 threads per (page, head) loop over its elements with one
// scalar load each and two integer divisions, take the block absmax (warp
// shuffles, then thread 0 over the warp maxima), then quantize in a second
// pass that reads the block again, mostly from L1/L2, and stores one byte per
// element. At the pager shape it ran at 23% of its bound (H100 80GB HBM3,
// 700 W).
//
// The flat quantize runs one warp per 256-element block, 8 warps per thread
// block: each lane loads its 8 elements with 16-byte loads (two float4 or one
// 8 x bf16 vector, neighbouring lanes on neighbouring addresses), keeps them
// in registers through a warp-shuffle absmax, and stores its 8 int8 values.
// Both dequantize kernels are elementwise; the flat one reads 8 int8 values
// and writes two float4 per thread.
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
// What they leave undone: no TMA bulk copies, and a quantize block loads,
// then reduces, then computes, so an SM overlaps one block's loads only with
// other blocks' arithmetic. A persistent grid that kept the next (page,
// head) in flight through a cp.async ring in shared memory while the
// current one quantized was slower: it ran fewer warps per SM, and the
// arithmetic, not the copies, set its pace.

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

// The VEC values of one 16-byte chunk, widened to fp32.
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

// Page quantize (K4), the general path: grid (n_pages, Hkv), one block of
// QUANT_THREADS per (page, head), any d and alignment.
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

// Offsets within a (page, head) block of this thread's CPT chunks, chunk
// t + k * blockDim.x being d-row c / cpr, elements VEC * (c % cpr) on; -1
// for a chunk past the block's n_chunks.
template <int CPT, int VEC>
__device__ __forceinline__ void chunk_offsets(int (&off)[CPT], int cpr,
                                              int row_stride, int n_chunks) {
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    const int r = c / cpr;
    off[k] = c < n_chunks ? r * row_stride + (c - r * cpr) * VEC : -1;
  }
}

// The block's absmax from each thread's held chunks: warp shuffles, then
// one barrier and each warp shuffling the warp maxima in warp_max, so every
// thread returns the block maximum.
template <typename T, int CPT>
__device__ __forceinline__ float block_absmax(const uint4 (&raw)[CPT],
                                              float* warp_max) {
  constexpr int VEC = 16 / sizeof(T);
  float mx = 0.f;
  if constexpr (VEC == 8) {
    // bf16 pairs: |x| and max are exact in bf16, so the pairs' max widened
    // is the max of the widened values
    __nv_bfloat162 m2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) m2 = __hmax2(m2, __habs2(h[i]));
    }
    const float2 f = __bfloat1622float2(m2);
    mx = fmaxf(f.x, f.y);
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      float v[VEC];
      unpack(raw[k], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) mx = fmaxf(mx, fabsf(v[i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const int lane = threadIdx.x % 32;
  if (lane == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = lane < static_cast<int>(blockDim.x / 32) ? warp_max[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  return mx;
}

// Quantizes the held chunks by scale s and stores each chunk's VEC int8
// values as one 8-byte (bf16) or 4-byte (fp32) store where it was loaded
// from. c = clip(rintf(x / s), -127, 127) is a whole float, so c + 1.5 * 2^23
// is exact and its low byte is c as an int8 (two's complement): four of
// them are packed by byte permutes, with no float-to-int conversion (those
// share the SM's quarter-rate pipe with the division's reciprocal and
// rintf).
template <typename T, int CPT>
__device__ __forceinline__ void store_chunks(int8_t* qb, const int (&off)[CPT],
                                             const uint4 (&raw)[CPT],
                                             float s) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    if (off[k] < 0) continue;
    float v[VEC];
    unpack(raw[k], v);
    uint32_t w[VEC / 4];
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      uint32_t b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = fminf(fmaxf(rintf(v[4 * j + i] / s), -127.f), 127.f);
        b[i] = __float_as_uint(__fadd_rn(c, 12582912.0f));
      }
      w[j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                         __byte_perm(b[2], b[3], 0x0040), 0x5410);
    }
    if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(qb + off[k]) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(qb + off[k]) = w[0];
  }
}

// Page quantize (K4), the vector path (see the header): grid (n_pages, Hkv),
// blockDim.x a multiple of 32 and at most QUANT_THREADS, CPT chunks of VEC
// elements per thread, page * cpr chunks per (page, head).
template <typename T, int CPT>
__global__ void __launch_bounds__(QUANT_THREADS)
    quantize_pages_kernel_vec(const T* __restrict__ x, int8_t* __restrict__ q,
                              float* __restrict__ scales, int page, int hkv,
                              int d, int cpr) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float warp_max[QUANT_THREADS / 32];
  const int h = blockIdx.y;
  const int row_stride = hkv * d;
  const long long base =
      static_cast<long long>(blockIdx.x) * page * row_stride +
      static_cast<long long>(h) * d;
  int off[CPT];
  chunk_offsets<CPT, VEC>(off, cpr, row_stride, page * cpr);
  uint4 raw[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    raw[k] = off[k] >= 0 ? *reinterpret_cast<const uint4*>(x + base + off[k])
                         : make_uint4(0u, 0u, 0u, 0u);
  const float s =
      fmaxf(block_absmax<T, CPT>(raw, warp_max), 1e-12f) / 127.0f;
  if (threadIdx.x == 0)
    scales[static_cast<long long>(blockIdx.x) * hkv + h] = s;
  store_chunks<T, CPT>(q + base, off, raw, s);
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

namespace {

template <typename T, int CPT>
void launch_quantize_pages_vec(const T* x, int8_t* q, float* scales,
                               dim3 grid, int threads, int page, int hkv,
                               int d, cudaStream_t s) {
  quantize_pages_kernel_vec<T, CPT><<<grid, threads, 0, s>>>(
      x, q, scales, page, hkv, d, d / (16 / static_cast<int>(sizeof(T))));
}

// The vector path's plan as the wrapper gives it: threads a multiple of 32
// and at most QUANT_THREADS, chunks per thread 1, 2, 4 or 8, enough chunks
// for the (page, head), d whole chunks, x 16-byte and q chunk aligned, and
// in-block offsets in 32 bits. Anything else is refused, not run otherwise.
template <typename T>
cudaError_t quantize_pages_vec(const T* x, int8_t* q, float* scales,
                               dim3 grid, int threads, int chunks, int page,
                               int hkv, int d, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (threads <= 0 || threads % 32 || threads > QUANT_THREADS ||
      d % VEC || static_cast<long long>(threads) * chunks * VEC <
                     static_cast<long long>(page) * d ||
      static_cast<long long>(page) * hkv * d >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % VEC)
    return cudaErrorInvalidValue;
  switch (chunks) {
    case 1:
      launch_quantize_pages_vec<T, 1>(x, q, scales, grid, threads, page, hkv,
                                      d, s);
      break;
    case 2:
      launch_quantize_pages_vec<T, 2>(x, q, scales, grid, threads, page, hkv,
                                      d, s);
      break;
    case 4:
      launch_quantize_pages_vec<T, 4>(x, q, scales, grid, threads, page, hkv,
                                      d, s);
      break;
    case 8:
      launch_quantize_pages_vec<T, 8>(x, q, scales, grid, threads, page, hkv,
                                      d, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize_pages_any(const T* x, int8_t* q, float* scales,
                               int n_pages, int page, int hkv, int d,
                               int path, int threads, int chunks,
                               cudaStream_t s) {
  const dim3 grid(n_pages, hkv);
  if (path == 1)
    return quantize_pages_vec<T>(x, q, scales, grid, threads, chunks, page,
                                 hkv, d, s);
  if (path != 0) return cudaErrorInvalidValue;
  quantize_pages_kernel<T><<<grid, QUANT_THREADS, 0, s>>>(x, q, scales, page,
                                                          hkv, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x for quantize, of out for
// dequantize). All arrays are contiguous, x/q/out (n_pages, page, hkv, d) and
// scales (n_pages, hkv). Each returns the CUDA error code of its launch (0 on
// success); they allocate nothing, run on the given stream and do not
// synchronise.
//
// quantize_pages takes its plan from the wrapper: path 0 is the general
// kernel (threads and chunks unused), path 1 the vector kernel with
// ``threads`` threads a block holding ``chunks`` 16-byte chunks each.
extern "C" int repro_quantize_pages(const void* x, void* q, void* scales,
                                    int dtype, int n_pages, int page, int hkv,
                                    int d, int path, int threads, int chunks,
                                    void* stream) {
  if (n_pages <= 0 || page <= 0 || hkv <= 0 || d <= 0 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      return static_cast<int>(quantize_pages_any<float>(
          static_cast<const float*>(x), qo, so, n_pages, page, hkv, d, path,
          threads, chunks, s));
    case 1:
      return static_cast<int>(quantize_pages_any<__nv_bfloat16>(
          static_cast<const __nv_bfloat16*>(x), qo, so, n_pages, page, hkv,
          d, path, threads, chunks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
