// HEIMDALL's probe kernels, for Hopper (sm_90a), written by hand in CUDA C++:
// the loads, sums, atomics and copies the microbenchmarks time on each memory
// tier, HBM or pinned host memory read through its mapped device pointer.
//
// They replace no Pallas kernel. The reference runs these probes as jitted
// JAX loops (repro/heimdall/micro.py): a pointer chase in lax.fori_loop
// (micro_latency :34, micro_loaded_latency :82, micro_cache_heatmap :171),
// sums of tier-resident arrays (:47, :96), a scatter-add (:136-149) and an
// elementwise copy (:217). On the card a Python loop of indexing ops would be
// one launch per step and would time the launch, not the load; and PyTorch
// cannot address pinned host memory from a kernel at all. So:
//
//   P1 pointer_chase  one thread runs a dependent chain of `steps` loads and
//                     writes the final int32. Mode 0 (chase): idx = p[idx],
//                     the index normalised and clamped as JAX's gather does.
//                     Mode 1 (sweep): acc = acc + p[acc mod n], in uint32 so
//                     that the sum wraps as JAX's int32 does (signed overflow
//                     is undefined in C++), then a floor modulo of its signed
//                     view (JAX's %, jnp.remainder; C's % truncates and would
//                     index below 0). Bound by latency alone: each load waits
//                     for the last, so the time per step is the result.
//   P2 tier_sum       fp32 sum of a buffer: 16-byte loads in a grid-stride
//                     loop, warp shuffles, one fp32 partial per block through
//                     shared memory, added in fp64 (atomicAdd on a zeroed
//                     scratch double) so that thousands of block partials do
//                     not lose bits to an fp32 running sum; the block that
//                     counts in last writes the fp32 result. The order of
//                     the sum differs from any other, so it is compared with
//                     a float64 sum at a relative tolerance, never bit for
//                     bit. Bound by bytes.
//   P3 tier_scatter_add  t[i[k]] += u[k] by atomicAdd, one thread per update;
//                     a negative index is taken from the end and one still
//                     out of range is dropped, as JAX's .at[].add does.
//                     Colliding updates serialise on one address: bound by
//                     the atomic unit, not bytes.
//   P4 tier_copy      out = x * 1.0 by the SMs (not the copy engine): 16-byte
//                     loads and stores in a grid-stride loop. Bound by bytes.
//
// A buffer on the host tier is pinned memory; the entry point asks
// cudaHostGetDevicePointer for its device address and returns that call's
// error if it has none (pageable memory is never read this way). Loads from
// host memory are ld.global.cv: each one crosses the link again instead of
// hitting a line the L2 kept (the L2 caches system memory). The chase reads
// device memory with ld.global.cg (L2, not L1: its working set is the tier's,
// not one SM's L1); the sweep, the cache-utilisation probe, uses plain loads
// so every cache level takes part. Atomics on mapped host memory are atomic
// from this device's point of view only (NVIDIA's CUDA documentation, mapped
// page-locked memory): enough for one device that adds and then checks.
//
// Entry points take plain C types and return the CUDA error of the launch
// (0 on success); they allocate nothing and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUM_THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

template <typename T>
__device__ __forceinline__ T load(const T* p, int sysmem, int cached) {
  if (sysmem) return __ldcv(p);
  return cached ? *p : __ldcg(p);
}

__global__ void pointer_chase_kernel(const int* p, long long n, int steps,
                                     int mode, int sysmem, int* out) {
  if (mode == 0) {
    int idx = 0;
    for (int s = 0; s < steps; ++s) {
      long long i = idx < 0 ? static_cast<long long>(idx) + n : idx;
      i = i < 0 ? 0 : (i >= n ? n - 1 : i);
      idx = load(p + i, sysmem, 0);
    }
    *out = idx;
    return;
  }
  uint32_t acc = 0;
  for (int s = 0; s < steps; ++s) {
    long long r = static_cast<long long>(static_cast<int32_t>(acc)) % n;
    if (r < 0) r += n;
    acc += static_cast<uint32_t>(load(p + r, sysmem, 1));
  }
  *out = static_cast<int32_t>(acc);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[SUM_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < SUM_THREADS / 32 ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// scratch of tier_sum: the fp64 running sum and the count of blocks done,
// zeroed by the entry point before the launch
struct SumScratch {
  double sum;
  unsigned int done;
};

__global__ void tier_sum_kernel(const float* x, long long n, int vec,
                                int sysmem, SumScratch* scratch,
                                float* out) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = load(x4 + i, sysmem, 1);
      acc += (v.x + v.y) + (v.z + v.w);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    acc += load(x + i, sysmem, 1);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    atomicAdd(&scratch->sum, static_cast<double>(acc));
    __threadfence();
    if (atomicAdd(&scratch->done, 1u) == gridDim.x - 1)
      *out = static_cast<float>(atomicAdd(&scratch->sum, 0.0));
  }
}

__global__ void tier_scatter_add_kernel(float* t, long long n,
                                        const int* idx, const float* u,
                                        long long m) {
  const long long k = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (k >= m) return;
  long long i = idx[k];
  if (i < 0) i += n;
  if (i < 0 || i >= n) return;
  atomicAdd(t + i, u[k]);
}

__global__ void tier_copy_kernel(const float* x, float* out, long long n,
                                 int vec, int sysmem) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = load(x4 + i, sysmem, 1);
      o4[i] = make_float4(v.x * 1.0f, v.y * 1.0f, v.z * 1.0f, v.w * 1.0f);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = load(x + i, sysmem, 1) * 1.0f;
}

// The address a kernel on the current device reads `p` through: `p` itself
// for device memory, the mapped device pointer for pinned host memory. On
// failure the runtime's last error is cleared, so the next launch check
// reports only its own.
cudaError_t device_view(const void* p, int on_host, const void** out) {
  if (!on_host) {
    *out = p;
    return cudaSuccess;
  }
  void* d = nullptr;
  const cudaError_t err =
      cudaHostGetDevicePointer(&d, const_cast<void*>(p), 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *out = d;
  return cudaSuccess;
}

int blocks_for(long long work) {
  const long long want = (work + SUM_THREADS - 1) / SUM_THREADS;
  return static_cast<int>(want < 1 ? 1 : (want < MAX_BLOCKS ? want
                                                            : MAX_BLOCKS));
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
          & 15u) == 0;
}

}  // namespace

extern "C" int repro_pointer_chase(const void* p, int on_host, long long n,
                                   int steps, int mode, void* out,
                                   void* stream) {
  if (n <= 0 || steps < 0 || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* pd = nullptr;
  const cudaError_t err = device_view(p, on_host, &pd);
  if (err != cudaSuccess) return static_cast<int>(err);
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pd), n, steps, mode, on_host,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `scratch`: 16 device bytes, 8-byte aligned (the wrapper's allocation).
extern "C" int repro_tier_sum(const void* x, int on_host, long long n,
                              void* scratch, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* xd = nullptr;
  cudaError_t err = device_view(x, on_host, &xd);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, sizeof(SumScratch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned16(xd, xd);
  tier_sum_kernel<<<blocks_for(vec ? n / 4 : n), SUM_THREADS, 0, s>>>(
      static_cast<const float*>(xd), n, vec, on_host,
      static_cast<SumScratch*>(scratch), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_tier_scatter_add(void* t, int on_host, long long n,
                                      const void* idx, const void* u,
                                      long long m, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* td = nullptr;
  const cudaError_t err = device_view(t, on_host, &td);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (m + SUM_THREADS - 1) / SUM_THREADS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tier_scatter_add_kernel<<<static_cast<unsigned>(grid), SUM_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(const_cast<void*>(td)), n,
      static_cast<const int*>(idx), static_cast<const float*>(u), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_tier_copy(const void* x, int on_host, void* out,
                               long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* xd = nullptr;
  const cudaError_t err = device_view(x, on_host, &xd);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned16(xd, out);
  tier_copy_kernel<<<blocks_for(vec ? n / 4 : n), SUM_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<float*>(out), n, vec,
      on_host);
  return static_cast<int>(cudaGetLastError());
}
