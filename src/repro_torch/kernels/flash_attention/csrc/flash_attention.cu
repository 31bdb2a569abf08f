// Forward flash attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_fwd_kernel
// and computes what it computes: GQA (kv_head = q_head / (Hq / Hkv)), causal
// and sliding-window masks filled with -1e30, a running max m, sum l and
// accumulator acc in fp32, and out = acc / (l == 0 ? 1 : l) in q's dtype. KV
// tiles wholly above the causal diagonal or below the window are skipped. The
// ragged edge is masked here (keys past Skv get p = 0, query rows past Sq are
// not stored) instead of asserting divisibility.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at
// the yi-9b prefill shape (B=4, Hq=32, Hkv=4, S=1024, d=128, causal, bf16) the
// unmasked products are 4*B*Hq*d*S*(S+1)/2 = 3.4e10 FLOP, 35 us at the
// tensor-core rate, against 75 MB of q, k, v and o, 23 us at the memory rate.
// So the bound is compute, about 35 us per call.
//
// Design (simple and right first). One block of 256 threads per (batch,
// q-head, 64-row q tile); the loop over 32-row KV tiles inside the block takes
// the place of the TPU's sequential KV grid axis. The q tile and each KV tile
// are staged in shared memory as fp32 (rows padded by one float so the
// column-wise reads of k hit distinct banks). Each thread owns 4 query rows
// (ty + 16 i) and computes their scores against 2 keys (tx + 16 j) and their
// output at d/16 columns (tx + 16 c) with fp32 FMAs; row max and row sum are
// reduced across the 16 threads of a row with warp shuffles, and p goes
// through shared memory to the p.v product. q, k, v and o are addressed
// through the strides given (last dim contiguous), so the model can pass
// (B, S, H, d) tensors viewed as (B, H, S, d) without copying them.
//
// What it leaves on the table: it uses no tensor cores (fp32 FMAs top out
// near 67 TFLOP/s, so this design cannot come within 15x of the bound), no
// wgmma, no TMA and no cp.async pipelining of the KV tiles, and under the
// causal mask the blocks of late q tiles do up to S/64 times the work of the
// first ones, with no rebalancing. Those are for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 32;   // key rows per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv;
  // strides in elements over (batch, head, seq); the head dim has stride 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return BLOCK_M * (D + 1) + BLOCK_N * (D + 1) + BLOCK_N * D +
         BLOCK_M * (BLOCK_N + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int QS = D + 1;        // padded row stride of the q and k tiles
  constexpr int PS = BLOCK_N + 1;  // padded row stride of the p tile
  constexpr int RM = BLOCK_M / 16; // query rows per thread
  constexpr int CN = BLOCK_N / 16; // keys per thread in the score tile
  constexpr int CD = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;                  // BLOCK_M x QS
  float* k_s = q_s + BLOCK_M * QS;    // BLOCK_N x QS
  float* v_s = k_s + BLOCK_N * QS;    // BLOCK_N x D
  float* p_s = v_s + BLOCK_N * D;     // BLOCK_M x PS

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    q_s[r * QS + c] = qr < p.Sq ? to_float(q[qr * p.q_ss + c]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + BLOCK_M - 1;
  const int n_kv = (p.Skv + BLOCK_N - 1) / BLOCK_N;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BLOCK_N;
    // Skip tiles wholly above the causal diagonal or below the window.
    if (p.causal && k0 > q_last) break;
    if (p.window > 0 && k0 + BLOCK_N - 1 <= q0 - p.window) continue;

    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    for (int i = tid; i < BLOCK_N * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool in = kr < p.Skv;
      k_s[r * QS + c] = in ? to_float(k[kr * p.k_ss + c]) : 0.f;
      v_s[r * D + c] = in ? to_float(v[kr * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) kv[jj] = k_s[(tx + 16 * jj) * QS + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < CN; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty + 16 * i;
      const int qr = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int kc = k0 + tx + 16 * jj;
        bool keep = true;
        if (p.causal) keep = keep && kc <= qr;
        if (p.window > 0) keep = keep && kc > qr - p.window;
        float sv = keep ? s[i][jj] * p.scale : MASKED;
        if (kc >= p.Skv) sv = -INFINITY;  // past the ragged edge: p = 0
        s[i][jj] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const float pv = expf(s[i][jj] - m_new);
        p_s[row * PS + tx + 16 * jj] = pv;
        rs += pv;
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BLOCK_N; ++n) {
      float pv[RM], vv[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * PS + n];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = v_s[n * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= p.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[qr * p.o_ss + tx + 16 * c] = from_float<T>(acc[i][c] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, p.Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// CUDA error code of the launch (0 on success). Allocates nothing; runs on
// the given stream and does not synchronise.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, int q_sb, int q_sh, int q_ss,
    int k_sb, int k_sh, int k_ss, int v_sb, int v_sh, int v_ss, int o_sb,
    int o_sh, int o_ss, float scale, int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_d<float>(p, B, D, s); break;
    case 1: err = launch_d<__nv_bfloat16>(p, B, D, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
