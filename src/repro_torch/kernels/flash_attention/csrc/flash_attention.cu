// Forward flash attention for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_fwd_kernel
// and computes what it computes: GQA (kv_head = q_head / (Hq / Hkv)), causal
// and sliding-window masks filled with -1e30, a running max m, sum l and
// accumulator acc in fp32, and out = acc / (l == 0 ? 1 : l) in q's dtype. KV
// tiles wholly above the causal diagonal or below the window are skipped. The
// ragged edge is masked here (keys past Skv get p = 0, query rows past Sq are
// not stored) instead of asserting divisibility. q, k, v and o are addressed
// through the strides given (last dim contiguous), so the model passes its
// (B, S, H, d) tensors viewed as (B, H, S, d) without copying them.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at
// the yi-9b prefill shape (B=4, Hq=32, Hkv=4, S=1024, d=128, causal, bf16) the
// unmasked products are 4*B*Hq*d*S*(S+1)/2 = 3.4e10 FLOP, 35 us at the
// tensor-core rate, against 75 MB of q, k, v and o, 23 us at the memory rate.
// So the bound is compute, about 35 us per call, and only the tensor cores
// can come near it.
//
// bf16 (the model's dtype): flash_fwd_kernel, on the tensor cores.
//   Work: one item per (q tile of 128 rows, batch, q head). The grid is
//   persistent, one block per SM, walking the items with the last q tiles
//   (the most KV tiles under the causal mask) first and the Hq / Hkv heads
//   of one KV head side by side, so that their K/V tiles come from L2.
//   Roles: warpgroups 0 and 1 (64 query rows each, the M of one wgmma)
//   multiply; warpgroup 2 copies. One of its threads issues TMA copies of
//   the q tile and of 128-key K and V tiles into a two-stage ring in shared
//   memory; the two sides meet only at mbarriers (full/empty for q, and for
//   each K and each V stage, so that tile j + 1's K can come in as soon as
//   S(j - 1) is done with its stage). setmaxnreg moves registers from the
//   copier (40) to the multipliers (232). Layouts TMA cannot take (strides
//   or pointers that are not 16-byte multiples) are copied element by
//   element by the whole copier warpgroup into the same tiles.
//   Tiles: 64-column blocks of 128-byte rows with the 128-byte swizzle
//   (16-byte chunk c of row r at c ^ (r % 8)), written so by TMA and named
//   so by the wgmma descriptors. Shared memory at d = 128: q 32 KB + 2 x (K
//   32 KB + V 32 KB) + the output tile 32 KB = 192 KB. A head dim below 64
//   runs the d = 64 instantiation and one between 64 and 128 the d = 128
//   one (any multiple of 8: zamba2's 112, say); TMA fills the columns past
//   d with zeros and the store leaves them out.
//   Products: S = q k^T by wgmma m64n128k16 with both operands in shared
//   memory (K-major); P v by wgmma m64n{d}k16 with P in registers (bf16)
//   and V read as an MN-major (transposed) B. Tile j issues S(j) and P(j-1)
//   v(j-1) together and runs the online softmax of tile j (on the fp32
//   accumulator fragment, P left in place there; exp2 with the scale folded
//   into log2 e; row max over the 4 lanes of a row by shuffles) while
//   P(j-1) v(j-1) is still on the tensor cores. The per-element mask runs
//   only on the tiles that straddle the causal diagonal, the window edge or
//   Skv. The output goes through shared memory so that each row leaves in
//   16-byte stores, while the copier already brings the next item's q in.
//   Precision: P v takes P in bf16, as every tensor-core flash kernel does;
//   scores, the softmax statistics and both accumulators stay fp32, and
//   out = acc * (1 / l) (the plain version divides; both round to bf16).
//
// float32 (tests only): flash_fwd_fp32_kernel, the first port's design, fp32
// FMAs through shared memory (one block of 256 threads per 64-row q tile,
// 32-key tiles). The fp32 sweep's 2e-5 tolerance rules out TF32.
//
// What it leaves undone: the two multiplying warpgroups are not scheduled
// in turn (a ping-pong on named barriers made ptxas serialise the wgmma for
// want of registers), ptxas caps a 384-thread block at 168 registers a
// thread before setmaxnreg and spills a little, and on the diagonal tile the
// first warpgroup computes the half of the scores that its mask throws away.
// PERF.md has the measurements.

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv, d;
  // strides in elements over (batch, head, seq); the head dim has stride 1
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;
};

// ---------------------------------------------------------------------------
// float32: fp32 FMAs through shared memory
// ---------------------------------------------------------------------------

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 32;   // key rows per tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads

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
constexpr int fp32_smem_floats() {
  return BLOCK_M * (D + 1) + BLOCK_N * (D + 1) + BLOCK_N * D +
         BLOCK_M * (BLOCK_N + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_fp32_kernel(
    const Params p) {
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // columns past p.d (a head dim the instantiation D rounds up) are zero
  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    q_s[r * QS + c] = qr < p.Sq && c < p.d ? q[qr * p.q_ss + c] : 0.f;
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
      const bool in = kr < p.Skv && c < p.d;
      k_s[r * QS + c] = in ? k[kr * p.k_ss + c] : 0.f;
      v_s[r * D + c] = in ? v[kr * p.v_ss + c] : 0.f;
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
      if (tx + 16 * c < p.d) o[qr * p.o_ss + tx + 16 * c] = acc[i][c] / li;
  }
}

template <int D>
cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
  const int smem = fp32_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, p.Hq, p.B);
  flash_fwd_fp32_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_M = 128;        // query rows per item: two warpgroups of 64
constexpr int TC_N = 128;        // keys per K/V tile (the N of q k^T)
constexpr int TC_CONSUMERS = 256;  // warpgroups 0 and 1: the products
constexpr int TC_THREADS = 384;    // warpgroup 2: the copies
constexpr int TC_STAGES = 2;

// q, the K and V stages, the output tile, then the barriers; 1 KB of slack
// to align the tiles to 1 KB
template <int D>
constexpr int tc_smem_bytes() {
  return 1024 + 2 * TC_M * D * 2 + TC_STAGES * 2 * TC_N * D * 2 + 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Byte offset of element (r, c) of a bf16 tile of `rows` rows, stored as
// 64-column blocks of 128-byte rows with the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// mbarriers: a phase completes when its arrivals (and, for a TMA copy, its
// bytes) are in; a wait names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A lost arrival would hang the card: give up with a trap instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int spin = 0; !mbar_try_wait(bar, parity); ++spin)
    if (spin > (1 << 24)) __trap();
}

// One TMA copy of a box of a 4-D tensor map into shared memory, counted on
// the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulator registers across the
// asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 128, fp32) = A (64 x 16, smem) * B (16 x 128, smem), both K-major;
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
struct PV;  // P.V wgmma for head dim (padded) D
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

// Rows [row0, row0 + ROWS) of one head's (seq, d) slice (seq stride ss) into
// a swizzled ROWS x D tile, element by element by the 128 copying threads
// (layouts TMA cannot take); rows past n_rows and columns past d are zero.
template <int ROWS, int D>
__device__ __forceinline__ void copy_tile(char* tile, const __nv_bfloat16* src,
                                          long long ss, int row0, int n_rows,
                                          int d, int t) {
  for (int i = t; i < ROWS * D; i += TC_THREADS - TC_CONSUMERS) {
    const int r = i / D, c = i % D;
    const bool in = row0 + r < n_rows && c < d;
    *reinterpret_cast<__nv_bfloat16*>(tile + sw128(ROWS, r, c)) =
        in ? src[(row0 + r) * ss + c] : __float2bfloat16(0.f);
  }
}

// 2^x, flushing a subnormal result to 0 (every x here is <= 0, and a p
// below 2^-126 is 0 beside the row's largest p, which is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S = q k^T for one 64-row warpgroup and one tile of TC_N keys: D / 16
// steps of k16 over the head dim, both operands K-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[TC_N / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  fence_regs(s);  // earlier reads of s come before the wgmma writes it
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;  // bytes into the 64-column block
    wgmma_ss_n128(s, desc_sw128(q_addr + (ks / 4) * TC_M * 128 + col, 16, 1024),
                  desc_sw128(k_addr + (ks / 4) * TC_N * 128 + col, 16, 1024),
                  ks > 0);
  }
  wgmma_commit();
}

// acc += P v over one tile: TC_N / 16 steps of k16 over the keys, P from
// registers, v MN-major in shared memory at v_addr.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[TC_N / 16][4],
                                         uint32_t v_addr) {
  fence_regs(acc);  // the rescaling and P are in registers before the wgmma
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < TC_N / 16; ++t)
    PV<D>::mma(acc, pa[t], desc_sw128(v_addr + t * 16 * 128, TC_N * 128, 1024));
  wgmma_commit();
}

// Online softmax of one tile on the accumulator fragment of S: s[4n + 2r + c]
// is row row_a + 8r, key k0 + 8n + 2 (lane % 4) + c. Updates the running max
// m and this thread's share of the row sum l, returns the rescale factor of
// the rows in alpha and leaves P (fp32) in s, in place.
__device__ __forceinline__ void online_softmax(
    float (&s)[TC_N / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Params& p, int k0, bool edge, int row_a, int lane,
    float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < TC_N / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * n + 2 * r + c];
        if (edge) {
          const int key = k0 + 8 * n + 2 * (lane % 4) + c;
          const int qr = row_a + 8 * r;
          bool keep = true;
          if (p.causal) keep = keep && key <= qr;
          if (p.window > 0) keep = keep && key > qr - p.window;
          x = keep ? x : MASKED;
          if (key >= p.Skv) x = -INFINITY;  // past the ragged edge: p = 0
        }
        s[4 * n + 2 * r + c] = x;
        mx[r] = fmaxf(mx[r], x);
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    l[r] *= alpha[r];  // this thread's share; the row sum is taken at the end
  }
  // p = 2^((s - m) * scale * log2 e); s - m is exactly 0 where a row has seen
  // only masked scores (s = m = -1e30), so such a row weighs its keys
  // evenly, as the plain version does
#pragma unroll
  for (int n = 0; n < TC_N / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float p0 = exp2_ftz((s[4 * n + 2 * r] - m[r]) * scale_log2);
      const float p1 = exp2_ftz((s[4 * n + 2 * r + 1] - m[r]) * scale_log2);
      l[r] += p0 + p1;
      s[4 * n + 2 * r] = p0;
      s[4 * n + 2 * r + 1] = p1;
    }
}

// P in bf16 as the A fragments of the k16 steps over the tile's keys: step
// t takes score columns 16t .. 16t + 15, i.e. n = 2t and 2t + 1.
__device__ __forceinline__ void pack_p(const float (&s)[TC_N / 2],
                                       uint32_t (&pa)[TC_N / 16][4]) {
#pragma unroll
  for (int n = 0; n < TC_N / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pa[n / 2][(n % 2) * 2 + r] = pack_bf16(s[4 * n + 2 * r],
                                             s[4 * n + 2 * r + 1]);
}

// One work item: a q tile of one (batch, head) and the KV tiles it visits,
// none wholly above the causal diagonal of its last row and none wholly
// below the window of its first.
struct Item {
  int q0, j_begin, j_end, b, h, hk;
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
};

// Items in the order the blocks take them: the last q tiles (the most KV
// tiles under the causal mask) first, the Hq / Hkv heads of one KV head
// side by side so that their K/V tiles come from L2.
__device__ __forceinline__ Item make_item(const Params& p, int i) {
  const int n_qt = (p.Sq + TC_M - 1) / TC_M;
  const int bh = p.B * p.Hq;
  const int b = (i % bh) / p.Hq;
  const int h = i % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  Item it;
  it.b = b;
  it.h = h;
  it.hk = hk;
  it.q0 = (n_qt - 1 - i / bh) * TC_M;
  const int n_kv = (p.Skv + TC_N - 1) / TC_N;
  it.j_end = p.causal ? min(n_kv, (it.q0 + TC_M - 1) / TC_N + 1) : n_kv;
  it.j_begin = 0;
  if (p.window > 0 && it.q0 - p.window + 1 > 0)
    it.j_begin = (it.q0 - p.window + 1) / TC_N;
  it.q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  it.k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  it.v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  it.o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  return it;
}

// The three tensors' TMA maps, 4-D with the head dim innermost; `seq_first`
// says whether the sequence (1) or the head (0) is the second dim.
struct Maps {
  CUtensorMap q, k, v;
  int seq_first;
};

// The box of rows [row0, row0 + rows) of head h of batch b, 64 columns from
// col, in the map's dim order.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int seq_first, int col,
                                         int row0, int h, int b) {
  if (seq_first)
    tma_load(dst, map, bar, col, row0, h, b);
  else
    tma_load(dst, map, bar, col, h, row0, b);
}

// Persistent: block x takes items x, x + gridDim.x, ... (gridDim.x = the
// SM count). Warpgroup 2 copies q and the K/V tiles in (TMA, or element by
// element where TMA cannot take the layout); warpgroups 0 and 1 multiply.
// The two sides meet only at mbarriers: q_full/q_empty for the q tile and
// k_full/k_empty, v_full/v_empty for each of the TC_STAGES K and V stages.
// K and V have barriers of their own, so that tile j + 1's K is copied in
// as soon as S(j - 1) is done with its stage, and its V once P(j - 1) v is.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_fwd_kernel(const Params p, int vec, int n_items,
                     const __grid_constant__ Maps maps) {
  constexpr int TILE = TC_N * D * 2;         // one K or V tile, bytes
  constexpr int QTILE = TC_M * D * 2;
  constexpr int NS = TC_N / 2;               // score registers per thread
  constexpr int NO = D / 2;                  // output registers per thread

  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* q_s = smem;                          // TC_M x D
  char* k_s = q_s + QTILE;                   // TC_STAGES x (TC_N x D)
  char* v_s = k_s + TC_STAGES * TILE;
  char* o_s = v_s + TC_STAGES * TILE;        // the output tile, TC_M x D
  const uint32_t bars = smem_u32(o_s + QTILE);
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 16 + 8 * st; };
  auto k_empty = [&](int st) { return bars + 16 + 8 * (TC_STAGES + st); };
  auto v_full = [&](int st) { return bars + 16 + 8 * (2 * TC_STAGES + st); };
  auto v_empty = [&](int st) { return bars + 16 + 8 * (3 * TC_STAGES + st); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    // a full barrier completes on the copier's arrival(s) and bytes, an
    // empty one on every multiplying thread's
    const int copiers = vec ? 1 : TC_THREADS - TC_CONSUMERS;
    mbar_init(q_full, copiers);
    mbar_init(q_empty, TC_CONSUMERS);
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(k_full(st), copiers);
      mbar_init(v_full(st), copiers);
      mbar_init(k_empty(st), TC_CONSUMERS);
      mbar_init(v_empty(st), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- the copier: q once per item, then K and V of each tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int t = tid - TC_CONSUMERS;
    if (vec && t != 0) return;  // one thread issues the TMA copies
    int tile = 0, item = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
      const Item it = make_item(p, i);
      mbar_wait(q_empty, (item & 1) ^ 1);
      if (vec) {
        mbar_expect_tx(q_full, QTILE);
        for (int cb = 0; cb < D / 64; ++cb)
          tma_rows(smem_u32(q_s) + cb * TC_M * 128, &maps.q, q_full,
                   maps.seq_first, cb * 64, it.q0, it.h, it.b);
      } else {
        copy_tile<TC_M, D>(q_s, it.q, p.q_ss, it.q0, p.Sq, p.d, t);
        fence_proxy_async();
        mbar_arrive(q_full);
      }
      for (int j = it.j_begin; j < it.j_end; ++j, ++tile) {
        const int st = tile % TC_STAGES, par = ((tile / TC_STAGES) & 1) ^ 1;
        char* kd = k_s + st * TILE;
        char* vd = v_s + st * TILE;
        mbar_wait(k_empty(st), par);
        if (vec) {
          mbar_expect_tx(k_full(st), TILE);
          for (int cb = 0; cb < D / 64; ++cb)
            tma_rows(smem_u32(kd) + cb * TC_N * 128, &maps.k, k_full(st),
                     maps.seq_first, cb * 64, j * TC_N, it.hk, it.b);
        } else {
          copy_tile<TC_N, D>(kd, it.k, p.k_ss, j * TC_N, p.Skv, p.d, t);
          fence_proxy_async();
          mbar_arrive(k_full(st));
        }
        mbar_wait(v_empty(st), par);
        if (vec) {
          mbar_expect_tx(v_full(st), TILE);
          for (int cb = 0; cb < D / 64; ++cb)
            tma_rows(smem_u32(vd) + cb * TC_N * 128, &maps.v, v_full(st),
                     maps.seq_first, cb * 64, j * TC_N, it.hk, it.b);
        } else {
          copy_tile<TC_N, D>(vd, it.v, p.v_ss, j * TC_N, p.Skv, p.d, t);
          fence_proxy_async();
          mbar_arrive(v_full(st));
        }
      }
    }
    return;
  }

  // ---- the two multiplying warpgroups, 64 q rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
  int tile = 0, item = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++item) {
    const Item it = make_item(p, i);
    const int q_last = it.q0 + TC_M - 1;
    // thread's rows: row_a and row_a + 8 (accumulator fragment of wgmma)
    const int row_a = it.q0 + 64 * wg + 16 * warp + lane / 4;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
    float s[NS], acc[NO];
    uint32_t pa[TC_N / 16][4];  // P of the tile before, for its P v
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[n] = 0.f;
    // the tile straddles the causal diagonal, the window edge or Skv
    auto edge = [&](int k0) {
      return (p.causal && k0 + TC_N - 1 > it.q0) ||
             (p.window > 0 && k0 <= q_last - p.window) || k0 + TC_N > p.Skv;
    };

    mbar_wait(q_full, item & 1);
    if (it.j_begin < it.j_end) {
      // Tile j issues S(j) = q k_j^T and P(j-1) v_{j-1} together and runs
      // the softmax of tile j while P(j-1) v_{j-1} is on the tensor cores;
      // the first tile is peeled off.
      float alpha[2];
      int st = tile % TC_STAGES, par = (tile / TC_STAGES) & 1;
      mbar_wait(k_full(st), par);
      issue_qk<D>(s, q_addr, smem_u32(k_s + st * TILE));
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty(st));
      if (it.j_begin + 1 == it.j_end) mbar_arrive(q_empty);
      online_softmax(s, m, l, alpha, p, it.j_begin * TC_N,
                     edge(it.j_begin * TC_N), row_a, lane, scale_log2);
      pack_p(s, pa);
      for (int j = it.j_begin + 1; j < it.j_end; ++j) {
        const int pst = st, ppar = par;  // tile j - 1
        ++tile;
        st = tile % TC_STAGES;
        par = (tile / TC_STAGES) & 1;
        mbar_wait(k_full(st), par);
        issue_qk<D>(s, q_addr, smem_u32(k_s + st * TILE));
        mbar_wait(v_full(pst), ppar);
        issue_pv<D>(acc, pa, smem_u32(v_s + pst * TILE));
        wgmma_wait<1>();  // S(j) is done; P(j-1) v may still run
        fence_regs(s);
        mbar_arrive(k_empty(st));
        if (j + 1 == it.j_end) mbar_arrive(q_empty);
        online_softmax(s, m, l, alpha, p, j * TC_N, edge(j * TC_N), row_a,
                       lane, scale_log2);
        wgmma_wait<0>();  // P(j-1) v is in acc, and pa is free again
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(v_empty(pst));
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[n] *= alpha[(n / 2) % 2];
        pack_p(s, pa);
      }
      mbar_wait(v_full(st), par);
      issue_pv<D>(acc, pa, smem_u32(v_s + st * TILE));
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty(st));
      ++tile;
    } else {
      mbar_arrive(q_empty);  // no tile: q is not read
    }

    // out = acc / l (l == 0: 1) in bf16, through o_s (swizzled like q) so
    // that each row leaves in 16-byte pieces
    named_sync(1, TC_CONSUMERS);  // the last item's stores are done with o_s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      const int row = 64 * wg + 16 * warp + lane / 4 + 8 * r;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(o_s + sw128(TC_M, row, col)) =
            pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      }
    }
    named_sync(1, TC_CONSUMERS);
    if (vec) {
      constexpr int STEP = TC_CONSUMERS / (D / 8);
      const int r0 = tid / (D / 8), c = (tid % (D / 8)) * 8;
#pragma unroll
      for (int k = 0; k < TC_M / STEP; ++k) {
        const int r = r0 + k * STEP;
        if (it.q0 + r < p.Sq && c < p.d)
          *reinterpret_cast<uint4*>(it.o + (it.q0 + r) * p.o_ss + c) =
              *reinterpret_cast<const uint4*>(o_s + sw128(TC_M, r, c));
      }
    } else {
      for (int e = tid; e < TC_M * D; e += TC_CONSUMERS) {
        const int r = e / D, c = e % D;
        if (it.q0 + r < p.Sq && c < p.d)
          it.o[(it.q0 + r) * p.o_ss + c] =
              *reinterpret_cast<const __nv_bfloat16*>(o_s + sw128(TC_M, r, c));
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that
// nothing links -lcuda; null where the driver does not offer it.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 4-D map (head dim, then seq and head in the order of their strides,
// then batch) whose box is 64 columns of `rows` rows, 128-byte swizzled;
// rows and columns outside the tensor read as zero.
bool encode(CUtensorMap* map, const void* base, int d, int S, int H, int B,
            long long ss, long long sh, long long sb, int rows,
            int seq_first) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d),
      static_cast<cuuint64_t>(seq_first ? S : H),
      static_cast<cuuint64_t>(seq_first ? H : S),
      static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(2 * (seq_first ? ss : sh)),
      static_cast<cuuint64_t>(2 * (seq_first ? sh : ss)),
      static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(seq_first ? rows : 1),
                             static_cast<cuuint32_t>(seq_first ? 1 : rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Params& p, int vec, cudaStream_t stream) {
  const int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((p.Sq + TC_M - 1) / TC_M) * p.B * p.Hq;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  Maps maps = {};
  // TMA takes the sequence or the head as the second dim, whichever has
  // the smaller stride in all three tensors
  maps.seq_first = p.q_ss <= p.q_sh && p.k_ss <= p.k_sh && p.v_ss <= p.v_sh;
  if (vec)
    vec = encode(&maps.q, p.q, p.d, p.Sq, p.Hq, p.B, p.q_ss, p.q_sh, p.q_sb,
                 TC_M, maps.seq_first) &&
          encode(&maps.k, p.k, p.d, p.Skv, p.Hkv, p.B, p.k_ss, p.k_sh,
                 p.k_sb, TC_N, maps.seq_first) &&
          encode(&maps.v, p.v, p.d, p.Skv, p.Hkv, p.B, p.v_ss, p.v_sh,
                 p.v_sb, TC_N, maps.seq_first);
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_fwd_kernel<D><<<blocks, TC_THREADS, smem, stream>>>(
      p, vec, static_cast<int>(items), maps);
  return cudaGetLastError();
}

// TMA needs every row start 16-byte aligned
bool rows_16b_aligned(const Params& p) {
  const long long strides[] = {p.q_sb, p.q_sh, p.q_ss, p.k_sb, p.k_sh,
                               p.k_ss, p.v_sb, p.v_sh, p.v_ss, p.o_sb,
                               p.o_sh, p.o_ss};
  for (long long s : strides)
    if (s % 8) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
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
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.d = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // Any head dim up to 128 that is a multiple of 8 runs the instantiation
  // that rounds it up: the extra columns are loaded as zeros (TMA fills
  // what lies past the tensor map's d; the element copies test c < d), add
  // nothing to q k^T, and are not stored (a multiple of 8 keeps the 16-byte
  // stores of a row whole, and a bf16 row a 16-byte multiple for TMA).
  if (D <= 0 || D > 128 || D % 8 != 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D <= 16) err = launch_fp32<16>(p, s);
    else if (D <= 32) err = launch_fp32<32>(p, s);
    else if (D <= 64) err = launch_fp32<64>(p, s);
    else err = launch_fp32<128>(p, s);
  } else if (dtype == 1) {
    const int vec = rows_16b_aligned(p) ? 1 : 0;
    if (D <= 64) err = launch_bf16<64>(p, vec, s);
    else err = launch_bf16<128>(p, vec, s);
  }
  return static_cast<int>(err);
}
