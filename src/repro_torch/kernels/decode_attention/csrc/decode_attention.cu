// Dense GQA decode attention (one query token per sequence) over a layer's
// (B, S, Hkv, d) K/V cache, read in place by strides, for Hopper (sm_90a),
// written by hand in CUDA C++: flash-decoding, a split kernel over ranges of
// each sequence's keys and, where a sequence is cut into more than one
// range, a combine kernel that merges them.
//
// It replaces no TPU kernel: the reference's decode attention
// (src/repro/models/attention.py::decode_attention) is a jnp einsum that
// XLA fuses. The port's plain version (ref.py) widened the whole bf16 cache
// to fp32 and copied it again into each einsum's layout, nine reads and
// writes of the cache a layer. This kernel computes what the plain version
// computes: query head h*G + g reads kv head h (G = Hq / Hkv); scores are
// q . k * scale in fp32 (bf16 products are exact in fp32 and summed in
// fp32); keys at or past the live length n are masked; the softmax is fp32
// and P . V is fp32 with P kept in fp32, never rounded to bf16; the output
// is cast to q's dtype. q and the cache share one dtype (the model's); K
// and V are widened in registers, and no copy of the cache is written.
//
// The live length is read on the device: n = min(pos + 1, S) from the
// one-element int64 position the decode step already holds (a ring cache
// that has wrapped has all S keys live), or n = S where no position is given
// (cross-attention). The host never reads it, so a CUDA graph captured
// around a call serves every position. Blocks whose range lies past n write
// an empty partial and exit.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32, 989 bf16 on
// the tensor cores): at yi-9b's decode (B 64, Hq 32, Hkv 4, d 128, bf16,
// ~530 live keys) a layer must read 69 MB of K and V, 21 us at the memory
// rate, against 142 M fp32 FMAs for P . V (4.4 us on the CUDA cores) and as
// many bf16 products for q . k. So it is bound by bytes, and the design keeps
// every SM streaming and the arithmetic per byte small:
//
// Grid (split, Hkv, B): block (s, h, b) takes kv head h of sequence b over
// keys [s * per, min(s * per + per, n)). The G query heads of the group
// share every K/V tile the block loads, so the cache is read once. The
// wrapper picks split and per from the shapes and the SM count alone; at
// the served shapes B * Hkv blocks already fill the card (split 1: no
// workspace, no combine).
//
// Copies. 16-byte cp.async of a tile's K and V rows into a two-stage ring of
// shared memory, rows padded by 16 bytes so that 8 consecutive rows fall in
// distinct bank groups; tile i + 1 is in flight while tile i is multiplied.
// Two stages of 64 rows of d 128 and eight warps a block: two blocks an SM
// (registers at most 128 a thread). Eight warps rather than four, a third
// stage and a fourth were timed at yi-9b's shape: 33.6 us a layer against
// 39.2 (four warps), 36.6 (three stages) and 66.6 (four stages of four
// warps: one block an SM); the copies alone, with the arithmetic cut out, take 27.9 us (74%
// of the HBM rate), so the arithmetic is mostly hidden behind them.
//
// q . k. In bf16 at d 64 or 128: mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate; the products are exact, as in the plain version's fp32
// einsum over widened bf16): the G query heads on M (rows past G are zero),
// 8 keys on N, K by ldmatrix from the ring, the q fragments in registers for
// the whole block; warp w takes keys [8w, 8w + 8) of a 64-key tile.
// Otherwise (fp32, other head dims): fp32 FMAs, one key and a share of
// the heads per thread, q in shared memory.
//
// Softmax: the tile's fp32 scores in shared memory, one warp per head: the
// running max m and sum l, the exponentials written back in place (fp32),
// and alpha = e^(m_old - m_new) for the accumulator.
//
// P . V on the CUDA cores in fp32: thread t owns two columns of the head dim
// for all G heads (acc[G][2] in registers) and every KH-th key of the tile,
// KH = 512 / d; each V pair is read and widened once per block, each p is a
// broadcast read. The KH partial accumulators are summed through shared
// memory once, at the end of the block.
//
// Combine (split > 1 only): decode_attention_kernel_combine, one block per
// query row, merges the partials by log-sum-exp, skipping empty ones; the
// K2/K3 combine (paged_attention.cu) is the same algorithm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;          // tiles in the copy ring
constexpr int PAD = 16;            // bytes after each row in shared memory
constexpr int MMA_TK = 64;         // keys per tile on the tensor cores
constexpr int MMA_NT = MMA_TK / (8 * WARPS);  // 8-key n-tiles a warp
constexpr float MASKED = -1e30f;
constexpr int MAX_SMEM = 232448;   // per block on an H100
constexpr int MAX_G = 16;
constexpr int MAX_D = 256;
constexpr int COMBINE_THREADS = 128;

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;          // (B, Hq, D), contiguous
  const void* k;          // (B, S, Hkv, D): strides sb, ss; Hkv D, D 1
  const void* v;
  const long long* pos;   // one element, or null (all S keys live)
  void* o;                // (B, Hq, D), q's dtype
  float* ws;              // split > 1: acc (B*Hq*split, D), then (m, l)
  long long k_sb, k_ss, v_sb, v_ss;  // strides in elements
  int B, Hq, Hkv, D, S, split, per;
  float scale;
};

// ---- conversions ----------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of cache -> 16 / sizeof(T) floats (bf16 widened exactly)
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
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// two consecutive cache elements -> two floats
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void load_pair(const bf16* p, float& a, float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// ---- shared layout ---------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int row_bytes(int D) {
  return D * static_cast<int>(sizeof(T)) + PAD;
}

// keys per tile: 64 on the tensor cores; on the FMA path a stage of at most
// ~35 KB
template <typename T>
__host__ __device__ constexpr int tile_keys(int D, bool mma) {
  return mma ? MMA_TK
             : row_bytes<T>(D) <= 272 ? 64
                                       : row_bytes<T>(D) <= 528 ? 32 : 16;
}

// scores / probabilities of a tile: (TK, PS) floats, a key's heads in one
// row, rows 16-byte aligned where a thread reads four heads at once
__host__ __device__ constexpr int p_stride(int GM) {
  return GM <= 2 ? GM : GM + 4;
}

// key groups of P . V: thread t owns column pair t % (D / 2), keys
// t / (D / 2) + KH * i
__host__ __device__ constexpr int key_groups(int D) {
  return THREADS / (D / 2);
}

// The first region holds the ring during the loop and the key groups'
// partial accumulators after it.
template <typename T>
__host__ __device__ constexpr int region_bytes(int GM, int D, bool mma) {
  const int ring = STAGES * 2 * tile_keys<T>(D, mma) * row_bytes<T>(D);
  const int red = (key_groups(D) - 1) * GM * D * 4;
  return ring > red ? ring : red;
}

// region; p: TK x PS; q: GM x D (FMA path); m, l, alpha: GM each
template <typename T>
__host__ __device__ constexpr int smem_bytes(int GM, int D, bool mma) {
  return region_bytes<T>(GM, D, mma) +
         (tile_keys<T>(D, mma) * p_stride(GM) + (mma ? 0 : GM * D) +
          3 * GM) * 4;
}

__device__ __forceinline__ int live_len(const Params& p) {
  if (p.pos == nullptr) return p.S;
  const long long n = *p.pos + 1;
  return n < 0 ? 0 : n < p.S ? static_cast<int>(n) : p.S;
}

__device__ __forceinline__ float* ws_ml(const Params& p) {
  return p.ws + static_cast<long long>(p.B) * p.Hq * p.split * p.D;
}

__device__ __forceinline__ float* ws_acc(const Params& p, long long row,
                                         int s) {
  return p.ws + (row * p.split + s) * p.D;
}

// Keys [k0, k0 + TK) of kv head h of sequence b into one stage; keys at or
// past `end` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, char* stage,
                                          int TK, int D, int b, int h,
                                          int k0, int end) {
  const int rowb = row_bytes<T>(D);
  const int CH = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int E = 16 / sizeof(T);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb +
                 static_cast<long long>(h) * D;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb +
                 static_cast<long long>(h) * D;
  char* ks = stage;
  char* vs = stage + TK * rowb;
  for (int i = threadIdx.x; i < TK * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const int key = k0 + r;
    const bool ok = key < end;
    const long long kk = ok ? key : 0;
    cp_async16(ks + r * rowb + c * 16, kb + kk * p.k_ss + c * E, ok);
    cp_async16(vs + r * rowb + c * 16, vb + kk * p.v_ss + c * E, ok);
  }
}

// ---- the split kernel ---------------------------------------------------------

// grid (split, Hkv, B): block (s, h, b) attends sequence b's keys
// [s * per, min(s * per + per, n)) with kv head h. GM: G rounded up to a
// power of two (the accumulator rows). MMA_D = 0: q . k in fp32 FMAs at any
// head dim; MMA_D = d: q . k by mma.sync (bf16 q and cache).
template <typename T, int GM, int MMA_D>
__global__ void __launch_bounds__(THREADS, 2) decode_attention_kernel_split(
    const Params p) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool MMA = MMA_D > 0;
  constexpr int PS = p_stride(GM);
  const int G = p.Hq / p.Hkv;
  const int D = MMA ? MMA_D : p.D;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long row0 = static_cast<long long>(b) * p.Hq +
                         static_cast<long long>(h) * G;
  const int begin = s * p.per;
  const int end = min(begin + p.per, live_len(p));
  if (begin >= end) {  // an empty partial: l = 0, skipped by the combine
    if (p.split > 1) {
      float* ml = ws_ml(p);
      for (int g = tid; g < G; g += THREADS) {
        ml[2 * ((row0 + g) * p.split + s)] = MASKED;
        ml[2 * ((row0 + g) * p.split + s) + 1] = 0.f;
      }
    } else {  // no live key at all (a position below 0): zeros
      T* o = static_cast<T*>(p.o) + row0 * D;
      for (int i = tid; i < G * D; i += THREADS) o[i] = from_float<T>(0.f);
    }
    return;
  }

  const int TK = tile_keys<T>(D, MMA);
  const int rowb = row_bytes<T>(D);
  const int sbytes = 2 * TK * rowb;
  const int tiles = (end - begin + TK - 1) / TK;
  float* p_s = reinterpret_cast<float*>(smem + region_bytes<T>(GM, D, MMA));
  float* q_s = p_s + TK * PS;
  float* m_s = q_s + (MMA ? 0 : GM * D);
  float* l_s = m_s + GM;
  float* a_s = l_s + GM;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles)
      load_tile<T>(p, smem + t * sbytes, TK, D, b, h, begin + t * TK, end);
    cp_async_commit();
  }

  const T* q = static_cast<const T*>(p.q) + row0 * D;
  // q fragments of the mma path: k-step ks, rows lane / 4 and + 8, columns
  // ks * 16 + (lane % 4) * 2 (+ 8)
  uint32_t qa[MMA ? MMA_D / 16 : 1][4];
  if constexpr (MMA) {
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int ks = 0; ks < MMA_D / 16; ++ks) {
      const int col = ks * 16 + c;
      const uint32_t* q0 =
          reinterpret_cast<const uint32_t*>(q + r * MMA_D + col);
      const uint32_t* q1 =
          reinterpret_cast<const uint32_t*>(q + (r + 8) * MMA_D + col);
      qa[ks][0] = r < G ? q0[0] : 0u;
      qa[ks][1] = r + 8 < G ? q1[0] : 0u;
      qa[ks][2] = r < G ? q0[4] : 0u;
      qa[ks][3] = r + 8 < G ? q1[4] : 0u;
    }
  } else {
    for (int i = tid; i < G * D; i += THREADS) q_s[i] = to_float(q[i]);
  }
  for (int i = tid; i < TK * PS; i += THREADS) p_s[i] = 0.f;
  for (int g = tid; g < GM; g += THREADS) {
    m_s[g] = MASKED;
    l_s[g] = 0.f;
    a_s[g] = 0.f;
  }

  const int NP = D / 2, KH = key_groups(D);
  const int cp = tid % NP, kh = tid / NP;
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    // tile t has landed and every thread is done with tile t - 1's stage
    // and probabilities
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int k0 = begin + t * TK;
    const int tn = t + STAGES - 1;
    if (tn < tiles)
      load_tile<T>(p, smem + (tn % STAGES) * sbytes, TK, D, b, h,
                    begin + tn * TK, end);
    cp_async_commit();
    const char* ks = smem + (t % STAGES) * sbytes;
    const char* vs = ks + TK * rowb;
    const int nv = min(TK, end - k0);

    // scores of the tile into p_s
    if constexpr (MMA) {
      const int wk = warp * 8 * MMA_NT;
      if (wk < nv) {
#pragma unroll
        for (int nt = 0; nt < MMA_NT; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const uint32_t base =
              smem_u32(ks + (wk + nt * 8 + (lane & 7)) * rowb +
                       (lane >> 3) * 16);
#pragma unroll
          for (int kk = 0; kk < MMA_D / 32; ++kk) {
            uint32_t r[4];
            ldsm_x4(r, base + kk * 64);
            mma_bf16(c, qa[2 * kk], r[0], r[1]);
            mma_bf16(c, qa[2 * kk + 1], r[2], r[3]);
          }
          const int j = wk + nt * 8 + (lane & 3) * 2;
          const int g0 = lane >> 2;
          if (g0 < G) {
            p_s[j * PS + g0] = c[0] * p.scale;
            p_s[(j + 1) * PS + g0] = c[1] * p.scale;
          }
          if (g0 + 8 < G) {
            p_s[j * PS + g0 + 8] = c[2] * p.scale;
            p_s[(j + 1) * PS + g0 + 8] = c[3] * p.scale;
          }
        }
      }
    } else {
      using V = Vec<T>;
      const int NHG = THREADS / TK;
      const int j = tid % TK, hg = tid / TK;
      const int CH = D / V::N;
      if (j < nv) {
        const char* kr = ks + j * rowb;
        for (int g = hg; g < G; g += NHG) {
          const float* qg = q_s + g * D;
          float sc = 0.f;
          for (int c = 0; c < CH; ++c) {
            float kf[V::N];
            V::unpack(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
#pragma unroll
            for (int e = 0; e < V::N; ++e)
              sc = fmaf(qg[c * V::N + e], kf[e], sc);
          }
          p_s[j * PS + g] = sc * p.scale;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per head: p = e^(s - m), masked keys 0
    for (int g = warp; g < G; g += WARPS) {
      float mx = MASKED;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, p_s[j * PS + g]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float e = j < nv ? expf(p_s[j * PS + g] - m_new) : 0.f;
        p_s[j * PS + g] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v over this thread's keys of the tile
    if (kh < KH) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        acc[g][0] *= a_s[g];
        acc[g][1] *= a_s[g];
      }
      const T* vc = reinterpret_cast<const T*>(vs) + 2 * cp;
#pragma unroll 4
      for (int j = kh; j < nv; j += KH) {
        float v0, v1;
        load_pair(reinterpret_cast<const T*>(
                          reinterpret_cast<const char*>(vc) + j * rowb),
                      v0, v1);
        const float* pr = p_s + j * PS;
        if constexpr (GM >= 4) {
#pragma unroll
          for (int g = 0; g < GM; g += 4) {
            const float4 pp = *reinterpret_cast<const float4*>(pr + g);
            acc[g][0] = fmaf(pp.x, v0, acc[g][0]);
            acc[g][1] = fmaf(pp.x, v1, acc[g][1]);
            acc[g + 1][0] = fmaf(pp.y, v0, acc[g + 1][0]);
            acc[g + 1][1] = fmaf(pp.y, v1, acc[g + 1][1]);
            acc[g + 2][0] = fmaf(pp.z, v0, acc[g + 2][0]);
            acc[g + 2][1] = fmaf(pp.z, v1, acc[g + 2][1]);
            acc[g + 3][0] = fmaf(pp.w, v0, acc[g + 3][0]);
            acc[g + 3][1] = fmaf(pp.w, v1, acc[g + 3][1]);
          }
        } else {
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            acc[g][0] = fmaf(pr[g], v0, acc[g][0]);
            acc[g][1] = fmaf(pr[g], v1, acc[g][1]);
          }
        }
      }
    }
  }

  // the key groups' partial accumulators summed through the (now idle) ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (kh > 0 && kh < KH) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        float* r = red + ((kh - 1) * GM + g) * D + 2 * cp;
        r[0] = acc[g][0];
        r[1] = acc[g][1];
      }
  }
  __syncthreads();
  if (kh != 0) return;
  for (int k = 1; k < KH; ++k)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        const float* r = red + ((k - 1) * GM + g) * D + 2 * cp;
        acc[g][0] += r[0];
        acc[g][1] += r[1];
      }
  if (p.split == 1) {
    T* o = static_cast<T*>(p.o) + row0 * D + 2 * cp;
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        const float inv = 1.f / l_s[g];
        o[g * D] = from_float<T>(acc[g][0] * inv);
        o[g * D + 1] = from_float<T>(acc[g][1] * inv);
      }
  } else {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        float* w = ws_acc(p, row0 + g, s) + 2 * cp;
        w[0] = acc[g][0];
        w[1] = acc[g][1];
      }
    for (int g = cp; g < G; g += NP) {
      float* ml = ws_ml(p) + 2 * ((row0 + g) * p.split + s);
      ml[0] = m_s[g];
      ml[1] = l_s[g];
    }
  }
}

// ---- the combine -----------------------------------------------------------

// grid (B * Hq): block r merges query row r's split partials by log-sum-exp,
// thread c column c (and c + 128, ...), skipping those with l = 0.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
    decode_attention_kernel_combine(const Params p) {
  constexpr int CHUNK = 8;  // splits whose loads are in flight at once
  const long long row = blockIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml(p)) + row * p.split;
  for (int c = threadIdx.x; c < p.D; c += COMBINE_THREADS) {
    const float* acc = ws_acc(p, row, 0) + c;
    float M = MASKED, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < p.split; s0 += CHUNK) {
      float2 v[CHUNK];
      float x[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const bool in = s0 + j < p.split;
        v[j] = in ? ml[s0 + j] : make_float2(MASKED, 0.f);
        x[j] = in ? acc[static_cast<long long>(s0 + j) * p.D] : 0.f;
      }
      float Mc = M;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (v[j].y > 0.f) Mc = fmaxf(Mc, v[j].x);
      const float r = expf(M - Mc);
      L *= r;
      A *= r;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (v[j].y > 0.f) {
          const float w = expf(v[j].x - Mc);
          L = fmaf(v[j].y, w, L);
          A = fmaf(x[j], w, A);
        }
      M = Mc;
    }
    static_cast<T*>(p.o)[row * p.D + c] =
        from_float<T>(A / (L == 0.f ? 1.f : L));
  }
}

// ---- launch --------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// the dynamic shared memory each instantiation has been allowed so far on
// each device, so that a call under stream capture (the same shapes as the
// eager calls before it) sets no attribute
template <typename T, int GM, int MMA_D>
int& smem_allowed(int device) {
  static int bytes[MAX_DEVICES] = {};
  return bytes[device];
}

template <typename T, int GM, int MMA_D>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  auto kernel = decode_attention_kernel_split<T, GM, MMA_D>;
  const int smem = smem_bytes<T>(GM, p.D, MMA_D > 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int& allowed = smem_allowed<T, GM, MMA_D>(device);
  if (smem > 48 * 1024 && smem > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<dim3(p.split, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int GM>
cudaError_t launch_g(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.D == 128) return launch_split<T, GM, 128>(p, stream);
    if (p.D == 64) return launch_split<T, GM, 64>(p, stream);
  }
  return launch_split<T, GM, 0>(p, stream);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const cudaError_t err = G <= 1   ? launch_g<T, 1>(p, stream)
                          : G <= 2 ? launch_g<T, 2>(p, stream)
                          : G <= 4 ? launch_g<T, 4>(p, stream)
                          : G <= 8 ? launch_g<T, 8>(p, stream)
                                   : launch_g<T, 16>(p, stream);
  if (err != cudaSuccess || p.split == 1) return err;
  decode_attention_kernel_combine<T>
      <<<p.B * p.Hq, COMBINE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int D, int S, int split, int per) {
  return B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
         Hq / Hkv > MAX_G || D <= 0 || D % 8 != 0 || D > MAX_D || S <= 0 ||
         split <= 0 || split > 65535 || per <= 0 ||
         static_cast<long long>(split) * per < S ||
         static_cast<long long>(split - 1) * per >= S;
}

}  // namespace

// dtype of q, k, v and o: 0 = float32, 1 = bfloat16. q, o (B, Hq, d)
// contiguous;
// k, v (B, S, Hkv, d) with strides (k_sb, k_ss, d, 1) and (v_sb, v_ss, d, 1)
// in elements, rows 16-byte aligned; pos a device pointer to one int64 (the
// step's position: n = min(pos + 1, S) keys live) or null (all S live); ws a
// float32 workspace of B * Hq * split * (d + 2) when split > 1 (else
// unused). Block s of a (sequence, kv head) takes keys [s * per, s * per +
// per): split * per >= S > (split - 1) * per. Launches the split kernel,
// then (split > 1) the combine kernel. Returns the CUDA error code of the
// launches (0 on success); allocates nothing, runs on the given stream,
// never reads pos on the host and does not synchronise.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* ws, int dtype, int B, int Hq, int Hkv, int D, int S,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss, int split,
    int per, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, S, split, per) || (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = static_cast<const long long*>(pos);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.S = S;
  p.split = split;
  p.per = per;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch<float>(p, s); break;
    case 1: err = launch<bf16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
