// Paged decode attention (one query token per sequence) through a block
// table, over fp pages or int8 pages with per-(page, head) scales, for Hopper
// (sm_90a), written by hand in CUDA C++: flash-decoding, a split kernel over
// ranges of each sequence's pages and a combine kernel that merges them.
//
// Replaces the TPU kernels repro/kernels/paged_attention/kernel.py::
// paged_attention (_kernel, _flash_page_step) and ::paged_attention_quant
// (_kernel_quant), and computes what they compute: GQA (query head
// h*G + g reads kv head h, G = Hq / Hkv), a running max m, sum l and
// accumulator acc in fp32 across the sequence's pages, positions >= seq_len
// masked with -1e30 and their p set to 0 (so a zero-length row gives exact
// zeros), and out = acc / (l == 0 ? 1 : l) in q's dtype. In int8 mode k =
// (float)q * scale[page, head]; no fp copy of the pool is made.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32, 989 bf16 on
// the tensor cores): at the pager shape (yi-9b's KV geometry, Hq=32, Hkv=4,
// d=128, page=64, bf16; 16 sequences of 2080 tokens) one call reads 68.2 MB
// of K and V rows plus 0.26 MB of q and out, 20.4 us at the memory rate,
// against 0.545 GFLOP (8.1 us in fp32 FMAs, 0.6 us on the tensor cores). So it
// is bound by bytes: about 20 us a call, 10.3 us for the int8 pool (34.3 MB).
// A bound of bytes needs every SM streaming all the time, so the design
// spreads each sequence over many blocks and keeps copies in flight while it
// multiplies.
//
// Split. The grid is (split, Hkv, B): block (s, h, b) takes kv head h and
// pages [s*per, s*per + per) of sequence b, cut at ceil(seq_len / page). The
// wrapper picks split and per from the table width and the SM count, never
// from seq_lens (that would cost a device-to-host sync): as many blocks as
// the card holds at once (three an SM), so there is no second wave; 6
// splits of 6 pages at the pager shape, 384 blocks. A block past its
// sequence's last page writes m = -1e30, l = 0, acc = 0 and exits. Every
// block writes its G query rows' (m, l, acc) in fp32 to a workspace the
// wrapper allocates, B*Hq*split*(d + 2) floats.
//
// Combine. paged_attention_kernel_combine, one warp per (b, query head),
// merges the partials by log-sum-exp: M = max m_s over l_s > 0, L = sum l_s
// e^(m_s - M), out = sum acc_s e^(m_s - M) / (L == 0 ? 1 : L); a
// zero-length row has only empty partials and gets exact zeros.
//
// Copies. A block first puts its columns of the block table in shared
// memory (no copy then waits on a table read), then walks its range in
// tiles of positions (64 on the tensor cores; 64, 32 or 16 on the FMA path
// as the row width allows). Every thread issues 16-byte cp.async for its
// share of a tile's K and V rows (and, in int8 mode, 4-byte copies of their
// scales) into a two-stage ring of shared memory, rows padded by 16 bytes so
// that 8 consecutive rows hit distinct bank groups: tile i + 1 is in flight
// while tile i is multiplied, and one block barrier per tile hands a stage
// back. Two stages rather than three let three blocks share an SM. Rows past
// min(seq_len, the range's end) are zero-filled (cp.async with no source
// bytes) and masked.
//
// Arithmetic, bf16 q over bf16 or int8 pages with G <= 16 and d in {32, 64,
// 128}: mma.sync.m16n8k16 (bf16 in, fp32 out). Warp w of four takes keys
// [16w, 16w + 16) of every tile and keeps its own m, l and acc, so the warps
// never wait on each other inside a tile; they merge once, at the end of the
// block. S = q k^T puts the G query heads on M (rows past G are zero; at G =
// 8 half of M is padding, which costs nothing at this bound) and 8 keys on
// N; the q fragments stay in registers for the whole block. The S
// accumulator of two 8-key tiles is, element for element, the A fragment of
// P v (the FlashAttention-2 layout identity), so P never leaves registers.
// bf16 pages: K by ldmatrix, V by ldmatrix.trans. int8 pages: widening is
// exact (an int8 is a bf16 integer; bit operations and one bf16 subtraction
// per pair). K is widened in registers straight from the ring: the q
// fragments hold each k-step's columns permuted so that a thread's four B
// values are four consecutive int8 of a K row, one 32-bit load. V is
// widened into a buffer of the warp's own for ldmatrix.trans. The scales
// factor out of the products: s = scale_k[row] * (q . k_int8), and
// scale_v[row] multiplies p after l has summed it and before p is rounded to
// bf16. So widening adds no error; only P is rounded, as in every
// tensor-core flash kernel. The softmax runs in log2 units (ex2.approx) and
// rescales acc only when a row's max moved.
//
// Arithmetic elsewhere (fp32 q or pages, G > 16, other head dims): fp32
// FMAs on the same ring; q, acc and the tile's scores in shared memory,
// scores one (head, key) per thread, softmax one warp per head, p.v one
// (head, column) per thread. The fp32 tests' 2e-5 tolerance rules out TF32.
//
// What it leaves on the table (times in PERF.md section 6, measured on an
// H100 80GB HBM3 at 700 W). bf16 pages: the copies alone, with the
// arithmetic cut out, take about as long as the whole kernel, so the
// cp.async stream, not the tensor cores, sets its time, at about two thirds
// of the HBM rate; a block of all kv heads (contiguous rows) and a third
// stage were tried and were slower, since they cost blocks per SM. int8
// pages: the copies and the arithmetic (the widening above all) each take
// about two thirds of the kernel and overlap only in part; registers (165 a
// thread) hold an SM to three blocks. The combine is a second launch of a
// few microseconds; folding it into the split kernel's last block (an
// atomic counter) made the split kernel slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;          // tiles in the copy ring
constexpr int PAD = 16;            // bytes after each row in shared memory
constexpr int MMA_TK = 16 * WARPS; // positions per tile on the tensor cores
constexpr float MASKED = -1e30f;
constexpr int MAX_SMEM = 232448;   // per block on an H100
constexpr int MAX_PER = 256;       // table columns a block takes, at most
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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
  float* ws;              // acc (B*Hq*split, d), then (m, l) (B*Hq*split, 2)
  int B, Hq, Hkv, D, page, pps, split, per;
  int page_shift;         // log2(page) when page is a power of two, else -1
  float scale;
};

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(full ? 4 : 0)
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// four int8 (one 32-bit word) -> four bf16 (two words), exactly: with 0x43
// above it, a byte x is the bf16 0x43xx; its low 7 bits give 128 + (x & 127)
// and its top bit alone gives 128 or 256, whose difference is x
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t a = __byte_perm(w, 0x43434343u, 0x5140);  // x0, x1
  const uint32_t c = __byte_perm(w, 0x43434343u, 0x5342);  // x2, x3
  const uint32_t am = a & 0xFF7FFF7Fu, ab = a & 0xFF80FF80u;
  const uint32_t cm = c & 0xFF7FFF7Fu, cb = c & 0xFF80FF80u;
  const __nv_bfloat162 l2 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&am),
              *reinterpret_cast<const __nv_bfloat162*>(&ab));
  const __nv_bfloat162 h2 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&cm),
              *reinterpret_cast<const __nv_bfloat162*>(&cb));
  lo = *reinterpret_cast<const uint32_t*>(&l2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
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

// 2^x; 0 for x far below -126
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- shared layout -------------------------------------------------------

template <typename KT>
__host__ __device__ constexpr int row_bytes(int D) {
  return D * static_cast<int>(sizeof(KT)) + PAD;
}

// K rows, V rows, then (int8) the rows' k and v scales
template <typename KT, bool QUANT>
__host__ __device__ constexpr int stage_bytes(int TK, int D) {
  return 2 * TK * row_bytes<KT>(D) + (QUANT ? 2 * TK * 4 : 0);
}

// rows per tile on the FMA path: a stage of at most ~36 KB
template <typename KT>
__host__ __device__ inline int fma_tile(int D) {
  const int rowb = row_bytes<KT>(D);
  return rowb <= 272 ? 64 : rowb <= 528 ? 32 : 16;
}

// Shared memory of a block: the ring, the block's columns of the block
// table (MAX_PER ints), then each path's own.
template <typename KT, bool QUANT>
__host__ inline int fma_smem(int G, int D) {
  const int TK = fma_tile<KT>(D);
  // ring; table; q, acc: G x D; p: G x TK; m, l, alpha: G
  return STAGES * stage_bytes<KT, QUANT>(TK, D) + MAX_PER * 4 +
         (2 * G * D + G * TK + 3 * G) * 4;
}

template <typename KT, bool QUANT>
__host__ inline int mma_smem(int D) {
  const int ring = STAGES * stage_bytes<KT, QUANT>(MMA_TK, D) + MAX_PER * 4;
  // int8: each warp's 16 rows of V widened to bf16
  const int widen = QUANT ? WARPS * 16 * row_bytes<__nv_bfloat16>(D) : 0;
  const int merge = (2 * WARPS * 16 + WARPS * 16 * (D + 8)) * 4;
  return ring + widen > merge ? ring + widen : merge;
}

// ---- the block's range and the tile copy -----------------------------------

// The block's range: positions [begin, end) of its sequence (empty when
// tiles == 0), from table column j0 on.
struct Range {
  int begin, end, tiles, j0;
};

__device__ __forceinline__ Range block_range(const Params& p, int b, int s,
                                             int TK) {
  const int len = p.lens[b];
  const int n_used = min(p.pps, (len + p.page - 1) / p.page);
  const int j0 = s * p.per;
  const int j1 = min(j0 + p.per, n_used);
  Range r;
  r.j0 = j0;
  r.begin = j0 * p.page;
  r.end = j0 < j1 ? min(len, j1 * p.page) : r.begin;
  r.tiles = (r.end - r.begin + TK - 1) / TK;
  return r;
}

// The block's columns of the block table into shared memory, so that no
// copy waits on a table read from global memory.
__device__ __forceinline__ void load_table(const Params& p, int* tab, int b,
                                           const Range& rg) {
  const int n = (rg.end - rg.begin + p.page - 1) / p.page;
  const int* trow = p.table + static_cast<long long>(b) * p.pps + rg.j0;
  for (int i = threadIdx.x; i < n; i += THREADS) tab[i] = trow[i];
  __syncthreads();
}

// Byte offset of the row of position pos, kv head h, in the pool.
__device__ __forceinline__ long long row_offset(const Params& p,
                                                const int* tab,
                                                const Range& rg, int pos,
                                                int h, int head_bytes) {
  int j, r;
  if (p.page_shift >= 0) {
    j = pos >> p.page_shift;
    r = pos & (p.page - 1);
  } else {
    j = pos / p.page;
    r = pos - j * p.page;
  }
  const long long pg = tab[j - rg.j0];
  return ((pg * p.page + r) * p.Hkv + h) * head_bytes;
}

// Positions [pos0, pos0 + TK) of kv head h into one stage; rows at or past
// the range's end are zero-filled. CH_T: 16-byte chunks per row when known
// at compile time (then TK = MMA_TK and the loop unrolls; 0: from p.D).
template <typename KT, bool QUANT, int CH_T>
__device__ __forceinline__ void load_tile(const Params& p, char* stage,
                                          const int* tab, const Range& rg,
                                          int TK, int h, int pos0) {
  const int tid = threadIdx.x;
  const int rowb = row_bytes<KT>(p.D);
  const int CH = CH_T ? CH_T : p.D * static_cast<int>(sizeof(KT)) / 16;
  const int head_bytes = p.D * static_cast<int>(sizeof(KT));
  const char* kp = static_cast<const char*>(p.k);
  const char* vp = static_cast<const char*>(p.v);
  char* ks = stage;
  char* vs = stage + TK * rowb;
  const int n = TK * CH;
  constexpr int UNROLL = CH_T ? (MMA_TK * CH_T + THREADS - 1) / THREADS : 1;
  for (int i0 = tid; i0 < n; i0 += UNROLL * THREADS) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) {
        const int r = i / CH, c = i - r * CH;
        const int pos = pos0 + r;
        const bool ok = pos < rg.end;
        const long long off =
            ok ? row_offset(p, tab, rg, pos, h, head_bytes) + c * 16 : 0;
        cp_async16(ks + r * rowb + c * 16, kp + off, ok);
        cp_async16(vs + r * rowb + c * 16, vp + off, ok);
      }
    }
  }
  if (QUANT) {
    float* sk = reinterpret_cast<float*>(stage + 2 * TK * rowb);
    float* sv = sk + TK;
    for (int r = tid; r < TK; r += THREADS) {
      const int pos = pos0 + r;
      const bool ok = pos < rg.end;
      long long si = 0;
      if (ok) {
        const int j = p.page_shift >= 0 ? pos >> p.page_shift : pos / p.page;
        si = tab[j - rg.j0] * static_cast<long long>(p.Hkv) + h;
      }
      cp_async4(sk + r, p.k_scales + si, ok);
      cp_async4(sv + r, p.v_scales + si, ok);
    }
  }
}

__device__ __forceinline__ float* ws_ml(const Params& p) {
  return p.ws + static_cast<long long>(p.B) * p.Hq * p.split * p.D;
}

// the partial of query row `row` from split s
__device__ __forceinline__ void write_ml(const Params& p, long long row,
                                         int s, float m, float l) {
  float* ml = ws_ml(p) + 2 * (row * p.split + s);
  ml[0] = m;
  ml[1] = l;
}

__device__ __forceinline__ float* ws_acc(const Params& p, long long row,
                                         int s) {
  return p.ws + (row * p.split + s) * p.D;
}

// ---- fp32 FMAs ---------------------------------------------------------------

template <typename QT, typename KT, bool QUANT>
__device__ void fma_block(const Params& p, char* smem, const Range& rg,
                          int b, int h, int s) {
  const int G = p.Hq / p.Hkv, D = p.D;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int TK = fma_tile<KT>(D);
  const int sbytes = stage_bytes<KT, QUANT>(TK, D);
  const int rowb = row_bytes<KT>(D);
  const long long row0 = static_cast<long long>(b) * p.Hq +
                         static_cast<long long>(h) * G;
  int* tab = reinterpret_cast<int*>(smem + STAGES * sbytes);
  float* q_s = reinterpret_cast<float*>(tab + MAX_PER);
  float* acc_s = q_s + G * D;
  float* p_s = acc_s + G * D;
  float* m_s = p_s + G * TK;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  load_table(p, tab, b, rg);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < rg.tiles)
      load_tile<KT, QUANT, 0>(p, smem + t * sbytes, tab, rg, TK, h,
                              rg.begin + t * TK);
    cp_async_commit();
  }
  const QT* q = static_cast<const QT*>(p.q) + row0 * D;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_float(q[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = MASKED;
    l_s[g] = 0.f;
  }
  using V = Vec<KT>;
  for (int t = 0; t < rg.tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; tile t - 1 and its p_s are consumed
    const int tn = t + STAGES - 1;
    if (tn < rg.tiles)
      load_tile<KT, QUANT, 0>(p, smem + (tn % STAGES) * sbytes, tab, rg, TK,
                              h, rg.begin + tn * TK);
    cp_async_commit();

    const char* st = smem + (t % STAGES) * sbytes;
    const char* kt = st;
    const char* vt = st + TK * rowb;
    const float* sk = reinterpret_cast<const float*>(st + 2 * TK * rowb);
    const float* sv = sk + TK;
    const int rows = min(TK, rg.end - (rg.begin + t * TK));

    // scores: one (query head, key) pair per thread and step
    for (int i = tid; i < G * TK; i += THREADS) {
      const int g = i / TK, r = i - g * TK;
      float x = MASKED;
      if (r < rows) {
        const KT* kr = reinterpret_cast<const KT*>(kt + r * rowb);
        const float* qr = q_s + g * D;
        float a = 0.f;
        for (int c = 0; c < D; c += V::N) {
          float kf[V::N];
          V::unpack(*reinterpret_cast<const uint4*>(kr + c), kf);
#pragma unroll
          for (int e = 0; e < V::N; ++e) a = fmaf(qr[c + e], kf[e], a);
        }
        x = (QUANT ? a * sk[r] : a) * p.scale;
      }
      p_s[i] = x;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* pr = p_s + g * TK;
      float mx = MASKED;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, pr[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int r = lane; r < TK; r += 32) {
        const float e = r < rows ? expf(pr[r] - m_new) : 0.f;
        sum += e;
        pr[r] = QUANT ? e * sv[r] : e;
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
      const int g = i / D, c = i - g * D;
      const float* pr = p_s + g * TK;
      float a = 0.f;
      for (int r = 0; r < rows; ++r)
        a = fmaf(pr[r],
                 to_float(reinterpret_cast<const KT*>(vt + r * rowb)[c]), a);
      acc_s[i] = acc_s[i] * a_s[g] + a;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i - g * D;
    ws_acc(p, row0 + g, s)[c] = acc_s[i];
  }
  for (int g = tid; g < G; g += THREADS)
    write_ml(p, row0 + g, s, m_s[g], l_s[g]);
}

// ---- tensor cores ----------------------------------------------------------

// Warp w takes keys [16 w, 16 w + 16) of each tile of MMA_TK positions.
template <typename KT, bool QUANT, int D>
__device__ void mma_block(const Params& p, char* smem, const Range& rg,
                          int b, int h, int s) {
  constexpr int KS = D / 16;  // k-steps of q k^T
  constexpr int NT = D / 8;   // n-tiles of P v
  constexpr int TK = MMA_TK;
  constexpr int ROWB = row_bytes<KT>(D);
  constexpr int RB16 = row_bytes<__nv_bfloat16>(D);
  constexpr int SBYTES = stage_bytes<KT, QUANT>(TK, D);
  constexpr int CH_T = D * static_cast<int>(sizeof(KT)) / 16;
  constexpr float LOG2E = 1.4426950408889634f;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g0 = lane / 4, t4 = lane % 4;
  const long long row0 = static_cast<long long>(b) * p.Hq +
                         static_cast<long long>(h) * G;
  int* tab = reinterpret_cast<int*>(smem + STAGES * SBYTES);

  load_table(p, tab, b, rg);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < rg.tiles)
      load_tile<KT, QUANT, CH_T>(p, smem + t * SBYTES, tab, rg, TK, h,
                                 rg.begin + t * TK);
    cp_async_commit();
  }

  // q fragments: rows g0 and g0 + 8 of the (G padded to 16) x d block. For
  // int8 pages the columns of a k-step are permuted so that a thread's four
  // B values are four consecutive int8 of a K row (one 32-bit load): slots
  // (2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9) hold columns 4 t4 .. 4 t4 + 3.
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                             row0 * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = g0 + (i & 1) * 8;
        const int c = ks * 16 + (QUANT ? t4 * 4 + (i >> 1) * 2
                                       : (i >> 1) * 8 + t4 * 2);
        qa[ks][i] =
            g < G ? *reinterpret_cast<const uint32_t*>(q + g * D + c) : 0u;
      }
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (in log2 units) and this thread's share of the row sums
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * LOG2E;

  // int8: this warp's 16 rows of V widened to bf16
  char* vw = smem + STAGES * SBYTES + MAX_PER * 4 + warp * 16 * RB16;
  // ldmatrix lane rows and columns: K as the B operand of q k^T, V as the
  // (transposed) B operand of P v
  const int k_row = ((lane >> 4) & 1) * 8 + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int v_col = (lane >> 4) * 8;

  for (int t = 0; t < rg.tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is consumed
    const int tn = t + STAGES - 1;
    if (tn < rg.tiles)
      load_tile<KT, QUANT, CH_T>(p, smem + (tn % STAGES) * SBYTES, tab, rg,
                                 TK, h, rg.begin + tn * TK);
    cp_async_commit();

    const char* st = smem + (t % STAGES) * SBYTES;
    const char* kt = st + warp * 16 * ROWB;  // this warp's 16 rows
    const char* vt = kt + TK * ROWB;
    const float* sk =
        reinterpret_cast<const float*>(st + 2 * TK * ROWB) + warp * 16;
    const float* sv = sk + TK;

    // S = q k^T for this warp's 16 keys: two n-tiles of 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    uint32_t vb_addr;
    int vrb;
    if constexpr (QUANT) {
      // K straight from the ring: four int8 of row (8 nt + g0) a thread
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t b0, b1;
          widen4(*reinterpret_cast<const uint32_t*>(
                     kt + (nt * 8 + g0) * ROWB + ks * 16 + t4 * 4),
                 b0, b1);
          mma_bf16(sc[nt], qa[ks], b0, b1);
        }
      // V widened to bf16 in this warp's buffer, for ldmatrix.trans
      constexpr int CH8 = D / 16;  // 16-byte int8 chunks per row
      __syncwarp();  // the previous tile's ldmatrix reads are done
#pragma unroll
      for (int i = lane; i < 16 * CH8; i += 32) {
        const int r = i / CH8, c = i % CH8;
        const uint4 w = *reinterpret_cast<const uint4*>(vt + r * ROWB + c * 16);
        uint4 o0, o1;
        widen4(w.x, o0.x, o0.y);
        widen4(w.y, o0.z, o0.w);
        widen4(w.z, o1.x, o1.y);
        widen4(w.w, o1.z, o1.w);
        char* dst = vw + r * RB16 + c * 32;
        *reinterpret_cast<uint4*>(dst) = o0;
        *reinterpret_cast<uint4*>(dst + 16) = o1;
      }
      __syncwarp();
      vb_addr = smem_u32(vw);
      vrb = RB16;
    } else {
      const uint32_t kb_addr = smem_u32(kt);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(kb, kb_addr + k_row * ROWB + (ks * 16 + k_col) * 2);
        mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
      }
      vb_addr = smem_u32(vt);
      vrb = ROWB;
    }

    // scale (log2 units), mask, online softmax: rows g0 and g0 + 8; a row's
    // 16 keys lie in the 4 threads of a quad
    const int lim = rg.end - (rg.begin + t * TK + warp * 16);
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + t4 * 2 + (e & 1);
        float x = sc[nt][e] * scale2;
        if (QUANT) x *= sk[key];
        x = key < lim ? x : MASKED;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    float pv[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + t4 * 2 + (e & 1);
        const float x = key < lim ? exp2_approx(sc[nt][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += x;
        pv[nt][e] = QUANT ? x * sv[key] : x;
      }
    // the S accumulators of keys 0-7 and 8-15 are P's A fragment
    const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]),
                            pack_bf16(pv[0][2], pv[0][3]),
                            pack_bf16(pv[1][0], pv[1][1]),
                            pack_bf16(pv[1][2], pv[1][3])};
    // rescale acc only when a row's max moved (alpha = 1 exactly otherwise)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vb_addr + v_row * vrb + (j * 8 + v_col) * 2);
      mma_bf16(acc[j], pa, vb[0], vb[1]);
      mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
    }
  }

  // merge the four warps' (m, l, acc) through shared memory; m back to
  // natural-log units for the combine
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  constexpr int AW = D + 8;  // row stride of the warps' acc, in floats
  float* mw = reinterpret_cast<float*>(smem);
  float* lw = mw + WARPS * 16;
  float* aw = lw + WARPS * 16;
  if (t4 == 0) {
    mw[warp * 16 + g0] = m[0];
    mw[warp * 16 + g0 + 8] = m[1];
    lw[warp * 16 + g0] = l[0];
    lw[warp * 16 + g0 + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(aw + (warp * 16 + g0 + r * 8) * AW + j * 8 +
                                 t4 * 2) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    float M = MASKED;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * 16 + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2_approx(mw[w * 16 + g] - M);
      L += lw[w * 16 + g] * f;
      A += aw[(w * 16 + g) * AW + c] * f;
    }
    ws_acc(p, row0 + g, s)[c] = A;
    if (c == 0) write_ml(p, row0 + g, s, M / LOG2E, L);
  }
}

// ---- the combine -----------------------------------------------------------

// grid (B * Hq): block r merges query row r's split partials by log-sum-exp,
// thread c column c (and c + 128, ...). A thread reads the partials of a
// chunk of splits at once (m, l and its acc element), merges them into a
// running (M, L, A), and skips those with l = 0.
template <typename QT>
__global__ void __launch_bounds__(COMBINE_THREADS)
    paged_attention_kernel_combine(const Params p) {
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
    static_cast<QT*>(p.o)[row * p.D + c] =
        from_float<QT>(A / (L == 0.f ? 1.f : L));
  }
}

// ---- the split kernel -------------------------------------------------------

// grid (split, Hkv, B): block (s, h, b) attends sequence b's pages
// [s * per, s * per + per) with kv head h and writes its G query rows'
// partials. MMA_D = 0: fp32 FMAs; MMA_D = d: mma.sync (bf16 q; bf16 or int8
// pages; G <= 16).
template <typename QT, typename KT, bool QUANT, int MMA_D>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel_split(
    const Params p) {
  extern __shared__ __align__(16) char smem[];
  const int G = p.Hq / p.Hkv;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Range rg = block_range(p, b, s, MMA_D ? MMA_TK : fma_tile<KT>(p.D));
  if (rg.tiles == 0) {  // l = 0: the combine skips this partial
    const long long row0 = static_cast<long long>(b) * p.Hq +
                           static_cast<long long>(h) * G;
    for (int g = threadIdx.x; g < G; g += THREADS)
      write_ml(p, row0 + g, s, MASKED, 0.f);
  } else if constexpr (MMA_D == 0) {
    fma_block<QT, KT, QUANT>(p, smem, rg, b, h, s);
  } else {
    mma_block<KT, QUANT, MMA_D>(p, smem, rg, b, h, s);
  }
}

template <typename Kernel>
cudaError_t launch_split(Kernel kernel, const Params& p, int smem,
                         cudaStream_t stream) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.split, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  cudaError_t err;
  if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                !std::is_same<KT, float>::value) {
    if (G <= 16 && p.D == 128)
      err = launch_split(paged_attention_kernel_split<QT, KT, QUANT, 128>, p,
                         mma_smem<KT, QUANT>(128), stream);
    else if (G <= 16 && p.D == 64)
      err = launch_split(paged_attention_kernel_split<QT, KT, QUANT, 64>, p,
                         mma_smem<KT, QUANT>(64), stream);
    else if (G <= 16 && p.D == 32)
      err = launch_split(paged_attention_kernel_split<QT, KT, QUANT, 32>, p,
                         mma_smem<KT, QUANT>(32), stream);
    else
      err = launch_split(paged_attention_kernel_split<QT, KT, QUANT, 0>, p,
                         fma_smem<KT, QUANT>(G, p.D), stream);
  } else {
    err = launch_split(paged_attention_kernel_split<QT, KT, QUANT, 0>, p,
                       fma_smem<KT, QUANT>(G, p.D), stream);
  }
  if (err != cudaSuccess) return err;
  const int rows = p.B * p.Hq;
  paged_attention_kernel_combine<QT><<<rows, COMBINE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_scales, const void* v_scales,
                   const void* table, const void* lens, void* o, void* ws,
                   int B, int Hq, int Hkv, int D, int page, int pps,
                   int split, int per, float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.page = page;
  p.pps = pps;
  p.split = split;
  p.per = per;
  p.page_shift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  p.scale = scale;
  return p;
}

bool bad_shape(int B, int Hq, int Hkv, int D, int page, int pps, int split,
               int per) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D % 16 != 0 ||
         D > 256 || page <= 0 || pps <= 0 || B > 65535 || Hkv > 65535 ||
         split <= 0 || split > 4096 || per <= 0 || per > MAX_PER ||
         static_cast<long long>(split) * per < pps ||
         static_cast<long long>(split - 1) * per >= pps;
}

}  // namespace

// q_dtype, kv_dtype: 0 = float32, 1 = bfloat16. q, o (B, Hq, d); k, v
// (n_pages, page, Hkv, d); table (B, pps) int32; lens (B,) int32; ws a
// float32 workspace of B * Hq * split * (d + 2); all contiguous. Block s of a
// (sequence, kv head) takes pages [s * per, s * per + per): split * per >=
// pps > (split - 1) * per, per <= 256. Launches the split kernel, then the
// combine kernel. Returns the CUDA error code of the launches (0 on
// success); allocates nothing, runs on the given stream and does not
// synchronise.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* table,
                                     const void* lens, void* o, void* ws,
                                     int q_dtype, int kv_dtype, int B, int Hq,
                                     int Hkv, int D, int page, int pps,
                                     int split, int per, float scale,
                                     void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, pps, split, per))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, nullptr, nullptr, table, lens, o, ws,
                               B, Hq, Hkv, D, page, pps, split, per, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype * 2 + kv_dtype) {
    case 0: err = launch<float, float, false>(p, s); break;
    case 1: err = launch<float, __nv_bfloat16, false>(p, s); break;
    case 2: err = launch<__nv_bfloat16, float, false>(p, s); break;
    case 3: err = launch<__nv_bfloat16, __nv_bfloat16, false>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As repro_paged_attention over int8 k, v with float32 k_scales, v_scales
// (n_pages, Hkv).
extern "C" int repro_paged_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* table, const void* lens, void* o,
    void* ws, int q_dtype, int B, int Hq, int Hkv, int D, int page, int pps,
    int split, int per, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, pps, split, per))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, k_scales, v_scales, table, lens, o,
                               ws, B, Hq, Hkv, D, page, pps, split, per,
                               scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0: err = launch<float, int8_t, true>(p, s); break;
    case 1: err = launch<__nv_bfloat16, int8_t, true>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
