// Fused binary spiking attention of the binary engine, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spike_attention.py::spike_attention (the
// Pallas body `_kernel`, grid (BH, nQ, nK) with the KV axis innermost).
// For {0,1} spikes q, k, v: (BH, L, d) it computes
//   s = (q k^T) * scale, a = 1[s - delta >= 0] (or s itself when
//   binarize == 0), a = 0 above the diagonal when causal, out = a v,
// in one pass, and writes the context in the operands' dtype. Any BH, L
// and d.
//
// Contract, as the TPU kernel's: q, k and v hold {0,1} spikes (exact in
// bf16, so an fp32 operand becomes bf16 on its way into shared memory).
//
// What bounds it: at the training step's shape (BH = T*B*H = 2048, L =
// 64, d = 32, bf16) a call reads q, k, v and writes the context, 33.5 MB:
// bytes (~10 us at 3.35 TB/s); at an 8-512 step's (1024, 196, 64) 103 MB
// (~31 us). A causal prompt (BH 8, L 4608, d 32) does 11 G operations on
// the bf16 tensor cores for 9.4 MB: operations (~11 us at 989 TFLOP/s).
//
// Design: the TPU kernel's own mapping, both products on the matrix
// units. A block of NW = 4 warps owns (bh, a tile of QT = 64 query rows, a
// slice of up to 128 output columns); each warp owns 16 query rows. The
// block walks its head's keys in tiles of KT = 64, in ascending order,
// and under causal stops at its diagonal. Key and value tiles come
// straight from the operands through a two-stage cp.async ring in shared
// memory, one block barrier a tile; the query tile stays in shared memory
// for the whole walk. No block converts keys to bits: a bf16 row is
// copied as it is (16-byte copies; aligned bf16 rows of d = 32, 64 or 128
// take a fast path whose strides are constants and whose copies are fixed
// pieces a thread, rows past L zero-filled), an fp32, unaligned or ragged
// row goes through registers as bf16, element by element. A head's keys
// and values leave device memory once: its other query tiles read them
// from L2 (blocks of a head are numbered side by side; causal blocks are
// numbered heaviest first, so the longest walks start in the first wave,
// and a whole causal problem's keys sit in L2 at the prompts it serves).
// Row strides carry 16 bytes of pad, so the eight rows of an ldmatrix lie
// in distinct banks.
// S = Q K^T runs on mma.sync m16n8k16 bf16 with fp32 accumulators: exact
// integer counts (at most d), d padded to 16 by zeros. A count passes the
// threshold when fma32(count, scale, -delta) >= 0, the reference's rule
// (jitted XLA contracts s * scale - delta into one FMA; float64 product
// and sum, rounded once, as models/nn.fma32). That rule is monotone in the
// count (rounding is monotone), so the counts that pass are an interval
// [lo, hi], which each warp finds once from the d + 1 counts; a score then
// costs two saturating adds and a min (sat(c + 1 - lo), sat(hi + 1 - c),
// exact on integers), and the causal mask a third where a key tile
// reaches past a warp's first row. The {0,1} scores stay in registers: the
// accumulator layout of m16n8k16 is the A layout of the next product (as
// in FlashAttention-2), so O += A V runs on mma.sync too, V's fragments by
// ldmatrix.trans, O in fp32 registers: exact integer counts (at most L <
// 2^24), rounded once to the output dtype. With no softmax there is
// nothing to rescale: no key chunk, no shared-memory accumulator, no
// atomics. A warp skips the 16-key steps of a tile that hold no key it
// needs (past L, or past its last row under causal): they would add exact
// zeros. What bounds the products is shared memory: every warp reads the
// whole key and value tile through ldmatrix. So past one key tile a
// binarized d <= 64 walk gives each warp two query tiles, taken in 32-key
// halves (the registers of both tiles' counts and contexts fit), and each
// key and value fragment serves both: half the shared-memory reads a
// product. A binarized causal walk past NG_LEN keys instead takes two warp
// groups of NW warps (one query tile a warp) on the same query tile, each
// on alternate key tiles, the second handing its integer context to the
// first through shared memory at the end (exact in any order): the
// heaviest block's serial walk, which sets a long prompt's time, halves.
// With binarize == 0 the scores stay analog: each warp writes its tile of
// fl(count * scale) (0 above the diagonal) to shared memory, and each lane
// owns output columns of the warp's 16 rows, adding the score of every key
// whose value is set, key by key in ascending order, one fp32 add a term
// (fmaf(v, s, acc) with v in {0, 1}: v s is exact, so it rounds as
// acc + s, or leaves acc), the running sums in registers across key
// tiles: the order of the plain version (kernels/fused_ssa.analog_context)
// and of the fused SSA bundle, so all three agree bitwise (JAX sums in
// XLA's order, so the reference agrees within a tolerance).
// Any d: up to 128 output columns a block (d above 128 runs in column
// slices, each recomputing S); the query tile stays resident while d
// padded to 16 is at most 256, and past that S's depth is streamed in
// 128-deep chunks through the ring, the query chunk beside the key chunk.
//
// Where it stands (PERF.md section 6; NVIDIA H100 80GB HBM3 at 700 W,
// bf16, profiler device time, in turns with the earlier design): 12 us at
// the training shape (1.2x its bound) against 45-47, 25 us at the bf16 LM
// prefill's (256, 512, 32) causal against 127-129, 59 us at (8, 4608,
// 32) causal against 395, 63 us at (1024, 196, 64) against 262; analog
// 30 and 243 us against 370 and 4215. Measured along the way: a deeper
// ring, more blocks an SM and split accumulators did not help; the
// copies' bookkeeping (runtime divisions a piece), the threshold's
// predicate logic (ten instructions a score) and the key and value
// fragments' shared-memory reads did, before the fast path, the
// saturating adds and two query tiles a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int NW = 4;          // warps of a warp group, 16 query rows each
constexpr int KT = 64;         // keys a tile
constexpr int DRES = 256;      // padded d up to which Q stays resident
constexpr int DC = 128;        // depth of a streamed chunk of S
constexpr int SCS = 20;        // analog scores: floats a key (16 rows, pad)
constexpr int PAD = 8;         // bf16 pad at the end of a shared row
constexpr int STAGES = 2;      // ring stages (steps in flight: STAGES - 1)
// a binarized causal walk past NG_LEN keys takes two warp groups
constexpr int NG_LEN = 2048;

// Where a block's tiles lie in shared memory (bf16 elements from the
// base; the analog scores after them), for head dim d, slice width ds, ng
// warp groups and qt query rows. A ring stage holds one step: [the
// streamed query chunk] and each group's key chunk and value slice.
struct Plan {
  int dp, nck, ckw, qs, ks, vs, q_elems, slot, stage, k_off, elems;
  __host__ __device__ Plan(int d, int ds, int ng, int qt) {
    dp = (d + 15) / 16 * 16;
    nck = dp <= DRES ? 1 : (dp + DC - 1) / DC;
    ckw = nck == 1 ? dp : DC;
    qs = ckw + PAD;
    ks = ckw + PAD;
    vs = ds + PAD;
    q_elems = qt * qs;
    k_off = nck == 1 ? 0 : q_elems;
    slot = KT * ks + KT * vs;
    stage = k_off + ng * slot;
    elems = (nck == 1 ? q_elems : 0) + STAGES * stage;
  }
  // the ring, or the second group's context when it is handed over, and
  // the analog scores
  __host__ __device__ size_t bytes(bool analog, int ng, int dn,
                                   int mt) const {
    const size_t ring = (size_t)elems * 2;
    const size_t merge = ng > 1 ? (size_t)NW * 32 * mt * dn * 4 * 4 : 0;
    return (ring > merge ? ring : merge) +
           (analog ? (size_t)NW * KT * SCS * 4 : 0);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
// 16 bytes, or zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
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
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One 8-key n-tile of counts (m16n8 accumulators: row g, keys 2 tig and
// 2 tig + 1, then row g + 8) as the {0,1} halves of two A registers of the
// next product: a count c passes when sat(c + t_lo) and sat(t_hi - c) are
// both 1 (t_lo = 1 - lo, t_hi = hi + 1: exact on integers); under diag a
// key past its row gives 0, rk being row - key + 1 of the first score.
__device__ __forceinline__ void binarize(const float (&c)[4], float t_lo,
                                         float t_hi, bool diag, float rk,
                                         uint32_t& lo, uint32_t& hi) {
  float p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = fminf(__saturatef(c[e] + t_lo), __saturatef(t_hi - c[e]));
  if (diag) {
    p[0] = fminf(p[0], __saturatef(rk));
    p[1] = fminf(p[1], __saturatef(rk - 1.f));
    p[2] = fminf(p[2], __saturatef(rk + 8.f));
    p[3] = fminf(p[3], __saturatef(rk + 7.f));
  }
  lo = pack_bf16(p[0], p[1]);
  hi = pack_bf16(p[2], p[3]);
}

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// Rows [row0, row0 + nrows) and columns [col0, col0 + ncols) (ncols a
// multiple of 8) of one head's (L, d) operand into a bf16 tile of row
// stride ld; zeros past L or d. A piece is 8 columns of a row, and the
// NTH threads take consecutive pieces of a row. A whole tile of bf16 rows
// (vec: d a multiple of 8, 16-byte aligned) whose row holds a power of two
// of pieces goes by 16-byte cp.async copies from fixed columns a thread;
// otherwise each piece goes through registers as bf16: fp32 rows as two
// 16-byte loads (vec: d a multiple of 4, aligned), ragged and unaligned
// pieces element by element.
template <typename T, int NTH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int nrows, int L, int col0,
                                          int ncols, int d, bool vec,
                                          __nv_bfloat16* dst, int ld) {
  const int ppr = ncols / 8;
  if constexpr (sizeof(T) == 2) {
    if (vec && row0 + nrows <= L && col0 + ncols <= d &&
        (ppr & (ppr - 1)) == 0 && ppr <= NTH) {
      const int sh = __ffs(ppr) - 1, rstep = NTH >> sh;
      const int c8 = (threadIdx.x & (ppr - 1)) * 8;
      int r = threadIdx.x >> sh;
      const T* s = src + (size_t)(row0 + r) * d + col0 + c8;
      __nv_bfloat16* p = dst + r * ld + c8;
      for (; r < nrows; r += rstep, s += (size_t)rstep * d, p += rstep * ld)
        cp_async16(p, s);
      return;
    }
  }
  const int total = nrows * ppr;
  for (int i = threadIdx.x; i < total; i += NTH) {
    const int r = i / ppr, c = i - r * ppr;
    const int gr = row0 + r, gc = col0 + c * 8;
    __nv_bfloat16* p = dst + r * ld + c * 8;
    if (gr >= L || gc >= d) {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = src + (size_t)gr * d + gc;
    const bool whole = vec && gc + 8 <= d;
    if constexpr (sizeof(T) == 2) {
      if (whole) {
        cp_async16(p, s);
        continue;
      }
    }
    uint32_t w[4];
    if (sizeof(T) == 4 && whole) {
      const float4 a = reinterpret_cast<const float4*>(s)[0];
      const float4 b = reinterpret_cast<const float4*>(s)[1];
      const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (uint32_t)bf16_bits(f[2 * e]) |
               (uint32_t)bf16_bits(f[2 * e + 1]) << 16;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = gc + 2 * e < d ? bf16_bits(s[2 * e]) : 0u;
        const uint32_t hi = gc + 2 * e + 1 < d ? bf16_bits(s[2 * e + 1]) : 0u;
        w[e] = lo | hi << 16;
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The fast path's copy: rows [row0, row0 + nrows) of a bf16 operand with
// d = 8 DN columns (16-byte aligned) into a tile of row stride 8 DN + PAD,
// zeros past L. Thread t copies the piece t % DN of rows t / DN + j NTH / DN:
// fixed columns, consecutive threads on consecutive pieces of a row. At
// most ROWS rows.
template <int DN, int NTH, int ROWS>
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* __restrict__ src,
                                          int row0, int nrows, int L,
                                          __nv_bfloat16* dst) {
  constexpr int D = DN * 8, RSTEP = NTH / DN;
  const int r = threadIdx.x / DN, c8 = threadIdx.x % DN * 8;
  const __nv_bfloat16* s = src + (size_t)(row0 + r) * D + c8;
  __nv_bfloat16* p = dst + r * (D + PAD) + c8;
#pragma unroll
  for (int j = 0; j < (ROWS + RSTEP - 1) / RSTEP; ++j) {
    if (j * RSTEP + r >= nrows) break;
    const bool in = row0 + r + j * RSTEP < L;
    cp_async16(p + j * RSTEP * (D + PAD), in ? s + (size_t)j * RSTEP * D : src,
               in ? 16 : 0);
  }
}

// DN: n-tiles of 8 output columns a block (a slice of DN * 8 columns).
// ANALOG: binarize == 0. NG: warp groups, each of NW warps on the block's
// query tile, taking alternate key tiles (binarized only: their integer
// contexts add exactly). FAST: bf16 operands, 16-byte aligned, d = 8 DN:
// every stride a constant and each copy a fixed piece a thread. MT: query
// tiles of 16 rows a warp (2: binarized, d <= 64, each key and value
// fragment read from shared memory serves both, in 32-key halves).
// Blocks an SM: 6 warp groups (at most 80 registers) for binarized d <=
// 32 and one tile a warp, else 4 (128 registers).
template <typename T, int DN, bool ANALOG, int NG, bool FAST, int MT>
__global__ void __launch_bounds__(NW * 32 * NG,
                                  (DN == 4 && !ANALOG && MT == 1 ? 6 : 4) /
                                      NG)
spike_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ delta_p, float scale,
                       int causal, int bh_count, int L, int d, int vec_mask,
                       T* __restrict__ out) {
  static_assert(!ANALOG || NG == 1, "analog sums run in key order");
  static_assert(MT == 1 || (!ANALOG && DN <= 8), "two tiles a warp: "
                "binarized, the query tile resident");
  constexpr int DS = DN * 8, NTH = NW * 32 * NG, QT = 16 * NW * MT;
  static_assert(!FAST || sizeof(T) == 2, "the fast path copies bf16 rows");
  if constexpr (FAST) d = DS;
  const Plan pl(d, DS, NG, QT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / NW, wq = warp % NW;
  const int g = lane >> 2, tig = lane & 3;
  const int ns = (d + DS - 1) / DS, nqt = (L + QT - 1) / QT;
  // heaviest first under causal: the last query tiles of every head lead
  const long long b = blockIdx.x;
  int qt, bh, slice;
  if (causal) {
    const long long per = (long long)bh_count * ns;
    qt = nqt - 1 - (int)(b / per);
    const int rem = (int)(b % per);
    bh = rem / ns;
    slice = rem % ns;
  } else {
    qt = (int)(b % nqt);
    const long long rest = b / nqt;
    slice = (int)(rest % ns);
    bh = (int)(rest / ns);
  }
  const int q0 = qt * QT, c0 = slice * DS, r0 = q0 + wq * 16 * MT;
  const int kend = causal ? min(L, q0 + QT) : L;  // keys this block reads
  const int nkt = (kend + KT - 1) / KT;
  // a step: NG key tiles (one a group) at one depth chunk
  const int steps = (nkt + NG - 1) / NG * pl.nck;
  const size_t head = (size_t)bh * L * d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const bool vq = vec_mask & 1, vk = vec_mask & 2, vv = vec_mask & 4;

  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qres = sm;  // the resident query tile (nck == 1)
  __nv_bfloat16* ring = sm + (pl.nck == 1 ? pl.q_elems : 0);
  float* sc = reinterpret_cast<float*>(
                  smem + pl.bytes(false, NG, DN, MT)) +
              wq * KT * SCS;  // this warp's analog scores [key][row]

  // the counts that pass the threshold are an interval [lo, hi] (empty
  // when lo > hi); a count c passes when sat(c + 1 - lo) and
  // sat(hi + 1 - c) are both 1 (exact on integers)
  float t_lo = 0.f, t_hi = 0.f;
  if constexpr (!ANALOG) {
    const float delta = *delta_p;
    int lo = d + 1, hi = -1;
    for (int c = lane; c <= d; c += 32)
      if (fma32((float)c, scale, -delta) >= 0.f) {
        lo = min(lo, c);
        hi = max(hi, c);
      }
    t_lo = (float)(1 - __reduce_min_sync(FULL, lo));
    t_hi = (float)(__reduce_max_sync(FULL, hi) + 1);
  }

  auto issue = [&](int step) {
    if (step >= steps) return;
    if constexpr (FAST) {
      __nv_bfloat16* st = ring + (step % STAGES) * pl.stage;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int kt = step * NG + j;
        if (kt >= nkt) break;
        __nv_bfloat16* slot = st + pl.k_off + j * pl.slot;
        copy_rows<DN, NTH, KT>((const __nv_bfloat16*)kh, kt * KT, KT, L,
                               slot);
        copy_rows<DN, NTH, KT>((const __nv_bfloat16*)vh, kt * KT, KT, L,
                               slot + KT * pl.ks);
      }
      return;
    }
    __nv_bfloat16* st = ring + (step % STAGES) * pl.stage;
    const int ktp = pl.nck == 1 ? step : step / pl.nck;
    const int ck = pl.nck == 1 ? 0 : step % pl.nck;
    if (pl.nck > 1)
      load_tile<T, NTH>(qh, q0, QT, L, ck * pl.ckw, pl.ckw, d, vq, st, pl.qs);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int kt = ktp * NG + j;
      if (kt >= nkt) break;
      __nv_bfloat16* slot = st + pl.k_off + j * pl.slot;
      load_tile<T, NTH>(kh, kt * KT, KT, L, ck * pl.ckw, pl.ckw, d, vk, slot,
                        pl.ks);
      if (ck == pl.nck - 1)
        load_tile<T, NTH>(vh, kt * KT, KT, L, c0, DS, d, vv,
                          slot + KT * pl.ks, pl.vs);
    }
  };
  if constexpr (FAST)
    copy_rows<DN, NTH, QT>((const __nv_bfloat16*)qh, q0, QT, L, qres);
  else if (pl.nck == 1)
    load_tile<T, NTH>(qh, q0, QT, L, 0, pl.ckw, d, vq, qres, pl.qs);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    issue(i);
    cp_async_commit();
  }

  float o[ANALOG ? 1 : MT][ANALOG ? 1 : DN][4] = {};  // binarized context

  float acc[ANALOG ? DS / 32 : 1][16] = {};  // analog context
  float s[8][4];                             // a key tile's counts

  // MT == 2: the warp's two query tiles against one key tile, in halves
  // of 32 keys (NS 16-key steps of the half hold a key the warp needs);
  // each K and V fragment from shared memory feeds both tiles' products
  auto two_tiles = [&](const __nv_bfloat16* kt_s, const __nv_bfloat16* vt,
                       int k0) {
    const uint32_t qa = smem_u32(qres + (wq * 32 + (lane & 15)) * pl.qs +
                                 (lane >> 4) * 8);
    const uint32_t ka = smem_u32(
        kt_s + ((lane & 7) + ((lane >> 4) << 3)) * pl.ks +
        ((lane >> 3) & 1) * 8);
    const uint32_t va =
        smem_u32(vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * pl.vs +
                 (lane >> 4) * 8);
    auto half = [&](auto h_c, auto ns_c) {
      constexpr int HH = decltype(h_c)::value, NS = decltype(ns_c)::value;
      const int kh = k0 + 32 * HH;
      float sc2[2][4][4] = {};
      for (int kk = 0; kk < pl.ckw; kk += 16) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, qa + kk * 2);
        ldsm_x4(a1, qa + (16 * pl.qs + kk) * 2);
#pragma unroll
        for (int np = 0; np < NS; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, ka + ((32 * HH + 16 * np) * pl.ks + kk) * 2);
          mma_bf16(sc2[0][2 * np], a0, bf[0], bf[1]);
          mma_bf16(sc2[0][2 * np + 1], a0, bf[2], bf[3]);
          mma_bf16(sc2[1][2 * np], a1, bf[0], bf[1]);
          mma_bf16(sc2[1][2 * np + 1], a1, bf[2], bf[3]);
        }
      }
      const bool diag = causal && kh + 31 > r0;
#pragma unroll
      for (int ks = 0; ks < NS; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // row - key + 1 of this thread's first score of the tile
          const float rk = (float)(r0 + 16 * mi + g - kh - 2 * tig + 1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            binarize(sc2[mi][2 * ks + hh], t_lo, t_hi, diag,
                     rk - (float)(16 * ks + 8 * hh), a[mi][2 * hh],
                     a[mi][2 * hh + 1]);
        }
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, va + ((32 * HH + 16 * ks) * pl.vs + np * 16) * 2);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(o[mi][2 * np], a[mi], bf[0], bf[1]);
            mma_bf16(o[mi][2 * np + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    };
    using I0 = std::integral_constant<int, 0>;
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    // keys of the tile the warp needs: none past L, none past its last
    // row under causal
    const int kneed = min(L, causal ? r0 + 32 : L) - k0;
    if (kneed > 16)
      half(I0(), I2());
    else
      half(I0(), I1());
    if (kneed > 48)
      half(I1(), I2());
    else if (kneed > 32)
      half(I1(), I1());
  };

  // one barrier a step: once every warp has passed it, the stage read in
  // the step before is free for the step STAGES - 1 ahead
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(step + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* st = ring + (step % STAGES) * pl.stage;
    const int ktp = pl.nck == 1 ? step : step / pl.nck;
    const int ck = pl.nck == 1 ? 0 : step % pl.nck;
    const int kt = ktp * NG + grp, k0 = kt * KT;
    // a warp with no query row, or (causal) whose rows all lie before
    // this key tile, has nothing to do here
    const bool live =
        kt < nkt && r0 < L && (!causal || k0 <= r0 + 16 * MT - 1);
    if (!live) continue;
    const __nv_bfloat16* kt_s = st + pl.k_off + grp * pl.slot;
    const __nv_bfloat16* vt = kt_s + KT * pl.ks;
    if constexpr (MT == 2) {
      two_tiles(kt_s, vt, k0);
    } else {
      if (ck == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      }
      // the tile's first NK 16-key steps: the others hold no key this warp
      // needs (past L or, causal, past its last row) and would add exact
      // zeros
      auto tile = [&](auto nk_c) {
        constexpr int NK = decltype(nk_c)::value;
        {
          const __nv_bfloat16* qt_s = pl.nck == 1 ? qres : st;
          const uint32_t qa = smem_u32(qt_s + (wq * 16 + (lane & 15)) * pl.qs +
                                       (lane >> 4) * 8);
          const uint32_t ka = smem_u32(
              kt_s + ((lane & 7) + ((lane >> 4) << 3)) * pl.ks +
              ((lane >> 3) & 1) * 8);
          for (int kk = 0; kk < pl.ckw; kk += 16) {
            uint32_t a[4];
            ldsm_x4(a, qa + kk * 2);
#pragma unroll
            for (int np = 0; np < NK; ++np) {
              uint32_t bf[4];
              ldsm_x4(bf, ka + (np * 16 * pl.ks + kk) * 2);
              mma_bf16(s[2 * np], a, bf[0], bf[1]);
              mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
            }
          }
        }
        if (ck != pl.nck - 1) return;
        // keys past a row of this warp: only where the tile reaches past the
        // warp's first row
        const bool diag = causal && k0 + KT - 1 > r0;
        if constexpr (!ANALOG) {
          const uint32_t va =
              smem_u32(vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * pl.vs +
                       (lane >> 4) * 8);
          // row - key + 1 of this thread's first score in the tile
          const float rk = (float)(r0 + g - k0 - 2 * tig + 1);
#pragma unroll
          for (int ks = 0; ks < NK; ++ks) {
            uint32_t a[4];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              binarize(s[2 * ks + h], t_lo, t_hi, diag,
                       rk - (float)(16 * ks + 8 * h), a[2 * h], a[2 * h + 1]);
#pragma unroll
            for (int np = 0; np < DN / 2; ++np) {
              uint32_t bf[4];
              ldsm_x4_t(bf, va + (ks * 16 * pl.vs + np * 16) * 2);
              mma_bf16(o[0][2 * np], a, bf[0], bf[1]);
              mma_bf16(o[0][2 * np + 1], a, bf[2], bf[3]);
            }
          }
        } else {
          const int rg0 = r0 + g, rg1 = rg0 + 8;
          // this warp's tile of analog scores, 0 above the diagonal
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int kl = t * 8 + 2 * tig, kb = k0 + kl;
            float* p = sc + kl * SCS + g;
            p[0] = diag && kb > rg0 ? 0.f : __fmul_rn(s[t][0], scale);
            p[SCS] = diag && kb + 1 > rg0 ? 0.f : __fmul_rn(s[t][1], scale);
            p[8] = diag && kb > rg1 ? 0.f : __fmul_rn(s[t][2], scale);
            p[SCS + 8] = diag && kb + 1 > rg1 ? 0.f : __fmul_rn(s[t][3], scale);
          }
          __syncwarp();
          // keys past L hold v = 0; under causal none past the warp's last row
          const int kmax = min(min(KT, L - k0), causal ? r0 + 16 - k0 : KT);
          for (int kl = 0; kl < kmax; ++kl) {
            const float4* sp = reinterpret_cast<const float4*>(sc + kl * SCS);
            float sv[16];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 f = sp[j];
              sv[4 * j] = f.x;
              sv[4 * j + 1] = f.y;
              sv[4 * j + 2] = f.z;
              sv[4 * j + 3] = f.w;
            }
#pragma unroll
            for (int ci = 0; ci < DS / 32; ++ci) {
              const float vb =
                  __bfloat162float(vt[kl * pl.vs + ci * 32 + lane]);
#pragma unroll
              for (int r = 0; r < 16; ++r)
                acc[ci][r] = fmaf(vb, sv[r], acc[ci][r]);
            }
          }
          __syncwarp();
        }
      };
      const int nks = (min(L, causal ? r0 + 16 : L) - k0 + 15) / 16;
      if (nks >= 4)
        tile(std::integral_constant<int, 4>());
      else if (nks == 3)
        tile(std::integral_constant<int, 3>());
      else if (nks == 2)
        tile(std::integral_constant<int, 2>());
      else
        tile(std::integral_constant<int, 1>());
    }
  }

  if constexpr (NG > 1) {
    // the other groups hand their contexts to the first (exact integer
    // sums), through the ring, which no copy writes any more
    cp_async_wait<0>();
    __syncthreads();
    float* merge = reinterpret_cast<float*>(smem);
    const int me = wq * 32 + lane;
    for (int j = 1; j < NG; ++j) {
      if (grp == j) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nt = 0; nt < DN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              merge[((mi * DN + nt) * 4 + e) * NW * 32 + me] = o[mi][nt][e];
      }
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int nt = 0; nt < DN; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mi][nt][e] += merge[((mi * DN + nt) * 4 + e) * NW * 32 + me];
      }
      if (j + 1 < NG) __syncthreads();
    }
    if (grp != 0) return;
  }
  if (r0 >= L) return;
  T* oh = out + head;
  if constexpr (!ANALOG) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < DN; ++nt) {
        const int col = c0 + nt * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * mi + g + 8 * h;
          const float* c = o[mi][nt];
          if (row >= L || col >= d) continue;
          T* p = oh + (size_t)row * d + col;
          if (d % 2 == 0) {
            store_pair(p, c[2 * h], c[2 * h + 1]);
          } else {
            store(p, c[2 * h]);
            if (col + 1 < d) store(p + 1, c[2 * h + 1]);
          }
        }
      }
  } else {
#pragma unroll
    for (int ci = 0; ci < DS / 32; ++ci) {
      const int col = c0 + ci * 32 + lane;
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r0 + r < L) store(oh + (size_t)(r0 + r) * d + col, acc[ci][r]);
    }
  }
}

template <typename T, int DN, bool ANALOG, int NG, bool FAST, int MT>
int launch(const void* q, const void* k, const void* v, const float* delta,
           float scale, int causal, int bh, int l, int d, int vec, void* out,
           cudaStream_t stream) {
  auto kernel = spike_attention_kernel<T, DN, ANALOG, NG, FAST, MT>;
  constexpr int QT = 16 * NW * MT;
  const Plan pl(d, DN * 8, NG, QT);
  const size_t smem = pl.bytes(ANALOG, NG, DN, MT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long ns = (d + DN * 8 - 1) / (DN * 8), nqt = (l + QT - 1) / QT;
  const long long blocks = (long long)bh * ns * nqt;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NW * 32 * NG, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, delta, scale, causal, bh, l, d,
      vec, (T*)out);
  return (int)cudaGetLastError();
}

// a binarized causal walk past NG_LEN keys takes two warp groups where
// their ring fits
template <typename T, int DN, bool ANALOG, bool FAST>
int launch_g(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int bh, int l, int d, int vec, void* out,
             cudaStream_t stream) {
  if (!ANALOG && causal && l > NG_LEN &&
      Plan(d, DN * 8, 2, 16 * NW).bytes(false, 2, DN, 1) <= 227 * 1024)
    return launch<T, DN, false, 2, FAST, 1>(q, k, v, delta, scale, causal, bh,
                                            l, d, vec, out, stream);
  return launch<T, DN, ANALOG, 1, FAST, 1>(q, k, v, delta, scale, causal, bh,
                                           l, d, vec, out, stream);
}

// binarized, d <= 64, past one key tile (but for the causal walks that
// take two warp groups): two query tiles a warp
template <typename T, int DN, bool ANALOG, bool FAST>
int launch_m(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int bh, int l, int d, int vec, void* out,
             cudaStream_t stream) {
  if constexpr (!ANALOG && DN <= 8) {
    if (l > KT && !(causal && l > NG_LEN))
      return launch<T, DN, false, 1, FAST, 2>(q, k, v, delta, scale, causal,
                                              bh, l, d, vec, out, stream);
  }
  return launch_g<T, DN, ANALOG, FAST>(q, k, v, delta, scale, causal, bh, l,
                                       d, vec, out, stream);
}

// 16-byte pieces of a row straight from an operand: bf16 rows of a
// multiple of 8 elements, fp32 rows of 4, 16-byte aligned; the fast path
// when all three are aligned bf16 rows of exactly DN * 8 elements
template <typename T, int DN, bool ANALOG>
int launch_f(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int bh, int l, int d, void* out,
             cudaStream_t stream) {
  const int per = sizeof(T) == 2 ? 8 : 4;
  auto aligned = [&](const void* p) {
    return d % per == 0 && (uintptr_t)p % 16 == 0;
  };
  const int vec = (aligned(q) ? 1 : 0) | (aligned(k) ? 2 : 0) |
                  (aligned(v) ? 4 : 0);
  if constexpr (sizeof(T) == 2) {
    if (vec == 7 && d == DN * 8)
      return launch_m<T, DN, ANALOG, true>(q, k, v, delta, scale, causal, bh,
                                           l, d, vec, out, stream);
  }
  return launch_m<T, DN, ANALOG, false>(q, k, v, delta, scale, causal, bh, l,
                                        d, vec, out, stream);
}

template <typename T, bool ANALOG>
int launch_d(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int bh, int l, int d, void* out,
             cudaStream_t stream) {
  if (d <= 32)
    return launch_f<T, 4, ANALOG>(q, k, v, delta, scale, causal, bh, l, d,
                                  out, stream);
  if (d <= 64)
    return launch_f<T, 8, ANALOG>(q, k, v, delta, scale, causal, bh, l, d,
                                  out, stream);
  return launch_f<T, 16, ANALOG>(q, k, v, delta, scale, causal, bh, l, d, out,
                                 stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int binarize, int bh, int l, int d,
             void* out, cudaStream_t stream) {
  return binarize ? launch_d<T, false>(q, k, v, delta, scale, causal, bh, l,
                                       d, out, stream)
                  : launch_d<T, true>(q, k, v, delta, scale, causal, bh, l,
                                      d, out, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out); delta: one fp32 on the
// device. Returns a cudaError_t code (0 on success).
extern "C" int spike_attention_forward(int dtype, const void* q, const void* k,
                                       const void* v, const void* delta,
                                       float scale, int causal, int binarize,
                                       int bh, int l, int d, void* out,
                                       void* stream) {
  const float* dp = (const float*)delta;
  if (bh <= 0 || l <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_t<float>(q, k, v, dp, scale, causal, binarize, bh, l, d,
                           out, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, dp, scale, causal, binarize, bh,
                                   l, d, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spike_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
