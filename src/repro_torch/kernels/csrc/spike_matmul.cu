// The sparse engine's tile products for Hopper (sm_90a): the block-sparse
// spike matmul (#2) and its int8 twin (#3), on one pipelined tile skeleton.
//
// Replaces src/repro/kernels/spike_matmul.py::spike_matmul (#2: the Pallas
// bodies `_kernel` / `_kernel_bias`, grid (nM, nN, nK) with K innermost)
// and ::quant_spike_matmul (#3: `_qkernel` / `_qkernel_bias`).
//
// #2: y = s @ w (+ b) for s: (M, K) {0,1} spikes or integer counts and
// w: (K, N), both fp32 or both bf16, accumulated in fp32, the bias added
// after the last chunk, rounded once to the dtype (the TPU kernel's
// default out_dtype; the engine's cast of the fp32 result is fused into
// the store). On spikes or counts with dyadic-grid weights every partial
// sum is exact, so any order, the tensor cores' included, gives the plain
// version's result bitwise.
// #3: y = (lanes(s) @ qw) * scale (+ b) for s cast to its integer lanes
// (truncated toward zero; int8 for spikes, keeping the low byte; int32 for
// binary-attention counts) against int8 codes qw: (K, N), summed in int32
// (exact in any order), then acc * scale, or with a bias fma32(acc,
// scale, b) (the contraction jitted XLA makes), rounded once to fp32 or
// bf16. s is read in the dtype it comes in (fp32, bf16, or int8 / int32
// lanes): the lane cast happens here, in the staging.
//
// What bounds them: bytes. At a Spikingformer-4-256 layer's products (M =
// 16384; K, N of 256 or 1024) #2 moves 17-42 MB in bf16 (s and w read
// once, y written once) for 2.1-8.6 GFLOP, 125-260 operations a byte,
// below the bf16 tensor cores' ~295: 5-13 us at 3.35 TB/s. #3 reads s in
// fp32, as the engine passes it: 151 MB for its three products, 45 us.
//
// Design: one tile skeleton for both. A block of 8 warps owns a 128 x 256
// output tile (each warp 64 x 64) and walks K in 32-deep chunks, the skip
// tile's width. Blocks are numbered column tile first, so the column tiles
// of one row tile run side by side and their re-reads of s hit L2: s
// leaves device memory once a product. A chunk of s comes through a ring
// of SRING stages in shared memory by cp.async (16-byte copies, a warp's
// on whole sectors), issued S_AHEAD chunks ahead of the product. Once it
// has landed the block votes on it (each thread on the 16 values it
// copied), and only a live chunk's weights are copied, W_AHEAD chunks
// ahead, into a ring of their own: a dark chunk costs no weight copy and
// no product (`@pl.when(occ > 0)` in the JAX kernel). One barrier a chunk
// carries the vote. #2 in bf16 reads its fragments with ldmatrix (.trans
// for the (K, N) weights: no scalar transposes) and runs mma.sync
// m16n8k16 with fp32 accumulators; in fp32 it runs fmaf on the CUDA cores
// over the same fragments (no TF32). #3's vote also takes the chunk's
// largest lane magnitude and whether a lane is negative, which picks its
// byte planes (one unsigned plane for 0..255, else 1-4 with a signed top
// one); a live chunk's values are cast to their lanes and planes, and its
// codes turned K-major by byte permutes (int8_lanes.cuh, shared with #5),
// one chunk ahead of mma.sync m16n8k32. #3 on spike lanes with several
// column tiles (w1) takes a group of them in one block instead: the first
// casts s into lanes that stay resident in shared memory for the block's
// rows and records each chunk's vote; the others copy only the live
// chunks' codes, so s is read and cast once a block, not once a column
// tile. The epilogue stages half the tile at a time in shared memory and
// leaves in 16-byte stores. Ragged M, K and N are masked (zero-filled
// copies); an operand whose rows are not 16-byte aligned is copied
// element by element, in the same pipeline.
//
// Where they stand (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 6): the six bf16 products of a 4-256 training layer take ~159
// us of device time (q, k, v, wo ~15 each, w1 ~56, w2 ~43) against the
// earlier design's ~320 (one 128 x 64 tile a block, synchronous loads,
// scalar transposes), and #3's three products on fp32 s ~136 us against
// ~348 with the wrapper's cast (w1 ~60 with resident lanes, ~73 without).
// Variants measured: the copies alone of a K = 256 product take ~10.5 us
// and its products alone (no copies) ~10 us: a block's ring moves ~24 KB a
// chunk at ~3 TB/s over the card, and mma.sync runs near 70% of its own
// peak, about half the tensor cores' rate. Deeper rings (6 / 3 and 8 / 4
// chunks ahead), two 128 x 128 blocks an SM, and wgmma on unswizzled
// core-matrix layouts (both operands in shared memory, one chunk in
// flight) were no faster or slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_lanes.cuh"

namespace {

constexpr int NT = 256;      // 8 warps: 2 along M x 4 along N
constexpr int BM = 128;      // rows of an output tile (the skip tile's height)
constexpr int BN = 256;      // columns of an output tile
constexpr int WN = BN / 4;   // columns of a warp's 64-row share
constexpr int NJ = WN / 8;   // its n8 tiles
constexpr int BK = 32;       // a chunk of K (the skip tile's width)
constexpr int S_AHEAD = 4;   // chunks of s issued ahead of the product
constexpr int W_AHEAD = 2;   // chunks of weights issued ahead, after the vote
constexpr int SRING = S_AHEAD + 1;  // stages of the rings: a chunk's are
constexpr int WRING = W_AHEAD + 1;  // free once its products are done
constexpr int ASTR = BK + 16;      // bytes a row of #3's staged lane plane
constexpr int BSTR = BN + 8;       // words a row of #3's K-major codes
constexpr uint32_t FULL = 0xFFFFFFFFu;

// a chunk's vote: live, and for #3's count lanes the sign and magnitude
// classes that pick the byte planes
constexpr uint32_t LIVE = 1u, NEG = 2u, OVER7 = 4u, OVER8 = 8u, OVER15 = 16u,
                   OVER23 = 32u;

// the unsigned type of a value's bits
template <int B> struct Bits;
template <> struct Bits<1> { using T = uint8_t; };
template <> struct Bits<2> { using T = uint16_t; };
template <> struct Bits<4> { using T = uint32_t; };

// bytes a staged row of a chunk of s (its 16 bytes of padding put the
// eight rows of an ldmatrix in distinct banks), and a stage
template <typename S> __host__ __device__ constexpr int srow() {
  return BK * (int)sizeof(S) + 16;
}
template <typename S> __host__ __device__ constexpr int sstage() {
  return BM * srow<S>();
}
// bytes a staged row of a chunk of weights (or codes), and a stage
template <typename W> __host__ __device__ constexpr int wrow() {
  return BN * (int)sizeof(W) + 16;
}
template <typename W> __host__ __device__ constexpr int wstage() {
  return BK * wrow<W>();
}
// #3's staged operands: the lane planes of two chunks, the K-major codes
// of two chunks
template <int PMAX> __host__ __device__ constexpr int lanes_bytes() {
  return 2 * PMAX * BM * ASTR;
}
constexpr int codes_bytes() { return 2 * (BK / 4) * BSTR * 4; }
// a staged half tile of the output
template <typename TO> __host__ __device__ constexpr int ostr() {
  return BN + 16 / (int)sizeof(TO);
}

template <typename S, typename W, typename TO, int Q>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int rings = SRING * sstage<S>() + WRING * wstage<W>()
      + (Q ? lanes_bytes<Q == 2 ? 4 : 1>() + codes_bytes() : 0);
  constexpr int o = (BM / 2) * ostr<TO>() * (int)sizeof(TO);
  return rings > o ? rings : o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// src_bytes is 0
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

// an output pair, rounded once from fp32, into the staged tile
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The OR of every thread's f, one barrier: each warp's OR in wf (a buffer
// that alternates between chunks, so a fast warp's next write does not
// meet a slow warp's read).
__device__ __forceinline__ uint32_t block_or(uint32_t f, uint32_t* wf) {
  f = __reduce_or_sync(FULL, f);
  if (threadIdx.x % 32 == 0) wf[threadIdx.x / 32] = f;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) r |= wf[w];
  return r;
}

// A chunk of s is BM rows of s_ppr 16-byte pieces. Thread tid copies, and
// votes on, pieces tid + j NT (j < s_nps): consecutive threads take
// consecutive pieces of a row, so a warp's copies read whole sectors.
template <typename S> __host__ __device__ constexpr int s_ppr() {
  return BK * (int)sizeof(S) / 16;
}
template <typename S> __host__ __device__ constexpr int s_nps() {
  return BM * s_ppr<S>() / NT;
}
// where this thread's j-th piece of chunk c lies in the ring, and its row
// and first column in the chunk
template <typename S>
__device__ __forceinline__ int s_piece(int c, int j, int& row, int& col) {
  const int p = threadIdx.x + j * NT;
  row = p / s_ppr<S>();
  col = p % s_ppr<S>() * (16 / (int)sizeof(S));
  return c % SRING * sstage<S>() + row * srow<S>() + p % s_ppr<S>() * 16;
}

// Issue this thread's pieces of chunk c of s into its ring stage: 16-byte
// cp.async copies (vs), else element by element.
template <typename S>
__device__ __forceinline__ void issue_s(const S* __restrict__ s, uint8_t* ring,
                                        int c, int nk, int m0, int M, int K,
                                        bool vs) {
  using U = typename Bits<sizeof(S)>::T;
  constexpr int V = 16 / (int)sizeof(S);
  if (c >= nk) return;
#pragma unroll
  for (int j = 0; j < s_nps<S>(); ++j) {
    int r, kc;
    uint8_t* dst = ring + s_piece<S>(c, j, r, kc);
    const int gm = m0 + r, k = c * BK + kc;
    if (vs) {
      const bool in = gm < M && k < K;
      cp_async16(dst, in ? s + (size_t)gm * K + k : s, in ? 16 : 0);
    } else {
      const U* su = reinterpret_cast<const U*>(s) + (size_t)(gm < M ? gm : 0) * K;
#pragma unroll
      for (int q = 0; q < V; ++q)
        reinterpret_cast<U*>(dst)[q] = gm < M && k + q < K ? su[k + q] : U(0);
    }
  }
}

// Issue chunk c of the weights (or codes), rows c*BK.. and the tile's BN
// columns from n0, into its ring stage: 16-byte copies (vw), else element
// by element; past K or N, zeros.
template <typename W>
__device__ __forceinline__ void issue_w(const W* __restrict__ w, uint8_t* ring,
                                        int c, int n0, int K, int N, bool vw) {
  using U = typename Bits<sizeof(W)>::T;
  constexpr int V = 16 / (int)sizeof(W);
  constexpr int PR = BN / V;  // 16-byte pieces a row
  static_assert(BK * PR % NT == 0, "whole pieces a thread");
  uint8_t* stage = ring + c % WRING * wstage<W>();
#pragma unroll
  for (int j = 0; j < BK * PR / NT; ++j) {
    const int p = threadIdx.x + j * NT;
    const int kk = p / PR, nb = p % PR, gk = c * BK + kk, gn = n0 + nb * V;
    uint8_t* dst = stage + kk * wrow<W>() + nb * 16;
    if (vw) {
      const bool in = gk < K && gn < N;
      cp_async16(dst, in ? w + (size_t)gk * N + gn : w, in ? 16 : 0);
    } else {
      const U* wu = reinterpret_cast<const U*>(w);
      U* e = reinterpret_cast<U*>(dst);
#pragma unroll
      for (int q = 0; q < V; ++q)
        e[q] = gk < K && gn + q < N ? wu[(size_t)gk * N + gn + q] : U(0);
    }
  }
}

// the 16 values of chunk c of s in this thread's pieces, into registers
template <typename S>
__device__ __forceinline__ void own_values(const uint8_t* ring, int c,
                                           uint4 (&raw)[s_nps<S>()]) {
#pragma unroll
  for (int j = 0; j < s_nps<S>(); ++j) {
    int r, kc;
    raw[j] = *reinterpret_cast<const uint4*>(ring + s_piece<S>(c, j, r, kc));
  }
}

// the 16 staged values of row tid / 2, half tid % 2, of chunk c of s (any
// thread's copies: the chunk has landed and a barrier passed since)
template <typename S>
__device__ __forceinline__ void row_values(const uint8_t* ring, int c,
                                           uint4 (&raw)[sizeof(S)]) {
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  const uint4* p = reinterpret_cast<const uint4*>(
      ring + c % SRING * sstage<S>() + r * srow<S>()
      + h * 16 * (int)sizeof(S));
#pragma unroll
  for (int u = 0; u < (int)sizeof(S); ++u) raw[u] = p[u];
}

// This thread's vote on chunk c of s (landed): LIVE if a value is non-zero
// (#2: -0 is dark, as s != 0 is false for it) or, for #3, if a lane is;
// for count lanes also NEG and the magnitude classes.
template <typename S, int Q>
__device__ __forceinline__ uint32_t vote(const uint8_t* ring, int c, int nk) {
  if (c >= nk) return 0u;
  uint4 raw[s_nps<S>()];
  own_values<S>(ring, c, raw);
  if constexpr (Q == 0) {
    constexpr uint32_t MAG = sizeof(S) == 4 ? 0x7FFFFFFFu : 0x7FFF7FFFu;
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < s_nps<S>(); ++j)
      any |= raw[j].x | raw[j].y | raw[j].z | raw[j].w;
    return (any & MAG) != 0u ? LIVE : 0u;
  } else {
    const S* v = reinterpret_cast<const S*>(raw);
    uint32_t f = 0;
    int mag = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int x = lane_of<Q == 2>(v[q]);
      f |= x != 0 ? LIVE : 0u;
      if constexpr (Q == 2) {
        f |= x < 0 ? NEG : 0u;
        mag = max(mag, x ^ (x >> 31));  // x, or -x - 1 below zero
      }
    }
    if constexpr (Q == 2)
      f |= (mag > 0x7F ? OVER7 : 0u) | (mag > 0xFF ? OVER8 : 0u)
          | (mag > 0x7FFF ? OVER15 : 0u) | (mag > 0x7FFFFF ? OVER23 : 0u);
    return f;
  }
}

// the byte planes of a chunk's count lanes, from its vote
__device__ __forceinline__ void chunk_planes(uint32_t f, int& P, bool& U1) {
  const int mag = f & OVER23 ? 0x800000 : f & OVER15 ? 0x8000
      : f & OVER8 ? 0x100 : f & OVER7 ? 0x80 : 0;
  planes_of(mag, (f & NEG) != 0u, P, U1);
}

// #2, bf16: chunk c's products of the warp's 64 x 64 tile on the tensor
// cores, two k16 steps, fragments by ldmatrix
__device__ __forceinline__ void chunk_bf16(float (&acc)[4][NJ][4],
                                           const uint8_t* sring,
                                           const uint8_t* wring, int c,
                                           int wm, int wn, int lane) {
  constexpr int SR = srow<__nv_bfloat16>(), WR = wrow<__nv_bfloat16>();
  const uint32_t sb = smem_u32(sring + c % SRING * sstage<__nv_bfloat16>());
  const uint32_t wb = smem_u32(wring + c % WRING * wstage<__nv_bfloat16>());
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[NJ][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(a[i], sb + (64 * wm + 16 * i + lane % 16) * SR
                        + (kk + lane / 16 * 8) * 2);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t r[4];
      ldsm_x4_t(r, wb + (kk + lane % 16) * WR
                       + (WN * wn + 16 * jp + lane / 16 * 8) * 2);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// #2, fp32: chunk c's products on the CUDA cores, in the mma fragment
// layout (thread (g, t): rows g and g + 8, columns 2t and 2t + 1 of each
// 16 x 8 tile)
__device__ __forceinline__ void chunk_f32(float (&acc)[4][NJ][4],
                                          const uint8_t* sring,
                                          const uint8_t* wring, int c,
                                          int wm, int wn, int lane) {
  constexpr int SR = srow<float>() / 4, WR = wrow<float>() / 4;
  const float* sa =
      reinterpret_cast<const float*>(sring + c % SRING * sstage<float>());
  const float* sw =
      reinterpret_cast<const float*>(wring + c % WRING * wstage<float>());
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float av[4][2];
    float2 bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[i][h] = sa[(64 * wm + 16 * i + g + 8 * h) * SR + kk];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bv[j] = *reinterpret_cast<const float2*>(
          sw + kk * WR + WN * wn + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j][0] = fmaf(av[i][0], bv[j].x, acc[i][j][0]);
        acc[i][j][1] = fmaf(av[i][0], bv[j].y, acc[i][j][1]);
        acc[i][j][2] = fmaf(av[i][1], bv[j].x, acc[i][j][2]);
        acc[i][j][3] = fmaf(av[i][1], bv[j].y, acc[i][j][3]);
      }
  }
}

// Where #3's lanes of a chunk lie: the lane ring holds two chunks, each
// BM rows of ASTR bytes a plane; resident lanes (a block that loops over
// column tiles) hold every chunk of the block's rows, rows of `ks` bytes
// (32 lanes a chunk, 16 bytes of padding), a plane after the other.
struct Lanes {
  uint8_t* base;
  int ks;         // resident: bytes a row; 0: the two-chunk ring
  int pmax;
  __device__ __forceinline__ uint8_t* chunk(int c) const {
    return base + (ks ? c * BK : (c & 1) * pmax * BM * ASTR);
  }
  __device__ __forceinline__ int row() const { return ks ? ks : ASTR; }
  __device__ __forceinline__ int plane() const { return BM * row(); }
};

// #3: chunk c of s cast to its lanes and split into P byte planes (this
// thread's 16 values of row tid / 2), one chunk ahead of its products
template <typename S, bool COUNTS>
__device__ __forceinline__ void cast_chunk(const uint8_t* sring,
                                           const Lanes& lanes, int c, int P) {
  constexpr int PMAX = COUNTS ? 4 : 1;
  uint4 raw[sizeof(S)];
  row_values<S>(sring, c, raw);
  uint32_t pw[PMAX][4];
  lanes16<COUNTS>(reinterpret_cast<const S*>(raw), pw);
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  uint8_t* lb = lanes.chunk(c) + r * lanes.row() + 16 * h;
#pragma unroll
  for (int pl = 0; pl < PMAX; ++pl)
    if (pl < P)
      *reinterpret_cast<uint4*>(lb + pl * lanes.plane()) =
          make_uint4(pw[pl][0], pw[pl][1], pw[pl][2], pw[pl][3]);
}

// #3: chunk c's codes turned K-major (into code buffer c & 1), one chunk
// ahead of its products
__device__ __forceinline__ void codes_chunk(const uint8_t* wring,
                                            uint32_t* codes, int c) {
  const uint8_t* raw_codes = wring + c % WRING * wstage<int8_t>();
  uint32_t* cb = codes + (c & 1) * (BK / 4) * BSTR;
#pragma unroll
  for (int j = 0; j < (BK / 4) * (BN / 4) / NT; ++j) {
    const int b = threadIdx.x + j * NT;
    const int q = b / (BN / 4), c4 = 4 * (b % (BN / 4));
    uint32_t rows[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rows[e] = *reinterpret_cast<const uint32_t*>(
          raw_codes + (4 * q + e) * wrow<int8_t>() + c4);
    *reinterpret_cast<uint4*>(cb + q * BSTR + c4) = k_major4(rows);
  }
}

// #3: the products of staged chunk c on the tensor cores: one m16n8k32
// k-step of the warp's 64 x 64 tile in P byte planes
template <int P, bool U1>
__device__ __forceinline__ void chunk_s8(int (&acc)[4][NJ][4],
                                         const Lanes& lanes,
                                         const uint32_t* codes, int c, int wm,
                                         int wn, int lane) {
  const int g = lane / 4, t = lane % 4;
  const uint32_t* cb = codes + (c & 1) * (BK / 4) * BSTR + WN * wn + g;
  uint32_t b[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    b[j][0] = cb[t * BSTR + 8 * j];
    b[j][1] = cb[(4 + t) * BSTR + 8 * j];
  }
  const uint32_t lb = smem_u32(lanes.chunk(c));
  const int row = lanes.row(), plane = lanes.plane();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t a[P][4];
#pragma unroll
    for (int pl = 0; pl < P; ++pl)
      ldsm_x4(a[pl], lb + pl * plane + (64 * wm + 16 * i + lane % 16) * row
                         + lane / 16 * 16);
#pragma unroll
    for (int j = 0; j < NJ; ++j) plane_mma<P, U1>(acc[i][j], a, b[j][0], b[j][1]);
  }
}

// The tile product. Q: 0 = #2 (S = W = TO, fp32 accumulators), 1 = #3 on
// spike lanes, 2 = #3 on count lanes (int32 accumulators). Block
// blockIdx.x owns row tile blockIdx.x / ngroup and the column tiles
// [g tpb, (g + 1) tpb) of group g = blockIdx.x % ngroup, one after the
// other. Iteration i (a = W_AHEAD) waits for chunk i + a of s and chunk i
// of the weights, votes on chunk i + a, issues chunk i + S_AHEAD of s and,
// if the vote found chunk i + a live, its weights; #2 then multiplies
// chunk i, #3 stages chunk i and multiplies chunk i - 1. RES (#3 on spike
// lanes, tpb > 1): the first column tile casts s into resident lanes and
// records the chunks' votes; the others copy only the live chunks' codes
// and multiply the resident lanes, so s is read and cast once a block.
template <typename S, typename W, typename TO, int Q, bool RES>
__global__ void __launch_bounds__(NT, 1)
tile_product(const S* __restrict__ s, const W* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             TO* __restrict__ out, int M, int K, int N, int ntile, int tpb,
             int res_bytes, bool vs, bool vw, bool vo) {
  constexpr bool QUANT = Q > 0, COUNTS = Q == 2;
  constexpr int PMAX = COUNTS ? 4 : 1, LAG = QUANT ? 1 : 0;
  static_assert(!RES || Q == 1, "resident lanes: spike lanes only");
  using Acc = std::conditional_t<QUANT, int, float>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint32_t wflags[2][NT / 32];
  uint8_t* sring = smem + (RES ? res_bytes : 0);  // then the rings, which
  uint8_t* wring = sring + SRING * sstage<S>();  // the epilogue reuses
  uint8_t* ring_lanes = wring + WRING * wstage<W>();
  uint32_t* codes =
      reinterpret_cast<uint32_t*>(ring_lanes + lanes_bytes<PMAX>());
  const int nk = (K + BK - 1) / BK;
  const Lanes lanes{RES ? smem : ring_lanes, RES ? nk * BK + 16 : 0, PMAX};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int ngroup = (ntile + tpb - 1) / tpb;
  const int m0 = blockIdx.x / ngroup * BM, t0 = blockIdx.x % ngroup * tpb;
  const int t1 = RES ? min(ntile, t0 + tpb) : t0 + 1;
  static_assert(S_AHEAD == 2 * W_AHEAD, "s lands as its weights do");
  uint32_t live = 0;  // RES: the first tile's votes, bit c of chunk c
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * BN;
    const bool first = !RES || tile == t0;
    const bool warp_cols = n0 + WN * wn < N;  // the warp holds a column
    Acc acc[4][NJ][4] = {};
    if (first) {
#pragma unroll
      for (int c = 0; c < S_AHEAD - W_AHEAD; ++c) {
        issue_s(s, sring, c, nk, m0, M, K, vs);
        cp_async_commit();
      }
    }
    // the votes of chunk i - 1 and of chunks i .. i + W_AHEAD - 1 (fs[0]: i)
    uint32_t f_prev = 0, fs[W_AHEAD] = {};
    for (int i = -W_AHEAD; i < nk + LAG; ++i) {
      // this thread's copies of s i + W_AHEAD and w i are in
      cp_async_wait<W_AHEAD - 1>();
      const int ca = i + W_AHEAD;
      uint32_t f;
      if (first) {
        f = block_or(vote<S, Q>(sring, ca, nk), wflags[i & 1]);
        issue_s(s, sring, i + S_AHEAD, nk, m0, M, K, vs);
      } else {
        __syncthreads();  // the last chunk's stages have been read
        f = ca < nk && (live >> ca & 1u) ? LIVE : 0u;
      }
      if (f & LIVE) issue_w(w, wring, ca, n0, K, N, vw);
      cp_async_commit();
      const uint32_t f_cur = fs[0];
      if constexpr (QUANT) {
        int P = 1;
        bool U1 = false;
        if constexpr (COUNTS) chunk_planes(f_cur, P, U1);
        if (f_cur & LIVE) {
          if (first) cast_chunk<S, COUNTS>(sring, lanes, i, P);
          codes_chunk(wring, codes, i);
          if (RES) live |= 1u << i;
        }
        if (i >= 1 && (f_prev & LIVE) && warp_cols) {
          const int c = i - 1;
          if constexpr (COUNTS) {
            chunk_planes(f_prev, P, U1);
            if (U1) chunk_s8<1, true>(acc, lanes, codes, c, wm, wn, lane);
            else if (P == 1) chunk_s8<1, false>(acc, lanes, codes, c, wm, wn, lane);
            else if (P == 2) chunk_s8<2, false>(acc, lanes, codes, c, wm, wn, lane);
            else if (P == 3) chunk_s8<3, false>(acc, lanes, codes, c, wm, wn, lane);
            else chunk_s8<4, false>(acc, lanes, codes, c, wm, wn, lane);
          } else {
            chunk_s8<1, false>(acc, lanes, codes, c, wm, wn, lane);
          }
        }
      } else if (i >= 0 && (f_cur & LIVE) && warp_cols) {
        if constexpr (std::is_same<S, float>::value)
          chunk_f32(acc, sring, wring, i, wm, wn, lane);
        else
          chunk_bf16(acc, sring, wring, i, wm, wn, lane);
      }
      f_prev = f_cur;
#pragma unroll
      for (int a = 0; a + 1 < W_AHEAD; ++a) fs[a] = fs[a + 1];
      fs[W_AHEAD - 1] = f;
    }

    // epilogue: #2 the bias after the last chunk, #3 the scale (and
    // bias); one rounding to the output dtype; staged half the rows at a
    // time, then 16-byte stores where N and the output allow
    cp_async_wait<0>();
    const int g = lane / 4, t = lane % 4;
    constexpr int OS = ostr<TO>(), OV = 16 / (int)sizeof(TO);
    TO* so = reinterpret_cast<TO*>(sring);
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // the products' (or the last half's) shared reads
      if (wm == half) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int cl = WN * wn + 8 * j + 2 * t, col = n0 + cl;
          float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < N) {
              if constexpr (QUANT) sc[e] = scale[col + e];
              if (bias != nullptr) bi[e] = bias[col + e];
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const Acc a = acc[i][j][2 * h + e];
                if constexpr (QUANT)
                  v[e] = dequant(a, sc[e], bi[e], bias != nullptr);
                else
                  v[e] = bias != nullptr ? __fadd_rn(a, bi[e]) : a;
              }
              store_pair(so + (16 * i + g + 8 * h) * OS + cl, v[0], v[1]);
            }
        }
      }
      __syncthreads();
      for (int p = tid; p < (BM / 2) * (BN / OV); p += NT) {
        const int rl = p / (BN / OV), c = p % (BN / OV) * OV;
        const int row = m0 + BM / 2 * half + rl, col = n0 + c;
        if (row >= M || col >= N) continue;
        TO* o = out + (size_t)row * N + col;
        const TO* src = so + rl * OS + c;
        if (vo && col + OV <= N) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int q = 0; q < OV && col + q < N; ++q) o[q] = src[q];
        }
      }
    }
    if (RES) __syncthreads();  // the staged tile is read: the next tile's
  }                            // copies may land
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

constexpr int SMEM_MAX = 227 * 1024;  // a block's dynamic shared memory

template <typename S, typename W, typename TO, int Q, bool RES>
int launch_tiles(const void* s, const void* w, const float* scale,
                 const float* bias, void* out, int m, int k, int n, int ntile,
                 int tpb, int res_bytes, cudaStream_t stream) {
  const int smem = res_bytes + smem_bytes<S, W, TO, Q>();
  const auto kernel = tile_product<S, W, TO, Q, RES>;
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long blocks =
      (long long)((m + BM - 1) / BM) * ((ntile + tpb - 1) / tpb);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const bool vs = k % (16 / (int)sizeof(S)) == 0 && (uintptr_t)s % 16 == 0;
  const bool vw = n % (16 / (int)sizeof(W)) == 0 && (uintptr_t)w % 16 == 0;
  const bool vo = n % (16 / (int)sizeof(TO)) == 0 && (uintptr_t)out % 16 == 0;
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(
      (const S*)s, (const W*)w, scale, bias, (TO*)out, m, k, n, ntile, tpb,
      res_bytes, vs, vw, vo);
  return (int)cudaGetLastError();
}

// One block a (row tile, column tile): the column tiles of a row tile run
// side by side and re-read s from L2. #3 on spike lanes with several
// column tiles takes them a group at a time in one block over resident
// lanes, where those fit in shared memory (and their votes in a word):
// the fewest groups that keep the waves of blocks times the tiles a block
// as low as one tile a block would.
template <typename S, typename W, typename TO, int Q>
int launch(const void* s, const void* w, const float* scale,
           const float* bias, void* out, int m, int k, int n,
           cudaStream_t stream) {
  const int ntile = (n + BN - 1) / BN, mtile = (m + BM - 1) / BM;
  const int nk = (k + BK - 1) / BK;
  if constexpr (Q == 1) {
    const int res_bytes = (BM * (nk * BK + 16) + 127) / 128 * 128;
    if (ntile > 1 && nk <= 32
        && res_bytes + smem_bytes<S, W, TO, Q>() <= SMEM_MAX) {
      const long long sms = multiprocessors();
      auto cost = [&](int groups) {
        return (mtile * (long long)groups + sms - 1) / sms
            * ((ntile + groups - 1) / groups);
      };
      int groups = 1;
      for (int g = 2; g <= ntile; ++g)
        if (cost(g) < cost(groups)) groups = g;
      const int tpb = (ntile + groups - 1) / groups;
      if (tpb > 1)
        return launch_tiles<S, W, TO, Q, true>(s, w, scale, bias, out, m, k,
                                               n, ntile, tpb, res_bytes,
                                               stream);
    }
  }
  return launch_tiles<S, W, TO, Q, false>(s, w, scale, bias, out, m, k, n,
                                          ntile, 1, 0, stream);
}

template <typename S, int Q>
int launch_quant(int out_dtype, const void* s, const void* w,
                 const float* scale, const float* bias, void* out, int m,
                 int k, int n, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<S, int8_t, float, Q>(s, w, scale, bias, out, m, k, n, st);
  if (out_dtype == 1)
    return launch<S, int8_t, __nv_bfloat16, Q>(s, w, scale, bias, out, m, k,
                                               n, st);
  return (int)cudaErrorInvalidValue;
}

// #2's analog mode: a left operand that is no spike and no count (the
// analog context of a binarize_scores=False layer, the wo product) makes
// sums that are exact in no order, so they take one order, the plain
// version's (spike_matmul.py: fused_ssa.seq_matmul): every output is an
// fp32 chain over ascending k, one __fmul_rn product and one __fadd_rn sum
// a term (a bf16 x bf16 product is exact in fp32), the bias added after
// the last term, rounded once to the dtype. On CUDA cores, as launch B's
// wo on an analog context (fused_layer.cu, mlp_gemm's chain path). A block
// of 256 threads owns a 64 x 64 output tile (each thread 4 x 4, strided by
// 16 so a warp's loads from the staged chunks are conflict-free) and walks
// K in 32-deep chunks staged as fp32 in shared memory; a chunk of s whose
// 64 rows are all zero (0.0 or -0.0) costs no weight copy and no product,
// which changes no sum: its terms are zeros, and a chain that starts at
// +0.0 never holds -0.0.
constexpr int AT = 64;   // rows and columns of an analog output tile
constexpr int AK = 32;   // a chunk of K
constexpr int ANT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(ANT)
    analog_product(const T* __restrict__ s, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, int m,
                   int k, int n) {
  __shared__ float ss[AK][AT + 1];   // the chunk of s, k-major
  __shared__ float ws[AK][AT];       // the chunk of w
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * AT, n0 = blockIdx.y * AT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += AK) {
    int any = 0;
    for (int e = threadIdx.x; e < AT * AK; e += ANT) {
      const int r = e / AK, c = e % AK, gm = m0 + r, gk = k0 + c;
      const float v = gm < m && gk < k ? to_f32(s[(size_t)gm * k + gk]) : 0.f;
      ss[c][r] = v;
      any |= v != 0.f;
    }
    if (__syncthreads_or(any)) {   // the block's vote: a live chunk
      for (int e = threadIdx.x; e < AK * AT; e += ANT) {
        const int c = e / AT, col = e % AT, gk = k0 + c, gn = n0 + col;
        ws[c][col] = gk < k && gn < n ? to_f32(w[(size_t)gk * n + gn]) : 0.f;
      }
      __syncthreads();
      const int kc = min(AK, k - k0);
      for (int c = 0; c < kc; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ss[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
      }
    }
    __syncthreads();   // the chunk is consumed before the next is staged
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      const float y = bias ? __fadd_rn(acc[i][j], bias[col]) : acc[i][j];
      from_f32(out + (size_t)row * n + col, y);
    }
  }
}

template <typename T>
int launch_analog(const void* s, const void* w, const float* bias, void* out,
                  int m, int k, int n, cudaStream_t stream) {
  const long long mt = (m + AT - 1) / AT, nt = (n + AT - 1) / AT;
  if (mt > 0x7FFFFFFFLL || nt > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)mt, (unsigned)nt);
  analog_product<T><<<grid, ANT, 0, stream>>>((const T*)s, (const T*)w, bias,
                                              (T*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (s, w and out); bias: fp32 (n,) or null;
// out: (m, n). Returns a cudaError_t code (0 on success).
extern "C" int spike_matmul_forward(int dtype, const void* s, const void* w,
                                    const void* bias, void* out, int m, int k,
                                    int n, void* stream) {
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, float, float, 0>(s, w, nullptr, b, out, m, k, n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, 0>(
        s, w, nullptr, b, out, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}

// #2's analog mode (launch_analog): dtype, s, w, bias, out as
// spike_matmul_forward.
extern "C" int spike_matmul_analog_forward(int dtype, const void* s,
                                           const void* w, const void* bias,
                                           void* out, int m, int k, int n,
                                           void* stream) {
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_analog<float>(s, w, b, out, m, k, n, st);
  if (dtype == 1)
    return launch_analog<__nv_bfloat16>(s, w, b, out, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spike_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// s_code: the type s is read in, 0 float32 or 1 bfloat16 (values, cast to
// their lanes in the kernel), 2 int8 spike lanes, 3 int32 count lanes;
// counts: 1 = s holds counts (int32 lanes), 0 = spikes (int8 lanes);
// out_dtype: 0 float32, 1 bfloat16; w: (k, n) int8 codes; scale: fp32
// (n,); bias: fp32 (n,) or null; out: (m, n). Returns a cudaError_t code
// (0 on success).
extern "C" int quant_spike_matmul_forward(int s_code, int counts,
                                          int out_dtype, const void* s,
                                          const void* w, const void* scale,
                                          const void* bias, void* out, int m,
                                          int k, int n, void* stream) {
  const float* sc = (const float*)scale;
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (s_code == 0)
    return counts ? launch_quant<float, 2>(out_dtype, s, w, sc, b, out, m, k, n, st)
                  : launch_quant<float, 1>(out_dtype, s, w, sc, b, out, m, k, n, st);
  if (s_code == 1)
    return counts
        ? launch_quant<__nv_bfloat16, 2>(out_dtype, s, w, sc, b, out, m, k, n, st)
        : launch_quant<__nv_bfloat16, 1>(out_dtype, s, w, sc, b, out, m, k, n, st);
  if (s_code == 2 && !counts)
    return launch_quant<int8_t, 1>(out_dtype, s, w, sc, b, out, m, k, n, st);
  if (s_code == 3 && counts)
    return launch_quant<int32_t, 2>(out_dtype, s, w, sc, b, out, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}
