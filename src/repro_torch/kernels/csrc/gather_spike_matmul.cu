// The sparse engine's decoded datapath for Hopper (sm_90a): the
// gather-compacted spike matmul (#4) and its int8 twin (#5), which share
// one staging on the device.
//
// Replaces src/repro/kernels/spike_decode.py::gather_spike_matmul (#4: the
// Pallas bodies `_kernel` / `_kernel_bias`, grid (groups, N tiles,
// compacted chunks)) and ::quant_gather_spike_matmul (#5: `_qkernel` /
// `_qkernel_bias` and the staging `_stage`).
//
// The staging: two kernels and a memset, nothing read back. The row pass
// (stage_row_pass) reads s once in its own dtype, one warp a row, and
// writes the row's occupancy, its live bits (bit k % 32 of word k / 32)
// and one word of facts about the row, and counts the row into its
// 1024-row chunk's histogram; the sort (stage_counting_sort) gives each
// row its place in a stable counting sort by occupancy (keys 0..K), which
// is torch.sort(stable=True)'s permutation, so the order and the sorted
// occupancies equal stage_rows' (the JAX schedule's sort, the paper's load
// balancing) bitwise. The two products test for a live entry differently,
// and this is the only thing their staging does not share: #4 tests the
// raw value (s != 0: -0.0 is dark, 0.3 or -0.7 live), as decode_indices
// does; #5 tests the value cast to its integer lane (truncated toward
// zero, so a value in (-1, 1) is dark). The fact word is, for #4, whether
// every live value of the row is exactly 1 (a spike row); for #5's count
// lanes, the row's value range.
//
// #4: y = s @ w (+ b) for s: (M, K) spikes, integer counts or analog values
// and w: (K, N), both fp32 or both bf16. Its contract is its plain
// version's (spike_decode.gather_spike_matmul_plain): each row's result is
// the fp32 sum, in ascending k, of value x w[k, :] over the row's live
// entries, one rounded product and one rounded add an entry, then the
// bias, rounded once to the dtype and written at the row's own index;
// bitwise on any finite weights. The tensor cores sum fp32 in an order of
// their own, so the product runs on the CUDA cores: one __fadd_rn (and a
// __fmul_rn, for a value other than 1) a live entry and output column.
//
// What bounds #4: bytes, against the card's peaks. s, w and y once each
// are 5-13 us a training product at 3.35 TB/s; the live multiply-adds
// (density ~0.2) are far less at the bf16 tensor-core peak. Its contract
// sets a higher floor: ~2.5 G live adds for the six products of a 4-256
// training layer (M = 16384) need ~85 us at the fp32 pipe's 128 adds a
// clock an SM, and feeding them bf16 weights (one integer op each to
// widen, 64 a clock an SM; shared memory gives 64 bf16 values a clock)
// ~170 us.
//
// Design of #4's product (gather_walk). A block of 8 warps takes 64
// consecutive rows of the sorted order, the densest blocks first, and a
// tile of 256 output columns; a lane owns 8 consecutive columns and a warp
// walks 8 rows. The block ORs its live rows' bit words once (the union)
// and streams only the union's non-zero words, ascending, one 32-deep K
// chunk each, through a cp.async ring in shared memory: the chunk's live
// rows of the w tile in the operands' dtype (widened in registers), the
// rows' bit words from the staging and, unless every live row of the
// block is a spike row, the rows' 32 values. A warp lists each of its
// rows' live k of the chunk in order (lane k writes k at its rank among
// the row's live bits) and walks the lists, two entries of a row loaded
// ahead of their adds; each live entry is one 16-byte shared load of the
// lane's 8 weights (bf16; two in fp32) and 8 adds into the row's fp32
// accumulators, in ascending k. A block of spike rows adds w as it is
// (exactly the plain version's 1 x w); any other block multiplies every
// entry by its value, which for a value of 1 is the same. No spike slab is
// staged and no row is decoded twice: the bits come from the staging, and
// each column tile reads them again from L2. Walking only the live entries
// executes exactly the JAX schedule's compacted chunks below each group's
// pow2 capacity (a chunk at or past it holds no live entry), and the sort
// keeps a block's rows, and so its warps' walks, about equally long: the
// load balancing of the paper's decoder. A block whose rows are all dark
// streams nothing and writes the bias (or zeros).
//
// Where #4 stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, bf16, the
// six products of a 4-256 training layer, density ~0.2): 78 us of staging
// on the device (row passes 40, sorts 32, memsets 6) and 463 us of product
// kernels, 0.64 ms whole by CUDA events, against 1.58 for the earlier
// design (stage_rows' PyTorch passes and a kernel that re-decoded a spike
// slab in every column tile); 3.1x the contract's bf16-feed floor and
// 5.5x torch.matmul, which sums in an order of its own. The walk is bound
// by its instruction stream, ~22 instructions a live entry and warp (one
// shared load, 8 widenings, 8 adds, the list), at about half the issue
// rate; shared memory runs at ~30% of its bandwidth and the weights' L2
// traffic overlaps. Measured variants that dropped the widenings, the
// list reads, the shared loads or 6 of the 8 adds each saved 7-20%; more
// warps, more rows a block, a deeper ring, grouped loads and TMA bulk
// copies of the weights saved nothing (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_lanes.cuh"

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; the bytes
// past src_bytes (0 or all) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// the staging of both products: occupancy, live bits, the row's facts, and
// a stable counting sort by occupancy
// ---------------------------------------------------------------------------

// what the row pass tests a value of s for: #5's spike or count lane, or
// #4's raw value
enum class Live { SPIKE_LANE, COUNT_LANE, VALUE };

constexpr int SNT = 256;     // threads a staging block
constexpr int SROWS = 16;    // rows a staging block, 2 a warp
constexpr int CHUNK = 1024;  // rows a sort block, one a thread

// One warp a row: the row once, read in s's own dtype. Writes the row's
// occupancy (0 for the padding rows m..mp-1), its live bits and its fact
// word: for VALUE, 1 if every live value is exactly 1, else 0; for
// COUNT_LANE, the code of its value range (max(hi, -lo - 1), the sign bit
// set if a lane is negative). Counts the row into its sort chunk's
// histogram. VEC: 16-byte loads.
template <typename S, Live LIVE, bool VEC>
__global__ void __launch_bounds__(SNT)
stage_row_pass(const S* __restrict__ s, int M, int K, int Mp, int W,
               int* __restrict__ occ, uint32_t* __restrict__ bits,
               int* __restrict__ facts, int* __restrict__ hist) {
  constexpr int V = VEC ? 16 / (int)sizeof(S) : 1;  // values a load
  constexpr int G = 32 / V;                         // loads a bit word
  constexpr int RW = SROWS / (SNT / 32);            // rows a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int p = blockIdx.x * SROWS + warp * RW + i;
    if (p >= Mp) return;
    int n = 0, lo = 0, hi = 0;
    bool ones = true;
    if (p < M) {
      const S* row = s + (size_t)p * K;
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 32 * V) {
        const int k = k0 + lane * V;
        uint32_t live = 0;  // this lane's V live bits
        if (k < K) {
          alignas(16) S v[V];
          if constexpr (VEC)
            *reinterpret_cast<uint4*>(v) =
                *reinterpret_cast<const uint4*>(row + k);
          else
            v[0] = row[k];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if constexpr (LIVE == Live::VALUE) {
              const float x = to_float(v[e]);
              live |= (uint32_t)(x != 0.f) << e;
              ones &= x == 0.f || x == 1.f;
            } else {
              const int x = lane_of<LIVE == Live::COUNT_LANE>(v[e]);
              live |= (uint32_t)(x != 0) << e;
              lo = min(lo, x);
              hi = max(hi, x);
            }
          }
        }
        n += __popc(live);
        // the G lanes of one bit word OR their bits together
        uint32_t word = live << (V * (lane % G));
#pragma unroll
        for (int o = 1; o < G; o <<= 1)
          word |= __shfl_xor_sync(FULL, word, o);
        const int wi = k0 / 32 + lane / G;
        if (lane % G == 0 && wi < W) bits[(size_t)p * W + wi] = word;
      }
      n = __reduce_add_sync(FULL, n);
      if constexpr (LIVE == Live::VALUE) {
        ones = __all_sync(FULL, ones);
      } else {
        lo = __reduce_min_sync(FULL, lo);
        hi = __reduce_max_sync(FULL, hi);
      }
    }
    if (lane == 0) {
      occ[p] = n;
      if (LIVE == Live::VALUE && p < M) facts[p] = ones ? 1 : 0;
      if (LIVE == Live::COUNT_LANE && p < M)
        facts[p] = max(hi, ~lo) | (lo < 0 ? (int)0x80000000u : 0);
      atomicAdd(&hist[(size_t)(p / CHUNK) * (K + 1) + n], 1);
    }
  }
}

// One block a chunk of CHUNK rows, one thread a row: the row's place in a
// stable counting sort by occupancy (keys 0..K) is the number of rows of
// smaller occupancy, plus the rows of its occupancy in earlier chunks
// (both from the chunks' histograms), plus those earlier in its own chunk:
// the earlier lanes of its warp (__match_any_sync) and the earlier warps'
// (one warp walks the warps in order, a group of equal occupancies a
// lane). Writes order[place] = row and sorted_occ[place] = its occupancy.
__global__ void __launch_bounds__(CHUNK)
stage_counting_sort(const int* __restrict__ occ, const int* __restrict__ hist,
                    int K, int Mp, long long* __restrict__ order,
                    int* __restrict__ sorted_occ) {
  extern __shared__ int next_place[];  // [K + 1]
  __shared__ int wsum[CHUNK / 32];
  __shared__ int lead_key[CHUNK], group[CHUNK];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, nch = gridDim.x;
  int carry = 0;
  for (int k0 = 0; k0 <= K; k0 += CHUNK) {
    const int k = k0 + tid;
    int tot = 0, before = 0;
    if (k <= K)
#pragma unroll 8
      for (int cc = 0; cc < nch; ++cc) {
        const int h = hist[(size_t)cc * (K + 1) + k];
        tot += h;
        before += cc < c ? h : 0;
      }
    int x = tot;  // inclusive scan of tot over the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = wsum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(FULL, y, o);
        if (lane >= o) y += z;
      }
      wsum[lane] = y;
    }
    __syncthreads();
    if (k <= K)
      next_place[k] = carry + (warp ? wsum[warp - 1] : 0) + x - tot + before;
    carry += wsum[CHUNK / 32 - 1];
    __syncthreads();
  }
  // each warp's groups of one occupancy: the group's first lane (its
  // leader) holds the key and the count, the others their rank
  const int p = c * CHUNK + tid;
  const int key = p < Mp ? occ[p] : -1;
  const uint32_t same = __match_any_sync(FULL, key);
  const int first = __ffs(same) - 1;
  lead_key[tid] = lane == first ? key : -1;
  group[tid] = __popc(same);
  __syncthreads();
  if (warp == 0) {  // the warps in order: each group's first place
    for (int w = 0; w < CHUNK / 32; ++w) {
      const int i = 32 * w + lane, k = lead_key[i];
      if (k >= 0) {
        const int at = next_place[k];
        next_place[k] = at + group[i];
        group[i] = at;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (key >= 0) {
    const int place =
        group[32 * warp + first] + __popc(same & ((1u << lane) - 1u));
    order[place] = p;
    sorted_occ[place] = key;
  }
}

// ---------------------------------------------------------------------------
// gather_spike_matmul (#4): the walk of the staged live bits
// ---------------------------------------------------------------------------

constexpr int GNT = 256;            // threads a product block: 8 warps
constexpr int GR = 8;               // sorted rows a warp walks
constexpr int GRB = GR * GNT / 32;  // sorted rows a block: 64
constexpr int GCPL = 8;             // output columns a lane, consecutive
constexpr int GNB = 32 * GCPL;      // output columns a block: 256
constexpr int GKC = 32;             // k a chunk: one live-bit word

// a ring stage: the chunk's rows of the w tile [GKC][GNB], the block's
// rows' values [GRB][GKC] (in the operands' dtype), their bit words [GRB]
template <typename T> struct Ring {
  static constexpr int V = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int DEPTH = sizeof(T) == 2 ? 3 : 2;  // stages
  static constexpr int WB = GKC * GNB * (int)sizeof(T);
  static constexpr int VB = GRB * GKC * (int)sizeof(T);
  static constexpr int STAGE = WB + VB + GRB * 4;
  // after the ring: each warp's list of its rows' live k [GR][GKC]
  static constexpr int LIST = GRB * GKC * 4;
};

// the lane's 8 weights of a staged w row, as loaded (one 16-byte load of
// bf16, two of fp32), widened to fp32: exactly, a bf16 value being the top
// half of its fp32 value
struct Float8 {
  float4 lo, hi;
};
__device__ __forceinline__ void widen(const Float8& v, float (&o)[GCPL]) {
  o[0] = v.lo.x, o[1] = v.lo.y, o[2] = v.lo.z, o[3] = v.lo.w;
  o[4] = v.hi.x, o[5] = v.hi.y, o[6] = v.hi.z, o[7] = v.hi.w;
}
__device__ __forceinline__ void widen(const uint4& v, float (&o)[GCPL]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] * 65536u);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[GCPL]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[GCPL]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// One chunk of a warp's rows: each row's live entries in ascending k, one
// weight row from shared memory and GCPL rounded adds (ONES: w as it is;
// else value x w, rounded, then the add) an entry. The warp first lists
// each row's live k in order in shared memory (lane k writes k at its
// rank among the live bits), so the walk is a counted loop whose list
// reads do not wait on one another; two entries of a row are loaded
// before the first is added, and the adds keep the order.
template <bool ONES, typename T>
__device__ __forceinline__ void walk_chunk(float (&acc)[GR][GCPL],
                                           const T* sw, const T* sv,
                                           const uint32_t* sb, int* list,
                                           int lane) {
  using Raw = typename std::conditional<sizeof(T) == 2, uint4, Float8>::type;
  const uint32_t below = (1u << lane) - 1u;
  int count[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const uint32_t b = sb[r];
    if (b >> lane & 1u) list[r * GKC + __popc(b & below)] = lane;
    count[r] = __popc(b);
  }
  __syncwarp();
  auto add = [&](int r, int j, const Raw& raw) {
    float wv[GCPL];
    widen(raw, wv);
    if constexpr (ONES) {
#pragma unroll
      for (int c = 0; c < GCPL; ++c) acc[r][c] = __fadd_rn(acc[r][c], wv[c]);
    } else {
      const float a = to_float(sv[r * GKC + j]);
#pragma unroll
      for (int c = 0; c < GCPL; ++c)
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(a, wv[c]));
    }
  };
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int* lr = list + r * GKC;
    int e = 0;
    for (; e + 1 < count[r]; e += 2) {
      const int j0 = lr[e], j1 = lr[e + 1];
      const Raw raw0 = *reinterpret_cast<const Raw*>(sw + j0 * GNB);
      const Raw raw1 = *reinterpret_cast<const Raw*>(sw + j1 * GNB);
      add(r, j0, raw0);
      add(r, j1, raw1);
    }
    if (e < count[r]) {
      const int j0 = lr[e];
      add(r, j0, *reinterpret_cast<const Raw*>(sw + j0 * GNB));
    }
  }
  __syncwarp();  // the list is read before the next chunk rewrites it
}

// The product: see the header. vw / vs / vo: 16-byte copies of w / s and
// stores of y (N / K a multiple of 16 bytes' elements, the base aligned).
template <typename T>
__global__ void __launch_bounds__(GNT, 2)
gather_walk(const T* __restrict__ s, const T* __restrict__ w,
            const float* __restrict__ bias, const long long* __restrict__ order,
            const int* __restrict__ sorted_occ,
            const uint32_t* __restrict__ bits, const int* __restrict__ ones,
            T* __restrict__ out, int M, int K, int N, int Mp, int W, bool vw,
            bool vs, bool vo) {
  using R = Ring<T>;
  constexpr int DEPTH = R::DEPTH, V = R::V;
  extern __shared__ __align__(16) uint8_t dyn[];
  uint32_t* uni =
      reinterpret_cast<uint32_t*>(dyn + DEPTH * R::STAGE + R::LIST);  // [W]
  int* live_words = reinterpret_cast<int*>(uni + W);                  // [W]
  __shared__ int row_of[GRB];
  __shared__ bool row_live[GRB];
  __shared__ int nsteps_sh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* list = reinterpret_cast<int*>(dyn + DEPTH * R::STAGE) + GR * GKC * warp;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * GRB;  // densest rows first
  const int n0 = blockIdx.y * GNB;
  bool spike_row = true;
  if (tid < GRB) {
    const int p = p0 + tid;
    int r = -1;
    bool live = false;
    if (p < Mp) {
      r = (int)order[p];
      live = sorted_occ[p] > 0;
    }
    if (r >= M) r = -1, live = false;  // padding rows
    row_of[tid] = r;
    row_live[tid] = live;
    spike_row = !live || ones[r] != 0;
  }
  for (int i = tid; i < W; i += GNT) uni[i] = 0u;
  const bool all_ones = __syncthreads_and(spike_row);

  // decode: the union of the live rows' bit words, and its non-zero words
  const bool same_word = W > 0 && GNT % W == 0;  // a thread's word is fixed
  uint32_t u = 0;
  for (int i = tid; i < GRB * W; i += GNT) {
    const int r = i / W, wi = i % W;
    const uint32_t b = row_live[r] ? bits[(size_t)row_of[r] * W + wi] : 0u;
    if (same_word) {
      u |= b;
    } else if (b) {
      atomicOr(&uni[wi], b);
    }
  }
  if (same_word && u) atomicOr(&uni[tid % W], u);
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < W; base += 32) {
      const bool l = base + lane < W && uni[base + lane] != 0u;
      const uint32_t m = __ballot_sync(FULL, l);
      if (l) live_words[n + __popc(m & ((1u << lane) - 1u))] = base + lane;
      n += __popc(m);
    }
    if (lane == 0) nsteps_sh = n;
  }
  __syncthreads();
  const int nsteps = nsteps_sh;

  // the chunk of live word `step` into ring stage `step % DEPTH`
  auto issue = [&](int step) {
    if (step < nsteps) {
      const int wi = live_words[step], k0 = 32 * wi;
      const uint32_t word = uni[wi];
      uint8_t* st = dyn + step % DEPTH * R::STAGE;
      T* sw = reinterpret_cast<T*>(st);
      for (int i = tid; i < GKC * (GNB / V); i += GNT) {
        const int kk = i / (GNB / V), c = i % (GNB / V) * V;
        if (!(word >> kk & 1u)) continue;  // no row of the block reads it
        const T* src = w + (size_t)(k0 + kk) * N + n0 + c;
        if (vw) {
          cp_async16(sw + kk * GNB + c, n0 + c < N ? src : w,
                     n0 + c < N ? 16 : 0);
        } else {
          for (int q = 0; q < V; ++q)
            sw[kk * GNB + c + q] = n0 + c + q < N ? src[q] : T(0.f);
        }
      }
      if (!all_ones) {  // the rows' values in the chunk
        T* sv = reinterpret_cast<T*>(st + R::WB);
        for (int i = tid; i < GRB * (GKC / V); i += GNT) {
          const int r = i / (GKC / V), c = i % (GKC / V) * V;
          const bool in = row_live[r] && k0 + c < K;
          const T* src = s + (size_t)(in ? row_of[r] : 0) * K + k0 + c;
          if (vs) {
            cp_async16(sv + r * GKC + c, in ? src : s, in ? 16 : 0);
          } else {
            for (int q = 0; q < V; ++q)
              sv[r * GKC + c + q] = in && k0 + c + q < K ? src[q] : T(0.f);
          }
        }
      }
      if (tid < GRB) {  // the rows' bit words
        const bool live = row_live[tid];
        cp_async4(reinterpret_cast<uint32_t*>(st + R::WB + R::VB) + tid,
                  live ? bits + (size_t)row_of[tid] * W + wi : bits,
                  live ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[GR][GCPL] = {};
#pragma unroll
  for (int step = 0; step < DEPTH - 1; ++step) issue(step);
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<DEPTH - 2>();  // this thread's part of chunk `step` is in
    __syncthreads();  // everyone's is, and chunk step - 1 is walked
    issue(step + DEPTH - 1);
    const uint8_t* st = dyn + step % DEPTH * R::STAGE;
    const T* sw = reinterpret_cast<const T*>(st) + GCPL * lane;
    const T* sv = reinterpret_cast<const T*>(st + R::WB) + GR * GKC * warp;
    const uint32_t* sb =
        reinterpret_cast<const uint32_t*>(st + R::WB + R::VB) + GR * warp;
    if (all_ones)
      walk_chunk<true>(acc, sw, sv, sb, list, lane);
    else
      walk_chunk<false>(acc, sw, sv, sb, list, lane);
  }

  // the bias after the last entry, one rounding, the row's own index
  const int col = n0 + GCPL * lane;
  if (col >= N) return;
  float b[GCPL];
#pragma unroll
  for (int c = 0; c < GCPL; ++c)
    b[c] = bias != nullptr && col + c < N ? bias[col + c] : 0.f;
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int row = row_of[GR * warp + r];
    if (row < 0) continue;
    float v[GCPL];
#pragma unroll
    for (int c = 0; c < GCPL; ++c)
      v[c] = bias != nullptr ? __fadd_rn(acc[r][c], b[c]) : acc[r][c];
    T* o = out + (size_t)row * N + col;
    if (vo && col + GCPL <= N) {
      store8(o, v);
    } else {
#pragma unroll
      for (int c = 0; c < GCPL; ++c)
        if (col + c < N) store_one(o + c, v[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// quant_gather_spike_matmul (#5): the decoded int8 product on the tensor
// cores
// ---------------------------------------------------------------------------

// #5: y = (lanes(s) @ qw) * scale (+ b) for spikes on int8 lanes or
// binary-attention counts on int32 lanes (spike_decode.py:429) against
// int8 weight codes. Its sums are int32, exact in any order, so any
// contraction order, the tensor cores' included, agrees bitwise with the
// plain version, with quant_spike_matmul and with the dense quantized
// reference on any weights and scales; the epilogue (acc * scale, or
// fma32(acc, scale, b) with a bias) and the one rounding to the output
// dtype are quant_spike_matmul's.
//
// What bounds it: bytes. The lanes, codes, scale and output once each are
// ~88 MB for the three products of a mixed 4-256 layer (M = 16384), 26 us
// at 3.35 TB/s; their dense multiply-adds take ~10 us at the int8 tensor
// core peak, and the live ones a fifth of that.
//
// Design. A block of 512 threads takes 128 consecutive sorted rows,
// decodes the union of their live lanes once (the OR of their bit words
// from the staging: the multi-lane decoder of the paper's Eq. 5 at the
// block's grain) and walks its non-zero words in ascending k, one 32-lane
// chunk an mma k-step: the rows' values there (cast to their lanes and
// split into byte planes) and only the code rows of the union's live lanes
// are staged in shared memory, and mma.sync m16n8k32 (s8 x s8 for spike
// lanes, u8 x s8 for count lanes below 256; larger or negative counts in
// byte planes, a signed top plane and unsigned lower ones, as many as the
// block's largest magnitude needs) sums them in int32 registers, 256
// output columns a pass. The sort groups sparse rows with sparse rows, so
// a block's union is narrow where its rows are; where it is near dense the
// block runs the dense chunk on the tensor cores. The block loops over the
// output columns itself (split over blocks only as far as one block a
// multiprocessor needs), so w1's 1024 columns do not re-decode the rows
// per column tile.
//
// Where it stands (chip_smoke.py, H100 SXM at 700 W, the three products of
// a mixed 4-256 layer): ~40 us (bf16 s) to ~64 us (fp32 s) of staging and
// ~111-132 us of product kernels on the device, 4-6x the bytes bound. The
// k-steps are bound by the instructions a step issues (the casts, the byte
// transposes, two barriers) and by memory latency; their dense mma alone
// would take ~10 us at the int8 peak.

constexpr int QNT = 512;          // threads a product block: 16 warps
constexpr int QBM = 128;          // sorted rows a block: warps 2 x 8
constexpr int QBN = 256;          // output columns a tile, 32 a warp
constexpr int KSTEP = 32;         // lanes a chunk, one mma k-step
constexpr int SEG = 2048;         // lanes decoded at once (64 bit words)
constexpr int ASTR = KSTEP + 16;  // bytes a staged lane row (the rows of a
                                  // fragment load in distinct banks)
constexpr int BSTR = QBN + 8;     // words a staged code row, [k / 4][n]

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One k-step of a warp's 64 x 32 tile (4 x 4 m16n8k32 products, each a
// plane_mma of the lanes' P byte planes). live_mt: the m-tiles holding a
// live row.
template <int P, bool U1>
__device__ __forceinline__ void warp_step(int (&acc)[4][4][4],
                                          const uint8_t* sA,
                                          const uint32_t* sB, int wm, int wn,
                                          int lane, unsigned live_mt) {
  const int g = lane / 4, t = lane % 4;
  uint32_t b[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = sB[t * BSTR + 32 * wn + 8 * j + g];
    b[j][1] = sB[(4 + t) * BSTR + 32 * wn + 8 * j + g];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!(live_mt >> i & 1u)) continue;
    const int r = 64 * wm + 16 * i + g;
    uint32_t a[P][4];
#pragma unroll
    for (int pl = 0; pl < P; ++pl) {
      const uint8_t* A = sA + pl * QBM * ASTR;
      a[pl][0] = ld32(A + r * ASTR + 4 * t);
      a[pl][1] = ld32(A + (r + 8) * ASTR + 4 * t);
      a[pl][2] = ld32(A + r * ASTR + 16 + 4 * t);
      a[pl][3] = ld32(A + (r + 8) * ASTR + 16 + 4 * t);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      plane_mma<P, U1>(acc[i][j], a, b[j][0], b[j][1]);
  }
}

constexpr int RING = 3;         // chunks in flight a block
constexpr int BROW = QBN + 16;  // bytes a raw code row of the ring

// bytes of a staged raw chunk row (32 values of s, 16 bytes apart rows)
template <typename S> __host__ __device__ constexpr int ring_row() {
  return KSTEP * (int)sizeof(S) + 16;
}

// the product's dynamic shared memory: the ring of raw chunks (the rows'
// values, then the code rows), then the staged lane planes and codes,
// which the output staging reuses
template <typename S, bool COUNTS, typename TO>
__host__ __device__ constexpr int product_smem() {
  constexpr int ring = RING * (QBM * ring_row<S>() + KSTEP * BROW);
  constexpr int ab = (COUNTS ? 4 : 1) * QBM * ASTR + (KSTEP / 4) * BSTR * 4;
  constexpr int o = (QBM / 2) * (QBN + 16 / (int)sizeof(TO)) * (int)sizeof(TO);
  return ring + (ab > o ? ab : o);
}

// four int8 codes of a code row from column n (zero past N)
__device__ __forceinline__ uint32_t codes4(const int8_t* wrow, int n, int N,
                                           bool vw) {
  if (vw) return n < N ? *reinterpret_cast<const uint32_t*>(wrow + n) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) v |= (uint32_t)(uint8_t)wrow[n + c] << (8 * c);
  return v;
}

// The decoded product. A block takes QBM consecutive rows of the sorted
// order and the output tiles [y tpb, (y + 1) tpb) of QBN columns. Decode,
// once a block (a segment of SEG lanes at a time where K is larger): the
// union of its live rows' bit words (from the staging); its non-zero words
// are the 32-lane chunks the block runs, in ascending k. A chunk is one
// mma k-step: the rows' values there, read 16 lanes a thread, cast to
// their lanes and split into byte planes, and only the code rows of the
// union's live lanes (each at its own place in the step; a dark lane's row
// is zero), byte-interleaved four k deep (the B fragment's layout), are
// staged in shared memory; then mma.sync into int32 registers. The raw
// chunks (values and code rows) come through a ring of RING in shared
// memory by cp.async (16-byte loads, where K, N and the pointers allow),
// each of the first 256 threads casting the 16 values it fetched. A chunk
// dark in every row fetches nothing and runs no mma, an m-tile of dark
// rows runs no mma, and a block of dark rows runs the epilogue alone. The epilogue goes through shared memory,
// half the rows at a time, so each output row leaves in 16-byte stores.
template <typename S, bool COUNTS, typename TO, bool VS>
__global__ void __launch_bounds__(QNT, 1)
quant_gather_mma(const S* __restrict__ s, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const long long* __restrict__ order,
                 const int* __restrict__ sorted_occ,
                 const uint32_t* __restrict__ bits,
                 const int* __restrict__ rng, TO* __restrict__ out, int M,
                 int K, int N, int Mp, int W, int tpb, bool vw, bool vb,
                 bool vo) {
  constexpr int PMAX = COUNTS ? 4 : 1;
  constexpr int RROW = ring_row<S>(), RSTAGE = QBM * RROW;
  constexpr int BSTAGE = KSTEP * BROW;
  constexpr int OSTR = QBN + 16 / (int)sizeof(TO);  // staged output row
  extern __shared__ __align__(16) uint8_t dyn[];
  uint8_t* bring = dyn + RING * RSTAGE;  // [RING][KSTEP][BROW]
  uint8_t* sA = bring + RING * BSTAGE;   // [P][QBM][ASTR], after the rings
  uint32_t* sB = reinterpret_cast<uint32_t*>(sA + PMAX * QBM * ASTR);
  TO* so = reinterpret_cast<TO*>(sA);  // [QBM / 2][OSTR], after the k-steps
  __shared__ uint32_t uni[SEG / 32];
  __shared__ int live_words[SEG / 32];
  __shared__ int row_of[QBM];
  __shared__ bool row_live[QBM];
  __shared__ int mt_live[QBM / 16];
  __shared__ int mag_sh, neg_sh, nwords_sh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 8, wn = warp % 8;
  if (tid == 0) mag_sh = 0, neg_sh = 0;
  if (tid < QBM / 16) mt_live[tid] = 0;
  __syncthreads();
  if (tid < QBM) {
    const int p = blockIdx.x * QBM + tid;
    int r = -1;
    bool live = false;
    if (p < Mp) {
      r = (int)order[p];
      live = sorted_occ[p] > 0;
    }
    if (r >= M) r = -1, live = false;  // padding rows
    row_of[tid] = r;
    row_live[tid] = live;
    if (live) {
      atomicOr(&mt_live[tid / 16], 1);
      if constexpr (COUNTS) {
        const int code = rng[r];
        atomicMax(&mag_sh, code & 0x7FFFFFFF);
        if (code < 0) atomicOr(&neg_sh, 1);
      }
    }
  }
  __syncthreads();
  // the byte planes the block's largest lane magnitude needs
  int P = 1;
  bool U1 = false;
  if constexpr (COUNTS) planes_of(mag_sh, neg_sh != 0, P, U1);
  unsigned live_mt = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) live_mt |= (mt_live[4 * wm + i] ? 1u : 0u) << i;

  // the first 2 QBM threads stage 16 lanes (half a chunk) of one row each
  const bool astage = tid < 2 * QBM;
  const int ar = astage ? tid / 2 : 0, ah = 16 * (tid % 2);
  constexpr int V = 16 / (int)sizeof(S);  // values a 16-byte load
  const bool arow = row_live[ar];
  const S* srow = s + (size_t)(arow ? row_of[ar] : 0) * K;
  uint8_t* mine = dyn + ar * RROW + ah * (int)sizeof(S);  // in a stage

  const int nseg = (K + SEG - 1) / SEG, ntile = (N + QBN - 1) / QBN;
  const int t0 = blockIdx.y * tpb, t1 = min(ntile, t0 + tpb);
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * QBN;
    int acc[4][4][4] = {};
    for (int seg = 0; seg < nseg; ++seg) {
      const int wseg = min(SEG / 32, W - seg * (SEG / 32));
      if (nseg > 1 || tile == t0) {
        // decode: the union of the live rows' bit words of the segment
        __syncthreads();
        if (tid < SEG / 32) uni[tid] = 0u;
        __syncthreads();
        uint32_t v = 0;
        for (int i = tid; i < QBM * wseg; i += QNT) {
          const int r = i / wseg, wi = i % wseg;
          const uint32_t b =
              row_live[r] ? bits[(size_t)row_of[r] * W + seg * (SEG / 32) + wi]
                          : 0u;
          if (QNT % wseg == 0) {
            v |= b;                 // this thread's word stays the same
          } else if (b) {
            atomicOr(&uni[wi], b);
          }
        }
        if (QNT % wseg == 0 && v) atomicOr(&uni[tid % wseg], v);
        __syncthreads();
        if (warp == 0) {  // the non-zero words, ascending
          const bool l0 = uni[2 * lane] != 0u, l1 = uni[2 * lane + 1] != 0u;
          const int c = l0 + l1;
          int x = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
          }
          int pos = x - c;
          if (l0) live_words[pos++] = 2 * lane;
          if (l1) live_words[pos] = 2 * lane + 1;
          if (lane == 31) nwords_sh = x;
        }
        __syncthreads();
      }
      const int nsteps = nwords_sh;
      // the raw chunk of live word `step` into ring stage `step % RING`:
      // the rows' values, and the code rows of the union's live lanes
      auto issue = [&](int step) {
        if (step < nsteps) {
          const int wi = live_words[step];
          const int k = seg * SEG + 32 * wi + ah;
          uint8_t* dst = mine + step % RING * RSTAGE;
#pragma unroll
          for (int u = 0; u < 16 / V; ++u) {
            const int ku = k + u * V;
            if (!astage) break;
            if (VS) {
              cp_async16(dst + 16 * u, arow && ku < K ? srow + ku : s,
                         arow && ku < K ? 16 : 0);
            } else {
              S* e = reinterpret_cast<S*>(dst + 16 * u);
#pragma unroll
              for (int q = 0; q < V; ++q)
                e[q] = arow && ku + q < K ? srow[ku + q] : S(0.f);
            }
          }
          const uint32_t word = uni[wi];
          const int k0 = seg * SEG + 32 * wi;
          uint8_t* bdst = bring + step % RING * BSTAGE;
          if (vb) {  // 16 columns of one code row a thread
            const int kk = tid / (QBN / 16), c16 = 16 * (tid % (QBN / 16));
            const bool in = (word >> kk & 1u) && n0 + c16 < N;
            cp_async16(bdst + kk * BROW + c16,
                       in ? w + (size_t)(k0 + kk) * N + n0 + c16 : w,
                       in ? 16 : 0);
          } else {   // four columns of four code rows a thread
            const int q = tid / (QBN / 4), c4 = 4 * (tid % (QBN / 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kk = 4 * q + e;
              *reinterpret_cast<uint32_t*>(bdst + kk * BROW + c4) =
                  word >> kk & 1u ? codes4(w + (size_t)(k0 + kk) * N,
                                           n0 + c4, N, vw)
                                  : 0u;
            }
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int step = 0; step < RING - 1; ++step) issue(step);
      for (int step = 0; step < nsteps; ++step) {
        issue(step + RING - 1);
        cp_async_wait<RING - 1>();  // this thread's chunk `step` is in
        __syncthreads();  // every thread's is, the last fragments are read
        if (astage) {  // the 16 lanes, cast and split into byte planes
          uint4 raw[16 / V];
#pragma unroll
          for (int u = 0; u < 16 / V; ++u)
            raw[u] = reinterpret_cast<const uint4*>(mine + step % RING * RSTAGE)[u];
          uint32_t pw[PMAX][4];
          lanes16<COUNTS>(reinterpret_cast<const S*>(raw), pw);
#pragma unroll
          for (int pl = 0; pl < PMAX; ++pl)
            if (pl < P)
              *reinterpret_cast<uint4*>(sA + pl * QBM * ASTR + ar * ASTR + ah) =
                  make_uint4(pw[pl][0], pw[pl][1], pw[pl][2], pw[pl][3]);
        }
        {  // four code rows x four columns, transposed 4 x 4 bytes: word c
           // holds byte c of the four rows
          const int q = tid / (QBN / 4), c4 = 4 * (tid % (QBN / 4));
          const uint8_t* braw = bring + step % RING * BSTAGE + c4;
          uint32_t bw[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bw[e] = *reinterpret_cast<const uint32_t*>(braw + (4 * q + e) * BROW);
          *reinterpret_cast<uint4*>(sB + q * BSTR + c4) = k_major4(bw);
        }
        __syncthreads();
        if constexpr (COUNTS) {
          if (U1) warp_step<1, true>(acc, sA, sB, wm, wn, lane, live_mt);
          else if (P == 1) warp_step<1, false>(acc, sA, sB, wm, wn, lane, live_mt);
          else if (P == 2) warp_step<2, false>(acc, sA, sB, wm, wn, lane, live_mt);
          else if (P == 3) warp_step<3, false>(acc, sA, sB, wm, wn, lane, live_mt);
          else warp_step<4, false>(acc, sA, sB, wm, wn, lane, live_mt);
        } else {
          warp_step<1, false>(acc, sA, sB, wm, wn, lane, live_mt);
        }
      }
    }

    // epilogue: the int32 sum rounded to fp32, the scale (and bias), one
    // rounding to the output dtype; staged half the rows at a time, then
    // stored at each row's own index
    const int g = lane / 4, t = lane % 4;
    constexpr int OV = 16 / (int)sizeof(TO);  // outputs a 16-byte store
    for (int half = 0; half < 2; ++half) {
      __syncthreads();  // the k-steps' (or the last half's) shared reads
      if (wm == half) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 32 * wn + 8 * j + 2 * t + e, col = n0 + c;
            const float sc = col < N ? scale[col] : 0.f;
            const float bi = bias != nullptr && col < N ? bias[col] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                store_one(so + (16 * i + g + 8 * h) * OSTR + c,
                          dequant(acc[i][j][2 * h + e], sc, bi,
                                  bias != nullptr));
          }
      }
      __syncthreads();
      for (int i = tid; i < (QBM / 2) * (QBN / OV); i += QNT) {
        const int rl = i / (QBN / OV), c = i % (QBN / OV) * OV;
        const int row = row_of[QBM / 2 * half + rl];
        if (row < 0 || n0 + c >= N) continue;
        TO* o = out + (size_t)row * N + n0 + c;
        const TO* src = so + rl * OSTR + c;
        if (vo && n0 + c + OV <= N) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int q = 0; q < OV && n0 + c + q < N; ++q) o[q] = src[q];
        }
      }
    }
  }
}

// the staging's workspace (spike_decode._workspace): order (mp int64) |
// sorted_occ (mp int32) | occ (mp) | bits (m x ceil(k / 32)) | facts (m) |
// hist (ceil(mp / CHUNK) x (k + 1)), int32 after the order
struct Layout {
  size_t sorted_occ, occ, bits, facts, hist, total;
  Layout(int m, int k, int mp) {
    const size_t w = (k + 31) / 32, nch = (mp + CHUNK - 1) / CHUNK;
    sorted_occ = (size_t)mp * 8;
    occ = sorted_occ + (size_t)mp * 4;
    bits = occ + (size_t)mp * 4;
    facts = bits + (size_t)m * w * 4;
    hist = facts + (size_t)m * 4;
    total = hist + nch * (k + 1) * 4;
  }
};

struct QArgs {
  const void *s, *w;
  const float *scale, *bias;
  uint8_t* ws;
  void* out;
  int m, k, n, mp;
};

template <typename S, Live LIVE>
int stage(const QArgs& a, cudaStream_t st) {
  const Layout l(a.m, a.k, a.mp);
  int* hist = reinterpret_cast<int*>(a.ws + l.hist);
  const int nch = (a.mp + CHUNK - 1) / CHUNK, w = (a.k + 31) / 32;
  cudaError_t e = cudaMemsetAsync(hist, 0, l.total - l.hist, st);
  if (e != cudaSuccess) return (int)e;
  constexpr int V = 16 / (int)sizeof(S);
  const dim3 grid((a.mp + SROWS - 1) / SROWS);
  int* occ = reinterpret_cast<int*>(a.ws + l.occ);
  uint32_t* bits = reinterpret_cast<uint32_t*>(a.ws + l.bits);
  int* facts = reinterpret_cast<int*>(a.ws + l.facts);
  if (a.k % V == 0 && (uintptr_t)a.s % 16 == 0)
    stage_row_pass<S, LIVE, true><<<grid, SNT, 0, st>>>(
        (const S*)a.s, a.m, a.k, a.mp, w, occ, bits, facts, hist);
  else
    stage_row_pass<S, LIVE, false><<<grid, SNT, 0, st>>>(
        (const S*)a.s, a.m, a.k, a.mp, w, occ, bits, facts, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(a.k + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(stage_counting_sort,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stage_counting_sort<<<nch, CHUNK, smem, st>>>(
      occ, hist, a.k, a.mp, reinterpret_cast<long long*>(a.ws),
      reinterpret_cast<int*>(a.ws + l.sorted_occ));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const QArgs& a, cudaStream_t st) {
  using R = Ring<T>;
  const Layout l(a.m, a.k, a.mp);
  const int W = (a.k + 31) / 32;
  const dim3 grid((a.mp + GRB - 1) / GRB, (a.n + GNB - 1) / GNB);
  const int smem = R::DEPTH * R::STAGE + R::LIST + 8 * W;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_walk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const bool vw = a.n % R::V == 0 && (uintptr_t)a.w % 16 == 0;
  const bool vs = a.k % R::V == 0 && (uintptr_t)a.s % 16 == 0;
  const bool vo = a.n % R::V == 0 && (uintptr_t)a.out % 16 == 0;
  gather_walk<T><<<grid, GNT, smem, st>>>(
      (const T*)a.s, (const T*)a.w, a.bias,
      reinterpret_cast<const long long*>(a.ws),
      reinterpret_cast<const int*>(a.ws + l.sorted_occ),
      reinterpret_cast<const uint32_t*>(a.ws + l.bits),
      reinterpret_cast<const int*>(a.ws + l.facts), (T*)a.out, a.m, a.k,
      a.n, a.mp, W, vw, vs, vo);
  return (int)cudaGetLastError();
}

// what: 0 the staging alone, 1 the product alone on a staged workspace,
// 2 both
template <typename T>
int run_gather(int what, const QArgs& a, cudaStream_t st) {
  if (what != 1) {
    const int rc = stage<T, Live::VALUE>(a, st);
    if (rc != 0 || what == 0) return rc;
  }
  return launch_gather<T>(a, st);
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

template <typename S, bool COUNTS, typename TO>
int launch_quant(const QArgs& a, cudaStream_t st) {
  const Layout l(a.m, a.k, a.mp);
  const int gx = (a.mp + QBM - 1) / QBM, ntile = (a.n + QBN - 1) / QBN;
  // column tiles split over blocks only as far as a block a
  // multiprocessor needs: each block decodes its rows once
  int gy = min(ntile, max(1, multiprocessors() / gx));
  const int tpb = (ntile + gy - 1) / gy;
  gy = (ntile + tpb - 1) / tpb;
  const bool vw = a.n % 4 == 0 && (uintptr_t)a.w % 4 == 0;
  const bool vb = a.n % 16 == 0 && (uintptr_t)a.w % 16 == 0;
  const bool vo = a.n % (16 / (int)sizeof(TO)) == 0 && (uintptr_t)a.out % 16 == 0;
  const bool vs = a.k % (16 / (int)sizeof(S)) == 0 && (uintptr_t)a.s % 16 == 0;
  const long long* order = reinterpret_cast<const long long*>(a.ws);
  const int* sorted_occ = reinterpret_cast<const int*>(a.ws + l.sorted_occ);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(a.ws + l.bits);
  const int* rng = reinterpret_cast<const int*>(a.ws + l.facts);
  const dim3 grid(gx, gy);
  constexpr int smem = product_smem<S, COUNTS, TO>();
  const auto kernel = vs ? quant_gather_mma<S, COUNTS, TO, true>
                         : quant_gather_mma<S, COUNTS, TO, false>;
  static bool smem_set[2] = {false, false};
  if (!smem_set[vs]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[vs] = true;
  }
  kernel<<<grid, QNT, smem, st>>>(
      (const S*)a.s, (const int8_t*)a.w, a.scale, a.bias, order, sorted_occ,
      bits, rng, (TO*)a.out, a.m, a.k, a.n, a.mp, (a.k + 31) / 32, tpb, vw,
      vb, vo);
  return (int)cudaGetLastError();
}

// what: 0 the staging alone, 1 the product alone on a staged workspace,
// 2 both
template <typename S, bool COUNTS>
int run_quant(int what, int out_dtype, const QArgs& a, cudaStream_t st) {
  if (what != 1) {
    const int rc =
        stage<S, COUNTS ? Live::COUNT_LANE : Live::SPIKE_LANE>(a, st);
    if (rc != 0 || what == 0) return rc;
  }
  if (out_dtype == 0) return launch_quant<S, COUNTS, float>(a, st);
  if (out_dtype == 1) return launch_quant<S, COUNTS, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// what: 0 stage s into ws, 1 run the product on a staged ws, 2 both.
// dtype: 0 float32, 1 bfloat16 (s, w and out); bias: fp32 (n,) or null;
// ws: the workspace Layout lays out, which the staging fills, beginning
// with the order (mp,) int64 and the sorted occupancies (mp,) int32 of the
// stable sort of the rows (and the padding rows m..mp-1, all dark) by
// occupancy, a value live where it is not zero; out: (m, n). Returns a
// cudaError_t code (0 on success).
extern "C" int gather_spike_matmul_forward(int what, int dtype, const void* s,
                                           const void* w, const void* bias,
                                           void* ws, void* out, int m, int k,
                                           int n, int mp, void* stream) {
  const QArgs a{s, w, nullptr, (const float*)bias, (uint8_t*)ws, out,
                m, k, n, mp};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return run_gather<float>(what, a, st);
  if (dtype == 1) return run_gather<__nv_bfloat16>(what, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gather_spike_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// what: 0 stage s into ws, 1 run the product on a staged ws, 2 both.
// s_code: the type s is read in, 0 float32 or 1 bfloat16 (values, cast to
// their lanes in the kernels), 2 int8 spike lanes, 3 int32 count lanes;
// counts: 1 = s holds counts (int32 lanes), 0 = spikes (int8 lanes);
// out_dtype: 0 float32, 1 bfloat16; w: (k, n) int8 codes; scale: fp32
// (n,); bias: fp32 (n,) or null; ws: the workspace Layout lays out, which
// the staging fills, beginning with the order (mp,) int64
// and the sorted occupancies (mp,) int32 of the stable sort of the rows
// (and the padding rows m..mp-1, all dark) by occupancy; out: (m, n).
// Returns a cudaError_t code (0 on success).
extern "C" int quant_gather_spike_matmul_forward(
    int what, int s_code, int counts, int out_dtype, const void* s,
    const void* w, const void* scale, const void* bias, void* ws, void* out,
    int m, int k, int n, int mp, void* stream) {
  const QArgs a{s, w, (const float*)scale, (const float*)bias,
                (uint8_t*)ws, out, m, k, n, mp};
  const cudaStream_t st = (cudaStream_t)stream;
  if (s_code == 0)
    return counts ? run_quant<float, true>(what, out_dtype, a, st)
                  : run_quant<float, false>(what, out_dtype, a, st);
  if (s_code == 1)
    return counts ? run_quant<__nv_bfloat16, true>(what, out_dtype, a, st)
                  : run_quant<__nv_bfloat16, false>(what, out_dtype, a, st);
  if (s_code == 2 && !counts)
    return run_quant<int8_t, false>(what, out_dtype, a, st);
  if (s_code == 3 && counts)
    return run_quant<int32_t, true>(what, out_dtype, a, st);
  return (int)cudaErrorInvalidValue;
}
