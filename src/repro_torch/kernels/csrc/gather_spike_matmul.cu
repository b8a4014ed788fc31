// Gather-compacted spike matmul of the sparse engine's decoded datapath,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spike_decode.py::gather_spike_matmul (the
// Pallas bodies `_kernel` / `_kernel_bias`, grid (groups, N tiles,
// compacted chunks)). It computes y = s @ w (+ b) for s: (M, K) {0,1}
// spikes or integer counts and w: (K, N): each row's result is the fp32
// sum, in ascending k, of value x w[k, :] over the row's live entries,
// then the bias, rounded once to the operands' dtype and written to the
// row's own index (the TPU kernel returns fp32 in sorted order and its
// caller un-permutes and casts).
//
// What bounds it: the bytes it must move are s, w and y once each plus
// the staged schedule (row order M int64, sorted occupancies M int32);
// the work is the live multiply-adds, sum over rows of occupancy
// x N. At the training step's shapes (M = 16384; K, N of 256 or 1024;
// bf16) the bytes take 5-13 us at 3.35 TB/s and the live work (~20% of
// the dense products on random weights) well under that at the bf16
// tensor-core peak, so bytes bound it. This kernel runs its products on
// CUDA cores, one fp32 sum (and product, for a non-spike value) per live
// entry and column, in a fixed order (the plain version's), and sits
// ~15x above that bound: 0.08 ms for a 256 x 256 product on an H100 SXM
// at 700 W. Halving its instructions per live entry moved it 3%, so
// that is not where its time goes; where it goes is not measured yet.
// It is the simple correct kernel, made faster later.
//
// Design. The staging keeps JAX's schedule and nothing more: the wrapper
// counts each row's non-zeros and sorts the rows by that occupancy (a
// stable sort; two PyTorch ops on the device, since every further small
// op costs the host a launch) into block_m groups; a block rounds its
// groups' largest occupancy, the last of each group in sorted order, up
// to a power of two, clipped to the padded width (the group's capacity),
// as build_schedule does. The TPU staging also
// materialises every row's compacted indices and values, (M, K) int32 +
// fp32, sixteen times the spikes at K = 1024; here each block decodes its
// rows itself instead. A block takes 64 consecutive rows of the sorted
// order and a 128-column tile of w, and walks K in slabs of 128 bytes a
// row: it stages the slab of its rows' spikes and the matching rows of
// the w tile in shared memory, then each warp decodes its 8 rows one
// 32-entry word at a time — a warp ballot marks the live entries, and
// __ffs walks them in ascending k, which is the order of the compacted
// slots (a slot's index is the popcount of the live bits before it). For
// each live entry the 32 lanes gather the entry's weight row (four
// consecutive columns a lane, one vector load) from shared memory; a
// spike (value 1) adds the weights as they are, exactly what 1 x w
// gives. Compacted chunks of c_block slots
// at or past a group's capacity hold no live entry, so walking only live
// entries executes exactly the chunks below the capacity; a group whose
// capacity is 0 (all rows dark) skips its spikes, weights and products,
// and a block of such rows skips the K walk. The sort makes the rows of a
// block, and so the warps' loops, about equally long: the load balancing
// of the paper's decoder.

// The quantized twin, quant_gather_mma below with its staging
// quant_stage_rows + quant_stage_sort, replaces
// src/repro/kernels/spike_decode.py::quant_gather_spike_matmul (the Pallas
// bodies `_qkernel` / `_qkernel_bias` and the staging `_stage`):
// y = (lanes(s) @ qw) * scale (+ b) for spikes on int8 lanes or
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
// Design. Staging, two kernels on the device, nothing read back: the first
// reads s once in its own dtype (fp32 or bf16; no (M, K) lanes tensor is
// written), casts each value to its lane as quant_lanes does, and writes
// each row's occupancy, its live bits (1/16 of bf16 s) and, for counts,
// its value range, and counts the rows into a histogram a 1024-row chunk;
// the second sorts the rows stably by occupancy with a counting sort
// (keys 0..K), which gives torch.sort(stable=True)'s permutation, so the
// order and sorted occupancies equal stage_rows' (the JAX schedule's sort,
// the paper's load balancing) bitwise. The product: a block of 512
// threads takes 128 consecutive sorted rows, decodes the union of their
// live lanes once (the OR of their bit words: the multi-lane decoder of
// the paper's Eq. 5 at the block's grain) and walks its non-zero words in
// ascending k, one 32-lane chunk an mma k-step: the rows' values there
// (cast to their lanes and split into byte planes) and only the code rows
// of the union's live lanes are staged in shared memory, and mma.sync
// m16n8k32 (s8 x s8 for spike lanes, u8 x s8 for count lanes below 256;
// larger or negative counts in byte planes, a signed top plane and
// unsigned lower ones, as many as the block's largest magnitude needs)
// sums them in int32 registers, 256 output columns a pass. The sort
// groups sparse rows with sparse rows, so a block's union is narrow where
// its rows are; where it is near dense the block runs the dense chunk on
// the tensor cores. The block loops over the output columns itself (split
// over blocks only as far as one block a multiprocessor needs), so w1's
// 1024 columns do not re-decode the rows per column tile.
//
// Where it stands (chip_smoke.py, H100 SXM at 700 W, bf16, the three
// products of a mixed 4-256 layer): ~40 us of staging and ~115 us of
// product kernels on the device, ~6x the bytes bound. The k-steps are
// bound by the instructions a step issues (the casts, the byte
// transposes, two barriers) and by memory latency; their dense mma alone
// would take ~10 us at the int8 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;      // 8 warps
constexpr int ROWS = 64;     // sorted rows a block
constexpr int RPW = ROWS / (NT / 32);  // rows a warp: 8
constexpr int CPL = 4;       // output columns a lane, consecutive
constexpr int NW = 32 * CPL; // output columns a block: 128

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int VEC = 4;                 // elements in 16 bytes
  static constexpr uint32_t MAG = 0x7FFFFFFFu;  // value bits without sign
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ void quad(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr uint32_t MAG = 0x7FFFu;
  static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
    return (uint32_t)__bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void quad(const __nv_bfloat16* p,
                                              float (&o)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = lo.x, o[1] = lo.y, o[2] = hi.x, o[3] = hi.y;
  }
  static __device__ __forceinline__ void store_quad(__nv_bfloat16* p,
                                                    const float (&v)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
};

// K-slab: 128 bytes of a row; the staged spike row is padded by 16 bytes
template <typename T> __host__ __device__ constexpr int slab() {
  return 128 / (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr int lds() {
  return slab<T>() + 16 / (int)sizeof(T);
}

// smallest power of two >= x (0 -> 0, 1 -> 1): spike_decode.pow2ceil
__device__ __forceinline__ int pow2ceil(int x) {
  return x <= 1 ? max(x, 0) : 1 << (32 - __clz(x - 1));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VS / VW: 16-byte loads of s / w (K / N a multiple of the vector and the
// base 16-byte aligned)
template <typename T, bool VS, bool VW>
__global__ void __launch_bounds__(NT)
gather_spike_matmul_kernel(const T* __restrict__ s, const T* __restrict__ w,
                           const float* __restrict__ bias,
                           const long long* __restrict__ order,
                           const int* __restrict__ sorted_occ,
                           T* __restrict__ out, int M, int K, int N, int Mp,
                           int block_m, int padded_cap) {
  using Tr = Traits<T>;
  constexpr int KS = slab<T>(), LDS = lds<T>(), V = Tr::VEC;
  __shared__ __align__(16) T ss[ROWS * LDS];  // [row][k]: spike slab
  __shared__ __align__(16) T ws[KS * NW];     // [k][col]: weight slab
  __shared__ int row_of[ROWS];                // original row, or -1
  __shared__ int row_cap[ROWS];               // the row's group capacity

  const int p0 = blockIdx.x * ROWS, n0 = blockIdx.y * NW, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  bool live = false;
  if (tid < ROWS) {
    const int p = p0 + tid;
    int r = -1, cap = 0;
    if (p < Mp) {
      r = (int)order[p];
      cap = min(pow2ceil(sorted_occ[(p / block_m + 1) * block_m - 1]),
                padded_cap);
    }
    if (r >= M) r = -1;                // padding rows sort among the dark
    row_of[tid] = r;
    row_cap[tid] = cap;
    live = r >= 0 && cap > 0;
  }
  const bool any_live = __syncthreads_or(live);

  float acc[RPW][CPL] = {};
  for (int k0 = 0; any_live && k0 < K; k0 += KS) {
    __syncthreads();                   // the previous slab is consumed
    // spikes of the block's rows in this slab (dark groups read nothing)
    if constexpr (VS) {
      for (int i = tid; i < ROWS * (KS / V); i += NT) {
        const int r = i / (KS / V), kk = i % (KS / V) * V;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row_of[r] >= 0 && row_cap[r] > 0 && k0 + kk < K)
          v = *reinterpret_cast<const uint4*>(s + (size_t)row_of[r] * K + k0 + kk);
        *reinterpret_cast<uint4*>(ss + r * LDS + kk) = v;
      }
    } else {
      for (int i = tid; i < ROWS * KS; i += NT) {
        const int r = i / KS, kk = i % KS;
        ss[r * LDS + kk] = row_of[r] >= 0 && row_cap[r] > 0 && k0 + kk < K
                               ? s[(size_t)row_of[r] * K + k0 + kk]
                               : T(0.f);
      }
    }
    // the slab's rows of the w tile
    if constexpr (VW) {
      for (int i = tid; i < KS * (NW / V); i += NT) {
        const int kk = i / (NW / V), nn = i % (NW / V) * V;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + kk < K && n0 + nn < N)
          v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * N + n0 + nn);
        *reinterpret_cast<uint4*>(ws + kk * NW + nn) = v;
      }
    } else {
      for (int i = tid; i < KS * NW; i += NT) {
        const int kk = i / NW, nn = i % NW;
        ws[kk * NW + nn] = k0 + kk < K && n0 + nn < N
                               ? w[(size_t)(k0 + kk) * N + n0 + nn]
                               : T(0.f);
      }
    }
    __syncthreads();

    // decode and contract: warp-uniform control flow throughout
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      if (row_cap[r] == 0) continue;   // a dark group's chunks all skip
      const T* srow = ss + r * LDS;
#pragma unroll
      for (int word = 0; word < KS / 32; ++word) {
        uint32_t bits = __ballot_sync(
            0xFFFFFFFFu, (Tr::bits(srow[word * 32 + lane]) & Tr::MAG) != 0u);
        while (bits) {                 // live entries, ascending k
          const int j = word * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          const float a = Tr::to_float(srow[j]);
          float wv[CPL];
          Tr::quad(ws + j * NW + CPL * lane, wv);
          if (a == 1.f) {              // a spike: a * w is w, exactly
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[i][c] = __fadd_rn(acc[i][c], wv[c]);
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a, wv[c]));
          }
        }
      }
    }
  }

  // bias after the last entry, one rounding, the row's own index
  const int col = n0 + CPL * lane;
  if (col >= N) return;
  float b[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    b[c] = bias != nullptr && col + c < N ? bias[col + c] : 0.f;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row_of[warp * RPW + i];
    if (r < 0) continue;
    float v[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      v[c] = bias != nullptr ? __fadd_rn(acc[i][c], b[c]) : acc[i][c];
    T* o = out + (size_t)r * N + col;
    if (N % CPL == 0) {
      Tr::store_quad(o, v);
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (col + c < N) store_one(o + c, v[c]);
    }
  }
}

struct Args {
  const void *s, *w;
  const float* bias;
  const long long* order;
  const int* sorted_occ;
  void* out;
  int m, k, n, mp, block_m, padded_cap;
};

template <typename T, bool VS, bool VW>
void launch_one(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.mp + ROWS - 1) / ROWS, (a.n + NW - 1) / NW);
  gather_spike_matmul_kernel<T, VS, VW><<<grid, NT, 0, stream>>>(
      (const T*)a.s, (const T*)a.w, a.bias, a.order, a.sorted_occ, (T*)a.out,
      a.m, a.k, a.n, a.mp, a.block_m, a.padded_cap);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int V = Traits<T>::VEC;
  const bool vs = a.k % V == 0 && (uintptr_t)a.s % 16 == 0;
  const bool vw = a.n % V == 0 && (uintptr_t)a.w % 16 == 0;
  if (vs && vw) launch_one<T, true, true>(a, stream);
  else if (vs) launch_one<T, true, false>(a, stream);
  else if (vw) launch_one<T, false, true>(a, stream);
  else launch_one<T, false, false>(a, stream);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// quant_gather_spike_matmul: the lanes' staging (occupancy, live bits,
// value range, a stable counting sort by occupancy) and the decoded int8
// product on the tensor cores
// ---------------------------------------------------------------------------

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// a value of s on its integer lane, as spike_matmul.quant_lanes casts it:
// truncated toward zero to int32; a spike lane keeps the low byte (int8)
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(__nv_bfloat16 v) {
  return __float2int_rz(__bfloat162float(v));
}
__device__ __forceinline__ int to_int(int8_t v) { return v; }
__device__ __forceinline__ int to_int(int32_t v) { return v; }

template <bool COUNTS, typename S>
__device__ __forceinline__ int lane_of(S v) {
  const int x = to_int(v);
  return COUNTS ? x : (int)(int8_t)(x & 0xFF);
}

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int SROWS = 16;    // rows a staging block, 2 a warp
constexpr int CHUNK = 1024;  // rows a sort block, one a thread

// One warp a row: the row's lanes once, read in s's own dtype. Writes the
// row's occupancy (0 for the padding rows m..mp-1), its live bits (bit
// k % 32 of word k / 32) and, for count lanes, the code of its value
// range (max(hi, -lo - 1), the sign bit set if a lane is negative); counts
// the row into its sort chunk's histogram. VEC: 16-byte loads.
template <typename S, bool COUNTS, bool VEC>
__global__ void __launch_bounds__(NT)
quant_stage_rows(const S* __restrict__ s, int M, int K, int Mp, int W,
                 int* __restrict__ occ, uint32_t* __restrict__ bits,
                 int* __restrict__ rng, int* __restrict__ hist) {
  constexpr int V = VEC ? 16 / (int)sizeof(S) : 1;  // lanes a load
  constexpr int G = 32 / V;                         // loads a bit word
  constexpr int RW = SROWS / (NT / 32);             // rows a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < RW; ++i) {
    const int p = blockIdx.x * SROWS + warp * RW + i;
    if (p >= Mp) return;
    int n = 0, lo = 0, hi = 0;
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
            const int x = lane_of<COUNTS>(v[e]);
            live |= (uint32_t)(x != 0) << e;
            lo = min(lo, x);
            hi = max(hi, x);
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
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
    }
    if (lane == 0) {
      occ[p] = n;
      if (COUNTS && p < M)
        rng[p] = max(hi, ~lo) | (lo < 0 ? (int)0x80000000u : 0);
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
quant_stage_sort(const int* __restrict__ occ, const int* __restrict__ hist,
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

constexpr int QNT = 512;          // threads a product block: 16 warps
constexpr int QBM = 128;          // sorted rows a block: warps 2 x 8
constexpr int QBN = 256;          // output columns a tile, 32 a warp
constexpr int KSTEP = 32;         // lanes a chunk, one mma k-step
constexpr int SEG = 2048;         // lanes decoded at once (64 bit words)
constexpr int ASTR = KSTEP + 16;  // bytes a staged lane row (the rows of a
                                  // fragment load in distinct banks)
constexpr int BSTR = QBN + 8;     // words a staged code row, [k / 4][n]

template <bool U>
__device__ __forceinline__ void mma8(int (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  if constexpr (U)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t shl8(int x) { return (uint32_t)x << 8; }

// One k-step of a warp's 64 x 32 tile (4 x 4 m16n8k32 products): the
// lanes in P byte planes, the lower ones unsigned and the top one signed
// (or, with U1, one unsigned plane), combined by Horner's rule,
// acc += sum_p 256^p (plane_p x codes), in int32 (exact modulo 2^32, as
// the plain version's int32 sums). live_mt: the m-tiles holding a live row.
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
    for (int j = 0; j < 4; ++j) {
      if constexpr (P == 1) {
        mma8<U1>(acc[i][j], a[0], b[j][0], b[j][1]);
      } else {
        int h[4] = {0, 0, 0, 0};
        mma8<false>(h, a[P - 1], b[j][0], b[j][1]);
#pragma unroll
        for (int pl = P - 2; pl >= 1; --pl) {
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = (int)shl8(h[e]);
          mma8<true>(h, a[pl], b[j][0], b[j][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = (int)((uint32_t)acc[i][j][e] + shl8(h[e]));
        mma8<true>(acc[i][j], a[0], b[j][0], b[j][1]);
      }
    }
  }
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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
  if constexpr (COUNTS) {
    const int mag = mag_sh;
    if (!neg_sh && mag <= 0xFF) U1 = true;
    else P = mag <= 0x7F ? 1 : mag <= 0x7FFF ? 2 : mag <= 0x7FFFFF ? 3 : 4;
  }
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
          uint32_t pw[PMAX][4] = {};
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int x = lane_of<COUNTS>(reinterpret_cast<const S*>(raw)[q]);
#pragma unroll
            for (int pl = 0; pl < PMAX; ++pl)
              pw[pl][q / 4] |= (uint32_t)(uint8_t)(x >> (8 * pl)) << (8 * (q % 4));
          }
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
          const uint32_t x0 = __byte_perm(bw[0], bw[1], 0x5140);
          const uint32_t x1 = __byte_perm(bw[2], bw[3], 0x5140);
          const uint32_t x2 = __byte_perm(bw[0], bw[1], 0x7362);
          const uint32_t x3 = __byte_perm(bw[2], bw[3], 0x7362);
          *reinterpret_cast<uint4*>(sB + q * BSTR + c4) =
              make_uint4(__byte_perm(x0, x1, 0x5410),
                         __byte_perm(x0, x1, 0x7632),
                         __byte_perm(x2, x3, 0x5410),
                         __byte_perm(x2, x3, 0x7632));
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
              for (int h = 0; h < 2; ++h) {
                const float a = __int2float_rn(acc[i][j][2 * h + e]);
                store_one(so + (16 * i + g + 8 * h) * OSTR + c,
                          bias != nullptr ? fma32(a, sc, bi)
                                          : __fmul_rn(a, sc));
              }
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
// sorted_occ (mp int32) | occ (mp) | bits (m x ceil(k / 32)) | rng (m) |
// hist (ceil(mp / CHUNK) x (k + 1)), int32 after the order
struct QLayout {
  size_t sorted_occ, occ, bits, rng, hist, total;
  QLayout(int m, int k, int mp) {
    const size_t w = (k + 31) / 32, nch = (mp + CHUNK - 1) / CHUNK;
    sorted_occ = (size_t)mp * 8;
    occ = sorted_occ + (size_t)mp * 4;
    bits = occ + (size_t)mp * 4;
    rng = bits + (size_t)m * w * 4;
    hist = rng + (size_t)m * 4;
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

template <typename S, bool COUNTS>
int stage_quant(const QArgs& a, cudaStream_t st) {
  const QLayout l(a.m, a.k, a.mp);
  int* hist = reinterpret_cast<int*>(a.ws + l.hist);
  const int nch = (a.mp + CHUNK - 1) / CHUNK, w = (a.k + 31) / 32;
  cudaError_t e = cudaMemsetAsync(hist, 0, l.total - l.hist, st);
  if (e != cudaSuccess) return (int)e;
  constexpr int V = 16 / (int)sizeof(S);
  const dim3 grid((a.mp + SROWS - 1) / SROWS);
  int* occ = reinterpret_cast<int*>(a.ws + l.occ);
  uint32_t* bits = reinterpret_cast<uint32_t*>(a.ws + l.bits);
  int* rng = reinterpret_cast<int*>(a.ws + l.rng);
  if (a.k % V == 0 && (uintptr_t)a.s % 16 == 0)
    quant_stage_rows<S, COUNTS, true><<<grid, NT, 0, st>>>(
        (const S*)a.s, a.m, a.k, a.mp, w, occ, bits, rng, hist);
  else
    quant_stage_rows<S, COUNTS, false><<<grid, NT, 0, st>>>(
        (const S*)a.s, a.m, a.k, a.mp, w, occ, bits, rng, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(a.k + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(quant_stage_sort,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  quant_stage_sort<<<nch, CHUNK, smem, st>>>(
      occ, hist, a.k, a.mp, reinterpret_cast<long long*>(a.ws),
      reinterpret_cast<int*>(a.ws + l.sorted_occ));
  return (int)cudaGetLastError();
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
  const QLayout l(a.m, a.k, a.mp);
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
  const int* rng = reinterpret_cast<const int*>(a.ws + l.rng);
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
    const int rc = stage_quant<S, COUNTS>(a, st);
    if (rc != 0 || what == 0) return rc;
  }
  if (out_dtype == 0) return launch_quant<S, COUNTS, float>(a, st);
  if (out_dtype == 1) return launch_quant<S, COUNTS, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (s, w and out); bias: fp32 (n,) or null;
// order: (mp,) int64 rows sorted by occupancy, stably (indices >= m are
// padding rows); sorted_occ: (mp,) int32 their occupancies; padded_cap:
// the compacted width rounded up to the chunk; out: (m, n). Returns a
// cudaError_t code (0 on success).
extern "C" int gather_spike_matmul_forward(int dtype, const void* s,
                                           const void* w, const void* bias,
                                           const void* order,
                                           const void* sorted_occ, void* out,
                                           int m, int k, int n, int mp,
                                           int block_m, int padded_cap,
                                           void* stream) {
  const Args a{s, w, (const float*)bias, (const long long*)order,
               (const int*)sorted_occ, out, m, k, n, mp, block_m,
               padded_cap};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
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
// (n,); bias: fp32 (n,) or null; ws: the workspace QLayout lays out, which
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
