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

// The quantized twin, quant_gather_kernel below, replaces
// src/repro/kernels/spike_decode.py::quant_gather_spike_matmul (the Pallas
// bodies `_qkernel` / `_qkernel_bias`): y = (s @ qw) * scale (+ b) over
// each row's live entries, on the same schedule and in-kernel row decode,
// for spikes on int8 lanes or binary-attention counts on int32 lanes
// (spike_decode.py:429) against int8 weight codes. Sums are int32, exact
// in any order, so it agrees bitwise with quant_spike_matmul and with the
// dense quantized reference on any weights and scales; the epilogue
// (acc * scale, or fma32(acc, scale, b) with a bias) and the one rounding
// to the output dtype are quant_spike_matmul's. The staged weight slab
// holds int8 codes, four columns of a lane in one 32-bit load.

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
// quant_gather_spike_matmul: int8 spike lanes or int32 count lanes x int8
// codes, int32 sums
// ---------------------------------------------------------------------------

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// VS / VW: 16-byte loads of the lanes / the codes
template <typename S, typename TO, bool VS, bool VW>
__global__ void __launch_bounds__(NT)
quant_gather_kernel(const S* __restrict__ s, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const long long* __restrict__ order,
                    const int* __restrict__ sorted_occ, TO* __restrict__ out,
                    int M, int K, int N, int Mp, int block_m, int padded_cap) {
  constexpr int KS = 128 / (int)sizeof(S);        // lanes of a 128-byte slab
  constexpr int LDS = KS + 16 / (int)sizeof(S);
  constexpr int V = 16 / (int)sizeof(S);
  __shared__ __align__(16) S ss[ROWS * LDS];       // [row][k]: lane slab
  __shared__ __align__(16) int8_t ws[KS * NW];     // [k][col]: code slab
  __shared__ int row_of[ROWS];
  __shared__ int row_cap[ROWS];

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
    if (r >= M) r = -1;
    row_of[tid] = r;
    row_cap[tid] = cap;
    live = r >= 0 && cap > 0;
  }
  const bool any_live = __syncthreads_or(live);

  int acc[RPW][CPL] = {};
  for (int k0 = 0; any_live && k0 < K; k0 += KS) {
    __syncthreads();
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
                               : S(0);
      }
    }
    if constexpr (VW) {
      for (int i = tid; i < KS * (NW / 16); i += NT) {
        const int kk = i / (NW / 16), nn = i % (NW / 16) * 16;
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
                               : int8_t(0);
      }
    }
    __syncthreads();

    // decode and contract: the live lanes of each row, ascending k
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      if (row_cap[r] == 0) continue;
      const S* srow = ss + r * LDS;
#pragma unroll
      for (int word = 0; word < KS / 32; ++word) {
        uint32_t bits = __ballot_sync(0xFFFFFFFFu, srow[word * 32 + lane] != 0);
        while (bits) {
          const int j = word * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          const int a = (int)srow[j];
          const uint32_t q4 = *reinterpret_cast<const uint32_t*>(ws + j * NW + CPL * lane);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int wv = (int)(int8_t)(q4 >> (8 * c) & 0xFFu);
            acc[i][c] += a * wv;
          }
        }
      }
    }
  }

  // epilogue at the row's own index: the int32 sum rounded to fp32, the
  // scale (and bias), one rounding to the output dtype
  const int col = n0 + CPL * lane;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row_of[warp * RPW + i];
    if (r < 0) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (col + c >= N) continue;
      const float a = __int2float_rn(acc[i][c]);
      const float v = bias != nullptr ? fma32(a, scale[col + c], bias[col + c])
                                      : __fmul_rn(a, scale[col + c]);
      store_one(out + (size_t)r * N + col + c, v);
    }
  }
}

struct QArgs {
  const void *s, *w;
  const float *scale, *bias;
  const long long* order;
  const int* sorted_occ;
  void* out;
  int m, k, n, mp, block_m, padded_cap;
};

template <typename S, typename TO, bool VS, bool VW>
void launch_quant_one(const QArgs& a, cudaStream_t stream) {
  const dim3 grid((a.mp + ROWS - 1) / ROWS, (a.n + NW - 1) / NW);
  quant_gather_kernel<S, TO, VS, VW><<<grid, NT, 0, stream>>>(
      (const S*)a.s, (const int8_t*)a.w, a.scale, a.bias, a.order,
      a.sorted_occ, (TO*)a.out, a.m, a.k, a.n, a.mp, a.block_m, a.padded_cap);
}

template <typename S, typename TO>
int launch_quant(const QArgs& a, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(S);
  const bool vs = a.k % V == 0 && (uintptr_t)a.s % 16 == 0;
  const bool vw = a.n % 16 == 0 && (uintptr_t)a.w % 16 == 0;
  if (vs && vw) launch_quant_one<S, TO, true, true>(a, stream);
  else if (vs) launch_quant_one<S, TO, true, false>(a, stream);
  else if (vw) launch_quant_one<S, TO, false, true>(a, stream);
  else launch_quant_one<S, TO, false, false>(a, stream);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_quant_lanes(int out_dtype, const QArgs& a, cudaStream_t stream) {
  if (out_dtype == 0) return launch_quant<S, float>(a, stream);
  if (out_dtype == 1) return launch_quant<S, __nv_bfloat16>(a, stream);
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

// counts: 0 = s is (m, k) int8 spike lanes, 1 = int32 count lanes;
// out_dtype: 0 float32, 1 bfloat16; w: (k, n) int8 codes; scale: fp32
// (n,); bias: fp32 (n,) or null; order, sorted_occ, padded_cap: the
// schedule of gather_spike_matmul_forward; out: (m, n). Returns a
// cudaError_t code (0 on success).
extern "C" int quant_gather_spike_matmul_forward(
    int counts, int out_dtype, const void* s, const void* w,
    const void* scale, const void* bias, const void* order,
    const void* sorted_occ, void* out, int m, int k, int n, int mp,
    int block_m, int padded_cap, void* stream) {
  const QArgs a{s, w, (const float*)scale, (const float*)bias,
                (const long long*)order, (const int*)sorted_occ, out, m, k, n,
                mp, block_m, padded_cap};
  const cudaStream_t st = (cudaStream_t)stream;
  if (counts) return launch_quant_lanes<int32_t>(out_dtype, a, st);
  return launch_quant_lanes<int8_t>(out_dtype, a, st);
}
