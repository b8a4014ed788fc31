// Block-sparse spike matmul of the sparse engine, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spike_matmul.py::spike_matmul (the Pallas
// bodies `_kernel` / `_kernel_bias`, grid (nM, nN, nK) with K innermost).
// It computes y = s @ w (+ b) with fp32 accumulation for s: (M, K) {0,1}
// spikes or small non-negative integer counts and w: (K, N), skipping
// the products of every all-zero spike tile, and writes y once, rounded
// from the fp32 accumulator to the operands' dtype (the TPU kernel's
// default out_dtype); the engine's operands carry the activation dtype,
// so its cast of the fp32 result (core/engine.spike_linear) is fused
// into the store.
//
// What bounds it: at the training step's shapes (M = T*B*L = 16384 rows,
// K and N of 256 or 1024, bf16 in and out) a call moves 17-42 MB (s read
// once, w read once, y written once) for at most 2.1-8.6 GFLOP, 125-260
// operations a byte: below the bf16 tensor cores' ~295, so bytes bound it
// (~5-13 us at 3.35 TB/s).
//
// Design. The TPU's sequential K grid axis becomes a loop inside the
// block: one block of 8 warps owns a 128 x 64 output tile and walks K in
// 32-deep chunks. Each chunk's 128 x 32 spike tile is staged in shared
// memory, and the block votes with __syncthreads_or whether any entry is
// non-zero; a dark tile costs no weight fetch and no products (a finer
// skip tile than the TPU's 128 x 128, with the same result: skipped
// products are exact zeros). A live chunk stages the 32 x 64 weight tile
// transposed, and each warp runs its 32 x 32 share: in bf16 as mma.sync
// m16n8k16 with fp32 accumulation (spikes, counts up to 256 and bf16
// weights are exact bf16 operands), in fp32 as FMAs on CUDA cores.
// Ragged M, K and N edges are masked in the loads and stores; the bias is
// added to the accumulator after the last chunk, as the TPU kernel adds
// it on its last K step. Loads are synchronous: many resident blocks (4
// an SM at 64 registers a thread), not a pipeline, hide their latency. A
// register prefetch of the next spike tile was tried and measured no
// faster (it cost a block an SM); a cp.async / TMA ring is later work.

// The quantized twin, quant_spike_matmul_kernel below, replaces
// src/repro/kernels/spike_matmul.py::quant_spike_matmul (the Pallas bodies
// `_qkernel` / `_qkernel_bias`): y = (s @ qw) * scale (+ b) for s: (M, K)
// {0,1} spikes on int8 lanes, or binary-attention counts on int32 lanes,
// against int8 weight codes qw: (K, N), summed in int32 (exact, so any
// order gives the TPU kernel's sums), with the per-channel fp32 scale in
// the epilogue: acc * scale, or with a bias fma32(acc, scale, b), the
// contraction jitted XLA makes of `acc * scale + b` (the plain version
// kernels/spike_matmul.quant_spike_matmul_plain rounds the same way),
// written once in fp32 or rounded once to bf16. Tiles and the skip are
// those of spike_matmul_kernel. Spikes run on the tensor cores, one
// mma.sync m16n8k32 s8 x s8 -> s32 a 32-deep chunk; counts (up to L,
// which an int8 lane cannot hold from 128 on) take int32 CUDA-core
// products over the same accumulator slots. What bounds it at the three
// products of a Spikingformer-4-256 layer (M = 16384; wo on counts,
// K = N = 256; w1 K = 256, N = 1024; w2 K = 1024, N = 256): the bytes
// of the lanes, the codes and the outputs, against ~5 G int8
// multiply-adds, under 3 us at the int8 tensor-core peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int BM = 128;  // output rows of a block (the skip tile's height)
constexpr int BN = 64;   // output columns of a block
constexpr int BK = 32;   // contraction chunk (the skip tile's width)

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int VEC = 4;               // elements in 16 bytes
  static constexpr uint32_t MAG = 0x7FFFFFFFu;  // value bits without sign
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr uint32_t MAG = 0x7FFF7FFFu;
};

// shared-memory row of a staged tile: BK plus 16 bytes, so the eight
// rows a warp's fragment loads touch fall in distinct banks
template <typename T> __host__ __device__ constexpr int ldk() {
  return BK + 16 / (int)sizeof(T);
}

__device__ __forceinline__ bool live_bits(uint32_t bits, uint32_t mag) {
  return (bits & mag) != 0u;  // -0 is dark, as s != 0 is false for it
}
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage the (BM, BK) spike tile at (m0, k0) into sa[BM][ldk]; returns
// whether this thread saw a non-zero entry. VEC: 16-byte loads (K is a
// multiple of the vector and s is 16-byte aligned).
template <typename T, bool VEC>
__device__ __forceinline__ bool stage_s(const T* __restrict__ s, T* sa,
                                        int m0, int k0, int M, int K,
                                        int tid) {
  constexpr int V = Traits<T>::VEC, LD = ldk<T>();
  bool live = false;
  if constexpr (VEC) {
    constexpr int PER_ROW = BK / V;
    for (int i = tid; i < BM * PER_ROW; i += NT) {
      const int r = i / PER_ROW, kk = (i % PER_ROW) * V;
      const int gm = m0 + r, gk = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        v = *reinterpret_cast<const uint4*>(s + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(sa + r * LD + kk) = v;
      live |= live_bits(v.x | v.y | v.z | v.w, Traits<T>::MAG);
    }
  } else {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      const T v = (gm < M && gk < K) ? s[(size_t)gm * K + gk] : T(0.f);
      sa[r * LD + kk] = v;
      live |= live_bits(bits_of(v), Traits<T>::MAG);
    }
  }
  return live;
}

// the output, rounded once from the fp32 accumulator
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// stage the (BK, BN) weight tile at (k0, n0) transposed into swt[BN][ldk]
template <typename T, bool VEC>
__device__ __forceinline__ void stage_w(const T* __restrict__ w, T* swt,
                                        int k0, int n0, int K, int N,
                                        int tid) {
  constexpr int V = Traits<T>::VEC, LD = ldk<T>();
  if constexpr (VEC) {
    constexpr int PER_ROW = BN / V;
    for (int i = tid; i < BK * PER_ROW; i += NT) {
      const int kk = i / PER_ROW, nn = (i % PER_ROW) * V;
      const int gk = k0 + kk, gn = n0 + nn;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) swt[(nn + j) * LD + kk] = e[j];
    }
  } else {
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      swt[nn * LD + kk] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : T(0.f);
    }
  }
}

// One block per (BM, BN) output tile. Warp (wm, wn) owns rows wm*32 +
// [0, 32) and columns wn*32 + [0, 32): two m16 by four n8 accumulator
// tiles in the mma.sync fragment layout, which the fp32 path shares.
template <typename T, bool VS, bool VW>
__global__ void __launch_bounds__(NT)
spike_matmul_kernel(const T* __restrict__ s, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int M, int K, int N) {
  constexpr int LD = ldk<T>();
  __shared__ __align__(16) unsigned char smem[(BM + BN) * ldk<float>() * 4];
  T* sa = reinterpret_cast<T*>(smem);  // [BM][LD]: spike tile
  T* swt = sa + BM * LD;               // [BN][LD]: weight tile, transposed
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  float acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous chunk's products have read the tiles
    const bool live = stage_s<T, VS>(s, sa, m0, k0, M, K, tid);
    if (!__syncthreads_or(live)) continue;  // dark tile: no weights, no MACs
    stage_w<T, VW>(w, swt, k0, n0, K, N, tid);
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
      for (int kk = 0; kk < BK; ++kk) {
        float av[2][2], bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[mt][h] = sa[(wm * 32 + mt * 16 + g + 8 * h) * LD + kk];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            bv[nt][c] = swt[(wn * 32 + nt * 8 + tig * 2 + c) * LD + kk];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[mt][nt][c] = fmaf(av[mt][c / 2], bv[nt][c % 2], acc[mt][nt][c]);
      }
    } else {
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* pa = sa + (wm * 32 + mt * 16 + g) * LD + k16 + tig * 2;
          a[mt][0] = ld_pair(pa);
          a[mt][1] = ld_pair(pa + 8 * LD);
          a[mt][2] = ld_pair(pa + 8);
          a[mt][3] = ld_pair(pa + 8 * LD + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* pb = swt + (wn * 32 + nt * 8 + g) * LD + k16 + tig * 2;
          const uint32_t b0 = ld_pair(pb), b1 = ld_pair(pb + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
  }

  // epilogue: bias after the last chunk, then one rounding to the output
  // dtype (pairs of stores when aligned)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + tig * 2;
        if (row >= M || col >= N) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        T* o = out + (size_t)row * N + col;
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bias[col]);
          if (col + 1 < N) v1 = __fadd_rn(v1, bias[col + 1]);
        }
        if (col + 1 < N && N % 2 == 0) {
          store_pair(o, v0, v1);
        } else {
          store_one(o, v0);
          if (col + 1 < N) store_one(o + 1, v1);
        }
      }
}

template <typename T, bool VS, bool VW>
void launch_one(dim3 grid, cudaStream_t stream, const void* s, const void* w,
                const float* bias, void* out, int m, int k, int n) {
  spike_matmul_kernel<T, VS, VW><<<grid, NT, 0, stream>>>(
      (const T*)s, (const T*)w, bias, (T*)out, m, k, n);
}

template <typename T>
int launch(const void* s, const void* w, const float* bias, void* out,
           int m, int k, int n, cudaStream_t stream) {
  constexpr int V = Traits<T>::VEC;
  const bool vs = k % V == 0 && (uintptr_t)s % 16 == 0;
  const bool vw = n % V == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (vs && vw) launch_one<T, true, true>(grid, stream, s, w, bias, out, m, k, n);
  else if (vs) launch_one<T, true, false>(grid, stream, s, w, bias, out, m, k, n);
  else if (vw) launch_one<T, false, true>(grid, stream, s, w, bias, out, m, k, n);
  else launch_one<T, false, false>(grid, stream, s, w, bias, out, m, k, n);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// quant_spike_matmul: int8 spike lanes or int32 count lanes x int8 codes
// ---------------------------------------------------------------------------

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// shared-memory row of a staged lane tile: BK lanes plus 16 bytes (the
// eight rows of a fragment load fall in distinct banks); the int8 weight
// tile is staged transposed, [n][k], in rows of QLD bytes
template <typename S> __host__ __device__ constexpr int qldk() {
  return BK + 16 / (int)sizeof(S);
}
constexpr int QLD = BK + 16;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage the (BM, BK) lane tile at (m0, k0) into sa[BM][qldk]; returns
// whether this thread saw a non-zero lane. VEC: 16-byte loads.
template <typename S, bool VEC>
__device__ __forceinline__ bool stage_lanes(const S* __restrict__ s, S* sa,
                                            int m0, int k0, int M, int K,
                                            int tid) {
  constexpr int V = 16 / (int)sizeof(S), LD = qldk<S>();
  bool live = false;
  if constexpr (VEC) {
    constexpr int PER_ROW = BK / V;
    for (int i = tid; i < BM * PER_ROW; i += NT) {
      const int r = i / PER_ROW, kk = (i % PER_ROW) * V;
      const int gm = m0 + r, gk = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        v = *reinterpret_cast<const uint4*>(s + (size_t)gm * K + gk);
      *reinterpret_cast<uint4*>(sa + r * LD + kk) = v;
      live |= (v.x | v.y | v.z | v.w) != 0u;
    }
  } else {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      const S v = (gm < M && gk < K) ? s[(size_t)gm * K + gk] : S(0);
      sa[r * LD + kk] = v;
      live |= v != 0;
    }
  }
  return live;
}

// stage the (BK, BN) tile of the codes at (k0, n0) transposed into
// swt[BN][QLD]
template <bool VEC>
__device__ __forceinline__ void stage_codes(const int8_t* __restrict__ w,
                                            int8_t* swt, int k0, int n0,
                                            int K, int N, int tid) {
  if constexpr (VEC) {
    constexpr int PER_ROW = BN / 16;
    for (int i = tid; i < BK * PER_ROW; i += NT) {
      const int kk = i / PER_ROW, nn = (i % PER_ROW) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) swt[(nn + j) * QLD + kk] = e[j];
    }
  } else {
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      swt[nn * QLD + kk] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : int8_t(0);
    }
  }
}

// One block per (BM, BN) output tile, the warps and accumulator slots of
// spike_matmul_kernel; int32 accumulators.
template <typename S, typename TO, bool VS, bool VW>
__global__ void __launch_bounds__(NT)
quant_spike_matmul_kernel(const S* __restrict__ s, const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, TO* __restrict__ out,
                          int M, int K, int N) {
  constexpr int LD = qldk<S>();
  __shared__ __align__(16) unsigned char smem[BM * LD * sizeof(S) + BN * QLD];
  S* sa = reinterpret_cast<S*>(smem);                           // [BM][LD]
  int8_t* swt = reinterpret_cast<int8_t*>(smem + BM * LD * sizeof(S));  // [BN][QLD]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous chunk's products have read the tiles
    const bool live = stage_lanes<S, VS>(s, sa, m0, k0, M, K, tid);
    if (!__syncthreads_or(live)) continue;  // dark tile: no codes, no MACs
    stage_codes<VW>(w, swt, k0, n0, K, N, tid);
    __syncthreads();
    if constexpr (sizeof(S) == 1) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* pa = sa + (wm * 32 + mt * 16 + g) * LD + tig * 4;
        a[mt][0] = ld32(pa);
        a[mt][1] = ld32(pa + 8 * LD);
        a[mt][2] = ld32(pa + 16);
        a[mt][3] = ld32(pa + 8 * LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* pb = swt + (wn * 32 + nt * 8 + g) * QLD + tig * 4;
        const uint32_t b0 = ld32(pb), b1 = ld32(pb + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    } else {
      for (int kk = 0; kk < BK; ++kk) {
        int av[2][2], bv[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            av[mt][h] = sa[(wm * 32 + mt * 16 + g + 8 * h) * LD + kk];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            bv[nt][c] = swt[(wn * 32 + nt * 8 + tig * 2 + c) * QLD + kk];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[mt][nt][c] += av[mt][c / 2] * bv[nt][c % 2];
      }
    }
  }

  // epilogue: the int32 sum rounded to fp32, the scale (and bias), one
  // rounding to the output dtype
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + tig * 2;
        if (row >= M) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (col + c >= N) continue;
          const float a = __int2float_rn(acc[mt][nt][2 * h + c]);
          const float v = bias != nullptr ? fma32(a, scale[col + c], bias[col + c])
                                          : __fmul_rn(a, scale[col + c]);
          store_one(out + (size_t)row * N + col + c, v);
        }
      }
}

template <typename S, typename TO, bool VS, bool VW>
void launch_quant_one(dim3 grid, cudaStream_t stream, const void* s,
                      const void* w, const float* scale, const float* bias,
                      void* out, int m, int k, int n) {
  quant_spike_matmul_kernel<S, TO, VS, VW><<<grid, NT, 0, stream>>>(
      (const S*)s, (const int8_t*)w, scale, bias, (TO*)out, m, k, n);
}

template <typename S, typename TO>
int launch_quant(const void* s, const void* w, const float* scale,
                 const float* bias, void* out, int m, int k, int n,
                 cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(S);
  const bool vs = k % V == 0 && (uintptr_t)s % 16 == 0;
  const bool vw = n % 16 == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (vs && vw) launch_quant_one<S, TO, true, true>(grid, stream, s, w, scale, bias, out, m, k, n);
  else if (vs) launch_quant_one<S, TO, true, false>(grid, stream, s, w, scale, bias, out, m, k, n);
  else if (vw) launch_quant_one<S, TO, false, true>(grid, stream, s, w, scale, bias, out, m, k, n);
  else launch_quant_one<S, TO, false, false>(grid, stream, s, w, scale, bias, out, m, k, n);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_quant_lanes(int out_dtype, const void* s, const void* w,
                       const float* scale, const float* bias, void* out,
                       int m, int k, int n, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_quant<S, float>(s, w, scale, bias, out, m, k, n, stream);
  if (out_dtype == 1)
    return launch_quant<S, __nv_bfloat16>(s, w, scale, bias, out, m, k, n, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (s, w and out); bias: fp32 (n,) or null;
// out: (m, n). Returns a cudaError_t code (0 on success).
extern "C" int spike_matmul_forward(int dtype, const void* s, const void* w,
                                    const void* bias, void* out, int m, int k,
                                    int n, void* stream) {
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(s, w, b, out, m, k, n, st);
  if (dtype == 1) return launch<__nv_bfloat16>(s, w, b, out, m, k, n, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spike_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// counts: 0 = s is (m, k) int8 spike lanes, 1 = int32 count lanes;
// out_dtype: 0 float32, 1 bfloat16; w: (k, n) int8 codes; scale: fp32
// (n,); bias: fp32 (n,) or null; out: (m, n). Returns a cudaError_t code
// (0 on success).
extern "C" int quant_spike_matmul_forward(int counts, int out_dtype,
                                          const void* s, const void* w,
                                          const void* scale, const void* bias,
                                          void* out, int m, int k, int n,
                                          void* stream) {
  const float* sc = (const float*)scale;
  const float* b = (const float*)bias;
  const cudaStream_t st = (cudaStream_t)stream;
  if (counts)
    return launch_quant_lanes<int32_t>(out_dtype, s, w, sc, b, out, m, k, n, st);
  return launch_quant_lanes<int8_t>(out_dtype, s, w, sc, b, out, m, k, n, st);
}
