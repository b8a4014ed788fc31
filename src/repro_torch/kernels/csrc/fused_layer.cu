// Fused layer program of the dual-engine overlay, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_layer.py::fused_layer (the Pallas
// kernel `_kernel`, grid (B, 8 phases, H)) for the vision family's eval
// layer: family 'bn', sparse='tile' or 'decoded', not pipelined. It computes one
// encoder layer: q/k/v spike projections + BN + LIF, binarized scores,
// context, wo + bn_o + residual + input LIF, up + bn_1 + LIF, down +
// bn_2 + residual; and the (H, 8, n_l_blocks) map of executed sub-blocks.
//
// What bounds it: at Spikingformer-4-256 (T=4, B=64, L=64, D=256, H=8,
// hd=32, F=1024) the layer is about 13.4 G multiply-adds of {0,1} spikes
// (or small integer counts) against weights, on ~25 MB of input and
// output, so it is bound by operations (~27 us at the bf16 tensor-core
// peak against ~8 us for the bytes). In bf16 both launches run their
// products on the tensor cores with mma.sync (fp32 keeps CUDA-core
// loops); launch B stages each weight chunk once for all timesteps and
// reads the next chunk into registers while the current one's products
// run. wgmma / TMA pipelines are later work. The decoded variant's
// projection (below) is a CUDA-core walk over live spikes instead.
//
// Design. The TPU grid keeps every head's q/k/v spikes for all T in
// VMEM (~786 KB at full width), which no SM can hold. The layer is split
// into two launches instead:
//   A. attention_phase, one block per (head, b): for each t, the head's
//      q/k/v projection of the (L, D) spike slab, staged whole in shared
//      memory, skipping dark L-blocks; the epilogue (scale,
//      BN, LIF with the membrane in registers across t) emits spikes as
//      bit planes; scores are AND-popcounts of those bits, binarized in
//      place; the context is a popcount of score bits against the
//      transposed value bits. Spikes never leave shared memory; the
//      context (integer counts) goes to a (T, B, L, H*hd) scratch.
//   B. mlp_phase, one block per (L-block, b): wo as one fixed-order fp32
//      sum over heads, then scale, bn_o, residual (x1 is parked in the
//      output) and the input LIF into bit planes; up per ff-chunk + bn_1
//      + LIF into hidden bit planes; down as one fixed-order sum over
//      chunks + bn_2 + residual. Spike operands are expanded from the bit
//      planes straight into mma fragments. Every predicate is evaluated
//      on the whole L-block, so the counts are those of the TPU kernel.
// Counts are summed with int32 atomicAdd (order-free); no float atomics.
//
// The decoded variant (sparse='decoded'; `_kernel` with decoded=True, the
// q/k/v `project` phases at fused_layer.py:152-215, staged by
// spike_decode.slab_decode) changes only the projection of launch A. The
// TPU staging materialises each row's compacted indices and values and
// per-L-block capacities min(pow2ceil(max occupancy), Cp); here the block
// decodes the staged slab itself: each warp walks its rows one 32-entry
// word at a time, a warp ballot marks the live spikes and __ffs visits
// them in ascending k (the order of the compacted slots), and for each
// live spike the lanes add the value times the spike's row of the head's
// q/k/v weights (staged untransposed, [D][3 hd]) with one fp32 product
// and one fp32 sum, three columns a lane. Chunks of c_block slots at or
// past an L-block's capacity hold no live spike, so they are skipped by
// construction; the executed chunks, ceil(capacity / c_block) per
// (t, b, L-block), go to the q/k/v counts. The epilogue and launch B are
// the tile variant's. It is CUDA-core work in both dtypes: the sum order
// is the plain version's, so the variant is bitwise equal to its plain
// version for any weights, and to the tile variant on dyadic weights.
//
// Rounding follows the plain version (kernels/fused_layer.py) step by
// step: fp32 accumulation, cast to the activation dtype, BN as
// (y - mean) * inv_std rounded and then fma32 (a float64 product and sum
// rounded once, XLA's contracted FMA), LIF and the residual in the
// activation dtype, each product and sum rounded with __fmul_rn /
// __fadd_rn so nvcc contracts nothing the plain version rounds apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block, both launches
constexpr int KC = 64;       // launch B contraction chunk, staged in shared memory
constexpr int MAX_L = 64;    // launch A holds all rows of one (t, b) slab
constexpr int MAX_HD = 32;   // q/k spikes of a row fit one 32-bit word
constexpr int TILE = 64;     // launch B output tile: 64 rows x 64 columns
constexpr int N_PHASES = 8;

template <typename T> struct Act;
template <> struct Act<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// eval BN of channel c; rows is a (4, n) block [mean, inv_std, scale, bias]
__device__ __forceinline__ float bn_eval(float y, const float* rows, int n,
                                         int c) {
  return fma32(__fmul_rn(__fsub_rn(y, rows[c]), rows[n + c]),
               rows[2 * n + c], rows[3 * n + c]);
}

struct Lif {
  float decay, vth;
  int soft;
};

// smallest power of two >= x (0 -> 0, 1 -> 1): spike_decode.pow2ceil
__device__ __forceinline__ int pow2ceil(int x) {
  return x <= 1 ? max(x, 0) : 1 << (32 - __clz(x - 1));
}

// one LIF step in the activation dtype (core/spiking.lif_step); returns
// the spike
template <typename T>
__device__ __forceinline__ bool lif_step(float& u, float y, const Lif& p) {
  using A = Act<T>;
  u = A::round(__fadd_rn(A::round(__fmul_rn(p.decay, u)), y));
  const float s = A::round(__fsub_rn(u, p.vth)) >= 0.f ? 1.f : 0.f;
  if (p.soft)
    u = A::round(__fsub_rn(u, A::round(__fmul_rn(s, p.vth))));
  else
    u = A::round(__fmul_rn(u, A::round(__fsub_rn(1.f, s))));
  return s != 0.f;
}

// ---------------------------------------------------------------------------
// tensor-core helpers: bf16 mma.sync m16n8k16 with fp32 accumulation
// ---------------------------------------------------------------------------

// two consecutive spike bits of `word` as a packed pair of bf16 {0, 1}
__device__ __forceinline__ uint32_t bit_pair(uint32_t word, int bit) {
  return ((word >> bit) & 1u) * 0x3F80u | ((word >> (bit + 1)) & 1u) * 0x3F800000u;
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

// ---------------------------------------------------------------------------
// launch A: projections + binary attention, one block per (head, b)
// ---------------------------------------------------------------------------
//
// The head's slice of w3 is staged once, transposed to [3 hd][D], and each
// timestep's (L, D) spike slab is staged whole, so the projection runs
// without further barriers. It is an (L x D) x (D x 3 hd) product: warp w
// owns rows 16 (w % 4) + [0, 16) and the n8-tiles w / 4, w / 4 + 2, ... of
// the 3 hd columns; slot (j, c) is accumulator c of its j-th tile. In bf16
// a k16 step is an mma.sync, in fp32 a CUDA-core loop over the same slots.

constexpr int MAXJ = 3 * MAX_HD / 8 / 2;   // n8-tiles per warp in launch A
// decoded projection: warp w owns rows DEC_ROWS w + [0, DEC_ROWS), lane
// owns columns lane + 32 c of the 3 hd
constexpr int DEC_ROWS = MAX_L / (NT / 32);
constexpr int DEC_COLS = 3 * MAX_HD / 32;

// shared-memory row of the staged slab and w^T: D plus 16 bytes, so the
// eight rows a warp's fragment loads touch fall in distinct banks
template <typename T>
__host__ __device__ constexpr int row_pad() { return 16 / (int)sizeof(T); }

template <typename T, bool DEC>
__global__ void __launch_bounds__(NT)
attention_phase(const T* __restrict__ s, const T* __restrict__ w3,
                const float* __restrict__ sc3, const float* __restrict__ auxp,
                const float* __restrict__ delta_p, float scale, Lif lif,
                int nt, int nb, int l, int d, int heads, int hd, int l_block,
                int c_block, int cp, T* __restrict__ ctx,
                int* __restrict__ counts) {
  using A = Act<T>;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int qd = heads * hd, nlb = (l + l_block - 1) / l_block;
  const int lw = (l + 31) / 32, n3 = 3 * hd, ntiles = n3 / 8;
  const int ldk = d + row_pad<T>(), vec = 16 / (int)sizeof(T);
  const float delta = *delta_p;

  extern __shared__ __align__(16) unsigned char dyn_a[];
  T* wt = (T*)dyn_a;                    // w3 head slice: [3 hd][ldk], transposed
                                        // (decoded: [D][3 hd])
  T* slab = wt + (size_t)n3 * ldk;      // [MAX_L][ldk]: one timestep's spikes
  __shared__ uint32_t qbits[MAX_L], kbits[MAX_L];          // [row] bits of hd
  __shared__ uint32_t vbits_t[MAX_HD * 2];                 // [col][L word]
  __shared__ uint32_t abits[MAX_L * 2];                    // [query][key word]
  __shared__ uint32_t key_mask[2], ctx_mask[2];  // live key columns
  __shared__ int row_live[MAX_L], blk_live[MAX_L], k_live[MAX_L],
      c_live[MAX_L], row_occ[MAX_L];
  __shared__ bool passes[MAX_HD + 1];  // binarized score of a count

  for (int i = tid; i < n3 * d; i += NT) {
    const int k = i / n3, n = i % n3;
    wt[DEC ? k * n3 + n : n * ldk + k] =
        w3[((size_t)(n / hd) * d + k) * qd + h * hd + n % hd];
  }
  for (int i = l * ldk + tid; i < MAX_L * ldk; i += NT) slab[i] = T(0.f);
  // a score is an integer count c <= hd; binarize each once:
  // fma32(c, scale, -delta) >= 0
  for (int c = tid; c <= hd; c += NT) passes[c] = fma32((float)c, scale, -delta) >= 0.f;

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int r_lo = (warp % 4) * 16 + g, jt0 = warp / 4;
  constexpr int AJ = DEC ? DEC_ROWS : MAXJ, AC = DEC ? DEC_COLS : 4;
  float u[AJ][AC] = {};       // LIF membranes of the thread's slots, across t
  int n_proj = 0, n_qkt = 0, n_qktv = 0;  // per L-block, thread tid < nlb

  for (int t = 0; t < nt; ++t) {
    const T* src = s + ((size_t)t * nb + b) * l * d;
    for (int i = tid; i < MAX_L; i += NT) {
      row_live[i] = 0;
      qbits[i] = kbits[i] = 0u;
    }
    for (int i = tid; i < MAX_L * 2; i += NT) abits[i] = 0u;
    for (int i = tid; i < MAX_HD * 2; i += NT) vbits_t[i] = 0u;
    __syncthreads();
    // stage the slab in 16-byte vectors; a row is live when any of its
    // values is non-zero (the sign bit masked: -0 is dark)
    const uint32_t mag = sizeof(T) == 2 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
    for (int i = tid; i < l * (d / vec); i += NT) {
      const int r = i / (d / vec), kv = i % (d / vec);
      const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * d + kv * vec);
      *reinterpret_cast<uint4*>(slab + (size_t)r * ldk + kv * vec) = v;
      if ((v.x | v.y | v.z | v.w) & mag) row_live[r] = 1;
    }
    __syncthreads();
    if (tid < nlb) {
      int any = 0;
      for (int r = tid * l_block; r < min(l, (tid + 1) * l_block); ++r) any |= row_live[r];
      blk_live[tid] = any;
    }
    __syncthreads();

    // epilogue of one projection slot: scale, BN, LIF -> spike bits (v
    // stored transposed)
    auto emit = [&](float a, float& uu, int r, int n) {
      const int p = n / hd, col = n % hd, ch = h * hd + col;
      float y = A::round(__fmul_rn(a, sc3[p * qd + ch]));
      y = A::round(bn_eval(y, auxp + (size_t)p * 4 * qd, qd, ch));
      if (!lif_step<T>(uu, y, lif)) return;
      if (p == 0) atomicOr(&qbits[r], 1u << col);
      else if (p == 1) atomicOr(&kbits[r], 1u << col);
      else atomicOr(&vbits_t[col * 2 + r / 32], 1u << (r % 32));
    };
    float acc[AJ][AC] = {};
    if constexpr (DEC) {
      // decoded q/k/v projection: each row's live spikes in ascending k
#pragma unroll
      for (int i = 0; i < DEC_ROWS; ++i) {
        const int r = warp * DEC_ROWS + i;
        if (r >= l) break;
        const T* srow = slab + (size_t)r * ldk;
        int occ = 0;
        for (int k0 = 0; k0 < d; k0 += 32) {
          uint32_t live = __ballot_sync(
              0xFFFFFFFFu, k0 + lane < d && A::load(srow + k0 + lane) != 0.f);
          occ += __popc(live);
          while (live) {
            const int k = k0 + __ffs(live) - 1;
            live &= live - 1u;
            const float a = A::load(srow + k);
            const T* wrow = wt + (size_t)k * n3;
#pragma unroll
            for (int c = 0; c < DEC_COLS; ++c) {
              const int n = lane + 32 * c;
              if (n < n3)
                acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a, A::load(wrow + n)));
            }
          }
        }
        if (lane == 0) row_occ[r] = occ;
      }
#pragma unroll
      for (int i = 0; i < DEC_ROWS; ++i) {
        const int r = warp * DEC_ROWS + i;
        if (r >= l) break;
#pragma unroll
        for (int c = 0; c < DEC_COLS; ++c)
          if (lane + 32 * c < n3) emit(acc[i][c], u[i][c], r, lane + 32 * c);
      }
    } else {
      // q/k/v projection; a warp whose rows all lie in dark L-blocks skips
      // its products (they would add exact zeros)
      bool warp_live = false;
      for (int r = (warp % 4) * 16; r < min(l, (warp % 4) * 16 + 16); ++r)
        warp_live |= blk_live[r / l_block] != 0;
      if (warp_live) {
        if constexpr (std::is_same<T, float>::value) {
          for (int k = 0; k < d; ++k) {
            const float a_lo = slab[r_lo * ldk + k], a_hi = slab[(r_lo + 8) * ldk + k];
#pragma unroll
            for (int j = 0; j < MAXJ; ++j) {
              const int jt = jt0 + 2 * j;
              if (jt >= ntiles) break;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float wv = wt[(jt * 8 + tig * 2 + c) * ldk + k];
                acc[j][c] = fmaf(a_lo, wv, acc[j][c]);
                acc[j][2 + c] = fmaf(a_hi, wv, acc[j][2 + c]);
              }
            }
          }
        } else {
          for (int k0 = 0; k0 < d; k0 += 16) {
            const T* pa = slab + r_lo * ldk + k0 + tig * 2;
            const uint32_t a[4] = {ld_pair(pa), ld_pair(pa + 8 * ldk),
                                   ld_pair(pa + 8), ld_pair(pa + 8 * ldk + 8)};
#pragma unroll
            for (int j = 0; j < MAXJ; ++j) {
              const int jt = jt0 + 2 * j;
              if (jt >= ntiles) break;
              const T* pb = wt + (jt * 8 + g) * ldk + k0 + tig * 2;
              mma_bf16(acc[j], a, ld_pair(pb), ld_pair(pb + 8));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int jt = jt0 + 2 * j;
        if (jt >= ntiles) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = r_lo + (c & 2) * 4;
          if (r < l) emit(acc[j][c], u[j][c], r, jt * 8 + tig * 2 + (c & 1));
        }
      }
    }
    __syncthreads();

    // key / value block occupancy; an all-dark key block scores zeros,
    // which binarize to zero unless delta <= 0
    if (tid < nlb) {
      const int r0 = tid * l_block, r1 = min(l, r0 + l_block);
      bool kany = false, vany = false;
      for (int r = r0; r < r1; ++r) kany |= kbits[r] != 0u;
      for (int w = 0; w < lw; ++w) {          // the block's rows in word w
        const int lo = max(r0, 32 * w), hi = min(r1, 32 * w + 32);
        if (lo >= hi) continue;
        const uint32_t m = (hi - lo == 32 ? ~0u : (1u << (hi - lo)) - 1u) << (lo - 32 * w);
        for (int cc = 0; cc < hd; ++cc) vany |= (vbits_t[cc * 2 + w] & m) != 0u;
      }
      const bool kl = kany || delta <= 0.f;
      k_live[tid] = kl;
      c_live[tid] = kl && vany;
      if constexpr (DEC) {   // executed chunks: ceil(capacity / c_block)
        int mx = 0;
        for (int r = r0; r < r1; ++r) mx = max(mx, row_occ[r]);
        n_proj += (min(pow2ceil(mx), cp) + c_block - 1) / c_block;
      } else {
        n_proj += blk_live[tid];
      }
      n_qkt += kl;
      n_qktv += kl && vany;
    }
    __syncthreads();
    if (tid < lw) {
      uint32_t km = 0u, cm = 0u;
      for (int jj = 0; jj < 32 && tid * 32 + jj < l; ++jj) {
        const int lb = (tid * 32 + jj) / l_block;
        km |= (uint32_t)k_live[lb] << jj;
        cm |= (uint32_t)c_live[lb] << jj;
      }
      key_mask[tid] = km;
      ctx_mask[tid] = cm;
    }
    __syncthreads();
    // scores: AND-popcount of q and k bits over live key blocks, binarized
    for (int w = tid; w < l * lw; w += NT) {
      const int i = w / lw, jw = w % lw;
      const uint32_t live = key_mask[jw], q = qbits[i];
      uint32_t word = 0u;
      for (int jj = 0; jj < 32; ++jj)
        if ((live >> jj & 1u) && passes[__popc(q & kbits[jw * 32 + jj])])
          word |= 1u << jj;
      abits[i * 2 + jw] = word;
    }
    __syncthreads();
    // context: popcount of score bits against value columns over live
    // key blocks (integer counts, exact in the activation dtype)
    for (int o = tid; o < l * hd; o += NT) {
      const int i = o / hd, cc = o % hd;
      int n = 0;
      for (int jw = 0; jw < lw; ++jw)
        n += __popc(abits[i * 2 + jw] & vbits_t[cc * 2 + jw] & ctx_mask[jw]);
      A::store(ctx + (((size_t)t * nb + b) * l + i) * qd + h * hd + cc, (float)n);
    }
    __syncthreads();
  }
  if (tid < nlb) {
    int* cnt = counts + (size_t)h * N_PHASES * nlb + tid;
    atomicAdd(cnt + 0 * nlb, n_proj);
    atomicAdd(cnt + 1 * nlb, n_proj);
    atomicAdd(cnt + 2 * nlb, n_proj);
    atomicAdd(cnt + 3 * nlb, n_qkt);
    atomicAdd(cnt + 4 * nlb, n_qktv);
  }
}

// ---------------------------------------------------------------------------
// launch B: wo + MLP, one block per (L-block, b)
// ---------------------------------------------------------------------------
//
// Each product is a 64-row x 64-column output tile accumulated over
// KC-deep K-chunks in ascending k, for all timesteps at once, so a weight
// chunk is staged once and serves every t. A thread owns 16 slots of the
// tile: warp w holds rows 16 (w % 4) + [0, 16) and columns 32 (w / 4) +
// [0, 32); slot q = 4 j + c is accumulator c of the warp's m16n8 tile j.
// In bf16 a chunk is KC / 16 tensor-core mma.sync steps (bf16 x bf16 -> fp32;
// spikes, integer counts and bf16 weights are exact operands); in fp32
// it is a CUDA-core loop over the same slots.

constexpr int MAX_T = 4;       // timesteps whose accumulators launch B holds
constexpr int LDS = KC + 8;    // padded row of the staged A and W^T tiles

__device__ __forceinline__ int slot_row(int q) {
  return (threadIdx.x / 32 % 4) * 16 + threadIdx.x % 32 / 4 + (q & 2) * 4;
}

__device__ __forceinline__ int slot_col(int q) {
  return threadIdx.x / 128 * 32 + q / 4 * 8 + threadIdx.x % 4 * 2 + (q & 1);
}

// One KC x TILE chunk of a row-major weight W[k][c], in flight through
// registers: each thread holds NV 16-byte vectors of it. `load` reads
// W[k0:k0+KC, c0:c0+TILE] (zero outside k_dim x ncols; ldw, c0 and ncols
// are multiples of a vector); `store` writes it to shared memory, bf16 as
// the transposed tile W^T[TILE][LDS], fp32 as W[KC][TILE].
template <typename T>
struct WeightChunk {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int NV = KC * TILE / VEC / NT;
  uint4 v[NV];

  __device__ __forceinline__ void load(const T* __restrict__ w, int ldw,
                                       int k0, int k_dim, int c0, int ncols) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int kk = idx / (TILE / VEC), cc = idx % (TILE / VEC) * VEC;
      v[i] = k0 + kk < k_dim && c0 + cc < ncols
          ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * ldw + c0 + cc)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(void* buf) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int kk = idx / (TILE / VEC), cc = idx % (TILE / VEC) * VEC;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<uint4*>((float*)buf + kk * TILE + cc) = v[i];
      } else {
        const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
        for (int q = 0; q < VEC; ++q) ((T*)buf)[(cc + q) * LDS + kk] = e[q];
      }
    }
  }
};

// Runs body(k0, mask) over the K-chunks k0 = 0, KC, ... whose timestep
// mask live(k0) is non-zero, in ascending order, with W[k0] staged in
// `wbuf`; the next live chunk's weights are read into registers while
// body runs, so their latency hides behind the products. live() and body
// are uniform over the block.
template <typename T, class Live, class Body>
__device__ __forceinline__ void chunk_loop(int k_dim, const T* __restrict__ w,
                                           int ldw, int c0, int ncols,
                                           Live live, Body body, void* wbuf) {
  auto next = [&](int k0) {
    while (k0 < k_dim && !live(k0)) k0 += KC;
    return k0;
  };
  WeightChunk<T> chunk;
  int k0 = next(0);
  if (k0 < k_dim) chunk.load(w, ldw, k0, k_dim, c0, ncols);
  while (k0 < k_dim) {
    const int k1 = next(k0 + KC);
    __syncthreads();                    // the previous chunk is consumed
    chunk.store(wbuf);
    if (k1 < k_dim) chunk.load(w, ldw, k1, k_dim, c0, ncols);
    __syncthreads();
    body(k0, live(k0));
    k0 = k1;
  }
}

// stage A[0:TILE, k0:k0+KC] of a row-major (n, k_dim) matrix as [TILE][LDS]
template <typename T>
__device__ __forceinline__ void stage_a(const T* __restrict__ a, int k_dim,
                                        int n, int k0, void* buf) {
  for (int i = threadIdx.x; i < TILE * KC; i += NT) {
    const int r = i / KC, kk = i % KC;
    const bool in = r < n && k0 + kk < k_dim;
    if constexpr (std::is_same<T, float>::value)
      ((float*)buf)[r * LDS + kk] = in ? a[(size_t)r * k_dim + k0 + kk] : 0.f;
    else
      ((T*)buf)[r * LDS + kk] = in ? a[(size_t)r * k_dim + k0 + kk]
                                   : __float2bfloat16_rn(0.f);
  }
}

// acc += A[:, k0:k0+KC] W[k0:k0+KC, tile] for one timestep; A is the staged
// tile `a_tile`, or, when `a_bits` is set, spike bits (`wpr` words a row)
template <typename T>
__device__ __forceinline__ void chunk_product(float (&acc)[16],
                                              const void* wbuf,
                                              const void* a_tile,
                                              const uint32_t* a_bits, int wpr,
                                              int k0) {
  const int g = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  const int r_lo = slot_row(0), cw = threadIdx.x / 128 * 32;
  if constexpr (std::is_same<T, float>::value) {
    const float* ws = (const float*)wbuf;
    const float* as = (const float*)a_tile;
    for (int kk = 0; kk < KC; ++kk) {
      float a_lo, a_hi;
      if (a_bits) {
        const int k = k0 + kk;
        a_lo = (float)((a_bits[r_lo * wpr + k / 32] >> (k % 32)) & 1u);
        a_hi = (float)((a_bits[(r_lo + 8) * wpr + k / 32] >> (k % 32)) & 1u);
      } else {
        a_lo = as[r_lo * LDS + kk];
        a_hi = as[(r_lo + 8) * LDS + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float wv = ws[kk * TILE + cw + j * 8 + tig * 2 + c];
          acc[4 * j + c] = fmaf(a_lo, wv, acc[4 * j + c]);
          acc[4 * j + 2 + c] = fmaf(a_hi, wv, acc[4 * j + 2 + c]);
        }
    }
  } else {
    const T* wt = (const T*)wbuf;
    const T* as = (const T*)a_tile;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      if (a_bits) {
        const int word = k0 / 32 + ks / 2;
        const uint32_t lo = a_bits[r_lo * wpr + word];
        const uint32_t hi = a_bits[(r_lo + 8) * wpr + word];
        const int bit = ks % 2 * 16 + tig * 2;
        a[0] = bit_pair(lo, bit);
        a[1] = bit_pair(hi, bit);
        a[2] = bit_pair(lo, bit + 8);
        a[3] = bit_pair(hi, bit + 8);
      } else {
        const T* p = as + r_lo * LDS + ks * 16 + tig * 2;
        a[0] = ld_pair(p);
        a[1] = ld_pair(p + 8 * LDS);
        a[2] = ld_pair(p + 8);
        a[3] = ld_pair(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* p = wt + (cw + j * 8 + g) * LDS + ks * 16 + tig * 2;
        mma_bf16(acc + 4 * j, a, ld_pair(p), ld_pair(p + 8));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_phase(const T* __restrict__ x, const T* __restrict__ ctx,
          const T* __restrict__ wo, const T* __restrict__ w1,
          const T* __restrict__ w2, const float* __restrict__ sco,
          const float* __restrict__ sc1, const float* __restrict__ sc2,
          const float* __restrict__ auxo, const float* __restrict__ aux1,
          const float* __restrict__ aux2, Lif lif, int nt, int nb, int l,
          int d, int heads, int hd, int ff, int l_block, T* __restrict__ out,
          int* __restrict__ counts) {
  using A = Act<T>;
  const int lb = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int r0 = lb * l_block, n = min(l, r0 + l_block) - r0;
  const int qd = heads * hd, ffc = ff / heads, nlb = gridDim.x;
  const int dw = (d + 31) / 32, fw = (ff + 31) / 32;

  extern __shared__ uint32_t dyn[];
  uint32_t* s2bits = dyn;                            // [t][TILE][dw]
  uint32_t* hbits = s2bits + (size_t)nt * TILE * dw;  // [t][TILE][fw]
  int* head_live = (int*)(hbits + (size_t)nt * TILE * fw);  // [t][heads]
  int* hid_live = head_live + nt * heads;            // [t][heads]
  int* s2_live = hid_live + nt * heads;              // [t]
  __shared__ __align__(16) float wbuf[KC * TILE];    // weight chunk
  __shared__ __align__(16) float abuf[TILE * LDS];   // context chunk

  const size_t nwords = (size_t)nt * TILE * (dw + fw) + (size_t)nt * (2 * heads + 1);
  for (size_t i = tid; i < nwords; i += NT) dyn[i] = 0u;
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const T* ctx_t = ctx + (((size_t)t * nb + b) * l + r0) * qd;
    for (int i = tid; i < n * qd; i += NT)
      if (A::load(ctx_t + i) != 0.f) head_live[t * heads + (i % qd) / hd] = 1;
  }
  __syncthreads();

  // wo: the sum over heads in order (dark head blocks skipped), then
  // scale, bn_o, residual (x1 parked in `out`) and the input LIF
  for (int c0 = 0; c0 < d; c0 += TILE) {
    float acc[MAX_T][16] = {}, u[16] = {};
    chunk_loop<T>(
        qd, wo, d, c0, d,
        [&](int k0) {                      // bit t: some head of the chunk lit
          int live = 0;
          for (int t = 0; t < nt; ++t)
            for (int hh = k0 / hd; hh <= (min(k0 + KC, qd) - 1) / hd; ++hh)
              if (head_live[t * heads + hh]) live |= 1 << t;
          return live;
        },
        [&](int k0, int live) {
#pragma unroll
          for (int t = 0; t < MAX_T; ++t) {
            if (!(live >> t & 1)) continue;
            __syncthreads();
            stage_a<T>(ctx + (((size_t)t * nb + b) * l + r0) * qd, qd, n, k0,
                       abuf);
            __syncthreads();
            chunk_product<T>(acc[t], wbuf, abuf, nullptr, 0, k0);
          }
        },
        wbuf);
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t >= nt) break;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = slot_row(q), c = c0 + slot_col(q);
        if (r >= n || c >= d) continue;
        float y = A::round(__fmul_rn(acc[t][q], sco[c]));
        y = A::round(bn_eval(y, auxo, d, c));
        const size_t off = (((size_t)t * nb + b) * l + r0 + r) * d + c;
        const float x1 = A::round(__fadd_rn(A::load(x + off), y));
        A::store(out + off, x1);
        if (lif_step<T>(u[q], x1, lif)) {
          atomicOr(&s2bits[((size_t)t * TILE + r) * dw + c / 32], 1u << (c % 32));
          s2_live[t] = 1;
        }
      }
    }
  }
  __syncthreads();

  // up, per ff-chunk: s2 spikes x w1 chunk, then scale, bn_1, LIF
  int s2_mask = 0;
  for (int t = 0; t < nt; ++t) s2_mask |= s2_live[t] << t;
  for (int hh = 0; hh < heads; ++hh)
    for (int c0 = 0; c0 < ffc; c0 += TILE) {
      float acc[MAX_T][16] = {}, u[16] = {};
      chunk_loop<T>(
          d, w1 + hh * ffc, ff, c0, ffc, [&](int) { return s2_mask; },
          [&](int k0, int live) {
#pragma unroll
            for (int t = 0; t < MAX_T; ++t)
              if (live >> t & 1)
                chunk_product<T>(acc[t], wbuf, nullptr,
                                 s2bits + (size_t)t * TILE * dw, dw, k0);
          },
          wbuf);
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t >= nt) break;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int r = slot_row(q), cc = c0 + slot_col(q);
          if (r >= n || cc >= ffc) continue;
          const int f = hh * ffc + cc;
          float y = A::round(__fmul_rn(acc[t][q], sc1[f]));
          y = A::round(bn_eval(y, aux1, ff, f));
          if (lif_step<T>(u[q], y, lif)) {
            atomicOr(&hbits[((size_t)t * TILE + r) * fw + f / 32], 1u << (f % 32));
            hid_live[t * heads + hh] = 1;
          }
        }
      }
    }
  __syncthreads();

  // down: the sum over ff-chunks in order (dark chunk blocks skipped),
  // then scale, bn_2 and the residual
  for (int c0 = 0; c0 < d; c0 += TILE) {
    float acc[MAX_T][16] = {};
    chunk_loop<T>(
        ff, w2, d, c0, d,
        [&](int k0) {                      // bit t: some ff-chunk of it lit
          int live = 0;
          for (int t = 0; t < nt; ++t)
            for (int hh = k0 / ffc; hh <= (min(k0 + KC, ff) - 1) / ffc; ++hh)
              if (hid_live[t * heads + hh]) live |= 1 << t;
          return live;
        },
        [&](int k0, int live) {
#pragma unroll
          for (int t = 0; t < MAX_T; ++t)
            if (live >> t & 1)
              chunk_product<T>(acc[t], wbuf, nullptr,
                               hbits + (size_t)t * TILE * fw, fw, k0);
        },
        wbuf);
#pragma unroll
    for (int t = 0; t < MAX_T; ++t) {
      if (t >= nt) break;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = slot_row(q), c = c0 + slot_col(q);
        if (r >= n || c >= d) continue;
        float y = A::round(__fmul_rn(acc[t][q], sc2[c]));
        y = A::round(bn_eval(y, aux2, d, c));
        const size_t off = (((size_t)t * nb + b) * l + r0 + r) * d + c;
        A::store(out + off, A::round(__fadd_rn(A::load(out + off), y)));
      }
    }
  }

  if (tid < heads) {
    int n_wo = 0, n_up = 0, n_down = 0;
    for (int t = 0; t < nt; ++t) {
      n_wo += head_live[t * heads + tid];
      n_up += s2_live[t];
      n_down += hid_live[t * heads + tid];
    }
    int* cnt = counts + (size_t)tid * N_PHASES * nlb + lb;
    atomicAdd(cnt + 5 * nlb, n_wo);
    atomicAdd(cnt + 6 * nlb, n_up);
    atomicAdd(cnt + 7 * nlb, n_down);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* s, const void* w3,
                   const void* wo, const void* w1, const void* w2,
                   const float* sc3, const float* sco, const float* sc1,
                   const float* sc2, const float* auxp, const float* auxo,
                   const float* aux1, const float* aux2, const float* delta,
                   float scale, Lif lif, int nt, int nb, int l, int d,
                   int heads, int hd, int ff, int l_block, int decoded,
                   int c_block, int cp, void* ctx, void* out, int* counts,
                   cudaStream_t stream) {
  const int nlb = (l + l_block - 1) / l_block;
  const size_t dyn_a = (size_t)(3 * hd + MAX_L) * (d + row_pad<T>()) * sizeof(T);
  const size_t dyn = 4 * ((size_t)nt * TILE * ((d + 31) / 32 + (ff + 31) / 32) +
                          (size_t)nt * (2 * heads + 1));
  auto attention = decoded ? attention_phase<T, true> : attention_phase<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      attention, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      mlp_phase<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  attention<<<dim3(heads, nb), NT, dyn_a, stream>>>(
      (const T*)s, (const T*)w3, sc3, auxp, delta, scale, lif, nt, nb, l, d,
      heads, hd, l_block, c_block, cp, (T*)ctx, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_phase<T><<<dim3(nlb, nb), NT, dyn, stream>>>(
      (const T*)x, (const T*)ctx, (const T*)wo, (const T*)w1, (const T*)w2,
      sco, sc1, sc2, auxo, aux1, aux2, lif, nt, nb, l, d, heads, hd, ff,
      l_block, (T*)out, counts);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; decoded: the decoded q/k/v
// projections with chunks of c_block compacted slots and padded width cp.
// Returns a cudaError_t (0 = success).
extern "C" int fused_layer_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, int nt, int nb, int l, int d,
    int heads, int hd, int ff, int l_block, int decoded, int c_block, int cp,
    void* ctx, void* out, void* counts, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  const auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return launch<float>(x, s, w3, wo, w1, w2, f(sc3), f(sco), f(sc1),
                         f(sc2), f(auxp), f(auxo), f(aux1), f(aux2), f(delta),
                         scale, lif, nt, nb, l, d, heads, hd, ff, l_block,
                         decoded, c_block, cp, ctx, out, (int*)counts,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        x, s, w3, wo, w1, w2, f(sc3), f(sco), f(sc1), f(sc2), f(auxp),
        f(auxo), f(aux1), f(aux2), f(delta), scale, lif, nt, nb, l, d, heads,
        hd, ff, l_block, decoded, c_block, cp, ctx, out, (int*)counts,
        (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_layer_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
