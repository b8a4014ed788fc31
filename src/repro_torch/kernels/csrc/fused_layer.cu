// Fused layer program of the dual-engine overlay, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_layer.py::fused_layer (the Pallas
// kernel `_kernel`, grid (B, 8 phases, H)), not pipelined, for both
// epilogue families:
//   bn   (the vision family's eval layer, sparse='tile' or 'decoded'):
//        q/k/v spike projections + BN + LIF, binarized scores, context,
//        wo + bn_o + residual + input LIF, up + bn_1 + LIF, down + bn_2 +
//        residual;
//   rope (the token family's layer, sparse='tile', causal): q/k/v
//        projections of the analog ln1 output + RoPE on q and k + LIF,
//        causal binarized scores, context, wo + residual + ln2 rmsnorm,
//        up of the analog ln2 output + LIF, down + residual; no BN;
// and the (H, 8, n_l_blocks) map of executed sub-blocks.
//
// What bounds it: at Spikingformer-4-256 (T=4, B=64, L=64, D=256, H=8,
// hd=32, F=1024) the layer is about 13.4 G multiply-adds of {0,1} spikes
// (or small integer counts) against weights, on ~25 MB of input and
// output, so it is bound by operations (~27 us at the bf16 tensor-core
// peak against ~8 us for the bytes); spikingformer-lm's prefill at B=8,
// L=512 is of the same size, and Spikingformer-8-512 (T=4, L=196, D=512,
// hd=64, F=2048) does ~8x the work a batch row. In bf16 both launches run
// their spike and count products on the tensor cores with mma.sync (fp32
// keeps CUDA-core loops); launch B stages each weight chunk once for all
// timesteps and reads the next chunk into registers while the current
// one's products run. The rope family's two analog products (q/k/v of
// ln1, up of ln2) are CUDA-core loops in ascending k in both dtypes: an
// analog sum is exact in no order, and this one is the plain version's,
// so kernel and plain version agree bitwise. wgmma / TMA pipelines are
// later work.
//
// Design. The TPU grid keeps every head's q/k/v spikes for all T in
// VMEM (~786 KB at full width), which no SM can hold. The layer is split
// into two launches instead:
//   A. attention_phase, one block per (head, b): the sequence in tiles of
//      64 rows, each (t, tile) slab staged in shared memory and projected
//      (dark rows skipped) against the head's w3 slice, which streams
//      through shared memory in 64-deep K-chunks (the whole 3 hd x D
//      slice, 200 KB in bf16 at hd=64, D=512, would not fit beside the
//      slab); the epilogue (scale, BN or RoPE, LIF with the membrane in
//      registers across t) emits spikes as bits kept for the whole
//      sequence (one or two 32-bit words a row for q and k, as head_dim
//      is up to 32 or up to 64); then per timestep one warp a query row
//      scores 32 keys a ballot (AND-popcount of q and k bits, binarized,
//      causal or not) and counts the context against the transposed
//      value bits. Spikes never leave shared memory; the context (integer
//      counts) goes to a (T, B, L, H*hd) scratch.
//   B. mlp_phase, one block per 64-row tile of an L-block and b: wo as
//      one fixed-order fp32 sum over heads, then scale, then bn_o,
//      residual (x1 is parked in the output) and the input LIF into bit
//      planes (bn), or residual and ln2 into a (T, B, L, D) scratch
//      (rope); up per ff-chunk + bn_1 + LIF into hidden bit planes; down
//      as one fixed-order sum over chunks + bn_2 + residual. Spike
//      operands are expanded from the bit planes straight into mma
//      fragments. Every predicate of the counts is evaluated on the whole
//      L-block (the tiles of one L-block merge their flags with atomicOr,
//      and the last of them to arrive counts), so the counts are those
//      of the TPU kernel.
// Counts are summed with int32 atomicAdd (order-free); no float atomics.
//
// The SSA bundle kernel (src/repro/kernels/fused_ssa.py::fused_ssa, body
// `_kernel`, grid (B, H, 4), both families) is launch A alone
// (fused_ssa_forward): its q/k/v projections, scale, BN (bn) or RoPE on q
// and k (rope), LIF and binarized attention (causal for rope) are
// exactly the bundle's, and its context is the bundle's output. It runs
// with one L-block a sequence (l_block = L), so a timestep's block flag
// is the TPU kernel's whole-slab occupancy test, and writes the bundle's
// (H, 4) map instead of the layer's: q, k and v add the timesteps whose
// (L, D) slab is live, attend adds 2 T, per b.
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
// q/k/v weights (the K-chunk staged untransposed, [KA][3 hd]) with one
// fp32 product and one fp32 sum, three columns a lane per 32 of head_dim.
// Chunks of c_block slots at or past an L-block's capacity hold no live
// spike, so they are skipped by construction; the executed chunks,
// ceil(capacity / c_block) per (t, b, L-block), go to the q/k/v counts.
// The epilogue and launch B are the tile variant's. It is CUDA-core work in both dtypes: the sum order
// is the plain version's, so the variant is bitwise equal to its plain
// version for any weights, and to the tile variant on dyadic weights.
//
// The pipeline variant (overlap='pipeline'; `_kernel` with pipeline=True,
// grid (B, T, 8, H), its LIF membranes riding VMEM scratch across the T
// axis) is the same two launches run once per timestep, A_0, B_0, A_1,
// B_1, ... on one stream (fused_layer_pipeline_forward): each launch sees
// one timestep (nt = 1, its operands offset to timestep t), so launch A
// keeps one timestep's bits and launch B one timestep's accumulators (no
// MAX_T). The membranes move between launches through device scratch in
// the activation dtype, where LIF keeps them exactly: q/k/v (B, L, 3 H hd),
// the input neuron (B, L, D), the MLP hidden layer (B, L, F); a launch
// reads them at t > 0 and starts from zero at t = 0, as the TPU kernel's
// `_lif` does. The counts are added per timestep and launch B's flag
// words are kept per timestep, so outputs and counts equal the fused
// variant's bitwise. It moves the membranes through device memory twice
// a timestep more than #1 and makes 2 T launches instead of 2.
//
// Analog scores (binarize_scores=False, Spikformer's raw SSA: the Pallas
// kernels' `a = sc` branch, fused_layer.py:232-235 with the always-live
// score predicate of `_qkt_live`, fused_ssa.py:152-155) are launch A's
// AN instantiation, a template flag, so the binarized kernels keep their
// code. A score is still the AND-popcount count c of a query's and a
// key's bits, now rounded once as fl(c * scale); the context of query i
// and column col is the fp32 sum of the scores of the keys whose value
// bit is set, in ascending key order, one __fadd_rn a term (the plain
// version's order, fused_ssa.analog_context, and spike_attention.cu's),
// on CUDA cores: a warp ballots the live keys of a 32-key word, then
// visits them in ascending order, each key's score broadcast from its
// lane with a shuffle, so no shared memory is added. Every key block is
// live for the score phase (n_qkt counts all of them); a context block
// when its value rows are not all dark. Launch B's wo then takes an
// analog left operand, exact in no order: it is summed in ascending k on
// CUDA cores (chunk_product's ANALOG path, the rope family's `up`),
// chosen per chunk by a block-uniform flag outside the k loop.
//
// Rounding follows the plain version (kernels/fused_layer.py) step by
// step: fp32 accumulation, cast to the activation dtype, BN as
// (y - mean) * inv_std rounded and then fma32 (a float64 product and sum
// rounded once, XLA's contracted FMA), RoPE as fma32(x1, cos, -(x2 sin))
// and fma32(x2, cos, x1 sin) (XLA's contraction), ln2's sum of squares as
// a pairwise tree and its rsqrt as a float64 1 / sqrt rounded once, LIF
// and the residual in the activation dtype, each product and sum rounded
// with __fmul_rn / __fadd_rn so nvcc contracts nothing the plain version
// rounds apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;      // threads per block, both launches
constexpr int KC = 64;       // launch B contraction chunk, staged in shared memory
constexpr int L_TILE = 64;   // rows of a launch A slab
constexpr int MAX_D = 1024;  // rope: launch B's rmsnorm holds a row in registers
constexpr int MAX_HD = 64;   // q/k spikes of a row fit two 32-bit words
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

// the two bf16 values of a pair (element k in the low half) as floats
__device__ __forceinline__ float pair_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float pair_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
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
// The sequence is walked in tiles of 64 rows (outer) and timesteps
// (inner), so the LIF membranes of a tile's slots stay in registers
// across t; each (t, tile) spike slab is staged in shared memory and
// projected against the head's slice of w3 in ka-deep K-chunks in
// ascending k (transposed to [3 hd][ka + pad]; decoded: [ka][3 hd]). The
// host picks ka = D, the whole slice staged once a block, when it fits
// beside the slab and the sequence's bits, and else streams KA-deep
// chunks through shared memory for every (t, tile), so no block has to
// hold the 3 hd x D slice (200 KB in bf16 at hd=64, D=512). The q/k/v
// spikes are kept as bits for the whole sequence ([t][row][HW] words
// of hd bits for q and k, [t][column][row word] for v). After the last
// tile, per timestep: the block occupancies, then one warp per query row
// scores a 32-key word with a ballot and adds the context counts of its
// lanes' columns.
//
// Projection: an (L x D) x (D x 3 hd) product; warp w owns rows
// 16 (w % 4) + [0, 16) of the tile and the n8-tiles w / 4, w / 4 + 2, ...
// of the 3 hd columns; slot (j, c) is accumulator c of its j-th tile. For
// spikes in bf16 a k16 step is an mma.sync; in fp32, and for the rope
// family's analog input in both dtypes, a CUDA-core loop over the same
// slots in ascending k (the rope family's sum is one fp32 product and one
// fp32 sum a term, the plain version's order, since analog sums are not
// exact in any order). Chunking K keeps each slot's order of summation:
// the chunks run in ascending k and each continues the slot's sum.
//
// HW, the 32-bit words of a row's q (or k) bits, is a template argument
// (1 for head_dim <= 32, 2 up to MAX_HD): it sizes the register arrays,
// so the head_dim <= 32 instantiation keeps its registers.

constexpr int KA = 64;       // launch A's streamed w3 K-chunk
// launch A's dynamic shared memory limit: the block's 227 KB less its
// static arrays
constexpr size_t SMEM_A_LIMIT = 232448 - 512;

template <int HW> struct AShape {
  static constexpr int MAXJ = 3 * 32 * HW / 8 / 2;   // n8-tiles per warp
  // decoded projection: warp w owns rows DEC_ROWS w + [0, DEC_ROWS), lane
  // owns columns lane + 32 c of the 3 hd
  static constexpr int DEC_ROWS = L_TILE / (NT / 32);
  static constexpr int DEC_COLS = 3 * HW;
};

// shared-memory row of the staged slab and of a transposed w3 chunk: 16
// bytes of padding, so the eight rows a warp's fragment loads touch fall
// in distinct banks
template <typename T>
__host__ __device__ constexpr int row_pad() { return 16 / (int)sizeof(T); }

// launch A's dynamic shared memory with w3 chunks ka deep, carved in this
// order (host and device)
struct SmemA {
  size_t slab, wt, qbits, kbits, vbits, keym, ctxm, blkv, total;
  __host__ __device__ SmemA(int tsize, int nt, int l, int d, int hd, int nlb,
                            int ka) {
    const int n3 = 3 * hd, ldk = d + 16 / tsize, lw = (l + 31) / 32;
    const int hw = (hd + 31) / 32;
    const size_t slab_row = (size_t)ldk * tsize > (size_t)n3 * 4 ? (size_t)ldk * tsize
                                                                  : (size_t)n3 * 4;
    slab = 0;
    wt = slab + L_TILE * slab_row;
    qbits = wt + (size_t)n3 * (ka * tsize + 16);
    kbits = qbits + (size_t)nt * l * hw * 4;
    vbits = kbits + (size_t)nt * l * hw * 4;
    keym = vbits + (size_t)nt * hd * lw * 4;
    ctxm = keym + (size_t)nt * lw * 4;
    blkv = ctxm + (size_t)nt * lw * 4;
    total = blkv + (size_t)nt * nlb * 4;
  }
};

// launch A's K-chunk depth: the whole slice (staged once a block) when
// it fits, else KA
inline int chunk_depth(int tsize, int nt, int l, int d, int hd, int nlb) {
  return d <= KA || SmemA(tsize, nt, l, d, hd, nlb, d).total <= SMEM_A_LIMIT ? d
                                                                          : KA;
}

// rows [k0, k0 + kc) of the head's w3 slice into wt, in 16-byte loads:
// transposed to [3 hd][lda] (tile and rope), or [kc][3 hd] (decoded);
// consecutive threads take consecutive k
template <typename T, bool DEC>
__device__ __forceinline__ void stage_w3(const T* __restrict__ w3, T* wt,
                                         int h, int d, int qd, int hd,
                                         int k0, int kc, int lda) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = hd / VEC;               // vectors in a row of a head's slice
  for (int i = threadIdx.x; i < 3 * nv * kc; i += NT) {
    const int k = i % kc, r = i / kc, p = r / nv, c = r % nv * VEC;
    const uint4 v = *reinterpret_cast<const uint4*>(
        w3 + ((size_t)p * d + k0 + k) * qd + h * hd + c);
    if constexpr (DEC) {
      *reinterpret_cast<uint4*>(wt + (size_t)k * 3 * hd + p * hd + c) = v;
    } else {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) wt[(p * hd + c + q) * lda + k] = e[q];
    }
  }
}

template <typename T, bool DEC, bool ROPE, int HW, bool AN>
__global__ void __launch_bounds__(NT)
attention_phase(const T* __restrict__ s, const T* __restrict__ w3,
                const float* __restrict__ sc3, const float* __restrict__ auxp,
                const float* __restrict__ delta_p, float scale, Lif lif,
                int causal, int nt, int nb, int l, int d, int heads, int hd,
                int l_block, int c_block, int cp, int ssa, int ka,
                T* __restrict__ ctx, int* __restrict__ counts,
                T* __restrict__ memb, int carry) {
  using A = Act<T>;
  using S = AShape<HW>;
  constexpr int MAXJ = S::MAXJ, DEC_ROWS = S::DEC_ROWS, DEC_COLS = S::DEC_COLS;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int qd = heads * hd, nlb = (l + l_block - 1) / l_block;
  const int lw = (l + 31) / 32, n3 = 3 * hd, ntiles = n3 / 8, half = hd / 2;
  const int ldk = d + row_pad<T>(), lda = ka + row_pad<T>(), vec = 16 / (int)sizeof(T);
  const float delta = *delta_p;

  extern __shared__ __align__(16) unsigned char dyn_a[];
  const SmemA lay(sizeof(T), nt, l, d, hd, nlb, ka);
  T* slab = (T*)(dyn_a + lay.slab);     // [L_TILE][ldk]: one (t, tile) slab
  float* yproj = (float*)slab;          // rope: [L_TILE][3 hd] scaled projections
  T* wt = (T*)(dyn_a + lay.wt);         // w3 K-chunk of the head: [3 hd][lda],
                                        // transposed (decoded: [ka][3 hd])
  uint32_t* qbits = (uint32_t*)(dyn_a + lay.qbits);   // [t][row][HW] bits of hd
  uint32_t* kbits = (uint32_t*)(dyn_a + lay.kbits);
  uint32_t* vbits_t = (uint32_t*)(dyn_a + lay.vbits); // [t][col][row word]
  uint32_t* key_mask = (uint32_t*)(dyn_a + lay.keym); // [t][row word]: live keys
  uint32_t* ctx_mask = (uint32_t*)(dyn_a + lay.ctxm); // [t][row word]: live contexts
  int* blkv = (int*)(dyn_a + lay.blkv);  // [t][L-block]: live (tile) / max occupancy
  __shared__ int row_live[L_TILE];
  __shared__ bool passes[MAX_HD + 1];  // binarized score of a count

  const size_t nwords = (lay.total - lay.qbits) / 4;
  for (size_t i = tid; i < nwords; i += NT) qbits[i] = 0u;
  // a score is an integer count c <= hd; binarize each once:
  // fma32(c, scale, -delta) >= 0
  for (int c = tid; c <= hd; c += NT) passes[c] = fma32((float)c, scale, -delta) >= 0.f;

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int r_lo = (warp % 4) * 16 + g, jt0 = warp / 4;
  constexpr int AJ = DEC ? DEC_ROWS : MAXJ, AC = DEC ? DEC_COLS : 4;
  const uint32_t mag = sizeof(T) == 2 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
  // a chunk as deep as D is the whole slice: staged once, before the
  // first projection (block-uniform)
  const bool resident = ka >= d;
  bool staged = false;
  // the pipeline variant's membrane scratch (memb, (B, L, 3 qd)): slot
  // (i, c) of the thread holds tile row r and column n of the 3 hd (the
  // slots `emit` is handed below); read when carry, written back after
  // the launch's timestep
  auto membranes = [&](float (&u)[AJ][AC], int r0, int nr, bool load) {
#pragma unroll
    for (int i = 0; i < AJ; ++i)
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        int r, n;
        if constexpr (DEC) {
          r = warp * DEC_ROWS + i;
          n = lane + 32 * c;
          if (r >= nr || n >= n3) continue;
        } else {
          const int jt = jt0 + 2 * i;
          r = r_lo + (c & 2) * 4;
          n = jt * 8 + tig * 2 + (c & 1);
          if (jt >= ntiles || r >= nr) continue;
        }
        T* p = memb + ((size_t)b * l + r0 + r) * 3 * qd + (n / hd) * qd + h * hd + n % hd;
        if (load)
          u[i][c] = A::load(p);
        else
          A::store(p, u[i][c]);
      }
  };

  for (int r0 = 0; r0 < l; r0 += L_TILE) {
    const int nr = min(L_TILE, l - r0);
    float u[AJ][AC] = {};       // LIF membranes of the thread's slots, across t
    if (memb && carry) membranes(u, r0, nr, true);
    for (int t = 0; t < nt; ++t) {
      const T* src = s + (((size_t)t * nb + b) * l + r0) * d;
      __syncthreads();          // the previous slab (and yproj) is consumed
      for (int i = tid; i < L_TILE; i += NT) row_live[i] = 0;
      for (int i = nr * ldk + tid; i < L_TILE * ldk; i += NT) slab[i] = T(0.f);
      __syncthreads();
      // stage the slab in 16-byte vectors; a row is live when any of its
      // values is non-zero (the sign bit masked: -0 is dark)
      for (int i = tid; i < nr * (d / vec); i += NT) {
        const int r = i / (d / vec), kv = i % (d / vec);
        const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * d + kv * vec);
        *reinterpret_cast<uint4*>(slab + (size_t)r * ldk + kv * vec) = v;
        if ((v.x | v.y | v.z | v.w) & mag) row_live[r] = 1;
      }
      __syncthreads();
      if (!DEC)
        for (int r = tid; r < nr; r += NT)
          if (row_live[r]) atomicOr(&blkv[t * nlb + (r0 + r) / l_block], 1);

      // epilogue of one projection slot of row r (tile row) and column n:
      // LIF -> spike bits (v stored transposed)
      auto emit = [&](float y, float& uu, int r, int n) {
        const int p = n / hd, col = n % hd, row = r0 + r;
        if (!lif_step<T>(uu, y, lif)) return;
        if (p == 0)
          atomicOr(&qbits[((size_t)t * l + row) * HW + col / 32], 1u << (col % 32));
        else if (p == 1)
          atomicOr(&kbits[((size_t)t * l + row) * HW + col / 32], 1u << (col % 32));
        else
          atomicOr(&vbits_t[((size_t)t * hd + col) * lw + row / 32], 1u << (row % 32));
      };
      // the projection epilogue before the LIF: scale, cast, BN
      auto bn_proj = [&](float a, int n) {
        const int p = n / hd, ch = h * hd + n % hd;
        const float y = A::round(__fmul_rn(a, sc3[p * qd + ch]));
        return A::round(bn_eval(y, auxp + (size_t)p * 4 * qd, qd, ch));
      };
      // a warp whose rows are all dark skips its tile products (they
      // would add exact zeros)
      bool warp_live = false;
      if (!DEC)
        for (int r = (warp % 4) * 16; r < min(nr, (warp % 4) * 16 + 16); ++r)
          warp_live |= row_live[r] != 0;
      float acc[AJ][AC] = {};
      int occ[DEC ? DEC_ROWS : 1] = {};   // decoded: live spikes of each row

      // the head's w3 slice, ka rows of K at a time, in ascending k
      for (int k0 = 0; k0 < d; k0 += ka) {
        const int kc = min(ka, d - k0);
        if (!resident || !staged) {
          __syncthreads();      // the previous chunk is consumed
          stage_w3<T, DEC>(w3, wt, h, d, qd, hd, k0, kc, lda);
          __syncthreads();
          staged = true;
        }
        if constexpr (DEC) {
          // decoded q/k/v projection: each row's live spikes in ascending
          // k, the chunk's share of them
#pragma unroll
          for (int i = 0; i < DEC_ROWS; ++i) {
            const int r = warp * DEC_ROWS + i;
            if (r >= nr) break;
            const T* srow = slab + (size_t)r * ldk;
            for (int kb = k0; kb < k0 + kc; kb += 32) {
              uint32_t live = __ballot_sync(
                  0xFFFFFFFFu, kb + lane < k0 + kc && A::load(srow + kb + lane) != 0.f);
              occ[i] += __popc(live);
              while (live) {
                const int k = kb + __ffs(live) - 1;
                live &= live - 1u;
                const float a = A::load(srow + k);
                const T* wrow = wt + (size_t)(k - k0) * n3;
#pragma unroll
                for (int c = 0; c < DEC_COLS; ++c) {
                  const int n = lane + 32 * c;
                  if (n < n3)
                    acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a, A::load(wrow + n)));
                }
              }
            }
          }
        } else if (warp_live) {
          if constexpr (ROPE && !std::is_same<T, float>::value) {
            // analog bf16 x bf16: every product is exact in fp32, so one
            // fmaf rounds as the plain version's product-then-sum; two k
            // a step from bf16 pairs
            for (int kk = 0; kk < kc; kk += 2) {
              const uint32_t p_lo = ld_pair(slab + r_lo * ldk + k0 + kk);
              const uint32_t p_hi = ld_pair(slab + (r_lo + 8) * ldk + k0 + kk);
              const float a0_lo = pair_lo(p_lo), a1_lo = pair_hi(p_lo);
              const float a0_hi = pair_lo(p_hi), a1_hi = pair_hi(p_hi);
#pragma unroll
              for (int j = 0; j < MAXJ; ++j) {
                const int jt = jt0 + 2 * j;
                if (jt >= ntiles) break;
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const uint32_t pw = ld_pair(wt + (jt * 8 + tig * 2 + c) * lda + kk);
                  const float w0 = pair_lo(pw), w1 = pair_hi(pw);
                  acc[j][c] = fmaf(a1_lo, w1, fmaf(a0_lo, w0, acc[j][c]));
                  acc[j][2 + c] = fmaf(a1_hi, w1, fmaf(a0_hi, w0, acc[j][2 + c]));
                }
              }
            }
          } else if constexpr (ROPE || std::is_same<T, float>::value) {
            for (int kk = 0; kk < kc; ++kk) {
              const float a_lo = A::load(slab + r_lo * ldk + k0 + kk);
              const float a_hi = A::load(slab + (r_lo + 8) * ldk + k0 + kk);
#pragma unroll
              for (int j = 0; j < MAXJ; ++j) {
                const int jt = jt0 + 2 * j;
                if (jt >= ntiles) break;
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const float wv = A::load(wt + (jt * 8 + tig * 2 + c) * lda + kk);
                  if constexpr (ROPE) {
                    acc[j][c] = __fadd_rn(acc[j][c], __fmul_rn(a_lo, wv));
                    acc[j][2 + c] = __fadd_rn(acc[j][2 + c], __fmul_rn(a_hi, wv));
                  } else {
                    acc[j][c] = fmaf(a_lo, wv, acc[j][c]);
                    acc[j][2 + c] = fmaf(a_hi, wv, acc[j][2 + c]);
                  }
                }
              }
            }
          } else {
            for (int kk = 0; kk < kc; kk += 16) {
              const T* pa = slab + r_lo * ldk + k0 + kk + tig * 2;
              const uint32_t a[4] = {ld_pair(pa), ld_pair(pa + 8 * ldk),
                                     ld_pair(pa + 8), ld_pair(pa + 8 * ldk + 8)};
#pragma unroll
              for (int j = 0; j < MAXJ; ++j) {
                const int jt = jt0 + 2 * j;
                if (jt >= ntiles) break;
                const T* pb = wt + (jt * 8 + g) * lda + kk + tig * 2;
                mma_bf16(acc[j], a, ld_pair(pb), ld_pair(pb + 8));
              }
            }
          }
        }
      }

      if constexpr (DEC) {
#pragma unroll
        for (int i = 0; i < DEC_ROWS; ++i) {
          const int r = warp * DEC_ROWS + i;
          if (r >= nr) break;
          if (lane == 0) atomicMax(&blkv[t * nlb + (r0 + r) / l_block], occ[i]);
#pragma unroll
          for (int c = 0; c < DEC_COLS; ++c) {
            const int n = lane + 32 * c;
            if (n < n3) emit(bn_proj(acc[i][c], n), u[i][c], r, n);
          }
        }
      } else {
        if constexpr (ROPE) {
          // scale and cast into yproj, then rotate q and k against their
          // partner column (col +- hd / 2 of the same head)
          __syncthreads();      // the slab is consumed: yproj aliases it
#pragma unroll
          for (int j = 0; j < MAXJ; ++j) {
            const int jt = jt0 + 2 * j;
            if (jt >= ntiles) break;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = jt * 8 + tig * 2 + (c & 1), r = r_lo + (c & 2) * 4;
              yproj[r * n3 + n] =
                  A::round(__fmul_rn(acc[j][c], sc3[(n / hd) * qd + h * hd + n % hd]));
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int jt = jt0 + 2 * j;
          if (jt >= ntiles) break;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = r_lo + (c & 2) * 4, n = jt * 8 + tig * 2 + (c & 1);
            if (r >= nr) continue;
            float y;
            if constexpr (ROPE) {
              y = yproj[r * n3 + n];
              const int col = n % hd;
              if (n / hd < 2) {     // q, k: [x1 cos - x2 sin, x2 cos + x1 sin]
                const int i = col % half;
                const float cs = auxp[(size_t)(r0 + r) * half + i];
                const float sn = auxp[((size_t)l + r0 + r) * half + i];
                const float other = yproj[r * n3 + n + (col < half ? half : -half)];
                y = col < half ? fma32(y, cs, -__fmul_rn(other, sn))
                               : fma32(y, cs, __fmul_rn(other, sn));
                y = A::round(y);
              }
            } else {
              y = bn_proj(acc[j][c], n);
            }
            emit(y, u[j][c], r, n);
          }
        }
      }
    }
    if (memb) membranes(u, r0, nr, false);
  }
  __syncthreads();

  // per timestep: key / value block occupancy (an all-dark key block
  // scores zeros, which binarize to zero unless delta <= 0; analog
  // scores keep every key block live), live-key and live-context masks,
  // then scores and context
  for (int lb = tid; lb < nlb; lb += NT) {
    const int r0 = lb * l_block, r1 = min(l, r0 + l_block);
    int n_proj = 0, n_qkt = 0, n_qktv = 0;
    for (int t = 0; t < nt; ++t) {
      bool kany = false, vany = false;
      for (int r = r0; r < r1; ++r)
        for (int w = 0; w < HW; ++w) kany |= kbits[((size_t)t * l + r) * HW + w] != 0u;
      for (int w = r0 / 32; w <= (r1 - 1) / 32; ++w) {   // the block's rows in word w
        const int lo = max(r0, 32 * w), hi = min(r1, 32 * w + 32);
        const uint32_t m = (hi - lo == 32 ? ~0u : (1u << (hi - lo)) - 1u) << (lo - 32 * w);
        for (int cc = 0; cc < hd; ++cc)
          vany |= (vbits_t[((size_t)t * hd + cc) * lw + w] & m) != 0u;
      }
      const bool kl = AN || kany || delta <= 0.f;
      if (kl) {
        for (int r = r0; r < r1; ++r) {
          atomicOr(&key_mask[t * lw + r / 32], 1u << (r % 32));
          if (vany) atomicOr(&ctx_mask[t * lw + r / 32], 1u << (r % 32));
        }
      }
      const int bv = blkv[t * nlb + lb];
      if constexpr (DEC)        // executed chunks: ceil(capacity / c_block)
        n_proj += (min(pow2ceil(bv), cp) + c_block - 1) / c_block;
      else
        n_proj += bv;
      n_qkt += kl;
      n_qktv += kl && vany;
    }
    if (ssa) {
      // the SSA bundle's (H, 4) map (one L-block, l_block = l): q, k, v
      // count the timesteps whose whole slab is live; attend counts its
      // 2 T dots unconditionally
      int* cnt = counts + (size_t)h * 4;
      atomicAdd(cnt + 0, n_proj);
      atomicAdd(cnt + 1, n_proj);
      atomicAdd(cnt + 2, n_proj);
      atomicAdd(cnt + 3, 2 * nt);
    } else {
      int* cnt = counts + (size_t)h * N_PHASES * nlb + lb;
      atomicAdd(cnt + 0 * nlb, n_proj);
      atomicAdd(cnt + 1 * nlb, n_proj);
      atomicAdd(cnt + 2 * nlb, n_proj);
      atomicAdd(cnt + 3 * nlb, n_qkt);
      atomicAdd(cnt + 4 * nlb, n_qktv);
    }
  }
  __syncthreads();
  // scores: a warp per (t, query row); lane j scores key 32 jw + j by the
  // AND-popcount of its q and k bits (HW words), binarized, over live
  // (and, when causal, past) keys; the ballot is the score word.
  // Context: lane c counts the score bits against value columns c + 32 m
  // (< hd) over live context blocks (integer counts, exact in the
  // activation dtype). AN: lane j's score is fl(count * scale); lane c
  // adds the scores of the live keys whose value bit its column has, in
  // ascending key order, each shuffled from the key's lane.
  for (int task = warp; task < nt * l; task += NT / 32) {
    const int t = task / l, i = task % l;
    uint32_t q[HW];
#pragma unroll
    for (int w = 0; w < HW; ++w) q[w] = qbits[((size_t)t * l + i) * HW + w];
    const int last = causal ? i / 32 : lw - 1;
    int n[HW] = {};
    float acc[HW] = {};
    for (int jw = 0; jw <= last; ++jw) {
      const int key = jw * 32 + lane;
      const uint32_t* kb = kbits + ((size_t)t * l + min(key, l - 1)) * HW;
      int score = 0;
#pragma unroll
      for (int w = 0; w < HW; ++w) score += __popc(q[w] & kb[w]);
      const bool live = key < l && (!causal || key <= i) &&
                        (key_mask[t * lw + jw] >> lane & 1u);
      uint32_t vw[HW];          // the word's value bits of the lane's columns
#pragma unroll
      for (int m = 0; m < HW; ++m) {
        const int col = lane + 32 * m;
        vw[m] = col < hd ? vbits_t[((size_t)t * hd + col) * lw + jw] : 0u;
      }
      if constexpr (AN) {
        const float sc = __fmul_rn((float)score, scale);
        uint32_t vor = 0u;
#pragma unroll
        for (int m = 0; m < HW; ++m) vor |= vw[m];
        // live keys that some column's value bit selects, ascending
        uint32_t todo = __ballot_sync(0xFFFFFFFFu, live) & ctx_mask[t * lw + jw] &
                        __reduce_or_sync(0xFFFFFFFFu, vor);
        while (todo) {
          const int kk = __ffs(todo) - 1;
          todo &= todo - 1u;
          const float sk = __shfl_sync(0xFFFFFFFFu, sc, kk);
#pragma unroll
          for (int m = 0; m < HW; ++m)
            if (vw[m] >> kk & 1u) acc[m] = __fadd_rn(acc[m], sk);
        }
      } else {
        const uint32_t word =
            __ballot_sync(0xFFFFFFFFu, live && passes[score]) & ctx_mask[t * lw + jw];
#pragma unroll
        for (int m = 0; m < HW; ++m) n[m] += __popc(word & vw[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < HW; ++m) {
      const int col = lane + 32 * m;
      if (col < hd)
        A::store(ctx + (((size_t)t * nb + b) * l + i) * qd + h * hd + col,
                 AN ? acc[m] : (float)n[m]);
    }
  }
}

// launch A's instantiation for a variant, head_dim (HW = 1 for head_dim
// <= 32, else 2) and scores (AN: analog)
template <typename T>
using AttentionKernel = void (*)(const T*, const T*, const float*,
                                 const float*, const float*, float, Lif, int,
                                 int, int, int, int, int, int, int, int, int,
                                 int, int, T*, int*, T*, int);

template <typename T, int HW, bool AN>
AttentionKernel<T> attention_variant(int rope, int decoded) {
  return rope ? attention_phase<T, false, true, HW, AN>
              : decoded ? attention_phase<T, true, false, HW, AN>
                        : attention_phase<T, false, false, HW, AN>;
}

template <typename T>
AttentionKernel<T> attention_kernel(int rope, int decoded, int analog, int hd) {
  if (hd <= 32)
    return analog ? attention_variant<T, 1, true>(rope, decoded)
                  : attention_variant<T, 1, false>(rope, decoded);
  return analog ? attention_variant<T, 2, true>(rope, decoded)
                : attention_variant<T, 2, false>(rope, decoded);
}

template <typename T>
cudaError_t launch_attention(int rope, int decoded, int analog, const void* s,
                             const void* w3, const float* sc3,
                             const float* auxp, const float* delta,
                             float scale, Lif lif, int causal, int nt, int nb,
                             int l, int d, int heads, int hd, int l_block,
                             int c_block, int cp, int ssa, void* ctx,
                             int* counts, void* memb, int carry,
                             cudaStream_t stream) {
  const int nlb = (l + l_block - 1) / l_block;
  const int ka = chunk_depth(sizeof(T), nt, l, d, hd, nlb);
  const size_t dyn_a = SmemA(sizeof(T), nt, l, d, hd, nlb, ka).total;
  const AttentionKernel<T> kernel = attention_kernel<T>(rope, decoded, analog, hd);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_a);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, nb), NT, dyn_a, stream>>>(
      (const T*)s, (const T*)w3, sc3, auxp, delta, scale, lif, causal, nt, nb,
      l, d, heads, hd, l_block, c_block, cp, ssa, ka, (T*)ctx, counts,
      (T*)memb, carry);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch B: wo + MLP, one block per (64-row tile of an L-block, b)
// ---------------------------------------------------------------------------
//
// Each product is a 64-row x 64-column output tile accumulated over
// KC-deep K-chunks in ascending k, for all timesteps at once, so a weight
// chunk is staged once and serves every t. A thread owns 16 slots of the
// tile: warp w holds rows 16 (w % 4) + [0, 16) and columns 32 (w / 4) +
// [0, 32); slot q = 4 j + c is accumulator c of the warp's m16n8 tile j.
// In bf16 a chunk is KC / 16 tensor-core mma.sync steps (bf16 x bf16 -> fp32;
// spikes, integer counts and bf16 weights are exact operands); in fp32
// it is a CUDA-core loop over the same slots. An analog operand (the rope
// family's ln2 output for up; for wo, the context of analog scores) is a
// CUDA-core loop in ascending k in both dtypes (chunk_product's ANALOG).

constexpr int MAX_T = 4;       // timesteps whose accumulators the fused launch B holds
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
// tile `a_tile`, or, when `a_bits` is set, spike bits (`wpr` words a row).
// ANALOG: an analog staged tile, summed on CUDA cores in ascending k, each
// term rounded as the plain version's product-then-sum (the plain
// version's order).
template <typename T, bool ANALOG = false>
__device__ __forceinline__ void chunk_product(float (&acc)[16],
                                              const void* wbuf,
                                              const void* a_tile,
                                              const uint32_t* a_bits, int wpr,
                                              int k0) {
  const int g = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  const int r_lo = slot_row(0), cw = threadIdx.x / 128 * 32;
  if constexpr (ANALOG && !std::is_same<T, float>::value) {
    // bf16 x bf16 products are exact in fp32: one fmaf a term rounds as
    // the plain version's product-then-sum; two kk a step from bf16 pairs
    const T* as = (const T*)a_tile;
    const T* wt = (const T*)wbuf;
    for (int kk = 0; kk < KC; kk += 2) {
      const uint32_t p_lo = ld_pair(as + r_lo * LDS + kk);
      const uint32_t p_hi = ld_pair(as + (r_lo + 8) * LDS + kk);
      const float a0_lo = pair_lo(p_lo), a1_lo = pair_hi(p_lo);
      const float a0_hi = pair_lo(p_hi), a1_hi = pair_hi(p_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t pw = ld_pair(wt + (cw + j * 8 + tig * 2 + c) * LDS + kk);
          const float w0 = pair_lo(pw), w1 = pair_hi(pw);
          acc[4 * j + c] = fmaf(a1_lo, w1, fmaf(a0_lo, w0, acc[4 * j + c]));
          acc[4 * j + 2 + c] = fmaf(a1_hi, w1, fmaf(a0_hi, w0, acc[4 * j + 2 + c]));
        }
    }
  } else if constexpr (ANALOG) {       // fp32: a rounded product, then the sum
    const float* as = (const float*)a_tile;
    for (int kk = 0; kk < KC; ++kk) {
      const float a_lo = as[r_lo * LDS + kk];
      const float a_hi = as[(r_lo + 8) * LDS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float wv = ((const float*)wbuf)[kk * TILE + cw + j * 8 + tig * 2 + c];
          acc[4 * j + c] = __fadd_rn(acc[4 * j + c], __fmul_rn(a_lo, wv));
          acc[4 * j + 2 + c] = __fadd_rn(acc[4 * j + 2 + c], __fmul_rn(a_hi, wv));
        }
    }
  } else if constexpr (std::is_same<T, float>::value) {
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

// TT: the timesteps whose accumulators a block holds (MAX_T fused, 1 for
// the pipeline variant, whose mem_in / mem_hid carry the input neuron's
// and the hidden layer's membranes across launches, read when carry)
template <typename T, bool ROPE, int TT>
__global__ void __launch_bounds__(NT)
mlp_phase(const T* __restrict__ x, const T* __restrict__ ctx,
          const T* __restrict__ wo, const T* __restrict__ w1,
          const T* __restrict__ w2, const float* __restrict__ sco,
          const float* __restrict__ sc1, const float* __restrict__ sc2,
          const float* __restrict__ auxo, const float* __restrict__ aux1,
          const float* __restrict__ aux2, Lif lif, float norm_eps, int analog,
          int nt, int nb, int l, int d, int heads, int hd, int ff, int l_block,
          T* __restrict__ s2g, T* __restrict__ out, int* __restrict__ counts,
          int* __restrict__ flags, T* __restrict__ mem_in,
          T* __restrict__ mem_hid, int carry) {
  using A = Act<T>;
  // block (x, b): tile x % tpb of L-block x / tpb, TILE rows (an L-block
  // of more than TILE rows spans several blocks)
  const int tpb = (l_block + TILE - 1) / TILE;
  const int lb = blockIdx.x / tpb, b = blockIdx.y, tid = threadIdx.x;
  const int blk1 = min(l, (lb + 1) * l_block);
  const int r0 = lb * l_block + blockIdx.x % tpb * TILE;
  const int n = max(0, min(TILE, blk1 - r0));
  const int qd = heads * hd, ffc = ff / heads, nlb = gridDim.x / tpb;
  const int dw = (d + 31) / 32, fw = (ff + 31) / 32;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ uint32_t dyn[];
  uint32_t* s2bits = dyn;                            // [t][TILE][dw]
  uint32_t* hbits = s2bits + (size_t)nt * TILE * dw;  // [t][TILE][fw]
  int* head_live = (int*)(hbits + (size_t)nt * TILE * fw);  // [t][heads]
  int* hid_live = head_live + nt * heads;            // [t][heads]
  int* s2_live = hid_live + nt * heads;              // [t]
  __shared__ __align__(16) float wbuf[KC * TILE];    // weight chunk
  __shared__ __align__(16) float abuf[TILE * LDS];   // context / s2 chunk
  __shared__ int last_of_group;

  const size_t ntile = (size_t)nt * TILE * (dw + fw) + (size_t)nt * (2 * heads + 1);
  for (size_t i = tid; i < ntile; i += NT) dyn[i] = 0u;
  __syncthreads();

  // every skip below is exact (a dark input adds exact zeros); the
  // counts read the whole L-block's flags, merged across its tiles
  if (n > 0) {
    for (int t = 0; t < nt; ++t) {
      const T* ctx_t = ctx + (((size_t)t * nb + b) * l + r0) * qd;
      for (int i = tid; i < n * qd; i += NT)
        if (A::load(ctx_t + i) != 0.f) head_live[t * heads + (i % qd) / hd] = 1;
    }
    __syncthreads();

    // wo: the sum over heads in order (dark head blocks skipped), then
    // scale; bn: bn_o, residual (x1 parked in `out`) and the input LIF;
    // rope: the residual (x1 parked in `out`). An analog context (analog
    // scores) is summed in ascending k on CUDA cores
    for (int c0 = 0; c0 < d; c0 += TILE) {
      float acc[TT][16] = {}, u[16] = {};
      // slot q of the input neuron's membrane in mem_in: tile row r, column c
      auto in_slot = [&](int q) {
        return mem_in + ((size_t)b * l + r0 + slot_row(q)) * d + c0 + slot_col(q);
      };
      const auto in_range = [&](int q) { return slot_row(q) < n && c0 + slot_col(q) < d; };
      if (!ROPE && mem_in && carry)
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (in_range(q)) u[q] = A::load(in_slot(q));
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
            for (int t = 0; t < TT; ++t) {
              if (!(live >> t & 1)) continue;
              __syncthreads();
              stage_a<T>(ctx + (((size_t)t * nb + b) * l + r0) * qd, qd, n, k0,
                         abuf);
              __syncthreads();
              if (analog)
                chunk_product<T, true>(acc[t], wbuf, abuf, nullptr, 0, k0);
              else
                chunk_product<T>(acc[t], wbuf, abuf, nullptr, 0, k0);
            }
          },
          wbuf);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t >= nt) break;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int r = slot_row(q), c = c0 + slot_col(q);
          if (r >= n || c >= d) continue;
          float y = A::round(__fmul_rn(acc[t][q], sco[c]));
          if (!ROPE) y = A::round(bn_eval(y, auxo, d, c));
          const size_t off = (((size_t)t * nb + b) * l + r0 + r) * d + c;
          const float x1 = A::round(__fadd_rn(A::load(x + off), y));
          A::store(out + off, x1);
          if (!ROPE && lif_step<T>(u[q], x1, lif)) {
            atomicOr(&s2bits[((size_t)t * TILE + r) * dw + c / 32], 1u << (c % 32));
            s2_live[t] = 1;
          }
        }
      }
      if (!ROPE && mem_in)
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if (in_range(q)) A::store(in_slot(q), u[q]);
    }
    __syncthreads();

    if constexpr (ROPE) {
      // ln2 (rmsnorm), a warp per (t, row): the sum of squares as a
      // pairwise tree over D zero-padded to a power of two (element i
      // meets i + P/2, then i + P/4, ...: the plain version's order), the
      // mean, one rsqrt as a float64 1 / sqrt rounded once, then
      // (x * rsqrt) * scale in the activation dtype, parked in s2g
      int p2 = 32;
      while (p2 < d) p2 *= 2;
      const int per = p2 / 32;
      for (int task = warp; task < nt * n; task += NT / 32) {
        const int t = task / n, r = task % n;
        const size_t row = (((size_t)t * nb + b) * l + r0 + r) * d;
        float v[MAX_D / 32];
#pragma unroll
        for (int j = 0; j < MAX_D / 32; ++j) {
          const int c = lane + 32 * j;
          const float xv = j < per && c < d ? A::load(out + row + c) : 0.f;
          v[j] = __fmul_rn(xv, xv);
        }
#pragma unroll
        for (int w = MAX_D / 64; w >= 1; w /= 2)
          if (w < per)
#pragma unroll
            for (int j = 0; j < w; ++j) v[j] = __fadd_rn(v[j], v[j + w]);
        float ss = v[0];
#pragma unroll
        for (int o = 16; o >= 1; o /= 2) ss = __fadd_rn(ss, __shfl_down_sync(0xFFFFFFFFu, ss, o));
        ss = __shfl_sync(0xFFFFFFFFu, ss, 0);
        const float var = __fadd_rn(__fdiv_rn(ss, (float)d), norm_eps);
        const float rs = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn((double)var)));
        bool any = false;
        for (int c = lane; c < d; c += 32) {
          const float y = A::round(__fmul_rn(__fmul_rn(A::load(out + row + c), rs), auxo[c]));
          A::store(s2g + row + c, y);
          any |= y != 0.f;
        }
        if (__any_sync(0xFFFFFFFFu, any) && lane == 0) s2_live[t] = 1;
      }
      __syncthreads();
    }

    // up, per ff-chunk: s2 x w1 chunk, then scale (+ bn_1), LIF
    int s2_mask = 0;
    for (int t = 0; t < nt; ++t) s2_mask |= s2_live[t] << t;
    for (int hh = 0; hh < heads; ++hh)
      for (int c0 = 0; c0 < ffc; c0 += TILE) {
        float acc[TT][16] = {}, u[16] = {};
        // slot q of the hidden membrane in mem_hid: tile row r, channel f
        auto hid_slot = [&](int q) {
          return mem_hid + ((size_t)b * l + r0 + slot_row(q)) * ff + hh * ffc + c0 + slot_col(q);
        };
        const auto hid_range = [&](int q) { return slot_row(q) < n && c0 + slot_col(q) < ffc; };
        if (mem_hid && carry)
#pragma unroll
          for (int q = 0; q < 16; ++q)
            if (hid_range(q)) u[q] = A::load(hid_slot(q));
        chunk_loop<T>(
            d, w1 + hh * ffc, ff, c0, ffc, [&](int) { return s2_mask; },
            [&](int k0, int live) {
#pragma unroll
              for (int t = 0; t < TT; ++t) {
                if (!(live >> t & 1)) continue;
                if constexpr (ROPE) {
                  __syncthreads();
                  stage_a<T>(s2g + (((size_t)t * nb + b) * l + r0) * d, d, n, k0,
                             abuf);
                  __syncthreads();
                  chunk_product<T, true>(acc[t], wbuf, abuf, nullptr, 0, k0);
                } else {
                  chunk_product<T>(acc[t], wbuf, nullptr,
                                   s2bits + (size_t)t * TILE * dw, dw, k0);
                }
              }
            },
            wbuf);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t >= nt) break;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int r = slot_row(q), cc = c0 + slot_col(q);
            if (r >= n || cc >= ffc) continue;
            const int f = hh * ffc + cc;
            float y = A::round(__fmul_rn(acc[t][q], sc1[f]));
            if (!ROPE) y = A::round(bn_eval(y, aux1, ff, f));
            if (lif_step<T>(u[q], y, lif)) {
              atomicOr(&hbits[((size_t)t * TILE + r) * fw + f / 32], 1u << (f % 32));
              hid_live[t * heads + hh] = 1;
            }
          }
        }
        if (mem_hid)
#pragma unroll
          for (int q = 0; q < 16; ++q)
            if (hid_range(q)) A::store(hid_slot(q), u[q]);
      }
    __syncthreads();

    // down: the sum over ff-chunks in order (dark chunk blocks skipped),
    // then scale (+ bn_2) and the residual
    for (int c0 = 0; c0 < d; c0 += TILE) {
      float acc[TT][16] = {};
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
            for (int t = 0; t < TT; ++t)
              if (live >> t & 1)
                chunk_product<T>(acc[t], wbuf, nullptr,
                                 hbits + (size_t)t * TILE * fw, fw, k0);
          },
          wbuf);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t >= nt) break;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int r = slot_row(q), c = c0 + slot_col(q);
          if (r >= n || c >= d) continue;
          float y = A::round(__fmul_rn(acc[t][q], sc2[c]));
          if (!ROPE) y = A::round(bn_eval(y, aux2, d, c));
          const size_t off = (((size_t)t * nb + b) * l + r0 + r) * d + c;
          A::store(out + off, A::round(__fadd_rn(A::load(out + off), y)));
        }
      }
    }
  }
  __syncthreads();

  // merge the tile's flags into its L-block's: per (b, L-block, t) a
  // mask of live heads for wo and for down and a flag for up, then an
  // arrival count; the group's last block turns the masks into counts
  int* grp = flags + ((size_t)b * nlb + lb) * (3 * nt + 1);
  for (int t = tid; t < nt; t += NT) {
    int m_wo = 0, m_down = 0;
    for (int hh = 0; hh < heads; ++hh) {
      m_wo |= head_live[t * heads + hh] << hh;
      m_down |= hid_live[t * heads + hh] << hh;
    }
    atomicOr(grp + 3 * t, m_wo);
    atomicOr(grp + 3 * t + 1, s2_live[t]);
    atomicOr(grp + 3 * t + 2, m_down);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_of_group = atomicAdd(grp + 3 * nt, 1) == tpb - 1;
  __syncthreads();
  if (last_of_group && tid < heads) {
    __threadfence();
    int n_wo = 0, n_up = 0, n_down = 0;
    for (int t = 0; t < nt; ++t) {
      n_wo += atomicOr(grp + 3 * t, 0) >> tid & 1;
      n_up += atomicOr(grp + 3 * t + 1, 0) != 0;
      n_down += atomicOr(grp + 3 * t + 2, 0) >> tid & 1;
    }
    int* cnt = counts + (size_t)tid * N_PHASES * nlb + lb;
    atomicAdd(cnt + 5 * nlb, n_wo);
    atomicAdd(cnt + 6 * nlb, n_up);
    atomicAdd(cnt + 7 * nlb, n_down);
  }
}

// One launch A and one launch B over nt timesteps (TT >= nt held by
// launch B); memb / mem_in / mem_hid, when set, carry the membranes in
// from the previous launch pair (carry) and out to the next one.
template <typename T, int TT>
cudaError_t launch_pair(const T* x, const T* s, const void* w3,
                        const void* wo, const void* w1, const void* w2,
                        const float* sc3, const float* sco, const float* sc1,
                        const float* sc2, const float* auxp, const float* auxo,
                        const float* aux1, const float* aux2,
                        const float* delta, float scale, Lif lif,
                        float norm_eps, int rope, int causal, int analog, int nt,
                        int nb, int l, int d, int heads, int hd, int ff, int l_block,
                        int decoded, int c_block, int cp, T* ctx, T* s2g,
                        T* out, int* counts, int* flags, T* memb, T* mem_in,
                        T* mem_hid, int carry, cudaStream_t stream) {
  if (nt > TT) return cudaErrorInvalidValue;
  const int nlb = (l + l_block - 1) / l_block, tpb = (l_block + TILE - 1) / TILE;
  const size_t dyn = 4 * ((size_t)nt * TILE * ((d + 31) / 32 + (ff + 31) / 32) +
                          (size_t)nt * (2 * heads + 1));
  auto mlp = rope ? mlp_phase<T, true, TT> : mlp_phase<T, false, TT>;
  cudaError_t err = cudaFuncSetAttribute(
      mlp, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return err;
  err = launch_attention<T>(rope, decoded, analog, s, w3, sc3, auxp, delta,
                            scale, lif, causal, nt, nb, l, d, heads, hd,
                            l_block, c_block, cp, 0, ctx, counts, memb, carry,
                            stream);
  if (err != cudaSuccess) return err;
  mlp<<<dim3(nlb * tpb, nb), NT, dyn, stream>>>(
      x, ctx, (const T*)wo, (const T*)w1, (const T*)w2, sco, sc1, sc2, auxo,
      aux1, aux2, lif, norm_eps, analog, nt, nb, l, d, heads, hd, ff, l_block, s2g,
      out, counts, flags, mem_in, mem_hid, carry);
  return cudaGetLastError();
}

// The layer program: fused, one launch pair over all T; or pipelined, one
// launch pair per timestep (A_0, B_0, A_1, B_1, ...), each pair's
// operands offset to its timestep (x, s, ctx, out, and launch B's flag
// words (T, B, nlb, 4)), with the rope family's ln2 scratch s2g holding
// one timestep.
template <typename T>
cudaError_t launch(int pipeline, const void* x, const void* s, const void* w3,
                   const void* wo, const void* w1, const void* w2,
                   const float* sc3, const float* sco, const float* sc1,
                   const float* sc2, const float* auxp, const float* auxo,
                   const float* aux1, const float* aux2, const float* delta,
                   float scale, Lif lif, float norm_eps, int rope, int causal,
                   int analog, int nt, int nb, int l, int d, int heads, int hd,
                   int ff, int l_block, int decoded, int c_block, int cp,
                   void* ctx, void* s2g, void* out, int* counts, int* flags,
                   void* memb, void* mem_in, void* mem_hid, cudaStream_t stream) {
  if (!pipeline)
    return launch_pair<T, MAX_T>(
        (const T*)x, (const T*)s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp,
        auxo, aux1, aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l,
        d, heads, hd, ff, l_block, decoded, c_block, cp, (T*)ctx, (T*)s2g,
        (T*)out, counts, flags, nullptr, nullptr, nullptr, 0, stream);
  const int nlb = (l + l_block - 1) / l_block;
  const size_t xs = (size_t)nb * l * d, cs = (size_t)nb * l * heads * hd;
  const size_t fs = (size_t)nb * nlb * 4;
  for (int t = 0; t < nt; ++t) {
    const cudaError_t err = launch_pair<T, 1>(
        (const T*)x + t * xs, (const T*)s + t * xs, w3, wo, w1, w2, sc3, sco,
        sc1, sc2, auxp, auxo, aux1, aux2, delta, scale, lif, norm_eps, rope,
        causal, analog, 1, nb, l, d, heads, hd, ff, l_block, decoded, c_block, cp,
        (T*)ctx + t * cs, (T*)s2g, (T*)out + t * xs, counts, flags + t * fs,
        (T*)memb, (T*)mem_in, (T*)mem_hid, t > 0, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int forward(int pipeline, const void* x, const void* s, const void* w3,
            const void* wo, const void* w1, const void* w2, const void* sc3,
            const void* sco, const void* sc1, const void* sc2,
            const void* auxp, const void* auxo, const void* aux1,
            const void* aux2, const void* delta, float scale, Lif lif,
            float norm_eps, int rope, int causal, int analog, int nt, int nb,
            int l, int d, int heads, int hd, int ff, int l_block, int decoded,
            int c_block, int cp, void* ctx, void* s2g, void* out,
            void* counts, void* flags, void* memb, void* mem_in,
            void* mem_hid, void* stream) {
  const auto f = [](const void* p) { return (const float*)p; };
  return (int)launch<T>(pipeline, x, s, w3, wo, w1, w2, f(sc3), f(sco),
                        f(sc1), f(sc2), f(auxp), f(auxo), f(aux1), f(aux2),
                        f(delta), scale, lif, norm_eps, rope, causal, analog, nt,
                        nb, l, d, heads, hd, ff, l_block, decoded, c_block, cp,
                        ctx, s2g, out, (int*)counts, (int*)flags, memb,
                        mem_in, mem_hid, (cudaStream_t)stream);
}

// The SSA bundle alone (kernels/fused_ssa.py::fused_ssa): launch A with
// one L-block a sequence, its context written to the output and its
// counts to the bundle's (H, 4) map; rope: the token family's bundle
// (analog input, RoPE on q and k, no BN), causal or not.
template <typename T>
cudaError_t launch_ssa(const void* s, const void* w3, const float* sc3,
                       const float* auxp, const float* delta, float scale,
                       Lif lif, int rope, int causal, int analog, int nt,
                       int nb, int l, int d, int heads, int hd, void* ctx,
                       int* counts, cudaStream_t stream) {
  return launch_attention<T>(rope, 0, analog, s, w3, sc3, auxp, delta, scale,
                             lif, causal, nt, nb, l, d, heads, hd, l, 1, d, 1,
                             ctx, counts, nullptr, 0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rope: the token family (analog
// projection input, RoPE, ln2 rmsnorm, no BN); causal: mask future keys;
// analog: analog scores fl(count * scale) (binarize_scores=False);
// decoded: the decoded q/k/v projections with chunks of c_block
// compacted slots and padded width cp. Returns a cudaError_t (0 =
// success).
extern "C" int fused_layer_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, void* ctx, void* s2g,
    void* out, void* counts, void* flags, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(0, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, ctx, s2g, out,
             counts, flags, nullptr, nullptr, nullptr, stream);
}

// The pipeline variant (overlap='pipeline'): fused_layer_forward's
// operands, with ctx (T, B, L, H hd), s2g (B, L, D) (rope; unused by bn),
// flags (T, B, nlb, 4) int32 zeroed, and the membrane scratch memb
// (B, L, 3 H hd), mem_in (B, L, D), mem_hid (B, L, F) in the activation
// dtype (uninitialised: the first timestep does not read it). Launches 2 T
// kernels on the stream.
extern "C" int fused_layer_pipeline_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, void* ctx, void* s2g,
    void* out, void* counts, void* flags, void* memb, void* mem_in,
    void* mem_hid, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(1, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, ctx, s2g, out,
             counts, flags, memb, mem_in, mem_hid, stream);
}

// The SSA bundle (fused_ssa): s (T, B, L, D) spikes (rope: normed
// currents), w3 (3, D, H hd), sc3 (3, H hd) fp32 scales, auxp (3, 4, H hd)
// fp32 BN rows [mean, inv_std, scale, bias] (rope: the (2, L, hd / 2)
// [cos; sin] table), delta (1,) fp32; rope: the token family's epilogue;
// causal: mask future keys; analog: analog scores; ctx (T, B, L, H hd) in
// the dtype (0 =
// float32, 1 = bfloat16); counts (H, 4) int32, zeroed by the caller.
// Returns a cudaError_t (0 = success).
extern "C" int fused_ssa_forward(int dtype, const void* s, const void* w3,
                                 const void* sc3, const void* auxp,
                                 const void* delta, float scale, float decay,
                                 float vth, int soft_reset, int rope,
                                 int causal, int analog, int nt, int nb, int l,
                                 int d, int heads, int hd, void* ctx,
                                 void* counts, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  const auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return launch_ssa<float>(s, w3, f(sc3), f(auxp), f(delta), scale, lif,
                             rope, causal, analog, nt, nb, l, d, heads, hd,
                             ctx, (int*)counts, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_ssa<__nv_bfloat16>(s, w3, f(sc3), f(auxp), f(delta), scale,
                                     lif, rope, causal, analog, nt, nb, l, d,
                                     heads, hd, ctx, (int*)counts,
                                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_layer_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
