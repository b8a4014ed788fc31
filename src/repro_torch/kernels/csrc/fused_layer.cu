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
// keeps CUDA-core loops). The rope family's two analog products (q/k/v of
// ln1, up of ln2) are CUDA-core loops in ascending k in both dtypes: an
// analog sum is exact in no order, and this one is the plain version's,
// so kernel and plain version agree bitwise; their floor is the fp32
// pipe, so launch A spreads the q/k/v product over the whole card.
//
// Design. The TPU grid keeps every head's q/k/v spikes for all T in
// VMEM (~786 KB at full width), which no SM can hold. The layer is split
// into launch A (two kernels) and launch B:
//   A. project_phase, one block per (column slice of the 3 H hd outputs,
//      row group): the w3 slice staged once and kept for every row tile
//      and timestep, the (t, tile) slabs streamed through a cp.async ring
//      of K-chunks, the LIF membranes in registers across t; the spikes go
//      as bits to a scratch in device memory (q and k row-major, v
//      transposed), with the flags of the counts. attend_phase, one block
//      per (64-query block, head, (t, b)), walks the keys in ascending
//      chunks of 2048 staged from that scratch: a warp scores a query
//      row 32 keys a ballot (AND-popcount of q and k bits, binarized,
//      causal or not) and counts the context against the transposed
//      value bits; the context (integer counts) goes to a (T, B, L, H*hd)
//      scratch. Nothing of the sequence is held in shared memory, so
//      launch A takes any L; head_dim up to 128 (four words a row of q or
//      k bits).
//   B. four kernels over the whole card, each a product tiled over
//      (64 flattened (b, l) rows, 64 output columns) for a group of up to
//      four timesteps at once, any T in groups, the LIF membranes in
//      registers across the groups (mlp_gemm below): wo, scale, bn_o,
//      residual (x1 parked in the output) and the input LIF into spike
//      bits in device memory (bn), or the residual (rope); (rope) ln2 into
//      a (T, B, L, D) scratch (norm_phase, a warp a row, any D); up +
//      bn_1 + LIF into hidden spike bits; down + bn_2 + residual. Spike
//      operands are expanded from the bits straight into mma fragments.
//      Every predicate of the counts is a flag of a whole L-block, set by
//      whichever block sees a live value (launch A's attend_phase for wo),
//      and down's blocks add the flags to the counts, so the counts are
//      those of the TPU kernel.
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
// decodes the staged slab chunks itself: each warp walks its rows one
// 32-entry word at a time, a warp ballot marks the live spikes and __ffs
// visits them in ascending k (the order of the compacted slots), and for
// each live spike the lanes add the value times the spike's row of the
// w3 slice with one fp32 product and one fp32 sum, a column a lane per 32
// of the slice. Chunks of c_block slots at or past an L-block's capacity
// hold no live spike, so they are skipped by construction; the executed
// chunks, ceil(capacity / c_block) per (t, b, L-block), go to the q/k/v
// counts. The epilogue and launch B are the tile variant's. It is
// CUDA-core work in both dtypes: the sum order is the plain version's, so
// the variant is bitwise equal to its plain version for any weights, and
// to the tile variant on dyadic weights.
//
// The pipeline variant (overlap='pipeline'; `_kernel` with pipeline=True,
// grid (B, T, 8, H), its LIF membranes riding VMEM scratch across the T
// axis) is the same launches run once per timestep, A_0, B_0, A_1, B_1,
// ... on one stream (fused_layer_pipeline_forward): each launch sees one
// timestep (nt = 1, its operands and its bit scratch offset to timestep
// t), launch B's kernels holding one timestep a block. The
// membranes move between launches through device scratch in the
// activation dtype, where LIF keeps them exactly: q/k/v (B, L, 3 H hd),
// the input neuron (B, L, D), the MLP hidden layer (B, L, F); a launch
// reads them at t > 0 and starts from zero at t = 0, as the TPU kernel's
// `_lif` does. The counts are added per timestep and launch B's flag
// words are kept per timestep, so outputs and counts equal the fused
// variant's bitwise. It moves the membranes through device memory twice
// a timestep more than #1 and makes 5 T launches (rope 6 T) instead of
// 5 (6).
//
// Analog scores (binarize_scores=False, Spikformer's raw SSA: the Pallas
// kernels' `a = sc` branch, fused_layer.py:232-235 with the always-live
// score predicate of `_qkt_live`, fused_ssa.py:152-155) are attend_phase's
// AN instantiation, a template flag, so the binarized kernels keep their
// code. A score is still the AND-popcount count c of a query's and a
// key's bits, now rounded once as fl(c * scale); the context of query i
// and column col is the fp32 sum of the scores of the keys whose value
// bit is set, in ascending key order, one __fadd_rn a term (the plain
// version's order, fused_ssa.analog_context, and spike_attention.cu's),
// on CUDA cores: a warp ballots the live keys of a 32-key word, then
// visits them in ascending order, each key's score broadcast from its
// lane with a shuffle. Every key block is live for the score phase
// (n_qkt counts all of them); a context block when its value rows are not
// all dark. Launch B's wo then takes an analog left operand, exact in no
// order: it is summed in ascending k on CUDA cores (mlp_gemm's chain
// path, as the rope family's `up`), chosen by a block-uniform flag
// outside the k loop.
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

constexpr int NT = 256;      // threads of an attention block
constexpr int MAX_HD = 128;  // q/k spikes of a row fit four 32-bit words
constexpr int N_PHASES = 8;

template <typename T> struct Act;
template <> struct Act<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void round2(float&, float&) {}
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // two values rounded by one packed conversion (as round, each)
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
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

struct Lif {
  float decay, vth;
  int soft;
};

// smallest power of two >= x (0 -> 0, 1 -> 1): spike_decode.pow2ceil
__device__ __forceinline__ int pow2ceil(int x) {
  return x <= 1 ? max(x, 0) : 1 << (32 - __clz(x - 1));
}

// one LIF step in the activation dtype (core/spiking.lif_step); returns
// the spike. The hard reset's 1 - s and u (1 - s) are exact in any dtype
// (s is 0 or 1, u already rounded), so their roundings are the identity
template <typename T>
__device__ __forceinline__ bool lif_step(float& u, float y, const Lif& p) {
  using A = Act<T>;
  u = A::round(__fadd_rn(A::round(__fmul_rn(p.decay, u)), y));
  const float s = A::round(__fsub_rn(u, p.vth)) >= 0.f ? 1.f : 0.f;
  if (p.soft)
    u = A::round(__fsub_rn(u, A::round(__fmul_rn(s, p.vth))));
  else
    u = __fmul_rn(u, __fsub_rn(1.f, s));
  return s != 0.f;
}

// lif_step on two neurons, each rounding of the pair one packed
// conversion; bit i of the result: neuron i spiked
template <typename T>
__device__ __forceinline__ uint32_t lif_step2(float (&u)[2], const float (&y)[2], const Lif& p) {
  using A = Act<T>;
  float a[2], c[2], s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) a[i] = __fmul_rn(p.decay, u[i]);
  A::round2(a[0], a[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) u[i] = __fadd_rn(a[i], y[i]);
  A::round2(u[0], u[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) c[i] = __fsub_rn(u[i], p.vth);
  A::round2(c[0], c[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) s[i] = c[i] >= 0.f ? 1.f : 0.f;
  if (p.soft) {
#pragma unroll
    for (int i = 0; i < 2; ++i) a[i] = __fmul_rn(s[i], p.vth);
    A::round2(a[0], a[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) u[i] = __fsub_rn(u[i], a[i]);
    A::round2(u[0], u[1]);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) u[i] = __fmul_rn(u[i], __fsub_rn(1.f, s[i]));
  }
  return (s[0] != 0.f) | (s[1] != 0.f) << 1;
}

// ---------------------------------------------------------------------------
// tensor-core helpers: bf16 mma.sync m16n8k16 with fp32 accumulation
// ---------------------------------------------------------------------------

// two consecutive spike bits of `word` as a packed pair of bf16 {0, 1}:
// the bits moved to positions 0 and 16, times bf16 1.0 (no carries)
__device__ __forceinline__ uint32_t bit_pair(uint32_t word, int bit) {
  const uint32_t x = word >> bit;
  return ((x & 1u) | (x << 15 & 0x10000u)) * 0x3F80u;
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
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// launch A: the q/k/v projections (project_phase), then the binary
// attention (attend_phase), the spike bits in device memory between them
// ---------------------------------------------------------------------------
//
// project_phase: block (cs, rg), 512 threads, holds column slice cs of
// the 3 H hd projection outputs, cw columns wide (whole (q/k/v, head)
// groups of hd columns, or, for head_dim past what shared memory holds
// beside D, a pair slice of one group: cw / 2 columns from each half, so
// a RoPE partner col +- hd / 2 lies in the same slice), and walks the row
// tiles rg, rg + gridDim.y, ... of the flattened (b, l) rows, MA at a
// time; the host picks the widest slice that fits and enough row groups
// to fill the card once. Its w3 slice is staged once and kept for every
// tile and timestep: by cp.async, untransposed as [D][ldw] (the layout
// ldmatrix.trans reads as mma B fragments, and the decoded walk reads a
// row at a time), or, for the rope family, transposed in fp32 as
// [cw][D + 4] (a column's 4 consecutive k in one 16-byte load). Each
// tile's slab is copied 256 bytes of each row at a time (KCA_BYTES: 128
// bf16 or 64 fp32 k) through a ring of SA stages by cp.async, the next
// chunks (of this timestep, the next one or the next tile) in flight
// while the current one is projected; the LIF membranes of a tile's
// slots stay in registers across t. Dark inputs are skipped, as they
// would add exact zeros: a tensor-core k16 step whose A fragment is all
// zero for the warp's 16 rows, a CUDA-core chunk whose rows are all dark
// for the warp; the live rows are recorded for the counts.
//
// Products: warp w holds rows 16 (w % 4) + [0, 16) of the tile and the
// n8 column tiles [j0, j1) of its quarter (w / 4) of the slice; slot
// (i, c) is accumulator c of its i-th tile. bf16 spikes: ldmatrix +
// mma.sync m16n8k16 with fp32 accumulation, a k16 step's fragments
// loaded before its products. fp32 spikes: CUDA-core fmaf on the same
// slots. The rope family's analog product: CUDA-core, four k a step, each
// slot its own ascending-k chain (bf16: fmaf, whose bf16 x bf16 product
// is exact in fp32; fp32: __fmul_rn then __fadd_rn), the plain version's
// order. The decoded variant: warp w walks rows DEC_ROWS w + [0,
// DEC_ROWS), a ballot a 32-entry word, __ffs visiting the live entries in
// ascending k, lane l adding value x weight into columns 4 l + [0, 4),
// read in one load (one fp32 product and one fp32 sum a term; in bf16 one
// fmaf, the product being exact). Chunking K keeps each slot's order: the chunks run in
// ascending k and each continues the slot's sum.
//
// The epilogue (scale, BN with its scale and bias staged as doubles for
// fma32, or RoPE; LIF) reads each column's parameters from shared memory
// and collects the thread's spikes in a register mask; warp shuffles (or
// a ballot) assemble them into the tile's words in shared memory: q and
// k row-major (a row's hd bits in hw = ceil(hd / 32) words), v as a
// 64-row mask a column. They then go to the
// bit scratch (Bits, (T, B, H, L, hw) words for q and k, (T, B, H, hd,
// ceil(L / 32)) for v transposed; a word that other slices or tiles
// share, at a pair slice's seam or a sequence's key word across tiles, by
// atomicOr), with the flags of the counts: key and value L-blocks that
// hold a spike (kf, vf), and per (t, b, L-block) the projection's live
// flag (tile) or its rows' largest occupancy (decoded, atomicMax).
//
// attend_phase: block (query block, head, (t, b)), QB query rows; the
// keys in ascending chunks of KCH (a causal block reads none past its last
// query row), each chunk's key bits (word-major) and value bits (an odd
// word stride a column) staged from the scratch into shared memory with
// its live-key and live-context masks (from kf / vf). A warp takes its 8
// query rows one 32-key word at a time, the word's key and value bits
// read once for all of them: lane j the AND-popcount of a query's and key
// 32 jw + j's bits, binarized through a table of the hd + 1 counts,
// causal or not; the context counts the score word against each of the
// lane's value columns. Analog scores: lane j's score is fl(count *
// scale), and each column adds the scores of the live keys whose value
// bit it has in ascending key order (one __fadd_rn a term, each score
// shuffled from its key's lane), the rows' sums interleaved, each carried
// across chunks. Block (0, h, (t, b)) adds the (t, b, h) counts of every L-block
// (int32 atomics, order-free).

constexpr int NTA = 512;            // threads of a projection block
constexpr int MA = 64;              // flattened (b, l) rows of a projection tile
constexpr int KCA_BYTES = 256;      // a staged slab chunk's row: 128 bf16, 64 fp32
constexpr int SA = 3;               // slab chunks in the ring
constexpr int CW_MAX = 128;         // columns of a block's w3 slice
constexpr int MAXJ = CW_MAX / 32;   // n8 tiles a warp holds (a quarter of the slice)
constexpr int DEC_ROWS = MA / (NTA / 32);  // decoded: rows a warp walks
constexpr int DEC_COLS = CW_MAX / 32;      // decoded: columns a lane holds, 4 lane + [0, 4)
constexpr int QB = 64;              // query rows of an attention block
constexpr int KCH = 2048;           // keys of an attention chunk
constexpr int VSTR = KCH / 32 + 1;  // a staged value column: an odd word stride
constexpr int MODE_TILE = 0, MODE_DEC = 1, MODE_ROPE = 2;

// the bit scratch of one launch A (kernels/fused_layer.py::bits_words)
struct Bits {
  uint32_t *q, *k, *v;   // (T, B, H, L, hw), same, (T, B, H, hd, lw) words
  int *kf, *vf;          // (T, B, H, nlb): a key / value spike in the L-block
  int *pf;               // (T, B, nlb): live rows (tile) / max occupancy (decoded)
};

// the sections of nt timesteps carved from one zeroed int32 buffer, each
// timestep's contiguous within its section
struct BitsLayout {
  size_t qk, v, f, p;   // words a timestep
  BitsLayout(int nb, int l, int heads, int hd, int nlb)
      : qk((size_t)nb * heads * l * ((hd + 31) / 32)),
        v((size_t)nb * heads * hd * ((l + 31) / 32)),
        f((size_t)nb * heads * nlb), p((size_t)nb * nlb) {}
  // timestep t's sections of a buffer of nt timesteps
  Bits at(void* base, int nt, int t) const {
    uint32_t* w = (uint32_t*)base;
    int* fl = (int*)(w + (size_t)nt * (2 * qk + v));
    return Bits{w + t * qk, w + nt * qk + t * qk, w + 2 * nt * qk + t * v,
                fl + t * f, fl + nt * f + t * f, fl + 2 * nt * f + t * p};
  }
};

// a staged row of n elements, padded so its stride is an odd number of
// 16-byte units: the eight rows an ldmatrix (or a warp's 16-byte loads)
// reads fall in distinct banks
__host__ __device__ constexpr int padded(int n, int es) {
  return n + ((n * es / 16) % 2 == 0 ? 16 / es : 32 / es);
}
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// project_phase's dynamic shared memory, carved in this order (host and
// device; kernels/fused_layer.py::smem_a); the rope family holds its w3
// slice transposed in fp32, [cw][D + 4]
struct SmemP {
  size_t w, ring, yproj, qkw, vw, cols, total;
  __host__ __device__ SmemP(int es, int d, int hd, int cw, int rope) {
    const int ngw = (cw >= hd ? cw / hd : 1) * ((hd + 31) / 32);
    w = 0;
    ring = align16(rope ? (size_t)cw * (d + 4) * 4 : (size_t)d * padded(cw, es) * es);
    yproj = ring + (size_t)SA * MA * padded(KCA_BYTES / es, es) * es;
    qkw = yproj + (rope ? (size_t)MA * cw * 4 : 0);
    vw = qkw + align16((size_t)MA * ngw * 4);
    cols = vw + (size_t)cw * 2 * 4;
    total = cols + (size_t)cw * 2 * 16;
  }
};

// a slice width launch A takes: whole groups that tile the 3 H groups, or
// a pair slice (cw dividing hd); a multiple of 8 up to CW_MAX
inline bool valid_width(int cw, int heads, int hd) {
  if (cw <= 0 || cw % 8 || cw > CW_MAX) return false;
  return cw >= hd ? cw % hd == 0 && (3 * heads) % (cw / hd) == 0 : hd % cw == 0;
}

// the global column (of the 3 H hd outputs, (q/k/v, head, col)) of local
// column j of slice cs
__device__ __forceinline__ int slice_col(int cs, int j, int cw, int hd) {
  if (cw >= hd) return cs * cw + j;
  const int hc = cw / 2, per = hd / cw, grp = cs / per, sl = cs % per;
  return grp * hd + (j < hc ? sl * hc + j : hd / 2 + sl * hc + j - hc);
}

// the local column of j's RoPE partner (col -+ hd / 2 of its group)
__device__ __forceinline__ int partner_col(int j, int cw, int hd) {
  if (cw >= hd) return j % hd < hd / 2 ? j + hd / 2 : j - hd / 2;
  return j < cw / 2 ? j + cw / 2 : j - cw / 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared memory, asynchronously; zero-filled when
// src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
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
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// the slice's w3 columns, all D rows, into ws ([D][ldw]) by cp.async: 16
// bytes a copy where the slice's column runs allow it, else 4
template <typename T>
__device__ __forceinline__ void stage_slice(const T* __restrict__ w3, T* ws, int cs,
                                            int cw, int d, int hd, int qd, int ldw) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = cw >= hd || ((cw / 2) % V == 0 && (hd / 2) % V == 0);
  const int per = vec ? V : 4 / (int)sizeof(T), nper = cw / per;
  for (int i = threadIdx.x; i < d * nper; i += NTA) {
    const int k = i / nper, j = i % nper * per, n = slice_col(cs, j, cw, hd);
    const T* src = w3 + ((size_t)(n / qd) * d + k) * qd + n % qd;
    T* dst = ws + (size_t)k * ldw + j;
    if (vec)
      cp_async16(dst, src, 16);
    else
      cp_async4(dst, src);
  }
}

// the rope family's slice transposed to fp32, wt[j][k] ([cw][D + 4]: a
// column's 4 consecutive k in one 16-byte load, the 4 columns a warp's
// lanes read at once in distinct banks); consecutive threads read
// consecutive columns
template <typename T>
__device__ __forceinline__ void stage_slice_t(const T* __restrict__ w3, float* wt, int cs,
                                              int cw, int d, int hd, int qd) {
  for (int i = threadIdx.x; i < d * cw; i += NTA) {
    const int k = i / cw, j = i % cw, n = slice_col(cs, j, cw, hd);
    wt[(size_t)j * (d + 4) + k] = Act<T>::load(w3 + ((size_t)(n / qd) * d + k) * qd + n % qd);
  }
}

// rows [m0, m0 + MA) of timestep t's (B L, D) slab, columns [k0, k0 + kc),
// into buf ([MA][ldk]) by 16-byte cp.async; rows past B L zero-filled
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ s, T* buf, int t,
                                            int m0, int m_all, int d, int k0, int kc,
                                            int ldk) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = kc / V;
  for (int i = threadIdx.x; i < MA * per_row; i += NTA) {
    const int r = i / per_row, v = i % per_row;
    const bool in = m0 + r < m_all;
    const T* src = s + ((size_t)t * m_all + (in ? m0 + r : 0)) * d + k0 + v * V;
    cp_async16(buf + r * ldk + v * V, src, in ? 16 : 0);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NTA)
project_phase(const T* __restrict__ s, const T* __restrict__ w3,
              const float* __restrict__ sc3, const float* __restrict__ auxp,
              Lif lif, int nt, int nb, int l, int d, int heads, int hd,
              int l_block, int cw, Bits bits, T* __restrict__ memb, int carry) {
  using A = Act<T>;
  constexpr bool DEC = MODE == MODE_DEC, ROPE = MODE == MODE_ROPE;
  constexpr bool MMA = MODE == MODE_TILE && !std::is_same<T, float>::value;
  constexpr int AJ = DEC ? DEC_ROWS : MAXJ, AC = DEC ? DEC_COLS : 4;
  const int cs = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4, wr = warp % 4;
  const int qd = heads * hd, m_all = nb * l, hw = (hd + 31) / 32;
  const int nlb = (l + l_block - 1) / l_block, lw = (l + 31) / 32, half = hd / 2;
  constexpr int KCA = KCA_BYTES / sizeof(T);
  const int ldw = padded(cw, sizeof(T)), ldk = padded(KCA, sizeof(T));
  const int ngw = (cw >= hd ? cw / hd : 1) * hw;
  const int nj = cw / 8, jq = (nj + 3) / 4, j0 = warp / 4 * jq, j1 = min(nj, j0 + jq);
  const int nkc = (d + KCA - 1) / KCA, ntiles = (m_all + MA - 1) / MA;
  // the projection flags come from one column slice a tile
  const bool record = cs == 0;
  // a q / k word whose columns all lie in this slice is stored, else ORed
  const bool owned = cw >= hd || ((cw / 2) % 32 == 0 && half % 32 == 0);
  // decoded: the columns 32 q + [0, 32) of 8 lanes are one q / k word
  const bool whole32 = cw >= hd && hd % 32 == 0;
  const uint32_t mag = sizeof(T) == 2 ? 0x7FFF7FFFu : 0x7FFFFFFFu;

  extern __shared__ __align__(16) unsigned char dyn_a[];
  const SmemP lay(sizeof(T), d, hd, cw, ROPE);
  T* ws = (T*)(dyn_a + lay.w);              // [D][ldw]: the w3 slice
  float* wsf = (float*)(dyn_a + lay.w);     // rope: [cw][D + 4], transposed fp32
  T* ring = (T*)(dyn_a + lay.ring);         // [SA][MA][ldk]: slab chunks
  float* yproj = (float*)(dyn_a + lay.yproj);  // rope: [MA][cw] scaled projections
  uint32_t* qkw = (uint32_t*)(dyn_a + lay.qkw);  // [MA][ngw]: q / k bit words
  uint32_t* vw = (uint32_t*)(dyn_a + lay.vw);    // [cw][2]: v 64-row masks
  float4* colp = (float4*)(dyn_a + lay.cols);    // [cw]: a column's parameters
  double2* colq = (double2*)(colp + cw);         // [cw]: BN's scale and bias
  __shared__ int row_live[MA];

  const int my_tiles = (int)blockIdx.y < ntiles ? (ntiles - 1 - blockIdx.y) / gridDim.y + 1 : 0;
  const int per_tile = nt * nkc, total = my_tiles * per_tile;
  if (total == 0) return;
  for (int i = tid; i < MA * ngw; i += NTA) qkw[i] = 0u;
  for (int i = tid; i < cw * 2; i += NTA) vw[i] = 0u;
  for (int i = tid; i < MA; i += NTA) row_live[i] = 0;

  if constexpr (!ROPE) stage_slice<T>(w3, ws, cs, cw, d, hd, qd, ldw);
  cp_async_commit();
  auto prefetch = [&](int st) {
    if (st < total) {
      const int tile = blockIdx.y + st / per_tile * gridDim.y, k0 = st % nkc * KCA;
      stage_chunk<T>(s, ring + (size_t)(st % SA) * MA * ldk, st / nkc % nt, tile * MA,
                     m_all, d, k0, min(KCA, d - k0), ldk);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < SA - 1; ++st) prefetch(st);
  if constexpr (ROPE) stage_slice_t<T>(w3, wsf, cs, cw, d, hd, qd);

  // slot (i, c) of the thread: tile row r and local column j
  auto slot = [&](int i, int c, int nrows, int& r, int& j) {
    if constexpr (DEC) {
      r = warp * DEC_ROWS + i;
      j = 4 * lane + c;
    } else {
      r = wr * 16 + g + (c & 2) * 4;
      j = (j0 + i) * 8 + tig * 2 + (c & 1);
      if (j0 + i >= j1) return false;
    }
    return r < nrows && j < cw;
  };
  float u[AJ][AC], acc[AJ][AC];
  int occ[DEC ? DEC_ROWS : 1];
  uint32_t rows_lit[2] = {0u, 0u};   // tensor cores: the lane's rows g, g + 8 hold a value
  // the pipeline variant's membranes (memb, (B L, 3 qd)): read when carry,
  // written back after the launch's timestep
  auto membranes = [&](int m0, int nrows, bool load) {
#pragma unroll
    for (int i = 0; i < AJ; ++i)
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        int r, j;
        if (!slot(i, c, nrows, r, j)) continue;
        T* p = memb + (size_t)(m0 + r) * 3 * qd + slice_col(cs, j, cw, hd);
        if (load)
          u[i][c] = A::load(p);
        else
          A::store(p, u[i][c]);
      }
  };
  // does any of the warp's 16 rows hold a non-zero value (the sign bit
  // masked: -0 is dark) in this chunk; live rows recorded for the counts
  auto warp_live = [&](const T* as, int kc) {
    const int vrow = kc * (int)sizeof(T) / 16;
    bool live = false;
    for (int v = lane; v < 16 * vrow; v += 32) {
      const int r = wr * 16 + v / vrow;
      const uint4 x = *reinterpret_cast<const uint4*>(as + r * ldk + v % vrow * (16 / sizeof(T)));
      if ((x.x | x.y | x.z | x.w) & mag) {
        live = true;
        if (record) row_live[r] = 1;
      }
    }
    return __any_sync(0xFFFFFFFFu, live);
  };

  // the tile's spike words and flags of timestep t to the scratch, the
  // shared words cleared for the next timestep
  auto writeout = [&](int t, int m0, int nrows) {
    for (int i = tid; i < MA * ngw; i += NTA) {
      const uint32_t word = qkw[i];
      if (!word) continue;
      qkw[i] = 0u;
      const int r = i / ngw, lg = i % ngw / hw, wd = i % hw;
      const int grp = cw >= hd ? cs * (cw / hd) + lg : cs / (hd / cw);
      const int p = grp / heads, h = grp % heads, m = m0 + r, b = m / l, ll = m % l;
      const size_t tbh = ((size_t)t * nb + b) * heads + h;
      uint32_t* dst = (p == 0 ? bits.q : bits.k) + (tbh * l + ll) * hw + wd;
      if (owned)
        *dst = word;
      else
        atomicOr(dst, word);
      if (p == 1) bits.kf[tbh * nlb + ll / l_block] = 1;
    }
    // a value column's 64-row mask, split at key-word and sequence edges
    for (int j = tid; j < cw; j += NTA) {
      uint64_t mask = (uint64_t)vw[2 * j] | (uint64_t)vw[2 * j + 1] << 32;
      if (!mask) continue;
      vw[2 * j] = vw[2 * j + 1] = 0u;
      const int n = slice_col(cs, j, cw, hd), h = n % qd / hd, c = n % hd;
      while (mask) {
        const int r = __ffsll((long long)mask) - 1, m = m0 + r, b = m / l, ll = m % l;
        const int len = min(32 - ll % 32, l - ll);
        const uint64_t run = ((1ull << len) - 1ull) << r;
        const uint32_t seg = (uint32_t)((mask & run) >> r);
        mask &= ~run;
        const size_t tbh = ((size_t)t * nb + b) * heads + h;
        atomicOr(&bits.v[(tbh * hd + c) * lw + ll / 32], seg << (ll % 32));
        for (int lb = ll / l_block; lb * l_block < ll + len; ++lb) {
          const int lo = max(ll, lb * l_block) - ll, hi = min(ll + len, (lb + 1) * l_block) - ll;
          const uint32_t bm = (hi - lo == 32 ? ~0u : (1u << (hi - lo)) - 1u) << lo;
          if (seg & bm) bits.vf[tbh * nlb + lb] = 1;
        }
      }
    }
    if (!DEC && record)
      for (int r = tid; r < MA; r += NTA)
        if (row_live[r]) {
          row_live[r] = 0;
          const int m = m0 + r;
          bits.pf[((size_t)t * nb + m / l) * nlb + m % l / l_block] = 1;
        }
  };

  // scale, BN or RoPE, LIF -> the tile's spike words. The thread's spikes
  // go to a register mask (bit AC i + c of slot (i, c)); whole groups
  // assemble their words with warp shuffles (tile path: the 4 lanes of a
  // row's n8 tile for a q / k byte, the 8 lanes of a column for a v
  // 16-row mask; decoded: a ballot is a q / k word), and one lane ORs each
  // into the tile's words; a pair slice ORs spike by spike
  auto epilogue = [&](int t, int m0, int nrows) {
    uint32_t sp = 0u;
    int ll[2] = {0, 0};                  // rope: the sequence position of rows g, g + 8
    if constexpr (ROPE) {
      ll[0] = (m0 + wr * 16 + g) % l;
      ll[1] = (m0 + wr * 16 + g + 8) % l;
      // scale and cast into yproj, then rotate q and k against their
      // partner column
#pragma unroll
      for (int i = 0; i < AJ; ++i)
#pragma unroll
        for (int c = 0; c < AC; ++c) {
          int r, j;
          if (slot(i, c, nrows, r, j))
            yproj[r * cw + j] = A::round(__fmul_rn(acc[i][c], colp[j].x));
        }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < AJ; ++i)
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        int r, j;
        const bool valid = slot(i, c, nrows, r, j);
        j = min(j, cw - 1);
        const float4 pp = colp[j];
        float y;
        if constexpr (ROPE) {
          y = yproj[min(r, MA - 1) * cw + j];
          const int info = __float_as_int(pp.y);
          if (info >= 0) {     // q, k: [x1 cos - x2 sin, x2 cos + x1 sin]
            const int ii = info >> 16, lr = ll[c >> 1];
            const float cs_ = auxp[(size_t)lr * half + ii];
            const float sn = auxp[((size_t)l + lr) * half + ii];
            const float other = yproj[min(r, MA - 1) * cw + (info & 0xFFFF)];
            y = __float_as_int(pp.z) ? fma32(y, cs_, -__fmul_rn(other, sn))
                                     : fma32(y, cs_, __fmul_rn(other, sn));
            y = A::round(y);
          }
        } else {
          // BN's fma32 with its scale and bias staged as doubles
          const double2 gb = colq[j];
          y = A::round(__fmul_rn(acc[i][c], pp.x));
          // (the double product is exact, so one fma rounds as fma32)
          y = A::round(__double2float_rn(
              __fma_rn((double)__fmul_rn(__fsub_rn(y, pp.y), pp.z), gb.x, gb.y)));
        }
        if (lif_step<T>(u[i][c], y, lif) && valid) sp |= 1u << (i * AC + c);
      }
    if constexpr (DEC) {
      // a v column collects its rows; when whole groups are multiples of
      // 32 columns, the 8 lanes of columns 32 q + [0, 32) OR their 4-bit
      // pieces into a row's q / k word, else a spike ORs its bit
      int tag[AC];
#pragma unroll
      for (int c = 0; c < AC; ++c) {
        const int j = min(4 * lane + c, cw - 1);
        tag[c] = __float_as_int(colp[j].w);
        uint32_t vm = 0u;
#pragma unroll
        for (int i = 0; i < AJ; ++i)
          vm |= (sp >> (i * AC + c) & 1u) << (warp * DEC_ROWS + i) % 32;
        if (tag[c] >> 28 == 2 && vm) atomicOr(&vw[j * 2 + warp * DEC_ROWS / 32], vm);
      }
#pragma unroll
      for (int i = 0; i < AJ; ++i) {
        const int r = warp * DEC_ROWS + i;
        const uint32_t nib = tag[0] >> 28 < 2 ? sp >> (i * AC) & 0xFu : 0u;
        if (whole32) {
          uint32_t word = nib << (4 * lane % 32);
          word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
          word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
          word |= __shfl_xor_sync(0xFFFFFFFFu, word, 4);
          if (lane % 8 == 0 && word) atomicOr(&qkw[r * ngw + (tag[0] >> 8 & 0xFFFFF)], word);
        } else {
#pragma unroll
          for (int c = 0; c < AC; ++c)
            if (tag[c] >> 28 < 2 && (sp >> (i * AC + c) & 1u))
              atomicOr(&qkw[r * ngw + (tag[c] >> 8 & 0xFFFFF)], 1u << (tag[c] & 31));
        }
      }
    } else if (cw >= hd) {
#pragma unroll
      for (int i = 0; i < AJ; ++i) {
        const int jt = j0 + i;
        if (jt >= j1) break;
        const int tag = __float_as_int(colp[jt * 8].w);
        if (tag >> 28 < 2) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            uint32_t byte = (sp >> (i * AC + 2 * rh) & 1u) << (tig * 2) |
                            (sp >> (i * AC + 2 * rh + 1) & 1u) << (tig * 2 + 1);
            byte |= __shfl_xor_sync(0xFFFFFFFFu, byte, 1);
            byte |= __shfl_xor_sync(0xFFFFFFFFu, byte, 2);
            const int r = wr * 16 + g + 8 * rh;
            if (tig == 0 && byte)
              atomicOr(&qkw[r * ngw + (tag >> 8 & 0xFFFFF)], byte << (tag & 31));
          }
        } else {
#pragma unroll
          for (int c1 = 0; c1 < 2; ++c1) {
            uint32_t m = (sp >> (i * AC + c1) & 1u) << g | (sp >> (i * AC + c1 + 2) & 1u) << (g + 8);
            m |= __shfl_xor_sync(0xFFFFFFFFu, m, 4);
            m |= __shfl_xor_sync(0xFFFFFFFFu, m, 8);
            m |= __shfl_xor_sync(0xFFFFFFFFu, m, 16);
            if (g == 0 && m)
              atomicOr(&vw[(jt * 8 + tig * 2 + c1) * 2 + wr / 2], m << (wr % 2 * 16));
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < AJ; ++i)
#pragma unroll
        for (int c = 0; c < AC; ++c) {
          int r, j;
          if (!(sp >> (i * AC + c) & 1u) || !slot(i, c, nrows, r, j)) continue;
          const int tag = __float_as_int(colp[j].w);
          if (tag >> 28 < 2)
            atomicOr(&qkw[r * ngw + (tag >> 8 & 0xFFFFF)], 1u << (tag & 31));
          else
            atomicOr(&vw[j * 2 + r / 32], 1u << (r % 32));
        }
    }
    if constexpr (MMA) {
      // the live rows of this timestep, from the first column quarter
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t lit = rows_lit[h2];
        lit |= __shfl_xor_sync(0xFFFFFFFFu, lit, 1);
        lit |= __shfl_xor_sync(0xFFFFFFFFu, lit, 2);
        if (record && warp < 4 && tig == 0 && lit) row_live[wr * 16 + g + 8 * h2] = 1;
      }
    }
    if constexpr (DEC) {
      if (record && lane == 0)
#pragma unroll
        for (int i = 0; i < DEC_ROWS; ++i) {
          const int r = warp * DEC_ROWS + i, m = m0 + r;
          if (r < nrows)
            atomicMax(&bits.pf[((size_t)t * nb + m / l) * nlb + m % l / l_block], occ[i]);
        }
    }
    __syncthreads();
    writeout(t, m0, nrows);
  };

  // the slice's columns, once: the scale, BN's mean and inv_std and its
  // scale and bias as doubles (rope: the RoPE table column and partner,
  // and whether the column is in the first half), and the word and bit of
  // a q / k spike (tag: p << 28 | word << 8 | bit)
  for (int j = tid; j < cw; j += NTA) {
    const int n = slice_col(cs, j, cw, hd), p = n / qd, col = n % hd;
    const int tag = p << 28 | ((cw >= hd ? j / hd : 0) * hw + col / 32) << 8 | col % 32;
    if constexpr (ROPE) {
      const int info = p < 2 ? (col % half) << 16 | partner_col(j, cw, hd) : -1;
      colp[j] = make_float4(sc3[n], __int_as_float(info), __int_as_float(col < half),
                            __int_as_float(tag));
    } else {
      const float* rows = auxp + (size_t)p * 4 * qd + n % qd;
      colp[j] = make_float4(sc3[n], rows[0], rows[qd], __int_as_float(tag));
      colq[j] = make_double2((double)rows[2 * qd], (double)rows[3 * qd]);
    }
  }

  for (int st = 0; st < total; ++st) {
    cp_async_wait<SA - 2>();   // the slice and chunk st have landed
    __syncthreads();           // ... for every thread; chunk st - 1 is consumed
    prefetch(st + SA - 1);
    const int tile = blockIdx.y + st / per_tile * gridDim.y;
    const int t = st / nkc % nt, kci = st % nkc, k0 = kci * KCA, kc = min(KCA, d - k0);
    const int m0 = tile * MA, nrows = min(MA, m_all - m0);
    const T* as = ring + (size_t)(st % SA) * MA * ldk;
    const T* wk = ws + (size_t)k0 * ldw;     // the chunk's rows of the slice
    if (kci == 0) {
#pragma unroll
      for (int i = 0; i < AJ; ++i)
#pragma unroll
        for (int c = 0; c < AC; ++c) {
          acc[i][c] = 0.f;
          if (t == 0) u[i][c] = 0.f;
        }
#pragma unroll
      for (int i = 0; i < (DEC ? DEC_ROWS : 1); ++i) occ[i] = 0;
      rows_lit[0] = rows_lit[1] = 0u;
      if (t == 0 && memb && carry) membranes(m0, nrows, true);
    }

    if constexpr (DEC) {
      // each row's live entries of the chunk in ascending k
#pragma unroll
      for (int i = 0; i < DEC_ROWS; ++i) {
        const int r = warp * DEC_ROWS + i;
        if (r >= nrows) break;
        const T* srow = as + (size_t)r * ldk;
        for (int kb = 0; kb < kc; kb += 32) {
          uint32_t live = __ballot_sync(0xFFFFFFFFu, kb + lane < kc && A::load(srow + kb + lane) != 0.f);
          occ[i] += __popc(live);
          while (live) {
            const int k = kb + __ffs(live) - 1;
            live &= live - 1u;
            const float a = A::load(srow + k);
            if (4 * lane >= cw) continue;
            // the lane's 4 columns of the spike's w3 row in one load
            float w[4];
            if constexpr (std::is_same<T, float>::value) {
              const float4 v = *reinterpret_cast<const float4*>(wk + (size_t)k * ldw + 4 * lane);
              w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
            } else {
              const uint2 v = *reinterpret_cast<const uint2*>(wk + (size_t)k * ldw + 4 * lane);
              w[0] = pair_lo(v.x), w[1] = pair_hi(v.x), w[2] = pair_lo(v.y), w[3] = pair_hi(v.y);
            }
#pragma unroll
            for (int c = 0; c < DEC_COLS; ++c) {
              // bf16 x bf16 is exact in fp32: one fmaf rounds as the
              // product-then-sum
              if constexpr (std::is_same<T, float>::value)
                acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a, w[c]));
              else
                acc[i][c] = fmaf(a, w[c], acc[i][c]);
            }
          }
        }
      }
    } else if constexpr (MMA) {
      // per k16 step the A fragment, which records the live rows and skips
      // the step when the warp's 16 rows are dark in it (it would add
      // exact zeros), then every B fragment of the warp's tiles, then its
      // mma.sync steps
      for (int kk = 0; kk < kc; kk += 16) {
        uint32_t a[4], bw[MAXJ / 2][4];
        ldsm_x4(a, smem_u32(as + (wr * 16 + lane % 16) * ldk + kk + lane / 16 * 8));
        rows_lit[0] |= (a[0] | a[2]) & mag;
        rows_lit[1] |= (a[1] | a[3]) & mag;
        if (!__any_sync(0xFFFFFFFFu, ((a[0] | a[1] | a[2] | a[3]) & mag) != 0u)) continue;
        const T* wrow = wk + (size_t)(kk + lane % 16) * ldw;
#pragma unroll
        for (int i = 0; i < MAXJ; i += 2) {
          const int j = j0 + i;
          if (j + 1 < j1) {
            ldsm_x4_t(bw[i / 2], smem_u32(wrow + (j + lane / 16) * 8));
          } else if (j < j1) {
            uint32_t b2[2];
            ldsm_x2_t(b2, smem_u32(wrow + j * 8));
            bw[i / 2][0] = b2[0];
            bw[i / 2][1] = b2[1];
          }
        }
#pragma unroll
        for (int i = 0; i < MAXJ; i += 2) {
          const int j = j0 + i;
          if (j >= j1) break;
          mma_bf16(acc[i], a, bw[i / 2][0], bw[i / 2][1]);
          if (j + 1 < j1) mma_bf16(acc[i + 1], a, bw[i / 2][2], bw[i / 2][3]);
        }
      }
    } else if (warp_live(as, kc)) {
      const int r_lo = wr * 16 + g;
      if constexpr (ROPE) {
        // the rope family's analog product, four k a step: each slot's
        // sum in ascending k, one fp32 product and one fp32 sum a term
        // (bf16: one fmaf, whose bf16 x bf16 product is exact in fp32)
        const float* wt = wsf + k0;
#pragma unroll 2
        for (int kk = 0; kk < kc; kk += 4) {
          float a4[2][4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const T* ap = as + (r_lo + 8 * h2) * ldk + kk;
            if constexpr (std::is_same<T, float>::value) {
              const float4 v = *reinterpret_cast<const float4*>(ap);
              a4[h2][0] = v.x, a4[h2][1] = v.y, a4[h2][2] = v.z, a4[h2][3] = v.w;
            } else {
              const uint2 v = *reinterpret_cast<const uint2*>(ap);
              a4[h2][0] = pair_lo(v.x), a4[h2][1] = pair_hi(v.x);
              a4[h2][2] = pair_lo(v.y), a4[h2][3] = pair_hi(v.y);
            }
          }
#pragma unroll
          for (int i = 0; i < MAXJ; ++i) {
            const int j = j0 + i;
            if (j >= j1) break;
#pragma unroll
            for (int c1 = 0; c1 < 2; ++c1) {
              const float4 w4 = *reinterpret_cast<const float4*>(
                  wt + (size_t)(j * 8 + tig * 2 + c1) * (d + 4) + kk);
              const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {
                  float& sum = acc[i][c1 + 2 * h2];
                  if constexpr (std::is_same<T, float>::value)
                    sum = __fadd_rn(sum, __fmul_rn(a4[h2][q], wv[q]));
                  else
                    sum = fmaf(a4[h2][q], wv[q], sum);
                }
            }
          }
        }
      } else {
        for (int kk = 0; kk < kc; ++kk) {
          const float a_lo = A::load(as + r_lo * ldk + kk);
          const float a_hi = A::load(as + (r_lo + 8) * ldk + kk);
          const T* w0 = wk + (size_t)kk * ldw + tig * 2;
#pragma unroll
          for (int i = 0; i < MAXJ; ++i) {
            const int j = j0 + i;
            if (j >= j1) break;
            const float2 wv = *reinterpret_cast<const float2*>(w0 + j * 8);
            acc[i][0] = fmaf(a_lo, wv.x, acc[i][0]);
            acc[i][1] = fmaf(a_lo, wv.y, acc[i][1]);
            acc[i][2] = fmaf(a_hi, wv.x, acc[i][2]);
            acc[i][3] = fmaf(a_hi, wv.y, acc[i][3]);
          }
        }
      }
    }

    if (kci == nkc - 1) {
      epilogue(t, m0, nrows);
      if (t == nt - 1 && memb) membranes(m0, nrows, false);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int MW, bool AN>
__global__ void __launch_bounds__(NT)
attend_phase(Bits bits, const float* __restrict__ delta_p, float scale, int causal,
             int nt, int nb, int l, int heads, int hd, int l_block, int c_block,
             int cp, int ssa, int decoded, T* __restrict__ ctx,
             int* __restrict__ counts, int* __restrict__ ctxf) {
  using A = Act<T>;
  constexpr int RPW = QB / (NT / 32);   // query rows a warp
  const int h = blockIdx.y, t = blockIdx.z / nb, b = blockIdx.z % nb;
  const int q0 = blockIdx.x * QB, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hw = (hd + 31) / 32, lw = (l + 31) / 32, nlb = (l + l_block - 1) / l_block;
  const int qd = heads * hd;
  const float delta = *delta_p;
  const size_t tbh = ((size_t)t * nb + b) * heads + h;
  const uint32_t* qb = bits.q + tbh * l * hw;
  const uint32_t* kb = bits.k + tbh * l * hw;
  const uint32_t* vb = bits.v + tbh * hd * lw;
  const int* kf = bits.kf + tbh * nlb;
  const int* vf = bits.vf + tbh * nlb;
  const int* pf = bits.pf + ((size_t)t * nb + b) * nlb;

  extern __shared__ __align__(16) uint32_t dyn_t[];
  uint32_t* ks = dyn_t;                   // [hw][KCH]: the chunk's key bits
  uint32_t* vs = ks + (size_t)hw * KCH;   // [hd][VSTR]: its value bits
  __shared__ uint32_t keym[KCH / 32], ctxm[KCH / 32];   // live keys, live contexts
  __shared__ bool passes[MAX_HD + 1];     // binarized score of a count

  // the counts of (t, b, h), from query block 0: a key block is live
  // unless all its key rows are dark (an all-dark block scores zeros,
  // which binarize to zero unless delta <= 0; analog scores keep every
  // block), a context block when its value rows are not all dark too
  if (blockIdx.x == 0)
    for (int lb = tid; lb < nlb; lb += NT) {
      const bool kl = AN || kf[lb] || delta <= 0.f, cl = kl && vf[lb];
      const int n_proj = decoded ? (min(pow2ceil(pf[lb]), cp) + c_block - 1) / c_block : pf[lb];
      if (ssa) {
        // the SSA bundle's (H, 4) map (l_block = l): q, k, v count the
        // timesteps whose whole slab is live; attend its 2 T dots
        int* cnt = counts + (size_t)h * 4;
        atomicAdd(cnt + 0, n_proj);
        atomicAdd(cnt + 1, n_proj);
        atomicAdd(cnt + 2, n_proj);
        atomicAdd(cnt + 3, 2);
      } else {
        int* cnt = counts + (size_t)h * N_PHASES * nlb + lb;
        atomicAdd(cnt + 0 * nlb, n_proj);
        atomicAdd(cnt + 1 * nlb, n_proj);
        atomicAdd(cnt + 2 * nlb, n_proj);
        atomicAdd(cnt + 3 * nlb, (int)kl);
        atomicAdd(cnt + 4 * nlb, (int)cl);
      }
    }
  // a score is an integer count c <= hd; binarize each once:
  // fma32(c, scale, -delta) >= 0
  for (int c = tid; c <= hd; c += NT) passes[c] = fma32((float)c, scale, -delta) >= 0.f;

  const int kend = causal ? min(l, q0 + QB) : l;
  int n[RPW][MW];
  float acc[RPW][MW];
#pragma unroll
  for (int ii = 0; ii < RPW; ++ii)
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      n[ii][m] = 0;
      acc[ii][m] = 0.f;
    }
  for (int c0 = 0; c0 < kend; c0 += KCH) {
    const int c1 = min(kend, c0 + KCH), nk = c1 - c0, nw = (nk + 31) / 32;
    __syncthreads();            // the previous chunk is consumed
    for (int i = tid; i < nk * hw; i += NT) ks[i % hw * KCH + i / hw] = kb[(size_t)c0 * hw + i];
    for (int i = tid; i < hd * nw; i += NT) {
      const int col = i / nw, w = i % nw;
      vs[col * VSTR + w] = vb[(size_t)col * lw + c0 / 32 + w];
    }
    for (int w = tid; w < nw; w += NT) {
      uint32_t km = 0u, cm = 0u;
      for (int j = 0; j < 32 && c0 + 32 * w + j < c1; ++j) {
        const int lb = (c0 + 32 * w + j) / l_block;
        if (AN || kf[lb] || delta <= 0.f) {
          km |= 1u << j;
          if (vf[lb]) cm |= 1u << j;
        }
      }
      keym[w] = km;
      ctxm[w] = cm;
    }
    __syncthreads();
    // a warp's query rows, each 32-key word of the chunk once for all of
    // them: lane j scores key 32 jw + j by the AND-popcount of a row's q
    // bits and the key's bits over live (and, when causal, past) keys; the
    // ballot is the row's score word. AN: lane j's score is
    // fl(count * scale); lane c adds the scores of the live keys whose
    // value bit its column has, key by key in ascending order, each key
    // to every row that takes it (the rows' sums interleave, each in its
    // own ascending order)
    uint32_t q[RPW][MW];
    int last[RPW], lastw = -1;
#pragma unroll
    for (int ii = 0; ii < RPW; ++ii) {
      const int i = q0 + warp * RPW + ii;
      last[ii] = i >= l || (causal && i < c0) ? -1 : (causal ? min(i, c1 - 1) : c1 - 1) - c0;
#pragma unroll
      for (int w = 0; w < MW; ++w)
        q[ii][w] = last[ii] >= 0 && w < hw ? qb[(size_t)i * hw + w] : 0u;
      lastw = max(lastw, last[ii]);
    }
    for (int jw = 0; jw * 32 <= lastw; ++jw) {
      const int kk = jw * 32 + lane;
      const uint32_t km = keym[jw], cm = ctxm[jw];
      uint32_t kw[MW], vw[MW];   // the lane's key bits; the word's value bits of its columns
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        kw[w] = w < hw ? ks[w * KCH + kk] : 0u;
        const int col = lane + 32 * w;
        vw[w] = col < hd ? vs[col * VSTR + jw] : 0u;
      }
      if constexpr (AN) {
        uint32_t vor = 0u;
#pragma unroll
        for (int m = 0; m < MW; ++m) vor |= vw[m];
        // live keys that some column's value bit selects
        const uint32_t sel = cm & __reduce_or_sync(0xFFFFFFFFu, vor);
        float sc[RPW];
        uint32_t todo[RPW], any = 0u;
#pragma unroll
        for (int ii = 0; ii < RPW; ++ii) {
          int score = 0;
#pragma unroll
          for (int w = 0; w < MW; ++w) score += __popc(q[ii][w] & kw[w]);
          sc[ii] = __fmul_rn((float)score, scale);
          todo[ii] = __ballot_sync(0xFFFFFFFFu, kk <= last[ii] && (km >> lane & 1u)) & sel;
          any |= todo[ii];
        }
        while (any) {
          const int k = __ffs(any) - 1;
          any &= any - 1u;
#pragma unroll
          for (int ii = 0; ii < RPW; ++ii) {
            const float sk = __shfl_sync(0xFFFFFFFFu, sc[ii], k);
            if (todo[ii] >> k & 1u)
#pragma unroll
              for (int m = 0; m < MW; ++m)
                if (vw[m] >> k & 1u) acc[ii][m] = __fadd_rn(acc[ii][m], sk);
          }
        }
      } else {
#pragma unroll
        for (int ii = 0; ii < RPW; ++ii) {
          if (jw * 32 > last[ii]) continue;
          int score = 0;
#pragma unroll
          for (int w = 0; w < MW; ++w) score += __popc(q[ii][w] & kw[w]);
          const uint32_t word = __ballot_sync(0xFFFFFFFFu, kk <= last[ii] && (km >> lane & 1u) &&
                                                               passes[min(score, hd)]) & cm;
#pragma unroll
          for (int m = 0; m < MW; ++m) n[ii][m] += __popc(word & vw[m]);
        }
      }
    }
  }
  // the context (integer counts, exact in the activation dtype; analog:
  // the ascending sums); ctxf, when set (the layer program), gets launch
  // B's wo flag of the row's (t, b, L-block, head): a value that is not
  // zero in the activation dtype
#pragma unroll
  for (int ii = 0; ii < RPW; ++ii) {
    const int i = q0 + warp * RPW + ii;
    if (i >= l) continue;
    bool lit = false;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int col = lane + 32 * m;
      if (col < hd) {
        const float v = AN ? acc[ii][m] : (float)n[ii][m];
        A::store(ctx + (((size_t)t * nb + b) * l + i) * qd + h * hd + col, v);
        lit |= A::round(v) != 0.f;
      }
    }
    if (ctxf && __any_sync(0xFFFFFFFFu, lit) && lane == 0)
      ctxf[(((size_t)t * nb + b) * nlb + i / l_block) * heads + h] = 1;
  }
}

template <typename T>
using AttendKernel = void (*)(Bits, const float*, float, int, int, int, int, int, int,
                              int, int, int, int, int, T*, int*, int*);

// attend_phase's instantiation for hw q / k words a row (1, 2, else up to
// 4) and analog scores
template <typename T>
AttendKernel<T> attend_kernel(int hw, int analog) {
  if (hw == 1) return analog ? attend_phase<T, 1, true> : attend_phase<T, 1, false>;
  if (hw == 2) return analog ? attend_phase<T, 2, true> : attend_phase<T, 2, false>;
  return analog ? attend_phase<T, 4, true> : attend_phase<T, 4, false>;
}

// the card's SMs and the blocks of `kernel` an SM holds at `smem` bytes
// of shared memory, asked once for each (device, kernel, smem): the
// queries cost host time on every launch
template <typename K>
cudaError_t blocks_per_card(K kernel, size_t smem, int* nsm, int* per_sm) {
  struct Entry {
    int dev;
    const void* kernel;
    size_t smem;
    int nsm, per_sm;
  };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].kernel == (const void*)kernel && cache[i].smem == smem) {
      *nsm = cache[i].nsm;
      *per_sm = cache[i].per_sm;
      return cudaSuccess;
    }
  if ((err = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NTA, smem)) !=
      cudaSuccess)
    return err;
  if (used < 32) cache[used++] = Entry{dev, (const void*)kernel, smem, *nsm, *per_sm};
  return cudaSuccess;
}

// launch A: project_phase over (column slice, row group) blocks, enough
// row groups to fill the card once, then attend_phase over (query block,
// head, (t, b)); bits is the zeroed scratch of these nt timesteps
template <typename T>
cudaError_t launch_attention(int rope, int decoded, int analog, const void* s,
                             const void* w3, const float* sc3,
                             const float* auxp, const float* delta,
                             float scale, Lif lif, int causal, int nt, int nb,
                             int l, int d, int heads, int hd, int l_block,
                             int c_block, int cp, int ssa, int cw, Bits bits,
                             void* ctx, int* counts, int* ctxf, void* memb, int carry,
                             cudaStream_t stream) {
  if (hd > MAX_HD || hd % 8 || d % 16 || !valid_width(cw, heads, hd))
    return cudaErrorInvalidValue;
  const size_t smem = SmemP(sizeof(T), d, hd, cw, rope).total;
  auto proj = rope ? project_phase<T, MODE_ROPE>
                   : decoded ? project_phase<T, MODE_DEC> : project_phase<T, MODE_TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      proj, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int nsm = 0, per_sm = 0;
  if ((err = blocks_per_card(proj, smem, &nsm, &per_sm)) != cudaSuccess) return err;
  const int ncs = 3 * heads * hd / cw, ntiles = (nb * l + MA - 1) / MA;
  const int nrg = max(1, min(ntiles, (nsm * max(per_sm, 1) + ncs - 1) / ncs));
  proj<<<dim3(ncs, nrg), NTA, smem, stream>>>(
      (const T*)s, (const T*)w3, sc3, auxp, lif, nt, nb, l, d, heads, hd, l_block, cw,
      bits, (T*)memb, carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int hw = (hd + 31) / 32;
  const AttendKernel<T> att = attend_kernel<T>(hw, analog);
  const size_t smem_t = ((size_t)hw * KCH + (size_t)hd * VSTR) * 4;
  err = cudaFuncSetAttribute(att, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_t);
  if (err != cudaSuccess) return err;
  att<<<dim3((l + QB - 1) / QB, heads, nt * nb), NT, smem_t, stream>>>(
      bits, delta, scale, causal, nt, nb, l, heads, hd, l_block, c_block, cp, ssa,
      decoded, (T*)ctx, counts, ctxf);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch B: wo, (rope) ln2, up and down, each a kernel over the whole card
// ---------------------------------------------------------------------------
//
// Each product is mlp_gemm<T, PH, PIPE>: block (row tile, column tile)
// holds BN output columns of NSETS row sets of BM flattened (b, l) rows:
// the fused kernel's sets are one row tile at NSETS timesteps, its block
// looping over groups of NSETS timesteps (any T) with the LIF membranes of
// its slots in shared memory across the groups; the pipelined kernel's
// are up to NSETS row tiles of its one timestep, its membranes in device
// memory. The K dimension streams through a cp.async ring of KC-deep
// chunks: each chunk's weights (KC x BN, padded rows: the ldmatrix.trans
// reads fall in distinct banks) and the left operand of every live set,
// so a weight chunk is copied once for the block's sets and its B
// fragments serve all of them. A thread owns 16 slots a set (warp w: rows
// 16 (w % 4) + [0, 16), columns 32 (w / 4) + [0, 32); slot q = 4 j + c is
// accumulator c of the warp's n8 tile j).
//   PH_WO   ctx (T, B L, H hd) x wo; scale; bn: bn_o, residual (x1 parked
//           in `out`), the input neuron's LIF into spike bits; rope:
//           residual (x1 in `out`);
//   PH_UP   the input neuron's spike bits x w1; scale, bn_1, LIF into the
//           hidden spike bits;
//   PH_UPR  the rope family's ln2 output (norm_phase, in s2g) x w1; scale,
//           LIF into the hidden spike bits;
//   PH_DOWN the hidden spike bits x w2; scale (+ bn_2), residual on x1.
// The spike bits live in device memory, (T, B L, ceil(D / 32)) and (T, B
// L, ceil(F / 32)) words (the wrapper's scratch): a warp assembles a row's
// 32-column word with two shuffles and one lane stores it, so no shared
// memory or atomic bounds D or F.
//
// Products: bf16 with exact operands (integer counts of binarized scores,
// spikes expanded from the bits) on the tensor cores, mma.sync m16n8k16
// with fp32 accumulation, the weights' B fragments loaded by
// ldmatrix.trans once a k16 step and reused for every set; a warp skips a
// set of a chunk whose spike words are dark for its 16 rows. Analog
// operands (the ln2 output; the context of analog scores) and fp32 run on
// CUDA cores, each output's sum in ascending k in one thread (bf16 fmaf,
// whose bf16 x bf16 product is exact; fp32 __fmul_rn then __fadd_rn: the
// plain version's seq_matmul), on the same slots. A chunk whose left
// operand is dark in every set adds exact zeros and is neither copied nor
// multiplied.
//
// Liveness and counts: launch A's attend_phase flags each (t, b, L-block,
// head) whose context is not all zero, the wo epilogue (bn) or norm_phase
// (rope) each (t, b, L-block) with an input-neuron spike or a non-zero ln2
// output, the up epilogue each (t, b, L-block, head) with a hidden spike:
// int32 words, stored (never read back by their writers). A block ORs the
// flags of the (b, L-block)s its rows meet into its chunks' set masks,
// and the down kernel's blocks turn the three flag sets into the (H, 8, nlb)
// map's wo, up and down columns with order-free int32 atomics, so the
// counts are the TPU kernel's at any number of heads.

constexpr int NTB = 256;          // threads of a launch B block
constexpr int BM = 64;            // flattened (b, l) rows of a tile
constexpr int BN = 64;            // output columns of a tile
constexpr int KCB_BYTES = 128;    // a K-chunk's row of a staged operand: 64 bf16, 32 fp32
constexpr int NSETS = 4;          // row sets of a block: timesteps (fused) or row tiles (pipelined)
constexpr int HEAD_CAP = 4096;    // heads whose masks a block keeps; past it: always live
constexpr int PH_WO = 0, PH_UP = 1, PH_UPR = 2, PH_DOWN = 3;

// launch B's flag words (kernels/fused_layer.py::flag_words), carved from
// one zeroed int32 buffer of nt timesteps: ctx and hid (T, B, nlb, H),
// s2 (T, B, nlb)
struct Flags {
  int *ctx, *hid, *s2;
  // timestep t's sections of a buffer of nt timesteps
  static Flags at(void* base, int nt, int t, int nb, int nlb, int heads) {
    int* f = (int*)base;
    const size_t hw = (size_t)nb * nlb * heads, sw = (size_t)nb * nlb;
    return Flags{f + t * hw, f + nt * hw + t * hw, f + 2 * nt * hw + t * sw};
  }
};

template <typename T>
struct MlpArgs {
  const T *x, *ctx, *wo, *w1, *w2;
  const float *sco, *sc1, *sc2, *auxo, *aux1, *aux2;
  // mem_*: the membranes between launches (pipelined) or between groups
  // of timesteps (fused, T > NSETS)
  T *s2g, *out, *mem_in, *mem_hid;
  uint32_t *s2b, *hb;                 // spike bits, chunk-major (spike_words)
  Flags fl;
  int* counts;
  Lif lif;
  float norm_eps;
  int rope, analog, carry, nt, nb, l, d, heads, hd, ff, l_block;
};

__host__ __device__ constexpr bool vals_operand(int ph) { return ph == PH_WO || ph == PH_UPR; }

// mlp_gemm's dynamic shared memory, carved in this order: the weight ring,
// the left-operand ring (every set's rows), the expanded spikes (these
// three hold the accumulators in the epilogue), a column's parameters, the
// expansion table of a byte of spikes, each row's flag index, the heads'
// set masks, each K-chunk's set mask
struct SmemB {
  int kc, stages, ldw, lda;
  size_t a, a_stage, aexp, cols, lut, rtbl, live, cmask, total;
  __host__ __device__ SmemB(int es, int ph, int ngroups, int k_dim)
      : kc(KCB_BYTES / es), stages(vals_operand(ph) ? 2 : 3), ldw(padded(BN, es)),
        lda(padded(KCB_BYTES / es, es)) {
    a = align16((size_t)stages * kc * ldw * es);
    a_stage = vals_operand(ph) ? (size_t)NSETS * BM * lda * es : (size_t)NSETS * BM * 8;
    aexp = a + align16((size_t)stages * a_stage);
    cols = aexp + (vals_operand(ph) || es == 4 ? 0 : (size_t)2 * NSETS * BM * kc * 2);
    // the accumulators are parked over the rings for the epilogue
    const size_t parked = (size_t)NSETS * 16 * NTB * 4;
    cols = cols < parked ? parked : cols;
    lut = cols + (size_t)BN * 32;
    rtbl = lut + (vals_operand(ph) || es == 4 ? 0 : (size_t)256 * 16);
    live = rtbl + (size_t)NSETS * BM * 4;
    cmask = live + align16((size_t)(ngroups < HEAD_CAP ? ngroups : HEAD_CAP) * 4);
    total = cmask + align16((size_t)((k_dim + kc - 1) / kc) * 4);
  }
};

// wgmma (sm_90a) on operands in shared memory laid out as 8 x 8 core
// matrices of 16-bit elements (128 contiguous bytes, no swizzle): a
// K-chunk of KC = 64 k is 8 k-groups CORE_KG bytes apart, and within a
// k-group the 8-row (A, K-major: a row's 8 k in 16 bytes) or 8-column
// (B, N-major: a k's 8 columns in 16 bytes) groups are 128 bytes apart
constexpr int CORE_KG = 1024;   // BM / 8 (= BN / 8) groups of 128 bytes

// the byte offsets of (column c, k) in B's chunk and of (row r, k) in A's
__host__ __device__ constexpr int core_b(int c, int k) {
  return k / 8 * CORE_KG + c / 8 * 128 + k % 8 * 16 + c % 8 * 2;
}
__host__ __device__ constexpr int core_a(int r, int k) {
  return k / 8 * CORE_KG + r / 8 * 128 + r % 8 * 16 + k % 8 * 2;
}

// a shared-memory matrix descriptor: start address, leading byte offset
// (between the two k-groups of a k16 step), stride byte offset (between
// 8-row or 8-column groups), no swizzle
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t)(smem_u32(p) >> 4 & 0x3FFFu) | (uint64_t)(CORE_KG >> 4) << 16 |
         (uint64_t)(128 >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from touching an accumulator across an async wgmma
__device__ __forceinline__ void fence_acc(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D[64 x 32] += A[64 x 16] B[16 x 32], bf16 in, fp32 accumulators (the
// warpgroup's 64 rows; a thread's 16 slots in mma.sync's C layout): A
// K-major, B N-major (transposed)
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// rows [k0, k0 + KC) x columns [n0, n0 + BN) of a row-major (k_dim, n)
// weight into dst, zero outside: row-major [KC][ldd], or (core) wgmma's
// N-major core matrices; 16-byte cp.async when rows are whole vectors
// (vec), else element by element
template <typename T, int KC>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, int n, int k_dim,
                                              int k0, int n0, T* dst, int ldd, bool vec,
                                              bool core) {
  constexpr int V = 16 / sizeof(T);
  auto at = [&](int kk, int cc) {
    return core ? (T*)((unsigned char*)dst + core_b(cc, kk)) : dst + kk * ldd + cc;
  };
  if (vec) {
    for (int i = threadIdx.x; i < KC * (BN / V); i += NTB) {
      const int kk = i / (BN / V), cc = i % (BN / V) * V;
      const bool in = k0 + kk < k_dim && n0 + cc < n;
      cp_async16(at(kk, cc), in ? w + (size_t)(k0 + kk) * n + n0 + cc : w, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < KC * BN; i += NTB) {
      const int kk = i / BN, cc = i % BN;
      if (k0 + kk < k_dim && n0 + cc < n)
        *at(kk, cc) = w[(size_t)(k0 + kk) * n + n0 + cc];
      else
        Act<T>::store(at(kk, cc), 0.f);
    }
  }
}

// the (H, 8, nlb) map's wo, up and down columns from launch B's flags:
// every block takes a grid-stride share of the (t, b, L-block, head)s
template <typename T>
__device__ void add_counts(const MlpArgs<T>& p, int nlb) {
  const size_t n = (size_t)p.nt * p.nb * nlb * p.heads;
  const size_t stride = (size_t)gridDim.x * gridDim.y * NTB;
  for (size_t i = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NTB + threadIdx.x; i < n;
       i += stride) {
    const size_t tbl = i / p.heads;
    const int h = (int)(i % p.heads), lb = (int)(tbl % nlb);
    int* cnt = p.counts + (size_t)h * N_PHASES * nlb + lb;
    if (p.fl.ctx[i]) atomicAdd(cnt + 5 * nlb, 1);
    if (p.fl.s2[tbl]) atomicAdd(cnt + 6 * nlb, 1);
    if (p.fl.hid[i]) atomicAdd(cnt + 7 * nlb, 1);
  }
}

template <typename T, int PH, bool PIPE>
__global__ void __launch_bounds__(NTB, 2) mlp_gemm(const __grid_constant__ MlpArgs<T> p) {
  using A = Act<T>;
  constexpr bool BF = !std::is_same<T, float>::value, VALS = vals_operand(PH);
  constexpr int KC = KCB_BYTES / sizeof(T), S = VALS ? 2 : 3;
  constexpr int LDW = padded(BN, sizeof(T)), LDA = padded(KC, sizeof(T));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const int M = p.nb * p.l, n0 = blockIdx.y * BN, nlb = (p.l + p.l_block - 1) / p.l_block;
  // the block's rows: fused, BM rows whose sets are the group's timesteps;
  // pipelined, NSETS row tiles of the launch's timestep, a set each
  const int mb = blockIdx.x * (PIPE ? NSETS : 1) * BM;
  const int ffc = p.ff / p.heads;
  const int K = PH == PH_WO ? p.heads * p.hd : PH == PH_DOWN ? p.ff : p.d;
  const int N = PH == PH_WO || PH == PH_DOWN ? p.d : p.ff;
  const T* W = PH == PH_WO ? p.wo : PH == PH_DOWN ? p.w2 : p.w1;
  // a flag group: the k columns of one head (wo: hd, down: F / H), or all
  // of K (up: one flag a (t, b, L-block))
  const int ngroups = PH == PH_WO || PH == PH_DOWN ? p.heads : 1;
  const int ncap = min(ngroups, HEAD_CAP);
  const int gw = PH == PH_WO ? p.hd : PH == PH_DOWN ? ffc : K;
  // spike bits, chunk-major: (T, pairs of 64 columns, B L rounded up to
  // even, 2 words); kp: the left operand's pairs, np_: the output's
  const int kp = (K + 63) / 64, np_ = (N + 63) / 64, nw = (N + 31) / 32, mp = M + (M & 1);
  const bool vec = (N * (int)sizeof(T)) % 16 == 0 && (size_t)W % 16 == 0;
  // CUDA cores in ascending k: fp32, and the analog left operands; else
  // (bf16, exact operands) the tensor cores' wgmma
  const bool chain = !BF || PH == PH_UPR || (PH == PH_WO && p.analog), gmma = !chain;
  const int wg = warp / 4;   // the warpgroup: columns 32 wg + [0, 32) of the tile
  // the LIF of the epilogue: bn wo (the input neuron), up (the hidden layer)
  const bool fires = PH == PH_UP || PH == PH_UPR || (PH == PH_WO && !p.rope);
  // the membranes in device memory (B L, N): the pipelined variant's
  // between launches, the fused one's between groups of timesteps (T >
  // NSETS; else none)
  T* mem = !fires ? nullptr : PH == PH_WO ? p.mem_in : p.mem_hid;
  const T* src_v = PH == PH_WO ? p.ctx : p.s2g;
  const uint32_t* src_b = PH == PH_UP ? p.s2b : p.hb;

  extern __shared__ __align__(16) unsigned char dyn_b[];
  const SmemB lay(sizeof(T), PH, ngroups, K);
  T* wring = (T*)dyn_b;
  unsigned char* aring = dyn_b + lay.a;
  const uint4* lut = (const uint4*)(dyn_b + lay.lut);  // [256]: a byte's 8 spikes in bf16
  float4* colp = (float4*)(dyn_b + lay.cols);   // [BN]: scale, BN's mean and inv_std
  double2* colq = (double2*)(colp + BN);        // [BN]: BN's scale and bias
  T* aexp = (T*)(dyn_b + lay.aexp);             // spikes: every set's chunk as wgmma's A
  int* rtbl = (int*)(dyn_b + lay.rtbl);         // [NSETS][BM]: a row's (t, b, L-block)
  int* live = (int*)(dyn_b + lay.live);         // [min(groups, HEAD_CAP)]: set masks
  int* cmask = (int*)(dyn_b + lay.cmask);       // [K-chunks]: set masks

  if constexpr (PH == PH_DOWN) add_counts(p, nlb);

  if (BF && !VALS)
    ((uint4*)lut)[tid] = make_uint4(bit_pair(tid, 0), bit_pair(tid, 2), bit_pair(tid, 4),
                                    bit_pair(tid, 6));
  const float* scl = PH == PH_WO ? p.sco : PH == PH_DOWN ? p.sc2 : p.sc1;
  const float* aux = PH == PH_WO ? p.auxo : PH == PH_DOWN ? p.aux2 : p.aux1;
  for (int j = tid; j < BN; j += NTB) {
    const int c = min(n0 + j, N - 1);
    colp[j] = make_float4(scl[c], p.rope ? 0.f : aux[c], p.rope ? 0.f : aux[N + c], 0.f);
    colq[j] = p.rope ? make_double2(0.0, 0.0) : make_double2(aux[2 * N + c], aux[3 * N + c]);
  }

  // the thread's spike word in a row, and (up) the first head it holds
  const int wi = n0 / 32 + wc, hw0 = PH == PH_UP || PH == PH_UPR ? 32 * wi / ffc : 0;
  // slot q: tile row and column
  auto srow = [&](int q) { return 16 * wr + g + 8 * (q >> 1 & 1); };
  auto scol = [&](int q) { return 32 * wc + 8 * (q >> 2) + 2 * tig + (q & 1); };

  for (int t0 = 0; t0 < (PIPE ? 1 : p.nt); t0 += NSETS) {
    // set s: timestep ts(s), rows ms(s) + [0, nr(s))
    const int ns = PIPE ? min(NSETS, (M - mb + BM - 1) / BM) : min(NSETS, p.nt - t0);
    auto ts = [&](int s) { return PIPE ? 0 : t0 + s; };
    auto ms = [&](int s) { return PIPE ? mb + s * BM : mb; };
    auto nr = [&](int s) { return min(BM, M - ms(s)); };
    const int all = (1 << ns) - 1;
    __syncthreads();   // the previous group's masks and stages are consumed
    // each row's (t, b, L-block), -1 past its set
    for (int i = tid; i < NSETS * BM; i += NTB) {
      const int st = i / BM, r = i % BM, m = ms(st) + r;
      rtbl[i] = st < ns && r < nr(st)
                    ? (ts(st) * p.nb + m / p.l) * nlb + m % p.l / p.l_block : -1;
    }
    for (int gi = tid; gi < ncap; gi += NTB) live[gi] = 0;
    __syncthreads();
    // bit s of live[gi]: some (b, L-block) that set s's rows meet has group
    // gi's flag at timestep ts(s); a row reads its flag where its (t, b,
    // L-block) starts
    for (int i = tid; i < ncap * NSETS * BM; i += NTB) {
      const int gi = i / (NSETS * BM), sr = i % (NSETS * BM), tbl = rtbl[sr];
      if (tbl < 0 || (sr % BM && rtbl[sr - 1] == tbl)) continue;
      const int f = PH == PH_WO    ? p.fl.ctx[(size_t)tbl * p.heads + gi]
                    : PH == PH_DOWN ? p.fl.hid[(size_t)tbl * p.heads + gi]
                                    : p.fl.s2[tbl];
      if (f) atomicOr(live + gi, 1 << sr / BM);
    }
    __syncthreads();
    // the sets whose left operand may be live in each K-chunk
    for (int ci = tid; ci * KC < K; ci += NTB) {
      int mask = 0;
      const int h1 = (min(ci * KC + KC, K) - 1) / gw;
      for (int h = ci * KC / gw; h <= h1; ++h) mask |= h < ncap ? live[h] : all;
      cmask[ci] = mask;
    }
    __syncthreads();
    auto chunk_live = [&](int k0) { return cmask[k0 / KC]; };
    auto next_live = [&](int k0) {
      while (k0 < K && !chunk_live(k0)) k0 += KC;
      return k0;
    };
    auto issue = [&](int k0, int st) {
      stage_weights<T, KC>(W, N, K, k0, n0, wring + (size_t)st * KC * LDW, LDW, vec, gmma);
      const int mask = chunk_live(k0);
      unsigned char* as = aring + st * lay.a_stage;
      for (int s = 0; s < NSETS; ++s) {
        // a dead set: skipped on CUDA cores, zeros for wgmma's A (its
        // products run unconditionally: a branch would serialize them)
        const bool lit = s < ns && mask >> s & 1;
        if (!lit && (!gmma || !VALS)) continue;
        const size_t row0 = (size_t)ts(s) * M + ms(s);
        const int rows = lit ? nr(s) : 0;
        if constexpr (VALS) {
          // wgmma: K-major core matrices, a set's BM x KC in BM KC 2 bytes;
          // CUDA cores: rows of LDA
          constexpr int V = 16 / sizeof(T);
          T* dst = (T*)as + (size_t)s * BM * LDA;
          for (int i = tid; i < BM * (KC / V); i += NTB) {
            const int r = i / (KC / V), kk = i % (KC / V) * V;
            const bool in = r < rows && k0 + kk < K;
            T* d = gmma ? (T*)((unsigned char*)as + s * BM * KC * 2 + core_a(r, kk))
                        : dst + r * LDA + kk;
            cp_async16(d, in ? src_v + (row0 + r) * K + k0 + kk : src_v, in ? 16 : 0);
          }
        } else {
          // the set's rows of the chunk's pair of words: 8 bytes a row,
          // contiguous, 16 bytes (two rows) a copy
          uint32_t* dst = (uint32_t*)as + (size_t)s * BM * 2;
          const uint32_t* src = src_b + (((size_t)ts(s) * kp + k0 / 64) * mp + ms(s)) * 2;
          for (int i = tid; i < BM / 2; i += NTB) {
            const int n_in = max(0, min(2, rows - 2 * i));
            cp_async16(dst + 4 * i, n_in ? src + 4 * i : src_b, 8 * n_in);
          }
        }
      }
    };

    float acc[NSETS][16];
#pragma unroll
    for (int s = 0; s < NSETS; ++s)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[s][q] = 0.f;
    // the ring: chunk kc (being multiplied) and ki (next to copy), S - 1
    // live chunks apart
    int kc = next_live(0), ki = kc;
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (ki < K) {
        issue(ki, st);
        ki = next_live(ki + KC);
      }
      cp_async_commit();
    }
    if (gmma) {
      if constexpr (BF) {
        // the tensor cores: chunk it's products run asynchronously while
        // chunk it + 1 lands and (spikes) is expanded into the other A
        // buffer, and chunk it + S - 1 is copied into chunk it - 1's stage
        constexpr int ASET = BM * KC * 2;   // bytes of a set's A
        // spikes: every set's bits of chunk k0 (stage st) into A buffer
        // buf, a row's word a byte (8 k) a 16-byte table entry (a dead
        // set's: zeros)
        auto expand = [&](int k0, int st, int buf) {
          const int mask = chunk_live(k0);
          const uint32_t* bs = (const uint32_t*)(aring + st * lay.a_stage);
          unsigned char* dst0 = (unsigned char*)aexp + buf * NSETS * ASET;
          for (int i = tid; i < NSETS * BM * 2; i += NTB) {
            const int r = i % BM, wd = i / BM % 2, se = i / (BM * 2);
            const uint32_t word = mask >> se & 1 ? bs[(se * BM + r) * 2 + wd] : 0u;
#pragma unroll
            for (int by = 0; by < 4; ++by)
              *reinterpret_cast<uint4*>(dst0 + se * ASET + core_a(r, (wd * 4 + by) * 8)) =
                  lut[word >> 8 * by & 255u];
          }
        };
        cp_async_wait<S - 2>();   // chunk 0
        fence_async_smem();
        __syncthreads();
        if constexpr (!VALS) {
          if (kc < K) expand(kc, 0, 0);
          fence_async_smem();
          __syncthreads();
        }
        for (int it = 0; kc < K; ++it) {
          const int kn = next_live(kc + KC);
          const unsigned char* ws = (const unsigned char*)(wring + (size_t)(it % S) * KC * LDW);
          const unsigned char* abase =
              VALS ? aring + (it % S) * lay.a_stage : (const unsigned char*)aexp + it % 2 * NSETS * ASET;
          // the warpgroup's 32 columns of every live set, a k16 step at a time
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) {
            const uint64_t db = gmma_desc(ws + ks * 2 * CORE_KG + wg * 512);
#pragma unroll
            for (int st = 0; st < NSETS; ++st)
              wgmma_m64n32(acc[st], gmma_desc(abase + st * ASET + ks * 2 * CORE_KG), db);
          }
          wgmma_commit();
          wgmma_wait1();   // chunk it - 1's products are done
          if (kn < K) {
            if constexpr (VALS) {
              __syncthreads();   // ... in both warpgroups: its stage is free
              if (ki < K) {
                issue(ki, (it + S - 1) % S);
                ki = next_live(ki + KC);
              }
              cp_async_commit();
              cp_async_wait<S - 2>();   // chunk it + 1
              fence_async_smem();
              __syncthreads();
            } else {
              cp_async_wait<S - 3>();   // chunk it + 1
              fence_async_smem();
              __syncthreads();   // ... and chunk it - 1's stage and A are free
              if (ki < K) {
                issue(ki, (it + S - 1) % S);
                ki = next_live(ki + KC);
              }
              cp_async_commit();
              expand(kn, (it + 1) % S, (it + 1) % 2);
              fence_async_smem();
              __syncthreads();
            }
          }
          kc = kn;
        }
        wgmma_wait0();
#pragma unroll
        for (int st = 0; st < NSETS; ++st)
#pragma unroll
          for (int q = 0; q < 16; ++q) fence_acc(acc[st][q]);
      }
    } else {
    // CUDA cores
    for (int it = 0; kc < K; ++it) {
      cp_async_wait<S - 2>();   // chunk kc has landed
      __syncthreads();          // ... for every thread; the previous stage is consumed
      if (ki < K) {
        issue(ki, (it + S - 1) % S);
        ki = next_live(ki + KC);
      }
      cp_async_commit();
      const int mask = chunk_live(kc);
      const T* ws = wring + (size_t)(it % S) * KC * LDW;
      const unsigned char* ast = aring + (it % S) * lay.a_stage;
      {
        // two k a step: the weights of the thread's 8 columns, then each
        // live set's rows g and g + 8, each slot's sum in ascending k
        for (int kk = 0; kk < KC; kk += 2) {
          float w[2][8];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const T* wp = ws + (kk + e) * LDW + 32 * wc + 8 * j + 2 * tig;
              if constexpr (BF) {
                const uint32_t v = ld_pair(wp);
                w[e][2 * j] = pair_lo(v);
                w[e][2 * j + 1] = pair_hi(v);
              } else {
                const float2 v = *reinterpret_cast<const float2*>(wp);
                w[e][2 * j] = v.x;
                w[e][2 * j + 1] = v.y;
              }
            }
#pragma unroll
          for (int s = 0; s < NSETS; ++s) {
            if (!(mask >> s & 1)) continue;
            float a[2][2];   // [row g / g + 8][k kk / kk + 1]
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * wr + g + 8 * h;
              if constexpr (VALS) {
                const T* ap = (const T*)ast + ((size_t)s * BM + r) * LDA + kk;
                if constexpr (BF) {
                  const uint32_t v = ld_pair(ap);
                  a[h][0] = pair_lo(v);
                  a[h][1] = pair_hi(v);
                } else {
                  const float2 v = *reinterpret_cast<const float2*>(ap);
                  a[h][0] = v.x;
                  a[h][1] = v.y;
                }
              } else {
                const uint32_t word =
                    ((const uint32_t*)ast)[((size_t)s * BM + r) * 2 + kc % 64 / 32 + kk / 32];
                a[h][0] = (float)(word >> (kk % 32) & 1u);
                a[h][1] = (float)(word >> (kk % 32 + 1) & 1u);
              }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int q = 0; q < 16; ++q) {
                const float av = a[q >> 1 & 1][e], wv = w[e][2 * (q >> 2) + (q & 1)];
                if constexpr (BF)
                  acc[s][q] = fmaf(av, wv, acc[s][q]);
                else
                  acc[s][q] = __fadd_rn(acc[s][q], __fmul_rn(av, wv));
              }
          }
        }
      }
      kc = next_live(kc + KC);
    }
    }
    cp_async_wait<0>();
    // the accumulators parked over the rings, so the epilogue holds one
    // set's in registers
    __syncthreads();   // every warp is done with the rings
    float* accs = (float*)dyn_b;   // [NSETS][16][NTB]
#pragma unroll
    for (int st = 0; st < NSETS; ++st)
#pragma unroll
      for (int q = 0; q < 16; ++q) accs[(st * 16 + q) * NTB + tid] = acc[st][q];

    // the epilogue, set by set in order (fused: the timesteps of the LIF)
    // fused: the membranes of the slots, from the previous group
    float u[16];
    if (!PIPE && fires)
#pragma unroll
      for (int q = 0; q < 16; ++q)
        u[q] = t0 && srow(q) < nr(0) && n0 + scol(q) < N
                   ? A::load(mem + (size_t)(mb + srow(q)) * N + n0 + scol(q)) : 0.f;
#pragma unroll
    for (int s = 0; s < NSETS; ++s) {
      if (s >= ns) break;
      const int tt = ts(s), m1 = ms(s), rows = nr(s);
      // the set's residual (wo: x; down: x1 in `out`) or (pipelined) its
      // membranes, loaded before any store, all 16 in flight
      float ld[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = srow(q), c = n0 + scol(q);
        const bool in = r < rows && c < N;
        if constexpr (PH == PH_WO || PH == PH_DOWN)
          ld[q] = in ? A::load((PH == PH_WO ? p.x : p.out) + ((size_t)tt * M + m1 + r) * N + c)
                     : 0.f;
        if (PIPE && fires) u[q] = p.carry && in ? A::load(mem + (size_t)(m1 + r) * N + c) : 0.f;
      }
      // slots q and q + 1 (q even: neighbouring columns of a row) at
      // once, each rounding to the activation dtype a packed conversion of
      // the pair
      uint32_t sp = 0u;   // bit q: slot q spiked
#pragma unroll
      for (int q = 0; q < 16; q += 2) {
        const int r = srow(q), j = scol(q), c = n0 + j;
        const bool in[2] = {r < rows && c < N, r < rows && c + 1 < N};
        float y[2], v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) y[e] = __fmul_rn(accs[(s * 16 + q + e) * NTB + tid], colp[j + e].x);
        A::round2(y[0], y[1]);
        // bn: (y - mean) * inv_std, then fma32 with BN's scale and bias (the
        // double product is exact, so one fma rounds as fma32)
        if (!p.rope) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 cp = colp[j + e];
            const double2 cq = colq[j + e];
            y[e] = __double2float_rn(__fma_rn((double)__fmul_rn(__fsub_rn(y[e], cp.y), cp.z), cq.x, cq.y));
          }
          A::round2(y[0], y[1]);
        }
        const size_t off = ((size_t)tt * M + m1 + r) * N + c, moff = (size_t)(m1 + r) * N + c;
        if constexpr (PH == PH_WO || PH == PH_DOWN) {
          // the residual; wo then steps the input neuron on x1
#pragma unroll
          for (int e = 0; e < 2; ++e) v[e] = __fadd_rn(ld[q + e], y[e]);
          A::round2(v[0], v[1]);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (in[e]) A::store(p.out + off + e, v[e]);
        } else {
          v[0] = y[0], v[1] = y[1];
        }
        if (fires) {
          float uu[2] = {u[q], u[q + 1]};
          const uint32_t fired = lif_step2<T>(uu, v, p.lif);
          u[q] = uu[0], u[q + 1] = uu[1];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (in[e] && (fired >> e & 1u)) sp |= 1u << (q + e);
            if (PIPE && in[e]) A::store(mem + moff + e, u[q + e]);
          }
        }
      }
      if (!fires) continue;
      // the spike words: a row's 32 columns of the warp from its 4 lanes
      // (tig), stored whole by lane tig == h for row half h; their flags
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            word |= (sp >> (4 * j + 2 * h + c) & 1u) << (8 * j + 2 * tig + c);
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
        const int r = 16 * wr + g + 8 * h;
        if (tig != h || r >= rows || wi >= nw) continue;
        const int m = m1 + r;
        const size_t tbl = rtbl[s * BM + r];
        // the word's place, and a pair's second word past the last column
        // written as zero
        uint32_t* dst = (PH == PH_WO ? p.s2b : p.hb) + (((size_t)tt * np_ + wi / 2) * mp + m) * 2;
        dst[wi % 2] = word;
        if (wi + 1 == nw && nw % 2) dst[1] = 0u;
        if constexpr (PH == PH_WO) {
          if (word) p.fl.s2[tbl] = 1;
        } else {
          // the heads whose columns the word holds
          for (int hh = hw0; word && hh * ffc < min(32 * wi + 32, N); ++hh) {
            const int lo = max(32 * wi, hh * ffc) - 32 * wi;
            const int hi = min(32 * wi + 32, (hh + 1) * ffc) - 32 * wi;
            const uint32_t bm = (hi - lo == 32 ? ~0u : (1u << (hi - lo)) - 1u) << lo;
            if (word & bm) p.fl.hid[tbl * p.heads + hh] = 1;
          }
        }
      }
    }
    if (!PIPE && fires && t0 + NSETS < p.nt)
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (srow(q) < nr(0) && n0 + scol(q) < N)
          A::store(mem + (size_t)(mb + srow(q)) * N + n0 + scol(q), u[q]);
  }
}

// The rope family's ln2 (rmsnorm), a warp per (t, row) of x1 (parked in
// `out`): the sum of squares as the plain version's pairwise tree over D
// zero-padded to a power of two P = 32 n (element i meets i + P / 2, then
// i + P / 4, ...). Lane i's share is the tree over its n elements i + 32 j,
// whose levels meet j and j + n / 2, then j + n / 4, ...: walked in
// bit-reversed order of j those are neighbours, so a stack of one partial
// sum a level reduces them as they stream in, for any D; the last five
// levels are the warp's shuffles. Then the mean, one rsqrt as a float64
// 1 / sqrt rounded once, (x * rsqrt) * scale in the activation dtype into
// s2g, and the up phase's flag of each (t, b, L-block) with a non-zero
// output.
constexpr int NORM_LEVELS = 16;   // n up to 2^16: D up to 2^21

template <typename T>
__global__ void __launch_bounds__(NTB) norm_phase(const __grid_constant__ MlpArgs<T> p) {
  using A = Act<T>;
  const int lane = threadIdx.x % 32, M = p.nb * p.l, nlb = (p.l + p.l_block - 1) / p.l_block;
  int lg = 0;
  while ((32 << lg) < p.d) ++lg;
  const int nw = gridDim.x * NTB / 32;
  for (int task = (blockIdx.x * NTB + threadIdx.x) / 32; task < p.nt * M; task += nw) {
    const T* row = p.out + (size_t)task * p.d;
    float st[NORM_LEVELS + 1];
    for (int pos = 0; pos < 1 << lg; ++pos) {
      const int j = lg ? (int)(__brev((unsigned)pos) >> (32 - lg)) : 0, c = lane + 32 * j;
      const float xv = c < p.d ? A::load(row + c) : 0.f;
      float cur = __fmul_rn(xv, xv);
      bool placed = false;
#pragma unroll
      for (int lv = 0; lv <= NORM_LEVELS; ++lv)
        if (!placed) {
          if (pos >> lv & 1) {
            cur = __fadd_rn(st[lv], cur);
          } else {
            st[lv] = cur;
            placed = true;
          }
        }
    }
    float ss = 0.f;
#pragma unroll
    for (int lv = 0; lv <= NORM_LEVELS; ++lv)
      if (lv == lg) ss = st[lv];
#pragma unroll
    for (int o = 16; o >= 1; o /= 2) ss = __fadd_rn(ss, __shfl_down_sync(0xFFFFFFFFu, ss, o));
    ss = __shfl_sync(0xFFFFFFFFu, ss, 0);
    const float var = __fadd_rn(__fdiv_rn(ss, (float)p.d), p.norm_eps);
    const float rs = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn((double)var)));
    bool any = false;
    for (int c = lane; c < p.d; c += 32) {
      const float y = A::round(__fmul_rn(__fmul_rn(A::load(row + c), rs), p.auxo[c]));
      A::store(p.s2g + (size_t)task * p.d + c, y);
      any |= y != 0.f;
    }
    if (__any_sync(0xFFFFFFFFu, any) && lane == 0) {
      const int t = task / M, m = task % M;
      p.fl.s2[((size_t)t * p.nb + m / p.l) * nlb + m % p.l / p.l_block] = 1;
    }
  }
}

template <typename T, int PH, bool PIPE>
cudaError_t launch_gemm(const MlpArgs<T>& p, cudaStream_t stream) {
  const int ngroups = PH == PH_WO || PH == PH_DOWN ? p.heads : 1;
  const int k_dim = PH == PH_WO ? p.heads * p.hd : PH == PH_DOWN ? p.ff : p.d;
  const size_t smem = SmemB(sizeof(T), PH, ngroups, k_dim).total;
  const auto kernel = mlp_gemm<T, PH, PIPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n = PH == PH_WO || PH == PH_DOWN ? p.d : p.ff, ncol = (n + BN - 1) / BN;
  // pipelined: NSETS row tiles a block (wgmma runs every set)
  const int rows = PIPE ? NSETS * BM : BM;
  kernel<<<dim3((p.nb * p.l + rows - 1) / rows, ncol), NTB, smem, stream>>>(p);
  return cudaGetLastError();
}

// launch B: wo, (rope) ln2, up, down on one stream
template <typename T, bool PIPE>
cudaError_t launch_mlp(const MlpArgs<T>& p, cudaStream_t stream) {
  cudaError_t err = launch_gemm<T, PH_WO, PIPE>(p, stream);
  if (err != cudaSuccess) return err;
  if (p.rope) {
    const int tasks = p.nt * p.nb * p.l;
    norm_phase<T><<<min((tasks + NTB / 32 - 1) / (NTB / 32), 4096), NTB, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_gemm<T, PH_UPR, PIPE>(p, stream);
  } else {
    err = launch_gemm<T, PH_UP, PIPE>(p, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_gemm<T, PH_DOWN, PIPE>(p, stream);
}

// The layer program: fused, launch A over all T and launch B's groups of
// NSETS timesteps; or pipelined, launch A and launch B per timestep (A_0, B_0, A_1, B_1, ...), each pair's operands offset to its
// timestep (x, s, ctx, out, launch A's bit scratch, launch B's flags),
// with one timestep's spike bits and (rope) ln2 output, and the
// membranes in memb / mem_in / mem_hid between the pairs.
template <typename T>
cudaError_t launch(int pipeline, const void* x, const void* s, const void* w3,
                   const void* wo, const void* w1, const void* w2,
                   const float* sc3, const float* sco, const float* sc1,
                   const float* sc2, const float* auxp, const float* auxo,
                   const float* aux1, const float* aux2, const float* delta,
                   float scale, Lif lif, float norm_eps, int rope, int causal,
                   int analog, int nt, int nb, int l, int d, int heads, int hd,
                   int ff, int l_block, int decoded, int c_block, int cp, int cw,
                   void* bits, void* ctx, void* s2g, void* out, int* counts,
                   void* flags, void* sbits, void* memb, void* mem_in, void* mem_hid,
                   cudaStream_t stream) {
  const int nlb = (l + l_block - 1) / l_block, steps = pipeline ? nt : 1;
  const int held = pipeline ? 1 : nt;
  const BitsLayout lay(nb, l, heads, hd, nlb);
  const size_t xs = (size_t)nb * l * d, cs = (size_t)nb * l * heads * hd;
  MlpArgs<T> p{};
  p.wo = (const T*)wo, p.w1 = (const T*)w1, p.w2 = (const T*)w2;
  p.sco = sco, p.sc1 = sc1, p.sc2 = sc2, p.auxo = auxo, p.aux1 = aux1, p.aux2 = aux2;
  p.s2g = (T*)s2g, p.mem_in = (T*)mem_in, p.mem_hid = (T*)mem_hid;
  p.s2b = (uint32_t*)sbits;
  p.hb = p.s2b + (size_t)held * (nb * l + (nb * l & 1)) * 2 * ((d + 63) / 64);
  p.counts = counts, p.lif = lif, p.norm_eps = norm_eps;
  p.rope = rope, p.analog = analog, p.nt = held, p.nb = nb, p.l = l, p.d = d;
  p.heads = heads, p.hd = hd, p.ff = ff, p.l_block = l_block;
  for (int t = 0; t < steps; ++t) {
    const int t0 = pipeline ? t : 0;
    p.x = (const T*)x + t0 * xs, p.ctx = (const T*)ctx + t0 * cs, p.out = (T*)out + t0 * xs;
    p.fl = Flags::at(flags, nt, t0, nb, nlb, heads);
    p.carry = t > 0;
    cudaError_t err = launch_attention<T>(
        rope, decoded, analog, (const T*)s + t0 * xs, w3, sc3, auxp, delta, scale, lif, causal,
        held, nb, l, d, heads, hd, l_block, c_block, cp, 0, cw, lay.at(bits, nt, t0),
        (void*)p.ctx, counts, p.fl.ctx, memb, t > 0, stream);
    if (err != cudaSuccess) return err;
    err = pipeline ? launch_mlp<T, true>(p, stream) : launch_mlp<T, false>(p, stream);
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
            int c_block, int cp, int cw, void* bits, void* ctx, void* s2g,
            void* out, void* counts, void* flags, void* sbits, void* memb,
            void* mem_in, void* mem_hid, void* stream) {
  const auto f = [](const void* p) { return (const float*)p; };
  return (int)launch<T>(pipeline, x, s, w3, wo, w1, w2, f(sc3), f(sco),
                        f(sc1), f(sc2), f(auxp), f(auxo), f(aux1), f(aux2),
                        f(delta), scale, lif, norm_eps, rope, causal, analog, nt,
                        nb, l, d, heads, hd, ff, l_block, decoded, c_block, cp, cw,
                        bits, ctx, s2g, out, (int*)counts, flags, sbits, memb,
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
                       int nb, int l, int d, int heads, int hd, int cw,
                       void* bits, void* ctx, int* counts, cudaStream_t stream) {
  return launch_attention<T>(rope, 0, analog, s, w3, sc3, auxp, delta, scale,
                             lif, causal, nt, nb, l, d, heads, hd, l, 1, d, 1, cw,
                             BitsLayout(nb, l, heads, hd, 1).at(bits, nt, 0), ctx,
                             counts, nullptr, nullptr, 0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rope: the token family (analog
// projection input, RoPE, ln2 rmsnorm, no BN); causal: mask future keys;
// analog: analog scores fl(count * scale) (binarize_scores=False);
// decoded: the decoded q/k/v projections with chunks of c_block
// compacted slots and padded width cp; cw: launch A's column slice
// (kernels/fused_layer.py::column_width); bits: launch A's zeroed int32
// scratch of bits_words(T, B, L, H, hd, nlb) words; flags: launch B's
// zeroed int32 scratch of flag_words(T, B, nlb, H) words; sbits: launch
// B's spike bits, spike_words(T, B L, D, F) int32 words, uninitialised;
// s2g (rope): the ln2 output (T, B, L, D); mem_in (B, L, D) and mem_hid
// (B, L, F) in the activation dtype: launch B's membranes between its
// groups of 4 timesteps (T > 4; else unused, may be null). Launches 5
// kernels (rope 6); returns a cudaError_t (0 = success).
extern "C" int fused_layer_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, int cw, void* bits, void* ctx,
    void* s2g, void* out, void* counts, void* flags, void* sbits, void* mem_in,
    void* mem_hid, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(0, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, cw, bits, ctx, s2g, out,
             counts, flags, sbits, nullptr, mem_in, mem_hid, stream);
}

// The pipeline variant (overlap='pipeline'): fused_layer_forward's
// operands, with s2g (B, L, D) (rope; unused by bn), sbits one timestep's
// spike_words(1, B L, D, F), and the membrane scratch memb (B, L, 3 H hd),
// mem_in (B, L, D), mem_hid (B, L, F) in the activation dtype
// (uninitialised: the first timestep does not read it). Launches 5 T
// kernels (rope 6 T) on the stream.
extern "C" int fused_layer_pipeline_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, int cw, void* bits, void* ctx,
    void* s2g, void* out, void* counts, void* flags, void* sbits, void* memb,
    void* mem_in, void* mem_hid, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(1, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, cw, bits, ctx, s2g, out,
             counts, flags, sbits, memb, mem_in, mem_hid, stream);
}

// The SSA bundle (fused_ssa): s (T, B, L, D) spikes (rope: normed
// currents), w3 (3, D, H hd), sc3 (3, H hd) fp32 scales, auxp (3, 4, H hd)
// fp32 BN rows [mean, inv_std, scale, bias] (rope: the (2, L, hd / 2)
// [cos; sin] table), delta (1,) fp32; rope: the token family's epilogue;
// causal: mask future keys; analog: analog scores; cw and bits as for
// fused_layer_forward (one L-block a sequence); ctx (T, B, L, H hd) in the
// dtype (0 = float32, 1 = bfloat16); counts (H, 4) int32, zeroed by the
// caller. Launches 2 kernels; returns a cudaError_t (0 = success).
extern "C" int fused_ssa_forward(int dtype, const void* s, const void* w3,
                                 const void* sc3, const void* auxp,
                                 const void* delta, float scale, float decay,
                                 float vth, int soft_reset, int rope,
                                 int causal, int analog, int nt, int nb, int l,
                                 int d, int heads, int hd, int cw, void* bits,
                                 void* ctx, void* counts, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  const auto f = [](const void* p) { return (const float*)p; };
  if (dtype == 0)
    return launch_ssa<float>(s, w3, f(sc3), f(auxp), f(delta), scale, lif,
                             rope, causal, analog, nt, nb, l, d, heads, hd, cw,
                             bits, ctx, (int*)counts, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_ssa<__nv_bfloat16>(s, w3, f(sc3), f(auxp), f(delta), scale,
                                     lif, rope, causal, analog, nt, nb, l, d,
                                     heads, hd, cw, bits, ctx, (int*)counts,
                                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_layer_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
