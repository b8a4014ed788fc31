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
// t), so launch B keeps one timestep's accumulators (no MAX_T). The
// membranes move between launches through device scratch in the
// activation dtype, where LIF keeps them exactly: q/k/v (B, L, 3 H hd),
// the input neuron (B, L, D), the MLP hidden layer (B, L, F); a launch
// reads them at t > 0 and starts from zero at t = 0, as the TPU kernel's
// `_lif` does. The counts are added per timestep and launch B's flag
// words are kept per timestep, so outputs and counts equal the fused
// variant's bitwise. It moves the membranes through device memory twice
// a timestep more than #1 and makes 3 T launches instead of 3.
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
// order: it is summed in ascending k on CUDA cores (chunk_product's
// ANALOG path, the rope family's `up`), chosen per chunk by a
// block-uniform flag outside the k loop.
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
constexpr int MAX_D = 1024;  // rope: launch B's rmsnorm holds a row in registers
constexpr int MAX_HD = 128;  // q/k spikes of a row fit four 32-bit words
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
             int* __restrict__ counts) {
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
  // the ascending sums)
#pragma unroll
  for (int ii = 0; ii < RPW; ++ii) {
    const int i = q0 + warp * RPW + ii;
    if (i >= l) continue;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int col = lane + 32 * m;
      if (col < hd)
        A::store(ctx + (((size_t)t * nb + b) * l + i) * qd + h * hd + col,
                 AN ? acc[ii][m] : (float)n[ii][m]);
    }
  }
}

template <typename T>
using AttendKernel = void (*)(Bits, const float*, float, int, int, int, int, int, int,
                              int, int, int, int, int, T*, int*);

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
                             void* ctx, int* counts, void* memb, int carry,
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
      decoded, (T*)ctx, counts);
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

// One launch A (two kernels) and one launch B over nt timesteps (TT >= nt
// held by launch B); bits is launch A's zeroed scratch of these nt
// timesteps; memb / mem_in / mem_hid, when set, carry the membranes in
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
                        int decoded, int c_block, int cp, int cw, Bits bits, T* ctx,
                        T* s2g, T* out, int* counts, int* flags, T* memb, T* mem_in,
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
                            l_block, c_block, cp, 0, cw, bits, ctx, counts, memb,
                            carry, stream);
  if (err != cudaSuccess) return err;
  mlp<<<dim3(nlb * tpb, nb), NT, dyn, stream>>>(
      x, ctx, (const T*)wo, (const T*)w1, (const T*)w2, sco, sc1, sc2, auxo,
      aux1, aux2, lif, norm_eps, analog, nt, nb, l, d, heads, hd, ff, l_block, s2g,
      out, counts, flags, mem_in, mem_hid, carry);
  return cudaGetLastError();
}

// The layer program: fused, one launch pair over all T; or pipelined, one
// launch pair per timestep (A_0, B_0, A_1, B_1, ...), each pair's
// operands offset to its timestep (x, s, ctx, out, launch A's bit scratch
// and launch B's flag words (T, B, nlb, 4)), with the rope family's ln2
// scratch s2g holding one timestep.
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
                   int* flags, void* memb, void* mem_in, void* mem_hid,
                   cudaStream_t stream) {
  const int nlb = (l + l_block - 1) / l_block;
  const BitsLayout lay(nb, l, heads, hd, nlb);
  if (!pipeline)
    return launch_pair<T, MAX_T>(
        (const T*)x, (const T*)s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp,
        auxo, aux1, aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l,
        d, heads, hd, ff, l_block, decoded, c_block, cp, cw, lay.at(bits, nt, 0),
        (T*)ctx, (T*)s2g, (T*)out, counts, flags, nullptr, nullptr, nullptr, 0, stream);
  const size_t xs = (size_t)nb * l * d, cs = (size_t)nb * l * heads * hd;
  const size_t fs = (size_t)nb * nlb * 4;
  for (int t = 0; t < nt; ++t) {
    const cudaError_t err = launch_pair<T, 1>(
        (const T*)x + t * xs, (const T*)s + t * xs, w3, wo, w1, w2, sc3, sco,
        sc1, sc2, auxp, auxo, aux1, aux2, delta, scale, lif, norm_eps, rope,
        causal, analog, 1, nb, l, d, heads, hd, ff, l_block, decoded, c_block, cp,
        cw, lay.at(bits, nt, t), (T*)ctx + t * cs, (T*)s2g, (T*)out + t * xs,
        counts, flags + t * fs, (T*)memb, (T*)mem_in, (T*)mem_hid, t > 0, stream);
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
            void* out, void* counts, void* flags, void* memb, void* mem_in,
            void* mem_hid, void* stream) {
  const auto f = [](const void* p) { return (const float*)p; };
  return (int)launch<T>(pipeline, x, s, w3, wo, w1, w2, f(sc3), f(sco),
                        f(sc1), f(sc2), f(auxp), f(auxo), f(aux1), f(aux2),
                        f(delta), scale, lif, norm_eps, rope, causal, analog, nt,
                        nb, l, d, heads, hd, ff, l_block, decoded, c_block, cp, cw,
                        bits, ctx, s2g, out, (int*)counts, (int*)flags, memb,
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
                             counts, nullptr, 0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rope: the token family (analog
// projection input, RoPE, ln2 rmsnorm, no BN); causal: mask future keys;
// analog: analog scores fl(count * scale) (binarize_scores=False);
// decoded: the decoded q/k/v projections with chunks of c_block
// compacted slots and padded width cp; cw: launch A's column slice
// (kernels/fused_layer.py::column_width); bits: launch A's zeroed int32
// scratch of bits_words(T, B, L, H, hd, nlb) words. Launches 3 kernels;
// returns a cudaError_t (0 = success).
extern "C" int fused_layer_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, int cw, void* bits, void* ctx,
    void* s2g, void* out, void* counts, void* flags, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(0, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, cw, bits, ctx, s2g, out,
             counts, flags, nullptr, nullptr, nullptr, stream);
}

// The pipeline variant (overlap='pipeline'): fused_layer_forward's
// operands, with ctx (T, B, L, H hd), s2g (B, L, D) (rope; unused by bn),
// flags (T, B, nlb, 4) int32 zeroed, and the membrane scratch memb
// (B, L, 3 H hd), mem_in (B, L, D), mem_hid (B, L, F) in the activation
// dtype (uninitialised: the first timestep does not read it). Launches 3 T
// kernels on the stream.
extern "C" int fused_layer_pipeline_forward(
    int dtype, const void* x, const void* s, const void* w3, const void* wo,
    const void* w1, const void* w2, const void* sc3, const void* sco,
    const void* sc1, const void* sc2, const void* auxp, const void* auxo,
    const void* aux1, const void* aux2, const void* delta, float scale,
    float decay, float vth, int soft_reset, float norm_eps, int rope,
    int causal, int analog, int nt, int nb, int l, int d, int heads, int hd, int ff,
    int l_block, int decoded, int c_block, int cp, int cw, void* bits, void* ctx,
    void* s2g, void* out, void* counts, void* flags, void* memb, void* mem_in,
    void* mem_hid, void* stream) {
  const Lif lif{decay, vth, soft_reset};
  auto fwd = dtype == 0 ? forward<float> : forward<__nv_bfloat16>;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return fwd(1, x, s, w3, wo, w1, w2, sc3, sco, sc1, sc2, auxp, auxo, aux1,
             aux2, delta, scale, lif, norm_eps, rope, causal, analog, nt, nb, l, d,
             heads, hd, ff, l_block, decoded, c_block, cp, cw, bits, ctx, s2g, out,
             counts, flags, memb, mem_in, mem_hid, stream);
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
