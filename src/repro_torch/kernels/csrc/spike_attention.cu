// Fused binary spiking attention of the binary engine, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spike_attention.py::spike_attention (the
// Pallas body `_kernel`, grid (BH, nQ, nK) with the KV axis innermost).
// For {0,1} spikes q, k, v: (BH, L, d) it computes
//   s = (q k^T) * scale, a = 1[s - delta >= 0] (or s itself when
//   binarize == 0), a = 0 above the diagonal when causal, out = a v,
// in one pass, and writes the context in the operands' dtype.
//
// Contract, as the TPU kernel's: q, k and v hold {0,1} spikes. The
// kernel reads any non-zero entry as a spike.
//
// What bounds it: at the training step's shape (BH = T*B*H = 2048, L =
// 64, d = 32, bf16) a call reads q, k, v and writes the context, 33.5 MB,
// for 4 BH L^2 d = 1.1 G multiply-adds of single bits: bytes bound it
// (~10 us at 3.35 TB/s). So the design spends nothing on tensor cores and
// keeps every intermediate in shared memory as bits.
//
// Design. One block per (bh, 64-query block). Each spike row becomes bit
// words (one 32-bit word per 32 columns) and each value column bit words
// over the keys: every thread first loads its share of q, k and v as
// 16-byte vectors into registers, all loads in flight at once, then ORs
// their bits into the words in shared memory. A score is then an exact
// integer count, the AND-popcount of a query and a key word, and its
// threshold is looked up in a table of the d + 1 possible counts,
// filled once per block with the reference's rounding rule: jitted XLA
// contracts s * scale - delta into one FMA, so the table holds
// fma32(count, scale, -delta) >= 0 (float64 product and sum, rounded
// once, as models/nn.fma32). Binarized scores of a query row are packed
// into words, and each context entry is the popcount of those words
// against a value column's words: exact integers, rounded once to the
// output dtype. Keys wholly above the diagonal are skipped under causal,
// a 32-key word at a time. With binarize == 0 the scores stay analog:
// each context entry sums fl(count * scale) over the keys whose value
// bit is set, in ascending key order on CUDA cores, one fp32 add a term:
// the plain version's order (kernels/fused_ssa.analog_context) and the
// fused SSA bundle's, so all three agree bitwise (JAX sums in XLA's
// order, so the reference agrees within a tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int QB = 64;      // query rows per block
constexpr int MAX_D = 128;  // head dim (the wrapper checks)

__device__ __forceinline__ bool is_spike(float v) { return v != 0.f; }
__device__ __forceinline__ bool is_spike(__nv_bfloat16 v) {
  return (__bfloat16_as_ushort(v) & 0x7FFFu) != 0u;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// The query rows [0, nq) of qs, and all L rows of ks and vs, as bit words
// (the words are zero on entry). Vector path: rows of d elements in
// 16-byte vectors (d a multiple of the vector, rows 16-byte aligned);
// each thread loads up to UNROLL vectors before it sets any bit, so its
// loads are in flight together. Otherwise one element a thread. A q or k
// vector lies in one word and sets it with one atomicOr; a v vector sets
// one bit in each of its columns' words.
template <typename T>
__device__ __forceinline__ void stage_bits(const T* __restrict__ qs,
                                           const T* __restrict__ ks,
                                           const T* __restrict__ vs, int nq,
                                           int L, int d, int W, int LW,
                                           int tid, uint32_t* kb,
                                           uint32_t* vt, uint32_t* qb) {
  constexpr int V = 16 / (int)sizeof(T), UNROLL = 4;
  const bool vec = d % V == 0 && ((uintptr_t)qs | (uintptr_t)ks |
                                  (uintptr_t)vs) % 16 == 0;
  const int per_row = vec ? d / V : d;
  const int total = (nq + 2 * L) * per_row;
  for (int base = tid; base < total; base += NT * UNROLL) {
    uint4 buf[UNROLL];
    int which[UNROLL], row[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * NT;
      int r = i / per_row;
      which[u] = r < nq ? 0 : (r < nq + L ? 1 : 2);
      row[u] = r - (which[u] == 0 ? 0 : (which[u] == 1 ? nq : nq + L));
      const T* src = which[u] == 0 ? qs : (which[u] == 1 ? ks : vs);
      const size_t off = (size_t)row[u] * d + (size_t)(i % per_row) * (vec ? V : 1);
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total) {
        if (vec) buf[u] = *reinterpret_cast<const uint4*>(src + off);
        else *reinterpret_cast<T*>(&buf[u]) = src[off];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * NT;
      if (i >= total) break;
      const int col0 = (i % per_row) * (vec ? V : 1), r = row[u];
      const T* e = reinterpret_cast<const T*>(&buf[u]);
      uint32_t mask = 0u;
      for (int j = 0; j < (vec ? V : 1); ++j) {
        if (!is_spike(e[j])) continue;
        if (which[u] == 2) atomicOr(&vt[(col0 + j) * LW + r / 32], 1u << (r % 32));
        else mask |= 1u << ((col0 + j) % 32);
      }
      if (mask) atomicOr(&(which[u] ? kb : qb)[r * W + col0 / 32], mask);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
spike_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ delta_p,
                       float scale, int causal, int binarize, int L, int d,
                       T* __restrict__ out) {
  const int bh = blockIdx.x, q0 = blockIdx.y * QB, tid = threadIdx.x;
  const int W = (d + 31) / 32, LW = (L + 31) / 32, nq = min(QB, L - q0);
  const size_t base = (size_t)bh * L * d;
  extern __shared__ uint32_t sm[];
  uint32_t* kb = sm;           // [L][W]: key rows
  uint32_t* vt = kb + L * W;   // [d][LW]: value columns over the keys
  uint32_t* qb = vt + d * LW;  // [QB][W]: this block's query rows
  uint32_t* ab = qb + QB * W;  // [QB][LW]: binarized scores
  __shared__ bool passes[MAX_D + 1];  // threshold of each count 0..d

  const float delta = *delta_p;
  for (int c = tid; c <= d; c += NT) passes[c] = fma32((float)c, scale, -delta) >= 0.f;
  for (int i = tid; i < L * W + d * LW + QB * W; i += NT) sm[i] = 0u;
  __syncthreads();

  stage_bits(q + base + (size_t)q0 * d, k + base, v + base, nq, L, d, W, LW,
             tid, kb, vt, qb);
  __syncthreads();

  if (binarize) {
    // scores of query row i against key word kw, binarized into a word
    for (int idx = tid; idx < nq * LW; idx += NT) {
      const int i = idx / LW, kw = idx % LW;
      const int kend = causal ? min(L, q0 + i + 1) : L;
      uint32_t word = 0u;
      for (int jj = 0; jj < 32; ++jj) {
        const int key = kw * 32 + jj;
        if (key >= kend) break;
        int c = 0;
        for (int wd = 0; wd < W; ++wd) c += __popc(qb[i * W + wd] & kb[key * W + wd]);
        if (passes[c]) word |= 1u << jj;
      }
      ab[i * LW + kw] = word;
    }
    __syncthreads();
    for (int idx = tid; idx < nq * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      int n = 0;
      for (int kw = 0; kw < LW; ++kw) n += __popc(ab[i * LW + kw] & vt[j * LW + kw]);
      store(out + base + (size_t)(q0 + i) * d + j, (float)n);
    }
  } else {
    for (int idx = tid; idx < nq * d; idx += NT) {
      const int i = idx / d, j = idx % d;
      const int kend = causal ? min(L, q0 + i + 1) : L;
      float acc = 0.f;
      for (int key = 0; key < kend; ++key) {
        if (!((vt[j * LW + key / 32] >> (key % 32)) & 1u)) continue;
        int c = 0;
        for (int wd = 0; wd < W; ++wd) c += __popc(qb[i * W + wd] & kb[key * W + wd]);
        acc = __fadd_rn(acc, __fmul_rn((float)c, scale));
      }
      store(out + base + (size_t)(q0 + i) * d + j, acc);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* delta,
           float scale, int causal, int binarize, int bh, int l, int d,
           void* out, cudaStream_t stream) {
  const int w = (d + 31) / 32, lw = (l + 31) / 32;
  const size_t smem = (size_t)(l * w + d * lw + QB * w + QB * lw) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spike_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(bh, (l + QB - 1) / QB);
  spike_attention_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, delta, scale, causal, binarize, l,
      d, (T*)out);
  return (int)cudaGetLastError();
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
  if (d > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, dp, scale, causal, binarize, bh, l, d, out,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dp, scale, causal, binarize, bh, l,
                                 d, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spike_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
