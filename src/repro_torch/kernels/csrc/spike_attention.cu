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
// Design. One block per (bh, 64-query block), walking the keys in
// ascending chunks of KC = 2048 (any L; one chunk, with no extra barrier
// or pass, while L <= KC, a separate instantiation): a chunk's key rows
// and value columns take at most 2048 W + d 65 words of shared memory,
// 116.5 KB in all at d = 128 with the running entries below. Key rows
// carry a pad word after every 32 keys and value columns an odd stride,
// so the threads of a warp, each on its own key word or value column,
// read distinct banks (unpadded, the 32 key words a warp reads at once
// lie in one bank from L = 1024 on). Each spike row becomes bit
// words (one 32-bit word per 32 columns) and each value column bit words
// over the chunk's keys: every thread first loads its share of q, k and v as
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
// output dtype. Past one chunk a thread keeps each of its entries' running
// value in a QB x d fp32 tile in shared memory (a count: exact integers,
// rounded once after the last chunk). Under causal a block stages no key
// past its last query row, so chunks wholly above its diagonal are
// skipped, and keys above a row's diagonal a 32-key word at a time.
// With binarize == 0 the scores stay analog:
// each context entry sums fl(count * scale) over the keys whose value
// bit is set, in ascending key order on CUDA cores, one fp32 add a term,
// the running sum carried across chunks in the same order:
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
constexpr int KC = 2048;    // keys a chunk

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

// The query rows [0, nq) of qs, and the L rows of ks and vs, as bit words
// (the words are zero on entry): key row r at kb[r W + r / 32] (a pad
// word after every 32 keys), value column j at vt[j LVP] (LVP odd).
// Vector path: rows of d elements in
// 16-byte vectors (d a multiple of the vector, rows 16-byte aligned);
// each thread loads up to UNROLL vectors before it sets any bit, so its
// loads are in flight together. Otherwise one element a thread. A q or k
// vector lies in one word and sets it with one atomicOr; a v vector sets
// one bit in each of its columns' words.
template <typename T>
__device__ __forceinline__ void stage_bits(const T* __restrict__ qs,
                                           const T* __restrict__ ks,
                                           const T* __restrict__ vs, int nq,
                                           int L, int d, int W, int LVP,
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
        if (which[u] == 2) atomicOr(&vt[(col0 + j) * LVP + r / 32], 1u << (r % 32));
        else mask |= 1u << ((col0 + j) % 32);
      }
      if (mask)
        atomicOr(which[u] ? &kb[r * W + r / 32 + col0 / 32] : &qb[r * W + col0 / 32],
                 mask);
    }
  }
}

// Shared memory in words: key rows padded so that the 32 threads of a
// warp, each on its own 32-key word, read 32 banks, and value columns
// at an odd stride, so that a warp's 32 columns read 32 banks.
__host__ __device__ __forceinline__ int kb_words(int kc, int W) {
  return kc * W + (kc + 31) / 32;
}

// CHUNKED: L > KC, the keys walked in chunks (at most 64 registers, 4
// blocks an SM; 92 unbounded); otherwise one chunk, none of the chunk
// loop's work compiled in, at 5 blocks an SM (at most 48 registers; 55
// unbounded).
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(NT, CHUNKED ? 4 : 5)
spike_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ delta_p,
                       float scale, int causal, int binarize, int L, int d,
                       T* __restrict__ out) {
  const int bh = blockIdx.x, q0 = blockIdx.y * QB, tid = threadIdx.x;
  const int W = (d + 31) / 32, nq = min(QB, L - q0);
  const int kc = min(L, KC), LW = (kc + 31) / 32;  // a chunk's keys, words
  const int LVP = LW | 1;
  // keys this block reads: under causal none past its last query row, so
  // chunks wholly above its diagonal are skipped
  const int kend_block = causal ? min(L, q0 + nq) : L;
  const int n_chunks = CHUNKED ? (kend_block + KC - 1) / KC : 1;
  const size_t base = (size_t)bh * L * d;
  extern __shared__ uint32_t sm[];
  uint32_t* kb = sm;                     // the chunk's key rows
  uint32_t* vt = kb + kb_words(kc, W);   // [d][LVP]: value columns
  uint32_t* qb = vt + d * LVP;           // [QB][W]: this block's query rows
  uint32_t* ab = qb + QB * W;            // [QB][LW]: binarized scores
  // [QB][d]: running context entries across chunks (CHUNKED only)
  float* acc = reinterpret_cast<float*>(ab + QB * LW);
  __shared__ bool passes[MAX_D + 1];  // threshold of each count 0..d

  const float delta = *delta_p;
  for (int c = tid; c <= d; c += NT) passes[c] = fma32((float)c, scale, -delta) >= 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * KC, nk = min(KC, kend_block - k0);
    const int kw_end = (nk + 31) / 32;
    const bool first = !CHUNKED || c == 0, last = !CHUNKED || c == n_chunks - 1;
    if (!first) __syncthreads();  // the previous chunk's reads are done
    const int zero = kb_words(kc, W) + d * LVP + (first ? QB * W : 0);
    for (int i = tid; i < zero; i += NT) sm[i] = 0u;
    __syncthreads();
    stage_bits(q + base + (size_t)q0 * d, k + base + (size_t)k0 * d,
               v + base + (size_t)k0 * d, first ? nq : 0, nk, d, W, LVP, tid,
               kb, vt, qb);
    __syncthreads();

    if (binarize) {
      // scores of query row i against key word kw, binarized into a word
      for (int idx = tid; idx < nq * kw_end; idx += NT) {
        const int i = idx / kw_end, kw = idx % kw_end;
        const int kend = min(causal ? min(L, q0 + i + 1) : L, k0 + nk);
        const uint32_t* kr = kb + kw * (32 * W + 1);
        uint32_t word = 0u;
        for (int jj = 0; jj < 32; ++jj) {
          if (k0 + kw * 32 + jj >= kend) break;
          int n = 0;
          for (int wd = 0; wd < W; ++wd) n += __popc(qb[i * W + wd] & kr[jj * W + wd]);
          if (passes[n]) word |= 1u << jj;
        }
        ab[i * LW + kw] = word;
      }
      __syncthreads();
      // each entry an exact integer count, summed across chunks in fp32
      // (exact below 2^24) and rounded once to the output dtype
      for (int idx = tid; idx < nq * d; idx += NT) {
        const int i = idx / d, j = idx % d;
        int n = 0;
        for (int kw = 0; kw < kw_end; ++kw) n += __popc(ab[i * LW + kw] & vt[j * LVP + kw]);
        float a = (float)n;
        if (!first) a += acc[idx];
        if (last) store(out + base + (size_t)(q0 + i) * d + j, a);
        else acc[idx] = a;
      }
    } else {
      // fl(count * scale) over the chunk's keys in ascending order, carried
      // across chunks: the one-pass sum's order
      for (int idx = tid; idx < nq * d; idx += NT) {
        const int i = idx / d, j = idx % d;
        const int kend = min(causal ? min(L, q0 + i + 1) : L, k0 + nk);
        float a = first ? 0.f : acc[idx];
        for (int key = k0; key < kend; ++key) {
          const int r = key - k0;
          if (!((vt[j * LVP + r / 32] >> (r % 32)) & 1u)) continue;
          int n = 0;
          for (int wd = 0; wd < W; ++wd)
            n += __popc(qb[i * W + wd] & kb[r * W + r / 32 + wd]);
          a = __fadd_rn(a, __fmul_rn((float)n, scale));
        }
        if (last) store(out + base + (size_t)(q0 + i) * d + j, a);
        else acc[idx] = a;
      }
    }
  }
}

template <typename T, bool CHUNKED>
int launch(const void* q, const void* k, const void* v, const float* delta,
           float scale, int causal, int binarize, int bh, int l, int d,
           void* out, cudaStream_t stream) {
  auto kernel = spike_attention_kernel<T, CHUNKED>;
  const int w = (d + 31) / 32, kc = l < KC ? l : KC, lw = (kc + 31) / 32;
  size_t words = (size_t)kb_words(kc, w) + (size_t)d * (lw | 1) + QB * w + QB * lw;
  if (CHUNKED) words += (size_t)QB * d;  // the running context entries
  const size_t smem = words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if ((l + QB - 1) / QB > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (l + QB - 1) / QB);
  kernel<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                     delta, scale, causal, binarize, l, d,
                                     (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_l(const void* q, const void* k, const void* v, const float* delta,
             float scale, int causal, int binarize, int bh, int l, int d,
             void* out, cudaStream_t stream) {
  return l > KC ? launch<T, true>(q, k, v, delta, scale, causal, binarize, bh,
                                  l, d, out, stream)
                : launch<T, false>(q, k, v, delta, scale, causal, binarize, bh,
                                   l, d, out, stream);
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
    return launch_l<float>(q, k, v, dp, scale, causal, binarize, bh, l, d,
                           out, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_l<__nv_bfloat16>(q, k, v, dp, scale, causal, binarize, bh,
                                   l, d, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spike_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
