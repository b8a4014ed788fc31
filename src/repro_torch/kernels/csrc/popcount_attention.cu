// AND-PopCount attention scores of the binary engine, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/popcount_attention.py::popcount_scores (the
// Pallas body `_kernel`, grid (BH, nQ, nK)). For bit-packed spikes
// q: (BH, Lq, W) and k: (BH, Lk, W), 32-bit words (core/bitpack.pack_bits:
// bit j of word w is element 32 w + j), it writes the int32 counts
//   out[b, i, j] = sum_w popc(q[b, i, w] & k[b, j, w]),   (BH, Lq, Lk),
// the overlap of query i and key j: the binary engine's scores before the
// threshold. The words arrive as int32 holding the uint32 pattern and are
// read as uint32.
//
// What bounds it: the output. Each count takes W popcounts of one word
// pair and is written as 4 bytes, against 4 W bytes of a query row and a
// key row that many counts share; at the port's shapes (W = 1 or 2) the
// int32 counts are ~97% of the bytes: 268 MB for the bf16 LM prefill (BH
// 256, L 512), 80 us at 3.35 TB/s; 154 MB at 8-512 (BH 1024, L 196, W 2),
// 46 us; 33.5 MB for the 4-256 train step (BH 2048, L 64), 10 us. The
// work is about 3 integer operations a word pair, 67-77 M counts a call:
// far under the CUDA cores' rate. The tensor cores are not the lever
// either: `mma.sync ... .b1.and.popc` (m16n8k256) pads a count's K to 256
// bits, 4-8x the 32-64 bits of these paths, for a kernel whose time is
// its stores. So the design is one stream of 16-byte stores.
//
// Design. The counts of all heads are one contiguous stream of BH Lq Lk
// int32, cut into groups of 4 consecutive counts. A persistent grid (as
// many blocks as fit at once on the card) gives each block an equal,
// contiguous range of groups; thread t of a block takes groups t, t + NT,
// ..., so a warp writes 512 contiguous bytes with one `st.global.v4` a
// thread and a block's stores stay in flight over its whole range. A
// thread finds its first count's (head, query row, key) with one
// division and then steps it by 4 NT counts with wraps (a division only
// where the step crosses a head), none a count. Query and key words are
// read through L1, with no staging and no barrier: a head's keys, 2 KB at
// the LM shape, are read by every row of the head. Where Lk % 4 == 0
// (196, 512, 64 on the paths) a group lies in one query row and starts at
// a key that is a multiple of 4: its 4 key rows are 4 W contiguous words,
// read as 16-byte vectors. Otherwise a group may wrap into the next row
// or head, and each count steps its own (head, row, key); a last group
// past the end is stored count by count. Any BH, Lq, Lk and W >= 1 run;
// the output, which the wrapper allocates, is 16-byte aligned, so no
// head's alignment matters. The stores take the streaming hint
// (`st.global.cs`: the counts are read once, by the lookup after the
// kernel): device us 10.9 / 55.0 / 89.4 at the 4-256 / 8-512 / LM shapes
// against 11.9 / 65.5 / 95.6 with plain stores (NVIDIA H100 80GB HBM3,
// 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int STEP = 4 * NT;   // counts a block advances a round

// sum_w popc(a[w] & b[w]) over WT words (or w when WT == 0)
template <int WT>
__device__ __forceinline__ int overlap(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b, int w) {
  int c = 0;
  if (WT) {
#pragma unroll
    for (int x = 0; x < WT; ++x) c += __popc(__ldg(a + x) & __ldg(b + x));
  } else {
    for (int x = 0; x < w; ++x) c += __popc(__ldg(a + x) & __ldg(b + x));
  }
  return c;
}

// VEC: Lk % 4 == 0 and k 16-byte aligned (a group is 4 keys of one row).
template <int WT, bool VEC>
__global__ void __launch_bounds__(NT)
popcount_scores_kernel(const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ k, int lq, int lk, int w,
                       long long total, long long per_block,
                       int32_t* __restrict__ out) {
  const int W = WT ? WT : w;
  const long long groups = (total + 3) / 4;
  const long long g1 = min(groups, (long long)(blockIdx.x + 1) * per_block);
  long long g = (long long)blockIdx.x * per_block + threadIdx.x;
  if (g >= g1) return;
  // (head h, query row i, key j) of count 4 g
  const long long row = 4 * g / lk;
  int j = (int)(4 * g - row * lk);
  int h = (int)(row / lq), i = (int)(row - (long long)h * lq);
  const int di = STEP / lk, dj = STEP % lk;

  for (; g < g1; g += NT) {
    int4 c;
    if (VEC) {
      const uint32_t* qr = q + ((size_t)h * lq + i) * W;
      const uint4* kr = reinterpret_cast<const uint4*>(
          k + ((size_t)h * lk + j) * W);
      if (WT == 1) {
        const uint32_t a = __ldg(qr);
        const uint4 b = __ldg(kr);
        c = make_int4(__popc(a & b.x), __popc(a & b.y), __popc(a & b.z),
                      __popc(a & b.w));
      } else if (WT == 2) {
        const uint32_t a0 = __ldg(qr), a1 = __ldg(qr + 1);
        const uint4 b01 = __ldg(kr), b23 = __ldg(kr + 1);
        c = make_int4(__popc(a0 & b01.x) + __popc(a1 & b01.y),
                      __popc(a0 & b01.z) + __popc(a1 & b01.w),
                      __popc(a0 & b23.x) + __popc(a1 & b23.y),
                      __popc(a0 & b23.z) + __popc(a1 & b23.w));
      } else {
        const uint32_t* kw = k + ((size_t)h * lk + j) * W;
        c = make_int4(overlap<WT>(qr, kw, W), overlap<WT>(qr, kw + W, W),
                      overlap<WT>(qr, kw + 2 * W, W),
                      overlap<WT>(qr, kw + 3 * W, W));
      }
      __stcs(reinterpret_cast<int4*>(out + 4 * g), c);
    } else {
      int cs[4];
      int hh = h, ii = i, jj = j;
      const int n = (int)min(4LL, total - 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cs[u] = u < n ? overlap<WT>(q + ((size_t)hh * lq + ii) * W,
                                    k + ((size_t)hh * lk + jj) * W, W)
                      : 0;
        if (++jj == lk) {
          jj = 0;
          if (++ii == lq) ii = 0, ++hh;
        }
      }
      if (n == 4) {
        __stcs(reinterpret_cast<int4*>(out + 4 * g),
               make_int4(cs[0], cs[1], cs[2], cs[3]));
      } else {
        for (int u = 0; u < n; ++u) __stcs(out + 4 * g + u, cs[u]);
      }
    }
    // the next group of this thread: STEP counts on
    j += dj;
    i += di;
    if (j >= lk) j -= lk, ++i;
    if (i >= lq) h += i / lq, i %= lq;
  }
}

template <int WT, bool VEC>
int launch(const uint32_t* q, const uint32_t* k, long long total, int lq,
           int lk, int w, int32_t* out, cudaStream_t stream) {
  auto kernel = popcount_scores_kernel<WT, VEC>;
  // the SM count and the blocks of this kernel an SM holds, read once (a
  // grid sized for another card is slower, never wrong)
  static int sms = 0, per_sm = 0;
  if (!per_sm) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (total + 3) / 4;
  long long blocks = (groups + NT - 1) / NT;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  const long long per_block = (groups + blocks - 1) / blocks;
  kernel<<<(unsigned)blocks, NT, 0, stream>>>(q, k, lq, lk, w, total,
                                              per_block, out);
  return (int)cudaGetLastError();
}

template <int WT>
int launch_words(const uint32_t* q, const uint32_t* k, long long total, int lq,
                 int lk, int w, int32_t* out, cudaStream_t stream) {
  const bool vec = lk % 4 == 0 && (uintptr_t)k % 16 == 0;
  return vec ? launch<WT, true>(q, k, total, lq, lk, w, out, stream)
             : launch<WT, false>(q, k, total, lq, lk, w, out, stream);
}

}  // namespace

// q: (bh, lq, w) and k: (bh, lk, w) 32-bit words; out: (bh, lq, lk) int32,
// 16-byte aligned. Returns a cudaError_t code (0 on success).
extern "C" int popcount_scores_forward(const void* q, const void* k, int bh,
                                       int lq, int lk, int w, void* out,
                                       void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || w <= 0 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)bh * lq * lk;
  const uint32_t* qw = (const uint32_t*)q;
  const uint32_t* kw = (const uint32_t*)k;
  int32_t* o = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 1) return launch_words<1>(qw, kw, total, lq, lk, w, o, st);
  if (w == 2) return launch_words<2>(qw, kw, total, lq, lk, w, o, st);
  return launch_words<0>(qw, kw, total, lq, lk, w, o, st);
}

extern "C" const char* popcount_scores_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
