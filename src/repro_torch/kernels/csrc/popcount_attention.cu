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
// pair and is written as 4 bytes, against 4 W bytes of its query row and
// key row that the whole tile shares; at the port's shapes (W = 1 or 2)
// the int32 counts are ~97% of the bytes, e.g. 268 MB for the bf16 LM
// prefill (BH 256, L 512), ~80 us at 3.35 TB/s. So the design keeps the
// words in shared memory, does the popcounts on CUDA cores, and writes
// every count once, coalesced along Lk.
//
// Design. One block per (bh, 64-query tile, 64-key tile). The block
// stages the tile's query and key words in shared memory, WC words of a
// row at a time (padded rows, so the key reads of a warp hit distinct
// banks; the query reads of a warp are one broadcast). Thread t owns key
// column t % 64 and query rows t / 64 + 4 r, r = 0..15: a warp writes 32
// consecutive counts of one row. Rows and columns past Lq / Lk are staged
// as zero words and not written, so any Lq and Lk work without padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int QT = 64;            // query rows per block
constexpr int KT = 64;            // key columns per block
constexpr int ROWS = QT * KT / NT;  // query rows per thread (16)

// WC: words of a row staged at a time (1, 2, 4 or 8, the least that
// holds W, 8 past that), so W = 1 pays for one word pair a count.
template <int WC>
__global__ void __launch_bounds__(NT)
popcount_scores_kernel(const uint32_t* __restrict__ q,
                       const uint32_t* __restrict__ k, int n_qt, int lq,
                       int lk, int w, int32_t* __restrict__ out) {
  __shared__ uint32_t qs[QT][WC + 1];
  __shared__ uint32_t ks[KT][WC + 1];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * QT;
  const int k0 = blockIdx.y * KT;
  const uint32_t* qb = q + (size_t)bh * lq * w;
  const uint32_t* kb = k + (size_t)bh * lk * w;
  const int col = tid % KT, row0 = tid / KT;

  int acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0;

  for (int w0 = 0; w0 < w; w0 += WC) {
    const int wn = min(WC, w - w0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < QT * WC; i += NT) {
      const int r = i / WC, c = i % WC;
      qs[r][c] = (q0 + r < lq && c < wn) ? qb[(size_t)(q0 + r) * w + w0 + c] : 0u;
      ks[r][c] = (k0 + r < lk && c < wn) ? kb[(size_t)(k0 + r) * w + w0 + c] : 0u;
    }
    __syncthreads();
    uint32_t kw[WC];
#pragma unroll
    for (int c = 0; c < WC; ++c) kw[c] = ks[col][c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qr = row0 + r * (NT / KT);
#pragma unroll
      for (int c = 0; c < WC; ++c) acc[r] += __popc(qs[qr][c] & kw[c]);
    }
  }

  if (k0 + col >= lk) return;
  int32_t* ob = out + (size_t)bh * lq * lk + k0 + col;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qr = q0 + row0 + r * (NT / KT);
    if (qr < lq) ob[(size_t)qr * lk] = acc[r];
  }
}

}  // namespace

// q: (bh, lq, w) and k: (bh, lk, w) 32-bit words; out: (bh, lq, lk) int32.
// Returns a cudaError_t code (0 on success).
extern "C" int popcount_scores_forward(const void* q, const void* k, int bh,
                                       int lq, int lk, int w, void* out,
                                       void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int n_qt = (lq + QT - 1) / QT, n_kt = (lk + KT - 1) / KT;
  if ((long long)bh * n_qt > 0x7FFFFFFFLL || n_kt > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh * n_qt, n_kt);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* qw = (const uint32_t*)q;
  const uint32_t* kw = (const uint32_t*)k;
  int32_t* o = (int32_t*)out;
  if (w == 1)
    popcount_scores_kernel<1><<<grid, NT, 0, st>>>(qw, kw, n_qt, lq, lk, w, o);
  else if (w == 2)
    popcount_scores_kernel<2><<<grid, NT, 0, st>>>(qw, kw, n_qt, lq, lk, w, o);
  else if (w <= 4)
    popcount_scores_kernel<4><<<grid, NT, 0, st>>>(qw, kw, n_qt, lq, lk, w, o);
  else
    popcount_scores_kernel<8><<<grid, NT, 0, st>>>(qw, kw, n_qt, lq, lk, w, o);
  return (int)cudaGetLastError();
}

extern "C" const char* popcount_scores_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
