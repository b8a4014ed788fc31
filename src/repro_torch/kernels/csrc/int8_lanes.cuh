// The int8 lane machinery of the two quantized products (#3,
// spike_matmul.cu; #5, gather_spike_matmul.cu): a value of s on its
// integer lane, the lanes split into byte planes, the tensor cores' int8
// product of the planes combined by Horner's rule, the codes laid out
// K-major for the B fragment, and the fp32 epilogue. Both products sum in
// int32, exact in any order, so each agrees bitwise with its plain
// version (spike_matmul.quant_spike_matmul_plain) and with the other.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// the quantized epilogue of an exact int32 sum: rounded to fp32, then
// acc * scale, or with a bias fma32(acc, scale, b)
__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool has_bias) {
  const float a = __int2float_rn(acc);
  return has_bias ? fma32(a, scale, bias) : __fmul_rn(a, scale);
}

// a value of s on its integer lane, as spike_matmul.quant_lanes casts it:
// truncated toward zero to int32; a spike lane keeps the low byte (int8)
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(__nv_bfloat16 v) {
  return __float2int_rz(__bfloat162float(v));
}
__device__ __forceinline__ int to_int(int8_t v) { return v; }
__device__ __forceinline__ int to_int(int32_t v) { return v; }

template <bool COUNTS, typename S>
__device__ __forceinline__ int lane_of(S v) {
  const int x = to_int(v);
  return COUNTS ? x : (int)(int8_t)(x & 0xFF);
}

// 16 values of s cast to their lanes and split into PMAX byte planes:
// pw[p][w] holds byte p of lanes 4w..4w+3 (the first P planes are used)
template <bool COUNTS, int PMAX, typename S>
__device__ __forceinline__ void lanes16(const S* v, uint32_t (&pw)[PMAX][4]) {
#pragma unroll
  for (int pl = 0; pl < PMAX; ++pl)
#pragma unroll
    for (int w = 0; w < 4; ++w) pw[pl][w] = 0u;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int x = lane_of<COUNTS>(v[q]);
#pragma unroll
    for (int pl = 0; pl < PMAX; ++pl)
      pw[pl][q / 4] |= (uint32_t)(uint8_t)(x >> (8 * pl)) << (8 * (q % 4));
  }
}

// The byte planes a set of lanes needs, from their largest magnitude
// (max(hi, -lo - 1)) and whether any is negative: one unsigned plane for
// 0..255 (U1), else the fewest P whose top plane, signed, holds it
// (spike_decode.lane_planes).
__device__ __forceinline__ void planes_of(int mag, bool neg, int& P,
                                          bool& U1) {
  U1 = !neg && mag <= 0xFF;
  P = U1 || mag <= 0x7F ? 1 : mag <= 0x7FFF ? 2 : mag <= 0x7FFFFF ? 3 : 4;
}

template <bool U>
__device__ __forceinline__ void mma8(int (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  if constexpr (U)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t shl8(int x) { return (uint32_t)x << 8; }

// One m16n8k32 tile of a k-step on lanes in P byte planes, the lower ones
// unsigned and the top one signed (or, with U1, one unsigned plane),
// combined by Horner's rule: acc += sum_p 256^p (plane_p x codes), in
// int32 (exact modulo 2^32, as the plain version's int32 sums).
template <int P, bool U1>
__device__ __forceinline__ void plane_mma(int (&acc)[4],
                                          const uint32_t (&a)[P][4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (P == 1) {
    mma8<U1>(acc, a[0], b0, b1);
  } else {
    int h[4] = {0, 0, 0, 0};
    mma8<false>(h, a[P - 1], b0, b1);
#pragma unroll
    for (int pl = P - 2; pl >= 1; --pl) {
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = (int)shl8(h[e]);
      mma8<true>(h, a[pl], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = (int)((uint32_t)acc[e] + shl8(h[e]));
    mma8<true>(acc, a[0], b0, b1);
  }
}

// four code rows of four columns (r[e]: row e's bytes c..c+3) transposed
// 4 x 4 bytes: word c holds column c's four rows, K-major, the layout of
// the m16n8k32 B fragment
__device__ __forceinline__ uint4 k_major4(const uint32_t (&r)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t x1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t x2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t x3 = __byte_perm(r[2], r[3], 0x7362);
  return make_uint4(__byte_perm(x0, x1, 0x5410), __byte_perm(x0, x1, 0x7632),
                    __byte_perm(x2, x3, 0x5410), __byte_perm(x2, x3, 0x7632));
}

}  // namespace
