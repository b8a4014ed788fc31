// Fused LIF membrane update over T time steps, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lif.py::lif_forward (the Pallas body
// `_kernel`, grid (nM, nD), a (block_m, block_d) fp32 membrane in VMEM
// scratch across the unrolled T loop). For currents i: (T, M, D) in fp32
// or bf16 it writes the spikes s: (T, M, D) in the same dtype:
//   u = 0;  for t:  u = decay * u + i[t]  (i[t] cast to fp32),
//                   s[t] = 1[u >= v_th],
//                   u = u * (1 - s[t])          (hard reset)
//                     or u - s[t] * v_th        (soft reset).
// The membrane is fp32 whatever the input dtype, as the TPU kernel's
// scratch is. The update rounds as the interpret-mode Pallas kernel does:
// XLA contracts decay * u + i into one fused multiply-add, so the kernel
// computes fma32(decay, u, i) (float64 product and sum, rounded once to
// fp32: models/nn.fma32, the definition the plain version uses), not
// nvcc's own contraction.
//
// What bounds it: bytes. Each element is read once and written once a
// step, 2 T M D itemsize bytes (16.8 MB for Spikingformer-4-256's layer
// input (4, 4096, 256) in bf16, ~5 us at 3.35 TB/s), for a handful of
// operations each. So each thread owns 16 bytes of the (M, D) plane (4
// fp32 or 8 bf16 elements, loaded and stored as one vector where the
// plane's rows are 16-byte aligned, element by element otherwise), keeps
// their membranes in registers, and walks t = 0..T-1: the membrane never
// leaves the chip, and every load and store is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// fp32 a * b + c rounded once: models/nn.fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// one LIF step of one membrane; returns the spike (0 or 1)
__device__ __forceinline__ float step(float& u, float x, float decay,
                                      float v_th, bool soft) {
  u = fma32(decay, u, x);
  const float s = u >= v_th ? 1.f : 0.f;
  u = soft ? __fsub_rn(u, __fmul_rn(s, v_th)) : __fmul_rn(u, __fsub_rn(1.f, s));
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NT)
lif_kernel(const T* __restrict__ in, T* __restrict__ out, int t_steps,
           long long n, float decay, float v_th, int soft, int vec) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long e0 = ((long long)blockIdx.x * NT + threadIdx.x) * V;
  if (e0 >= n) return;
  const int m = (int)min((long long)V, n - e0);
  float u[V];
#pragma unroll
  for (int j = 0; j < V; ++j) u[j] = 0.f;
  for (int t = 0; t < t_steps; ++t) {
    const size_t off = (size_t)t * n + e0;
    if (vec) {
      uint4 buf = *reinterpret_cast<const uint4*>(in + off);
      T* e = reinterpret_cast<T*>(&buf);
#pragma unroll
      for (int j = 0; j < V; ++j)
        from_f32(&e[j], step(u[j], to_f32(e[j]), decay, v_th, soft));
      *reinterpret_cast<uint4*>(out + off) = buf;
    } else {
      for (int j = 0; j < m; ++j)
        from_f32(&out[off + j], step(u[j], to_f32(in[off + j]), decay, v_th, soft));
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int t_steps, long long n, float decay,
           float v_th, int soft, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  // one vector a thread when every step's plane starts 16-byte aligned
  const int vec = n % V == 0 && ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  const long long blocks = ((n + V - 1) / V + NT - 1) / NT;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lif_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      (const T*)in, (T*)out, t_steps, n, decay, v_th, soft, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (currents and spikes); in / out: (t, n)
// with n = M * D. Returns a cudaError_t code (0 on success).
extern "C" int lif_forward(int dtype, const void* in, void* out, int t_steps,
                           long long n, float decay, float v_th, int soft,
                           void* stream) {
  if (t_steps <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(in, out, t_steps, n, decay, v_th, soft,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, t_steps, n, decay, v_th, soft,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lif_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
