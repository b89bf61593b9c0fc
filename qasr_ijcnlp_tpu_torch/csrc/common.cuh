// Shared device code of the port's hand-written kernels (sm_90a): the
// dtype codes and conversions (rnd<T> rounds through the compute dtype at
// the reference's rounding points), exact-erf GELU, warp reductions and
// the QASR_TRY launch check.  The GEMMs run on the tensor cores
// (gemm_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qasr {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float through T: reproduces the reference's per-op rounding to the
// compute dtype (a no-op for float).
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// Exact-erf GELU (the reference's XLA path); the TPU kernels used an
// Abramowitz-Stegun erf, the port uses erff everywhere.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace qasr

// Evaluate a launch; return its error code from the enclosing C function.
#define QASR_TRY(expr)                    \
  do {                                    \
    cudaError_t err__ = (expr);           \
    if (err__ != cudaSuccess) return (int)err__; \
  } while (0)
