// Shared device code of the port's hand-written kernels (sm_90a).
//
// One tiled SIMT GEMM with fp32 accumulation serves the kernels whose
// operands are not plain row-major tensors: K1 (melfront.cu) and the conv
// stem K2/K3 (conv_stem.cu).  Its operands are small loader functors, so
// each caller fuses its own prologue into the tile loads (conv taps read
// mel or y1 at shifted/strided offsets, the DFT reads framed audio times
// the Hann window, the mel product squares the spectrum on the fly) and its
// own epilogue into the store (bias, exact-erf GELU, residual, scale,
// log10).  The fused encoder block's products run on the tensor cores
// instead (gemm_tc.cuh, wgmma + TMA); moving K1-K3 there is later work.
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

// ---------------------------------------------------------------------------
// Tiled GEMM: C[z, m, n] = ep(z, m, n, sum_k a(z, m, k) * b(z, k, n)).
// 64x64 output tile per block, 16-deep k slices staged in shared memory as
// float, 256 threads each owning a 4x4 strided sub-tile (rows ty + 16i,
// cols tx + 16j: conflict-free shared reads, coalesced epilogue stores).
// ``kAMFast`` walks the A tile loads along m instead of k, for A operands
// whose rows are strided (conv1 reads mel time-major per channel).
// B loads walk k fastest: every B operand here is a weight stored (N, K).
// ---------------------------------------------------------------------------
constexpr int GBM = 64, GBN = 64, GBK = 16, GTHREADS = 256;

template <bool kAMFast, class AL, class BL, class EP>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(int M, int N, int K, AL a, BL b, EP ep) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x;
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
#pragma unroll
    for (int r = 0; r < (GBM * GBK) / GTHREADS; ++r) {
      const int i = tid + r * GTHREADS;
      const int mm = kAMFast ? i % GBM : i / GBK;
      const int kk = kAMFast ? i / GBM : i % GBK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? a(z, m, k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (GBN * GBK) / GTHREADS; ++r) {
      const int i = tid + r * GTHREADS;
      const int nn = i / GBK, kk = i % GBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? b(z, k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) ep(z, m, n, acc[i][j]);
    }
  }
}

template <bool kAMFast = false, class AL, class BL, class EP>
inline cudaError_t launch_gemm(int M, int N, int K, int Z, AL a, BL b, EP ep,
                               cudaStream_t stream) {
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, Z);
  gemm_kernel<kAMFast><<<grid, GTHREADS, 0, stream>>>(M, N, K, a, b, ep);
  return cudaGetLastError();
}

// Loader for a weight stored (N, K) row-major, the nn.Linear layout:
// b(k, n) = W[n, k].
template <typename T>
struct WeightNK {
  const T* w;
  int K;
  __device__ __forceinline__ float operator()(int, int k, int n) const {
    return to_f(w[(size_t)n * K + k]);
  }
};

}  // namespace qasr

// Evaluate a launch; return its error code from the enclosing C function.
#define QASR_TRY(expr)                    \
  do {                                    \
    cudaError_t err__ = (expr);           \
    if (err__ != cudaSuccess) return (int)err__; \
  } while (0)
