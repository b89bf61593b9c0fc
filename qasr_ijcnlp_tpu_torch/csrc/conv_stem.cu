// Encoder conv stem: mel -> conv1 (k3, p1) + GELU -> conv2 (k3, s2, p1) + GELU
// + positional embedding, written as the trunk input (B, Tp, D) with rows
// >= t_out zeroed.
//
// Replaces qasr_ijcnlp_tpu/ops/conv_stem.py `_stem_kernel` (K2).  The TPU
// kernel split mel into even/odd time phases so every tap became a
// whole-array row shift; on the GPU a tile load can read mel and y1 at any
// strided offset, so each convolution is one implicit GEMM over K = 3 * C_in
// (index kk = c * 3 + tap, which makes the (O, I, 3) weight a contiguous
// (N, K) operand).  y1 (B, 3000, D) goes through device memory between the
// two launches.  Bound on the H100: conv2 is 2 * B * 1536 * 1152 * 384 FLOP
// on SIMT fp32 FMAs (no tensor cores yet), i.e. compute, not bytes.
#include "common.cuh"

using namespace qasr;

namespace {

// conv1 A operand: a(m = (b, t), kk = (c, tap)) = mel[b, c, t + tap - 1]
// rounded to T (the reference casts mel to the compute dtype first).
template <typename T>
struct Conv1A {
  const float* mel;
  int C0, Tm;
  __device__ __forceinline__ float operator()(int, int m, int kk) const {
    const int bi = m / Tm, t = m % Tm;
    const int c = kk / 3, tt = t + kk % 3 - 1;
    if (tt < 0 || tt >= Tm) return 0.f;
    return rnd<T>(mel[((size_t)bi * C0 + c) * Tm + tt]);
  }
};

// conv1 epilogue: y1 = gelu(T(acc) + b1), stored (B, Tm, D) row-major.
template <typename T>
struct Conv1Ep {
  const T* b1;
  T* y1;
  int D;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const float v = rnd<T>(rnd<T>(acc) + to_f(b1[n]));
    y1[(size_t)m * D + n] = from_f<T>(gelu_erf(v));
  }
};

// conv2 A operand (stride 2): a(m = (b, t), kk = (c, tap)) = y1[b, 2t + tap - 1, c];
// output rows t >= t_out are the trunk's tile padding and read nothing.
template <typename T>
struct Conv2A {
  const T* y1;
  int Tm, D, Tp, t_out;
  __device__ __forceinline__ float operator()(int, int m, int kk) const {
    const int bi = m / Tp, t = m % Tp;
    if (t >= t_out) return 0.f;
    const int c = kk / 3, tt = 2 * t + kk % 3 - 1;
    if (tt < 0 || tt >= Tm) return 0.f;
    return to_f(y1[((size_t)bi * Tm + tt) * D + c]);
  }
};

// conv2 epilogue: out = gelu(T(acc) + b2) + pos, zero on padding rows.
template <typename T>
struct Conv2Ep {
  const T* b2;
  const T* pos;
  T* out;
  int D, Tp, t_out;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const int t = m % Tp;
    float v = 0.f;
    if (t < t_out) {
      v = rnd<T>(rnd<T>(acc) + to_f(b2[n]));
      v = rnd<T>(gelu_erf(v)) + to_f(pos[(size_t)t * D + n]);
    }
    out[(size_t)m * D + n] = from_f<T>(v);
  }
};

template <typename T>
int run_stem(const float* mel, const T* w1, const T* b1, const T* w2, const T* b2,
             const T* pos, T* y1, T* out, int B, int C0, int Tm, int D, int t_out,
             int Tp, cudaStream_t s) {
  QASR_TRY((launch_gemm<true>(B * Tm, D, 3 * C0, 1, Conv1A<T>{mel, C0, Tm},
                              WeightNK<T>{w1, 3 * C0}, Conv1Ep<T>{b1, y1, D}, s)));
  QASR_TRY((launch_gemm<false>(B * Tp, D, 3 * D, 1, Conv2A<T>{y1, Tm, D, Tp, t_out},
                               WeightNK<T>{w2, 3 * D},
                               Conv2Ep<T>{b2, pos, out, D, Tp, t_out}, s)));
  return 0;
}

}  // namespace

// mel (B, C0, Tm) float32; w1 (D, C0, 3), w2 (D, D, 3), b1/b2 (D,), pos
// (t_out, D) in the compute dtype; y1 scratch (B, Tm, D); out (B, Tp, D).
extern "C" int qasr_conv_stem(int dtype, const void* mel, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* pos, void* y1,
                              void* out, int B, int C0, int Tm, int D, int t_out, int Tp,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_stem<float>((const float*)mel, (const float*)w1, (const float*)b1,
                           (const float*)w2, (const float*)b2, (const float*)pos,
                           (float*)y1, (float*)out, B, C0, Tm, D, t_out, Tp, s);
  using bf = __nv_bfloat16;
  return run_stem<bf>((const float*)mel, (const bf*)w1, (const bf*)b1, (const bf*)w2,
                      (const bf*)b2, (const bf*)pos, (bf*)y1, (bf*)out, B, C0, Tm, D,
                      t_out, Tp, s);
}
