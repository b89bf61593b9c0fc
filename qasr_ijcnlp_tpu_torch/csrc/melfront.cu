// STFT + mel frontend: framed audio x Hann -> DFT (400 -> 201 bins, cos and
// sin) -> power -> mel (201 -> n_mels) -> log10(max(., 1e-10)).
//
// Replaces qasr_ijcnlp_tpu/ops/melfront.py `_mel_kernel` (K1).  Two
// tensor-core GEMMs (gemm_tc.cuh) in f32 as 3xTF32 (the reference pins
// Precision.HIGHEST; single TF32 would keep ~3 digits):
//
// * audio_rows_kernel cuts each reflect-padded waveform into rows of 160
//   samples (a hop), R rows an item, zero past its end, as hi/lo slabs; a
//   row pitch of 640 bytes also gives TMA the 16-byte pitch that a
//   waveform of any length lacks.
// * DFT: frame f = rows f, f + 1, f + 2 of its item (three taps of 160
//   samples, K = 480; basis columns 400-479 are zero), against the basis
//   with the Hann window folded in (ops/melfront.py, cached once) and its
//   rows interleaved as (cos_i, -sin_i), N = 402 -> 512, so each thread's
//   accumulator pair (n, n + 1) is (re, im) of bin n / 2.  The epilogue
//   writes power = re^2 + im^2 as the next GEMM's hi/lo operand, (M, 256),
//   bins 201-255 zero.  Every buffer row is computed; the two rows an item
//   past its last kept frame are dropped by the next epilogue.
// * mel: power x melfb (K 256, N n_mels -> 128); the epilogue writes
//   log10(max(., 1e-10)) transposed to (B, n_mels, F).
//
// The per-item max - 8 clamp and (x + 4) / 4 stay outside, as in the
// reference.  Bound on the H100: operations, the DFT's 2 B F 400 402 FLOP
// at the 3xTF32 rate (495 / 3 TFLOP/s).
#include "gemm_tc.cuh"

using namespace qasr;

namespace {

constexpr int HOP = 160, K_DFT = 3 * HOP, N_DFT = 512, N_POW = 256, N_MEL = 128;

// rows[(b R + q) 160 + s] = audio[b, 160 q + s] (0 past L), hi/lo slabs.
__global__ void audio_rows_kernel(const float* __restrict__ audio, float* __restrict__ rows,
                                  int L, int R, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / HOP;
    const int b = (int)(row / R), k = (int)(row - (size_t)b * R) * HOP + (int)(i - row * HOP);
    store_operand(rows, i, n, k < L ? audio[(size_t)b * L + k] : 0.f);
  }
}

// (re, im) of bin n / 2 -> power, stored as the mel GEMM's A operand.
struct PowerEp {
  float* power;
  size_t slab;
  __device__ __forceinline__ void operator()(int m, int n, float re, float im) const {
    store_operand(power, (size_t)m * N_POW + n / 2, slab, re * re + im * im);
  }
};

struct LogMelEp {
  float* out;
  int R, F, n_mels;
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const int b = m / R, f = m - b * R;
    if (f >= F || n >= n_mels) return;  // n_mels is even: n + 1 < n_mels too
    float* o = out + ((size_t)b * n_mels + n) * F + f;
    o[0] = log10f(fmaxf(a0, 1e-10f));
    o[F] = log10f(fmaxf(a1, 1e-10f));
  }
};

}  // namespace

// audio (B, L) float32, reflect-padded; basis (2, 512, 480) and melfb (2,
// 128, 256) hi/lo GEMM operands; scratch rows (2, B R, 160) and power (2,
// B R, 256); out (B, n_mels, F), F kept frames, R >= F + 2 rows an item.
extern "C" int qasr_log_mel(const void* audio, const void* basis, const void* melfb,
                            void* rows, void* power, void* out, int B, int L, int R, int F,
                            int n_mels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * R;
  if (R < F + 2 || n_mels % 2 || n_mels > N_MEL) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)M * HOP;
  audio_rows_kernel<<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, s>>>(
      (const float*)audio, (float*)rows, L, R, n);
  QASR_TRY(cudaGetLastError());
  QASR_TRY(launch_wgmma_gemm_taps<float>((const float*)rows, M, HOP, 3, 1,
                                         (const float*)basis, M, N_DFT,
                                         PowerEp{(float*)power, (size_t)M * N_POW}, s));
  QASR_TRY(launch_wgmma_gemm<float>((const float*)power, (const float*)melfb, M, N_MEL, N_POW,
                                    LogMelEp{(float*)out, R, F, n_mels}, s));
  return 0;
}
