// STFT + mel frontend: framed audio x Hann -> DFT (400 -> 201 bins, cos and
// sin) -> power -> mel (201 -> n_mels) -> log10(max(., 1e-10)).
//
// Replaces qasr_ijcnlp_tpu/ops/melfront.py `_mel_kernel` (K1).  Two GEMM
// launches in exact fp32 FMAs (the reference pins Precision.HIGHEST; no TF32
// anywhere): the first reads frames straight out of the reflect-padded
// waveform (frame f starts at sample 160 f; no framing copy) and multiplies
// the Hann window in as it loads, writing the (frames, 402) re|im spectrum;
// the second squares and sums re and im as it loads, so the power spectrum
// is never stored, and writes log10 mel already transposed to
// (B, n_mels, frames).  The global max-8 clamp and (x+4)/4 stay outside, as
// in the reference.  Bound on the H100: the DFT GEMM, 2 * frames * 400 * 402
// FLOP per clip on SIMT fp32 FMAs.
#include "common.cuh"

using namespace qasr;

namespace {

constexpr int N_FFT = 400, HOP = 160, N_BINS = N_FFT / 2 + 1;

// a(m = (b, f), k) = audio[b, 160 f + k] * window[k]
struct FrameA {
  const float* audio;
  const float* window;
  int L, F;
  __device__ __forceinline__ float operator()(int, int m, int k) const {
    const int bi = m / F, f = m % F;
    return audio[(size_t)bi * L + (size_t)f * HOP + k] * window[k];
  }
};

struct SpecEp {
  float* spec;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    spec[(size_t)m * 2 * N_BINS + n] = acc;
  }
};

// a(m, k) = re^2 + im^2 of bin k
struct PowerA {
  const float* spec;
  __device__ __forceinline__ float operator()(int, int m, int k) const {
    const float* row = spec + (size_t)m * 2 * N_BINS;
    const float re = row[k], im = row[N_BINS + k];
    return re * re + im * im;
  }
};

struct LogMelEp {
  float* out;
  int F, n_mels;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const int bi = m / F, f = m % F;
    out[((size_t)bi * n_mels + n) * F + f] = log10f(fmaxf(acc, 1e-10f));
  }
};

}  // namespace

// audio (B, L) float32, reflect-padded; window (400,); basis (402, 400) =
// [cos; -sin] rows; melfb (n_mels, 201); spec scratch (B * F, 402); out
// (B, n_mels, F) with F = the number of frames kept.
extern "C" int qasr_log_mel(const void* audio, const void* window, const void* basis,
                            const void* melfb, void* spec, void* out, int B, int L, int F,
                            int n_mels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * F;
  QASR_TRY(launch_gemm(M, 2 * N_BINS, N_FFT, 1,
                       FrameA{(const float*)audio, (const float*)window, L, F},
                       WeightNK<float>{(const float*)basis, N_FFT}, SpecEp{(float*)spec}, s));
  QASR_TRY(launch_gemm(M, n_mels, N_BINS, 1, PowerA{(const float*)spec},
                       WeightNK<float>{(const float*)melfb, N_BINS},
                       LogMelEp{(float*)out, F, n_mels}, s));
  return 0;
}
