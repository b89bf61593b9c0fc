// Shared mono resampler for the native audio decoders (wavio.cpp, flac.cpp).
//
// Downsampling applies a windowed-sinc FIR low-pass at 0.45x the target
// Nyquist BEFORE the linear interpolation: bare interpolation folds all
// source content above the target Nyquist back into the band (a 44.1/48 kHz
// recording aliases its 8-22 kHz energy over the speech band).  Upsampling
// skips the filter (no aliasing risk; interpolation images are negligible
// for speech into an 8 kHz-band mel frontend).
//
// Replaces the resample half of ffmpeg in the reference's load_audio
// (whisper/whisper/audio.py:25-62) when no ffmpeg binary is
// present.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace qasr {

// Returns the output length, or -3 if `cap` > 0 and too small.  With
// cap == 0 only the required length is computed (two-call protocol of the
// decoders' C API).
int64_t resample_linear(const std::vector<float>& mono, uint32_t rate,
                        int32_t target_rate, float* out, int64_t cap) {
  const size_t frames = mono.size();
  int64_t n_out;
  if (rate == static_cast<uint32_t>(target_rate)) {
    n_out = static_cast<int64_t>(frames);
    if (cap == 0) return n_out;
    if (n_out > cap) return -3;
    std::memcpy(out, mono.data(), static_cast<size_t>(n_out) * 4);
    return n_out;
  }
  n_out = static_cast<int64_t>(
      frames * static_cast<double>(target_rate) / rate + 0.5);
  if (cap == 0) return n_out;
  if (n_out > cap) return -3;

  const std::vector<float>* src = &mono;
  std::vector<float> filtered;
  if (static_cast<uint32_t>(target_rate) < rate) {
    constexpr int kTaps = 65;  // ~ -50 dB stopband with a Hamming window
    constexpr int kHalf = kTaps / 2;
    const double fc = 0.45 * target_rate / rate;  // cycles per input sample
    double h[kTaps];
    double sum = 0.0;
    for (int i = 0; i < kTaps; ++i) {
      const double n = i - kHalf;
      const double sinc =
          n == 0.0 ? 2.0 * fc : std::sin(2.0 * M_PI * fc * n) / (M_PI * n);
      const double w = 0.54 - 0.46 * std::cos(2.0 * M_PI * i / (kTaps - 1));
      h[i] = sinc * w;
      sum += h[i];
    }
    for (int i = 0; i < kTaps; ++i) h[i] /= sum;  // unity DC gain
    filtered.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      const int64_t lo = static_cast<int64_t>(i) - kHalf;
      for (int k = 0; k < kTaps; ++k) {
        const int64_t j = lo + k;
        if (j >= 0 && j < static_cast<int64_t>(frames))
          acc += h[k] * mono[static_cast<size_t>(j)];
      }
      filtered[i] = static_cast<float>(acc);
    }
    src = &filtered;
  }

  for (int64_t j = 0; j < n_out; ++j) {
    const double t = static_cast<double>(j) * rate / target_rate;
    const size_t i0 = static_cast<size_t>(t);
    const double frac = t - static_cast<double>(i0);
    const float a = i0 < frames ? (*src)[i0] : 0.0f;
    const float b = i0 + 1 < frames ? (*src)[i0 + 1] : a;
    out[j] = static_cast<float>(a + (b - a) * frac);
  }
  return n_out;
}

}  // namespace qasr
