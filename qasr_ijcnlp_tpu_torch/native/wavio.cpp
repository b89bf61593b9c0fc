// Native WAV decode + mono-mix + linear resample.
//
// The reference shells out to ffmpeg for audio IO
// (whisper/whisper/audio.py:42-62); our fallback chain ends
// in this native RIFF/PCM decoder so the hot eval/data path never pays
// Python per-sample loops.  Supports PCM 8/16/32-bit and IEEE float32,
// arbitrary channel counts, any source rate.

#include <cstdint>
#include <cstring>
#include <vector>

namespace qasr {
int64_t resample_linear(const std::vector<float>& mono, uint32_t rate,
                        int32_t target_rate, float* out, int64_t cap);
}  // namespace qasr

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  bool read(void* dst, size_t k) {
    if (off + k > n) return false;
    std::memcpy(dst, p + off, k);
    off += k;
    return true;
  }
  bool skip(size_t k) {
    if (off + k > n) return false;
    off += k;
    return true;
  }
};

}  // namespace

extern "C" {

// Decodes WAV bytes to mono float32 at `target_rate`.
// Returns the number of output samples, writing at most `cap` to `out`;
// negative values are errors (-1 malformed, -2 unsupported format,
// -3 capacity).  Call with cap=0 to query the required size.
int64_t qasr_wav_decode(const uint8_t* data, int64_t len, int32_t target_rate,
                        float* out, int64_t cap) {
  Reader r{data, static_cast<size_t>(len)};
  char tag[4];
  uint32_t riff_size;
  if (!r.read(tag, 4) || std::memcmp(tag, "RIFF", 4) != 0) return -1;
  if (!r.read(&riff_size, 4)) return -1;
  if (!r.read(tag, 4) || std::memcmp(tag, "WAVE", 4) != 0) return -1;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;

  while (r.off + 8 <= r.n) {
    char id[4];
    uint32_t sz;
    if (!r.read(id, 4) || !r.read(&sz, 4)) break;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[16];
      if (sz < 16 || !r.read(buf, 16)) return -1;
      std::memcpy(&fmt, buf + 0, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&rate, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (!r.skip(sz - 16 + (sz & 1))) return -1;
    } else if (std::memcmp(id, "data", 4) == 0) {
      if (r.off + sz > r.n) sz = static_cast<uint32_t>(r.n - r.off);
      pcm = data + r.off;
      pcm_len = sz;
      if (!r.skip(sz + (sz & 1))) break;
    } else {
      if (!r.skip(sz + (sz & 1))) break;
    }
  }
  if (!pcm || channels == 0 || rate == 0) return -1;
  if (fmt != 1 && fmt != 3) return -2;  // PCM or IEEE float only

  const size_t bytes_per = bits / 8;
  if (bytes_per == 0) return -2;
  const size_t frames = pcm_len / (bytes_per * channels);

  // Decode + mono-mix.
  std::vector<float> mono(frames);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (uint16_t c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per;
      double v;
      if (fmt == 3 && bits == 32) {
        float f;
        std::memcpy(&f, s, 4);
        v = f;
      } else if (bits == 16) {
        int16_t x;
        std::memcpy(&x, s, 2);
        v = x / 32768.0;
      } else if (bits == 32) {
        int32_t x;
        std::memcpy(&x, s, 4);
        v = x / 2147483648.0;
      } else if (bits == 8) {
        v = (s[0] - 128.0) / 128.0;
      } else {
        return -2;
      }
      acc += v;
    }
    mono[i] = static_cast<float>(acc / channels);
  }

  // Anti-aliased resample to target_rate (native/resample.cpp).
  return qasr::resample_linear(mono, rate, target_rate, out, cap);
}

}  // extern "C"
