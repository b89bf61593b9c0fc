// Native FLAC decode + mono-mix + linear resample.
//
// The reference's audio fixture (whisper/tests/jfk.flac, used by
// whisper/tests/test_audio.py:8-19 and test_transcribe.py)
// is FLAC; this container has no ffmpeg/soundfile, so real-audio end-to-end
// tests need a native reader.  This is a from-scratch decoder of the FLAC
// frame format (constant/verbatim/fixed/LPC subframes, Rice-partitioned
// residuals, left/right/mid-side stereo decorrelation, wasted bits), enough
// for any standard encoder output.  CRCs are consumed but not verified — a
// corrupt stream yields an error from structural checks instead.

#include <cstdint>
#include <cstring>
#include <vector>

namespace qasr {
int64_t resample_linear(const std::vector<float>& mono, uint32_t rate,
                        int32_t target_rate, float* out, int64_t cap);
}  // namespace qasr

namespace {

struct BitReader {
  const uint8_t* data;
  size_t len;     // bytes
  size_t byte = 0;
  int bit = 0;    // 0..7, MSB-first

  bool eof() const { return byte >= len; }

  // n <= 57 to fit the accumulator path; callers respect this.
  bool read_bits(int n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= len) return false;
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint8_t cur = data[byte];
      uint8_t chunk = (cur >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      bit += take;
      if (bit == 8) {
        bit = 0;
        ++byte;
      }
      n -= take;
    }
    *out = v;
    return true;
  }

  bool read_signed(int n, int64_t* out) {
    uint64_t v;
    if (!read_bits(n, &v)) return false;
    // sign-extend
    if (n > 0 && (v >> (n - 1)) & 1) v |= ~((1ull << n) - 1);
    *out = static_cast<int64_t>(v);
    return true;
  }

  bool read_unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      if (byte >= len) return false;
      uint8_t cur = data[byte];
      // scan remaining bits of this byte for the terminating 1
      for (; bit < 8; ++bit) {
        if ((cur >> (7 - bit)) & 1) {
          ++bit;
          if (bit == 8) {
            bit = 0;
            ++byte;
          }
          *out = q;
          return true;
        }
        ++q;
        if (q > (1u << 24)) return false;  // malformed stream guard
      }
      bit = 0;
      ++byte;
    }
  }

  void align() {
    if (bit != 0) {
      bit = 0;
      ++byte;
    }
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

// UTF-8-style coded number in the frame header (sample or frame index).
bool read_coded_number(BitReader* br, uint64_t* out) {
  uint64_t b0;
  if (!br->read_bits(8, &b0)) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint64_t b;
    if (!br->read_bits(8, &b)) return false;
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Rice-partitioned residual into res[order..blocksize).
bool read_residual(BitReader* br, uint32_t blocksize, uint32_t order,
                   std::vector<int64_t>* res) {
  uint64_t method, porder;
  if (!br->read_bits(2, &method)) return false;
  if (method > 1) return false;
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 15 : 31;
  if (!br->read_bits(4, &porder)) return false;
  const uint32_t partitions = 1u << porder;
  if (blocksize % partitions != 0) return false;
  const uint32_t psize = blocksize >> porder;
  // The first partition holds psize - order residuals: psize < order is
  // malformed for ANY partition count (count would underflow uint32 and
  // write ~2^32 residuals past the blocksize-sized buffer); with a single
  // partition psize == order (an empty residual) is malformed too.
  if (psize < order || (partitions == 1 && psize == order)) return false;

  uint32_t idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = psize - (p == 0 ? order : 0);
    uint64_t param;
    if (!br->read_bits(pbits, &param)) return false;
    if (param == escape) {
      uint64_t rawbits;
      if (!br->read_bits(5, &rawbits)) return false;
      for (uint32_t i = 0; i < count; ++i) {
        int64_t v = 0;
        if (rawbits > 0 && !br->read_signed(static_cast<int>(rawbits), &v))
          return false;
        (*res)[idx++] = v;
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q;
        if (!br->read_unary(&q)) return false;
        uint64_t r = 0;
        if (param > 0 && !br->read_bits(static_cast<int>(param), &r))
          return false;
        uint64_t u = (static_cast<uint64_t>(q) << param) | r;
        // zigzag: even -> u/2, odd -> -(u+1)/2
        (*res)[idx++] = (u & 1) ? -static_cast<int64_t>((u + 1) >> 1)
                                : static_cast<int64_t>(u >> 1);
      }
    }
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader* br, uint32_t blocksize, uint32_t bps,
                     std::vector<int64_t>* out) {
  uint64_t pad, type_code, wasted_flag;
  if (!br->read_bits(1, &pad) || pad != 0) return false;
  if (!br->read_bits(6, &type_code)) return false;
  if (!br->read_bits(1, &wasted_flag)) return false;
  uint32_t wasted = 0;
  if (wasted_flag) {
    uint32_t q;
    if (!br->read_unary(&q)) return false;
    wasted = q + 1;
  }
  if (wasted >= bps) return false;
  const uint32_t ebps = bps - wasted;  // effective bits per sample

  std::vector<int64_t>& s = *out;
  s.assign(blocksize, 0);

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br->read_signed(static_cast<int>(ebps), &v)) return false;
    for (uint32_t i = 0; i < blocksize; ++i) s[i] = v;
  } else if (type_code == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i)
      if (!br->read_signed(static_cast<int>(ebps), &s[i])) return false;
  } else if (type_code >= 8 && type_code <= 12) {  // FIXED, order 0..4
    const uint32_t order = static_cast<uint32_t>(type_code & 7);
    if (order > blocksize) return false;
    for (uint32_t i = 0; i < order; ++i)
      if (!br->read_signed(static_cast<int>(ebps), &s[i])) return false;
    if (!read_residual(br, blocksize, order, &s)) return false;
    // s currently holds warmup + residuals; reconstruct in place.
    switch (order) {
      case 0:
        break;
      case 1:
        for (uint32_t i = 1; i < blocksize; ++i) s[i] += s[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < blocksize; ++i)
          s[i] += 2 * s[i - 1] - s[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < blocksize; ++i)
          s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < blocksize; ++i)
          s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
        break;
    }
  } else if (type_code >= 32) {  // LPC, order 1..32
    const uint32_t order = static_cast<uint32_t>((type_code & 31) + 1);
    if (order > blocksize) return false;
    for (uint32_t i = 0; i < order; ++i)
      if (!br->read_signed(static_cast<int>(ebps), &s[i])) return false;
    uint64_t prec_m1;
    if (!br->read_bits(4, &prec_m1) || prec_m1 == 15) return false;
    const int precision = static_cast<int>(prec_m1) + 1;
    int64_t shift;
    if (!br->read_signed(5, &shift) || shift < 0) return false;
    int64_t coef[32];
    for (uint32_t i = 0; i < order; ++i)
      if (!br->read_signed(precision, &coef[i])) return false;
    if (!read_residual(br, blocksize, order, &s)) return false;
    for (uint32_t i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (uint32_t j = 0; j < order; ++j) acc += coef[j] * s[i - 1 - j];
      s[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }

  if (wasted)
    for (uint32_t i = 0; i < blocksize; ++i) s[i] <<= wasted;
  return true;
}

const uint32_t kBlockSizes[16] = {0,   192,  576,  1152,  2304, 4608, 0, 0,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kSampleRates[16] = {0,     88200, 176400, 192000, 8000, 16000,
                                   22050, 24000, 32000,  44100,  48000, 96000,
                                   0,     0,     0,      0};

}  // namespace

extern "C" {

// Decodes FLAC bytes to mono float32 at `target_rate`.
// Same contract as qasr_wav_decode: returns the number of output samples,
// writing at most `cap` to `out` (cap=0 queries the size); negative values
// are errors (-1 malformed, -2 unsupported, -3 capacity).
int64_t qasr_flac_decode(const uint8_t* data, int64_t len, int32_t target_rate,
                         float* out, int64_t cap) {
  if (len < 42 || std::memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  StreamInfo si;
  bool have_si = false;
  // metadata blocks
  for (;;) {
    if (pos + 4 > static_cast<size_t>(len)) return -1;
    const uint8_t hdr = data[pos];
    const bool last = hdr & 0x80;
    const uint8_t type = hdr & 0x7F;
    const uint32_t blen = (static_cast<uint32_t>(data[pos + 1]) << 16) |
                          (static_cast<uint32_t>(data[pos + 2]) << 8) |
                          data[pos + 3];
    pos += 4;
    if (pos + blen > static_cast<size_t>(len)) return -1;
    if (type == 0 && blen >= 34) {
      const uint8_t* p = data + pos;
      si.sample_rate = (static_cast<uint32_t>(p[10]) << 12) |
                       (static_cast<uint32_t>(p[11]) << 4) | (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 0x7) + 1;
      si.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total_samples = (static_cast<uint64_t>(p[13] & 0x0F) << 32) |
                         (static_cast<uint64_t>(p[14]) << 24) |
                         (static_cast<uint64_t>(p[15]) << 16) |
                         (static_cast<uint64_t>(p[16]) << 8) | p[17];
      have_si = true;
    }
    pos += blen;
    if (last) break;
  }
  if (!have_si || si.sample_rate == 0 || si.channels == 0 || si.channels > 8)
    return -1;
  if (si.bps < 4 || si.bps > 32) return -2;

  BitReader br{data, static_cast<size_t>(len)};
  br.byte = pos;

  std::vector<float> mono;
  if (si.total_samples) mono.reserve(static_cast<size_t>(si.total_samples));
  std::vector<std::vector<int64_t>> ch(si.channels);
  const double scale = 1.0 / static_cast<double>(1ull << (si.bps - 1));

  // frames until the stream ends
  while (br.byte + 2 < br.len) {
    uint64_t sync;
    if (!br.read_bits(14, &sync)) break;
    if (sync != 0x3FFE) return -1;  // streams are frame-aligned after headers
    uint64_t reserved, blocking;
    if (!br.read_bits(1, &reserved) || !br.read_bits(1, &blocking)) return -1;
    uint64_t bs_code, sr_code, ch_code, ss_code, reserved2;
    if (!br.read_bits(4, &bs_code) || !br.read_bits(4, &sr_code)) return -1;
    if (!br.read_bits(4, &ch_code) || !br.read_bits(3, &ss_code) ||
        !br.read_bits(1, &reserved2))
      return -1;
    uint64_t coded;
    if (!read_coded_number(&br, &coded)) return -1;

    uint32_t blocksize;
    if (bs_code == 6) {
      uint64_t v;
      if (!br.read_bits(8, &v)) return -1;
      blocksize = static_cast<uint32_t>(v) + 1;
    } else if (bs_code == 7) {
      uint64_t v;
      if (!br.read_bits(16, &v)) return -1;
      blocksize = static_cast<uint32_t>(v) + 1;
    } else {
      blocksize = kBlockSizes[bs_code];
      if (blocksize == 0) return -1;
    }
    if (sr_code == 12) {
      uint64_t v;
      if (!br.read_bits(8, &v)) return -1;
    } else if (sr_code == 13 || sr_code == 14) {
      uint64_t v;
      if (!br.read_bits(16, &v)) return -1;
    } else if (kSampleRates[sr_code] == 0 && sr_code != 0) {
      return -1;
    }
    uint64_t crc8;
    if (!br.read_bits(8, &crc8)) return -1;

    // channel layout for this frame
    uint32_t nch;
    int decor = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code < 8) {
      nch = static_cast<uint32_t>(ch_code) + 1;
    } else if (ch_code <= 10) {
      nch = 2;
      decor = static_cast<int>(ch_code) - 7;
    } else {
      return -1;
    }
    if (nch != si.channels) return -1;

    uint32_t bps = si.bps;
    switch (ss_code) {
      case 0: break;  // from STREAMINFO
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -1;
    }

    for (uint32_t c = 0; c < nch; ++c) {
      uint32_t sub_bps = bps;
      // the side channel carries one extra bit
      if ((decor == 1 && c == 1) || (decor == 2 && c == 0) ||
          (decor == 3 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(&br, blocksize, sub_bps, &ch[c])) return -1;
    }
    br.align();
    uint64_t crc16;
    if (!br.read_bits(16, &crc16)) return -1;

    // undo stereo decorrelation
    if (decor == 1) {  // left/side: right = left - side
      for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (decor == 2) {  // right/side: left = right + side
      for (uint32_t i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (decor == 3) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        const int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    for (uint32_t i = 0; i < blocksize; ++i) {
      double acc = 0.0;
      for (uint32_t c = 0; c < nch; ++c)
        acc += static_cast<double>(ch[c][i]) * scale;
      mono.push_back(static_cast<float>(acc / nch));
    }
    if (si.total_samples && mono.size() >= si.total_samples) break;
  }
  if (si.total_samples && mono.size() > si.total_samples)
    mono.resize(static_cast<size_t>(si.total_samples));
  if (mono.empty()) return -1;

  const size_t frames = mono.size();
  const uint32_t rate = si.sample_rate;
  // Anti-aliased resample to target_rate (native/resample.cpp).
  return qasr::resample_linear(mono, rate, target_rate, out, cap);
}

}  // extern "C"
