// Native BPE merge core.
//
// TPU-native replacement for the reference's Rust `tiktoken` dependency
// (reference whisper/whisper/tokenizer.py:7,357-363): the regex
// pretokenizer stays in Python (unicode classes), while the hot greedy
// lowest-rank pair-merge loop runs here.  C ABI, loaded via ctypes by
// qasr_ijcnlp_tpu/_native.py; token ids are identical to the pure-Python
// fallback (tested in tests/test_native.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 bpe.cpp -o libqasr_native.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct RankTable {
  std::unordered_map<std::string, int32_t> ranks;
};

}  // namespace

extern "C" {

// blob: concatenated key bytes; offsets: n+1 prefix offsets; rank_vals: n ranks.
void* qasr_bpe_create(const uint8_t* blob, const int64_t* offsets,
                      const int32_t* rank_vals, int64_t n) {
  auto* table = new RankTable();
  table->ranks.reserve(static_cast<size_t>(n) * 2);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t start = offsets[i];
    const int64_t len = offsets[i + 1] - start;
    table->ranks.emplace(
        std::string(reinterpret_cast<const char*>(blob + start),
                    static_cast<size_t>(len)),
        rank_vals[i]);
  }
  return table;
}

void qasr_bpe_destroy(void* handle) { delete static_cast<RankTable*>(handle); }

// Greedy lowest-rank adjacent pair merging over one pretokenized piece.
// Returns the number of token ids written to `out` (or -1 if cap exceeded).
int32_t qasr_bpe_merge(void* handle, const uint8_t* piece, int32_t len,
                       int32_t* out, int32_t cap) {
  const auto& ranks = static_cast<RankTable*>(handle)->ranks;
  const char* data = reinterpret_cast<const char*>(piece);

  // Whole-piece fast path.
  if (auto it = ranks.find(std::string(data, static_cast<size_t>(len)));
      it != ranks.end()) {
    if (cap < 1) return -1;
    out[0] = it->second;
    return 1;
  }

  // parts[i] = (start, length) of the current symbol.
  std::vector<std::pair<int32_t, int32_t>> parts;
  parts.reserve(static_cast<size_t>(len));
  for (int32_t i = 0; i < len; ++i) parts.emplace_back(i, 1);

  std::string key;
  while (parts.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = SIZE_MAX;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      key.assign(data + parts[i].first,
                 static_cast<size_t>(parts[i].second + parts[i + 1].second));
      auto it = ranks.find(key);
      if (it != ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_i == SIZE_MAX) break;
    parts[best_i].second += parts[best_i + 1].second;
    parts.erase(parts.begin() + static_cast<int64_t>(best_i) + 1);
  }

  if (static_cast<int32_t>(parts.size()) > cap) return -1;
  for (size_t i = 0; i < parts.size(); ++i) {
    key.assign(data + parts[i].first, static_cast<size_t>(parts[i].second));
    auto it = ranks.find(key);
    if (it == ranks.end()) return -2;  // un-mergeable byte: caller falls back
    out[i] = it->second;
  }
  return static_cast<int32_t>(parts.size());
}

}  // extern "C"
