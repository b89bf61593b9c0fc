// Native Levenshtein core for CER/WER scoring.
//
// The reference leans on the `editdistance` C extension and jiwer
// (reference utils.py:14-15); this is our native equivalent, driven
// over int32 symbol ids (the Python layer interns chars/words to ids).
// Banded two-row DP, O(n*m) worst case with an early-exit equal-prefix/
// suffix trim.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int32_t qasr_levenshtein(const int32_t* a, int32_t n, const int32_t* b,
                         int32_t m) {
  // Trim common prefix/suffix.
  while (n > 0 && m > 0 && a[0] == b[0]) {
    ++a;
    ++b;
    --n;
    --m;
  }
  while (n > 0 && m > 0 && a[n - 1] == b[m - 1]) {
    --n;
    --m;
  }
  if (n == 0) return m;
  if (m == 0) return n;
  if (n < m) {
    std::swap(a, b);
    std::swap(n, m);
  }

  std::vector<int32_t> row(static_cast<size_t>(m) + 1);
  for (int32_t j = 0; j <= m; ++j) row[static_cast<size_t>(j)] = j;
  for (int32_t i = 1; i <= n; ++i) {
    int32_t prev_diag = row[0];
    row[0] = i;
    const int32_t ai = a[i - 1];
    for (int32_t j = 1; j <= m; ++j) {
      const int32_t up = row[static_cast<size_t>(j)];
      const int32_t sub = prev_diag + (ai != b[j - 1] ? 1 : 0);
      const int32_t del = up + 1;
      const int32_t ins = row[static_cast<size_t>(j) - 1] + 1;
      row[static_cast<size_t>(j)] = std::min(sub, std::min(del, ins));
      prev_diag = up;
    }
  }
  return row[static_cast<size_t>(m)];
}

}  // extern "C"
