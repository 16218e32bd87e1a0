// twoway: from-scratch Two-Way (Crochemore-Perrin) substring search.
//
// Role: a second native CPU competitor tier for the benchmark harness —
// the measured-on-this-host counterpart of the reference's external
// `twoway::find_bytes` / `memmem::TwoWaySearcher` competitor rows
// (bench/benches/i386.rs; README table).  Implemented from the textbook
// algorithm: critical factorization via two maximal-suffix scans
// (lexicographic and reverse order), then the periodic/non-periodic search
// loops with the exact-period memory optimization.  O(n + k) time, O(1)
// space, never reads past hay[n).
//
// Build: compiled into libswarscan.so alongside swarscan.cpp
// (sliceslice_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>

namespace {

// Maximal suffix of x[0..k) under byte order (asc) or its reverse (!asc).
// Returns the suffix start; *period gets its local period.
size_t maximal_suffix(const uint8_t* x, size_t k, bool asc, size_t* period) {
  size_t ms = 0;   // candidate maximal-suffix start
  size_t j = 1;    // rival start
  size_t off = 0;  // compare offset within the current match
  size_t p = 1;    // current period
  while (j + off < k) {
    uint8_t a = x[j + off];
    uint8_t b = x[ms + off];
    bool a_less = asc ? (a < b) : (b < a);
    if (a_less) {
      j += off + 1;
      off = 0;
      p = j - ms;
    } else if (a == b) {
      if (off + 1 != p) {
        ++off;
      } else {
        j += p;
        off = 0;
      }
    } else {  // a "greater": a new maximal suffix starts at j
      ms = j;
      j = ms + 1;
      off = 0;
      p = 1;
    }
  }
  *period = p;
  return ms;
}

}  // namespace

extern "C" {

// First occurrence of needle[0..k) in hay[0..n), or -1.
int64_t twoway_find(const uint8_t* hay, int64_t n, const uint8_t* x,
                    int64_t k) {
  if (k <= 0) return n >= 0 ? 0 : -1;
  if (n < k) return -1;
  if (k == 1) {
    const void* r = std::memchr(hay, x[0], static_cast<size_t>(n));
    return r ? static_cast<const uint8_t*>(r) - hay : -1;
  }

  // Critical factorization: the later of the two maximal suffixes.
  size_t p1, p2;
  size_t c1 = maximal_suffix(x, static_cast<size_t>(k), true, &p1);
  size_t c2 = maximal_suffix(x, static_cast<size_t>(k), false, &p2);
  size_t crit = c1;
  size_t per = p1;
  if (c2 > c1) {
    crit = c2;
    per = p2;
  }

  const size_t kk = static_cast<size_t>(k);
  const size_t nn = static_cast<size_t>(n);

  // Vectorized candidate skip: a window at j can only match if the
  // critical-position byte matches; memchr (libc-vectorized) jumps j to
  // the next such alignment.  Returns false when no candidate remains.
  const uint8_t xc = x[crit];
  auto skip_to_candidate = [&](size_t& j) -> bool {
    if (j + kk > nn) return false;
    if (hay[j + crit] == xc) return true;
    const uint8_t* from = hay + j + crit + 1;
    size_t span = (nn - kk + crit) - (j + crit);  // last valid index + 1
    const void* r = std::memchr(from, xc, span);
    if (!r) return false;
    j = static_cast<const uint8_t*>(r) - hay - crit;
    return true;
  };

  // Bounds first (the memcmp below reads x[per .. per+crit)): provably
  // always true for maximal_suffix output (per <= suffix length = k-crit),
  // kept as a cheap guard so a future factorization change cannot turn the
  // memcmp into an over-read.
  if (crit < kk && crit + per <= kk &&
      std::memcmp(x, x + per, crit) == 0) {
    // Periodic case: x[0..crit) is a prefix of x[per..), so after a full
    // right-half match the window shifts by the exact period and `memory`
    // skips re-comparing the remembered prefix.
    size_t j = 0;
    size_t memory = 0;  // number of left-end bytes known to match
    while (j + kk <= nn) {
      if (memory == 0 && !skip_to_candidate(j)) return -1;
      size_t i = (crit > memory ? crit : memory);
      while (i < kk && x[i] == hay[j + i]) ++i;
      if (i < kk) {
        j += i - crit + 1;
        memory = 0;
        continue;
      }
      // Right half matched; verify the left half down to `memory`.
      size_t b = crit;
      while (b > memory && x[b - 1] == hay[j + b - 1]) --b;
      if (b <= memory) return static_cast<int64_t>(j);
      j += per;
      memory = kk - per;
    }
    return -1;
  }

  // Non-periodic case: approximate period ensures linearity.
  size_t q = (crit > kk - crit ? crit : kk - crit) + 1;
  size_t j = 0;
  while (j + kk <= nn) {
    if (!skip_to_candidate(j)) return -1;
    size_t i = crit;
    while (i < kk && x[i] == hay[j + i]) ++i;
    if (i < kk) {
      j += i - crit + 1;
      continue;
    }
    size_t b = crit;
    while (b > 0 && x[b - 1] == hay[j + b - 1]) --b;
    if (b == 0) return static_cast<int64_t>(j);
    j += q;
  }
  return -1;
}

// Batched first occurrences: needles concatenated in `flat` with
// offsets[i]..offsets[i+1] delimiting needle i; out[i] = offset or -1.
void twoway_find_batch(const uint8_t* hay, int64_t n, const uint8_t* flat,
                       const int64_t* offsets, int64_t count, int64_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    out[i] = twoway_find(hay, n, flat + offsets[i],
                         offsets[i + 1] - offsets[i]);
  }
}

}  // extern "C"
