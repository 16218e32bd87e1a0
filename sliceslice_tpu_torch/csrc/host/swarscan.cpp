// swarscan: portable SWAR (SIMD-within-a-register) substring scanner.
//
// Role: the native CPU competitor baseline + fast host-side oracle for the
// search framework's benchmarks — the counterpart of the reference's
// benchmark-only C++ sse4-strstr wrapper (bench/sse4-strstr/src/wrapper.cpp),
// re-implemented from scratch with 64-bit SWAR instead of AVX2 intrinsics so
// it runs on any little-endian host CPU (the lane extraction maps mask
// bytes to memory offsets via ctz; big-endian hosts fail the build below
// and fall back to the pure-Python oracle).
//
// Algorithm (Mula-style two-byte filter, expressed in SWAR):
//   broadcast the needle's first byte and the byte at `position` across a
//   uint64; for every 8-byte window compare both lanes-wise using the
//   classic zero-byte test  (x - 0x01..01) & ~x & 0x80..80 ,  AND the two
//   candidate masks, then verify each surviving candidate with memcmp.
// Exactly one byte past `end = n - k + 1` is never read: the scalar tail
// loop covers the last < 8 positions.
//
// Build: g++ -O3 -shared -fPIC (see sliceslice_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
// The candidate-lane extraction (ctz >> 3 -> byte offset) assumes
// little-endian loads; failing the BUILD here makes the Python loader
// degrade to the pure-Python oracle on big-endian hosts instead of
// silently returning false negatives.
#error "swarscan requires a little-endian host (loader degrades to Python)"
#endif

namespace {

constexpr uint64_t kLow = 0x0101010101010101ULL;
constexpr uint64_t kHigh = 0x8080808080808080ULL;

inline uint64_t broadcast(uint8_t b) { return kLow * static_cast<uint64_t>(b); }

// High bit set in every byte of `x` that is zero.
inline uint64_t zero_bytes(uint64_t x) { return (x - kLow) & ~x & kHigh; }

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

}  // namespace

extern "C" {

// First occurrence of needle[0..k) in hay[0..n), or -1.
// `position` selects the secondary filter byte (default k-1), mirroring the
// reference's with_position DoS-hardening knob (src/x86.rs:252-255).
int64_t swar_find_pos(const uint8_t* hay, int64_t n, const uint8_t* needle,
                      int64_t k, int64_t position) {
  if (k <= 0) return n >= 0 ? 0 : -1;
  if (n < k) return -1;
  if (k == 1) {
    const void* p = std::memchr(hay, needle[0], static_cast<size_t>(n));
    return p ? static_cast<const uint8_t*>(p) - hay : -1;
  }
  if (position < 0 || position >= k) position = k - 1;
  const int64_t end = n - k + 1;  // number of candidate positions
  const uint64_t first = broadcast(needle[0]);
  const uint64_t second = broadcast(needle[position]);

  int64_t i = 0;
  // 8 candidate positions per iteration; the `position` lane load stays in
  // bounds because i + 7 + position <= end - 1 + k - 1 < n.
  for (; i + 8 <= end; i += 8) {
    uint64_t cand = zero_bytes(load64(hay + i) ^ first) &
                    zero_bytes(load64(hay + i + position) ^ second);
    while (cand) {
      const int lane = __builtin_ctzll(cand) >> 3;
      // Full-needle verify: the zero-byte test can false-positive on a 0x01
      // lane when the lane below it borrows (v=0x00), so byte 0 must be
      // re-checked too.
      if (std::memcmp(hay + i + lane, needle, static_cast<size_t>(k)) == 0) {
        return i + lane;
      }
      cand &= cand - 1;
    }
  }
  for (; i < end; ++i) {
    if (hay[i] == needle[0] &&
        std::memcmp(hay + i + 1, needle + 1, static_cast<size_t>(k - 1)) == 0) {
      return i;
    }
  }
  return -1;
}

int64_t swar_find(const uint8_t* hay, int64_t n, const uint8_t* needle,
                  int64_t k) {
  return swar_find_pos(hay, n, needle, k, k - 1);
}

// Batched sweep: needles packed back-to-back, offsets[count+1] delimiting.
// out[i] = first offset of needle i in hay, or -1.
void swar_find_batch(const uint8_t* hay, int64_t n, const uint8_t* needles,
                     const int64_t* offsets, int64_t count, int64_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    const int64_t k = offsets[i + 1] - offsets[i];
    out[i] = swar_find(hay, n, needles + offsets[i], k);
  }
}

// All-pairs containment sweep (short-haystack bench shape): words packed
// back-to-back; out is row-major count x count int8 (1 = contained).
void swar_pairwise(const uint8_t* words, const int64_t* offsets,
                   int64_t count, int8_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    const uint8_t* nd = words + offsets[i];
    const int64_t k = offsets[i + 1] - offsets[i];
    for (int64_t j = 0; j < count; ++j) {
      const uint8_t* hy = words + offsets[j];
      const int64_t m = offsets[j + 1] - offsets[j];
      out[i * count + j] = swar_find(hy, m, nd, k) >= 0 ? 1 : 0;
    }
  }
}

}  // extern "C"

extern "C" {

// Match-bitmap decode (positions path, ops/xla_backend.match_bitmap_cols):
// words is uint32[(g, q, lanes)] where bit b of words[gi, qi, li] marks a
// match at flat offset gi*(s*lanes) + li*s + 32*qi + b.  Two-pass contract:
// decode_bitmap_count sizes the output, decode_bitmap fills it (unsorted
// memory-order positions; the caller sorts).  Replaces an unpackbits-based
// numpy decode that materialized 8x the bitmap in bytes.
int64_t decode_bitmap_count(const uint32_t* words, int64_t nwords) {
  int64_t c = 0;
  for (int64_t i = 0; i < nwords; ++i) {
    c += __builtin_popcount(words[i]);
  }
  return c;
}

int64_t decode_bitmap(const uint32_t* words, int64_t g, int64_t q,
                      int64_t lanes, int64_t s, int64_t* out, int64_t cap) {
  int64_t m = 0;
  const int64_t seg = s * lanes;
  for (int64_t gi = 0; gi < g; ++gi) {
    for (int64_t qi = 0; qi < q; ++qi) {
      const uint32_t* row = words + (gi * q + qi) * lanes;
      const int64_t base = gi * seg + 32 * qi;
      for (int64_t li = 0; li < lanes; ++li) {
        uint32_t w = row[li];
        const int64_t pos0 = base + li * s;
        while (w) {
          if (m >= cap) return -1;  // caller-size mismatch
          out[m++] = pos0 + __builtin_ctz(w);
          w &= w - 1;
        }
      }
    }
  }
  return m;
}

}  // extern "C"
