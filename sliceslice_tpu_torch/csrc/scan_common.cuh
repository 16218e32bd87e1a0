// The probe loops shared by the port's scan kernels, with the constants
// and helpers they share.  Header only; every kernel source includes it
// into its own anonymous namespace, so each object carries its own inlined
// copy.
//
// Two loops evaluate the same probe program,
//     (win32(p + 4i) & msk[i]) == val[i] for every slot i < t,
// where win32(q) is the little-endian 4-byte window at byte q, built from
// two aligned words by __funnelshift_r:
//   * probe_word: 4 positions per thread from one aligned word and one more
//     word per slot (the first design's loop, kept as the ablation kernel's
//     `word` variant, and probe_wide's last group before the buffer's end);
//   * probe_wide: 16 positions per thread from one 16-byte load plus one
//     word, then one more word per slot (the find, count and match-bitmap
//     kernels and the ablation kernel's other variants).  Per position it
//     spends a quarter of probe_word's loads and address math, which the
//     ablation of the first design (PERF.md §5) found to be half of that
//     loop's time.  Its offsets are 32-bit: a layout is below 2^31 bytes.
// Both stop a position at its first failing slot and stop the slot walk once
// every position has failed.  probe_wide's slot walk is probe_slots; its
// Slot parameter selects the ablation kernel's variants of a slot.  T > 0
// fixes the width at compile time (t is then ignored), so that a table of
// T <= kMaxRegT slots held in registers stays there instead of being read
// from shared memory once per word.

#pragma once

#include <cstdint>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kFindTile = kThreads * 4;   // positions per block step, probe_word
constexpr int kWideTile = kThreads * 16;  // positions per block step, probe_wide
constexpr int kMaxT = 512;                // widest probe table
constexpr int kMaxRegT = 4;               // widest table held in registers

// The probe program at the positions p0 .. p0+3 (p0 word aligned, p0 <
// stop) that lie below stop: bit r of the result is set when position
// p0 + r satisfies every slot.  Reads the words p0/4 .. p0/4 + width.
template <int T = 0>
__device__ __forceinline__ unsigned probe_word(const uint32_t* __restrict__ hay,
                                               long long p0, long long stop,
                                               const uint32_t* val,
                                               const uint32_t* msk, int t) {
  const int width = T > 0 ? T : t;
  const long long rem = stop - p0;
  unsigned alive = rem >= 4 ? 0xFu : ((1u << rem) - 1u);
  const long long j = p0 >> 2;
  uint32_t lo = __ldg(hay + j);
  for (int i = 0; i < width && alive; ++i) {
    const uint32_t hi = __ldg(hay + j + i + 1);
    const uint32_t m = msk[i];
    const uint32_t v = val[i];
    if (m != 0u) {  // a mask-0 slot is trivially true
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = __funnelshift_r(lo, hi, 8 * r);
        if ((w & m) != v) alive &= ~(1u << r);
      }
    }
    lo = hi;
  }
  return alive;
}

// Bits 0 .. width-1 (width < 32) for the positions below a limit `rem`
// positions away.
__device__ __forceinline__ unsigned live_bits(long long rem, int width) {
  return rem >= width ? (1u << width) - 1u : (rem > 0 ? (1u << rem) - 1u : 0u);
}

// How probe_wide evaluates a slot: as the kernels do (kSlotPlain), or as
// one of the ablation kernel's variants: no AND on a slot whose mask is all
// ones (kSlotNomask), or every slot of every position evaluated with
// selects, with no early exit across slots (kSlotBranchless).
enum Slot : int { kSlotPlain = 0, kSlotNomask = 1, kSlotBranchless = 2 };

// One slot of probe_wide: the 16 windows of w[0..4] (positions 4k + r of
// the group read w[k], w[k+1]) against one masked value.
template <int S = kSlotPlain>
__device__ __forceinline__ void probe_slot16(const uint32_t* w, uint32_t m, uint32_t v,
                                             unsigned* alive) {
  if constexpr (S == kSlotBranchless) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned miss = (__funnelshift_r(w[k], w[k + 1], 8 * r) & m) != v;
        *alive &= ~(miss << (4 * k + r));
      }
    }
    return;
  }
  if (m == 0u) return;  // a mask-0 slot is trivially true
  if (S == kSlotNomask && m == 0xffffffffu) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (__funnelshift_r(w[k], w[k + 1], 8 * r) != v) *alive &= ~(1u << (4 * k + r));
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if ((__funnelshift_r(w[k], w[k + 1], 8 * r) & m) != v) *alive &= ~(1u << (4 * k + r));
    }
  }
}

// probe_wide's slot walk over a group whose words w[0..4] are loaded and
// whose candidate positions are `alive`: slot i > 0 reads one more word,
// hay[j + i + 4].  Slots below From are taken as already tested (alive
// holds their survivors).  The caller has checked j + width + 4 <= n_words.
template <int T = 0, int S = kSlotPlain, int From = 0>
__device__ __forceinline__ unsigned probe_slots(const uint32_t* __restrict__ hay, int j,
                                                uint32_t* w, unsigned alive,
                                                const uint32_t* val, const uint32_t* msk,
                                                int t) {
  constexpr bool kExit = S != kSlotBranchless;
  if constexpr (T > 0) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i > 0) {
        if (kExit && !alive) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = w[k + 1];
        w[4] = __ldg(hay + j + i + 4);
      }
      if (i >= From) probe_slot16<S>(w, msk[i], val[i], &alive);
    }
  } else {
    for (int i = 0;;) {
      if (i >= From) probe_slot16<S>(w, msk[i], val[i], &alive);
      if (++i >= t || (kExit && !alive)) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = w[k + 1];
      w[4] = __ldg(hay + j + i + 4);
    }
  }
  return alive;
}

// The probe program at the positions p0 .. p0+15 (p0 16-byte aligned, p0 <
// stop) that lie below stop: bit b is set when position p0 + b satisfies
// every slot.  Slot i reads the words p0/4 + i .. p0/4 + i + 4; a group
// whose last slot would read past the buffer's n_words words takes
// probe_word's per-word loads instead, which read no further than the
// positions below stop need (stop <= 4 * (n_words - width)).
template <int T = 0, int S = kSlotPlain>
__device__ __forceinline__ unsigned probe_wide(const uint32_t* __restrict__ hay, int n_words,
                                               int p0, int stop, const uint32_t* val,
                                               const uint32_t* msk, int t) {
  const int width = T > 0 ? T : t;
  const int j = p0 >> 2;
  if (j + width + 4 > n_words) {
    unsigned alive = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p0 + 4 * k < stop) alive |= probe_word<T>(hay, p0 + 4 * k, stop, val, msk, t) << (4 * k);
    }
    return alive;
  }
  const unsigned alive = live_bits(stop - p0, 16);
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(hay + j));
  uint32_t w[5] = {q.x, q.y, q.z, q.w, __ldg(hay + j + 4)};
  return probe_slots<T, S>(hay, j, w, alive, val, msk, width);
}

// The positions [start, stop) of the block (row, blockIdx.y): span
// number blockIdx.y, cut at the row's limit min(ends[row] - base, n_pos).
// False when the span starts at or past that limit.
__device__ __forceinline__ bool row_span(const int32_t* ends, int row, long long n_pos,
                                         long long base, long long span,
                                         long long* start, long long* stop) {
  long long lim = static_cast<long long>(ends[row]) - base;
  if (lim > n_pos) lim = n_pos;
  *start = static_cast<long long>(blockIdx.y) * span;
  if (*start >= lim) return false;
  *stop = (*start + span < lim) ? *start + span : lim;
  return true;
}

// Row `row` of the [rows, t] tables into shared memory; the caller
// synchronises before reading it.
__device__ __forceinline__ void load_table(const uint32_t* __restrict__ values,
                                           const uint32_t* __restrict__ masks, int row,
                                           int t, uint32_t* s_val, uint32_t* s_msk) {
  for (int i = threadIdx.x; i < t; i += kThreads) {
    s_val[i] = values[static_cast<long long>(row) * t + i];
    s_msk[i] = masks[static_cast<long long>(row) * t + i];
  }
}

// Adds the sum of the warp's `v` to *out with one atomicAdd by lane 0
// (none when it is 0).  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(unsigned v, int32_t* out) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0u) atomicAdd(out, static_cast<int>(v));
}

// Adds the sum of every thread's `v` to *out with one atomicAdd (none when
// it is 0): warp sums by __reduce_add_sync, then warp 0 over s_warp
// (kThreads / 32 slots of shared memory).  Every thread of the block calls it.
__device__ __forceinline__ void block_add(unsigned v, int32_t* out, unsigned* s_warp) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned sum = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0u;
    sum = __reduce_add_sync(0xffffffffu, sum);
    if (threadIdx.x == 0 && sum != 0u) atomicAdd(out, static_cast<int>(sum));
  }
}

}  // namespace
