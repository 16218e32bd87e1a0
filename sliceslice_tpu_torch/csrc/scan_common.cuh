// The probe loop shared by the find, count and match-bitmap kernels
// (find.cu) and the ablation kernel (probe.cu), with the constants they
// share.  Header only; every kernel source includes it into its own
// anonymous namespace, so each object carries its own inlined copy.

#pragma once

#include <cstdint>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kFindTile = kThreads * 4;  // positions per block step
constexpr int kMaxT = 512;               // widest probe table

// The probe program at the positions p0 .. p0+3 (p0 word aligned, p0 <
// stop) that lie below stop: bit r of the result is set when position
// p0 + r satisfies every slot i < t,
//     (win32(p0 + r + 4i) & msk[i]) == val[i].
// Windows come from two aligned words by __funnelshift_r; a position drops
// out at its first failing slot, and the walk over slots stops once all
// four have.  T > 0 fixes the width at compile time (t is then ignored), so
// that a table held in registers stays there.
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
