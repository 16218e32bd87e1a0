// The chunk-major work queue of the port's scan kernels: the item draw, the
// per-item find, count and bitmap walks, and the loop a persistent block
// runs over them.  Header only; csrc/find.cu builds its three user kernels
// from queue_loop, and csrc/probe.cu (the ablation harness) runs queue_loop
// itself as its baseline and strips next_item, item_table and the walks
// piece by piece.  csrc/find.cu's header says what the design answers.

#pragma once

#include <cstdint>

#include "scan_common.cuh"

namespace {

// What a queue kernel does with its items (ssf_queue's `mode`; the
// wrapper, ops/scan_kernel.py, passes the same numbers).
enum Mode { kFindMode = 0, kCountMode = 1, kBitmapMode = 2 };

__device__ __forceinline__ int read_best(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

// One item of the chunk-major queue: positions [start, stop) of row `row`,
// item number idx.
struct Item {
  int row, start, stop, idx;
};

// Thread 0 only: the next item of the queue with positions to scan, or row
// -1 when the queue is empty.  Item i is chunk c = i / rows of row i % rows,
// so chunk c of every row is handed out before chunk c + 1 of any row.  An
// item is dead, and skipped here, when its chunk starts at or past the
// row's limit min(ends[row] - base, n_pos) or, for find (out != nullptr),
// at or past the row's best match so far: a stale read of that best only
// costs work, never an answer, since matches merge by atomicMin.
__device__ __forceinline__ Item next_item(int* queue, int n_items, int rows, int chunk,
                                          const int32_t* __restrict__ ends, int base,
                                          int n_pos, const int32_t* out) {
  for (;;) {
    const int i = atomicAdd(queue, 1);
    if (i >= n_items) return Item{-1, 0, 0, 0};
    const int c = i / rows;
    const int row = i - c * rows;
    const int start = c * chunk;
    const long long lim = min(static_cast<long long>(__ldg(ends + row)) - base,
                              static_cast<long long>(n_pos));
    if (start >= lim) continue;
    if (out != nullptr && static_cast<long long>(read_best(out + row)) - base <= start) continue;
    return Item{row, start, lim - start > chunk ? start + chunk : static_cast<int>(lim), i};
  }
}

// The row's table for one item: in registers (val, msk) when T > 0, else
// in shared memory (s_val, s_msk); the caller has synchronised since the
// last read of the shared table.
template <int T>
__device__ __forceinline__ void item_table(const uint32_t* __restrict__ values,
                                           const uint32_t* __restrict__ masks, int row, int t,
                                           uint32_t* val, uint32_t* msk, uint32_t* s_val,
                                           uint32_t* s_msk) {
  if constexpr (T > 0) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      val[i] = __ldg(values + row * T + i);
      msk[i] = __ldg(masks + row * T + i);
    }
  } else {
    load_table(values, masks, row, t, s_val, s_msk);
    __syncthreads();
  }
}

// The first match of one find item, merged into *best.  Every thread of
// the block calls it; it ends on a barrier only when it finds a match.
template <int T>
__device__ __forceinline__ void find_item(const uint32_t* __restrict__ hay, int n_words,
                                          Item it, const uint32_t* val, const uint32_t* msk,
                                          int t, int base, int* s_first, int32_t* best) {
  const int len = it.stop - it.start;
  for (int rel0 = 0; rel0 < len; rel0 += kWideTile) {
    const int rel = rel0 + 16 * static_cast<int>(threadIdx.x);
    const unsigned alive =
        rel < len ? probe_wide<T>(hay, n_words, it.start + rel, it.stop, val, msk, t) : 0u;
    if (__syncthreads_or(alive != 0u)) {
      if (alive) atomicMin(s_first, it.start + rel + __ffs(alive) - 1);
      __syncthreads();
      if (threadIdx.x == 0) atomicMin(best, *s_first + base);
      return;
    }
  }
}

// The matches of one count item, as this thread's share of the sum.
template <int T>
__device__ __forceinline__ unsigned count_item(const uint32_t* __restrict__ hay, int n_words,
                                               Item it, const uint32_t* val,
                                               const uint32_t* msk, int t) {
  const int len = it.stop - it.start;
  unsigned count = 0u;
  for (int rel = 16 * static_cast<int>(threadIdx.x); rel < len; rel += kWideTile) {
    count += __popc(probe_wide<T>(hay, n_words, it.start + rel, it.stop, val, msk, t));
  }
  return count;
}

// The bitmap words of one item, stored into the row's bitmap `bits_row`,
// and the item's matches as this thread's share of its count.  Lanes 2k and
// 2k + 1 hold positions 32m .. 32m + 15 and 32m + 16 .. 32m + 31 (item
// starts are multiples of kWideTile); the walk is block-uniform, so every
// lane reaches the shuffle.
template <int T>
__device__ __forceinline__ unsigned bitmap_item(const uint32_t* __restrict__ hay, int n_words,
                                                Item it, const uint32_t* val,
                                                const uint32_t* msk, int t,
                                                uint32_t* __restrict__ bits_row) {
  const int len = it.stop - it.start;
  unsigned count = 0u;
  for (int rel0 = 0; rel0 < len; rel0 += kWideTile) {
    const int rel = rel0 + 16 * static_cast<int>(threadIdx.x);
    const unsigned alive =
        rel < len ? probe_wide<T>(hay, n_words, it.start + rel, it.stop, val, msk, t) : 0u;
    const unsigned word = alive | (__shfl_xor_sync(0xffffffffu, alive, 1) << 16);
    if ((threadIdx.x & 1) == 0 && word != 0u) bits_row[(it.start + rel) >> 5] = word;
    count += __popc(alive);
  }
  return count;
}

// find, count or bitmap over the chunk-major queue: the block takes items
// until the queue is empty.  Thread 0 draws each live item (next_item) and
// the block reads it from shared memory after one barrier; a barrier at
// the end of each item keeps the shared item, first match and table from
// being rewritten while a thread still reads them.  `out` is the find or
// count output per row, or the bitmap's item counts per item; `bits` and
// `row_words` are the bitmap's (unused by find and count).
template <Mode kMode, int T>
__device__ __forceinline__ void queue_loop(const uint32_t* __restrict__ hay, int n_words,
                                           int n_pos, const uint32_t* __restrict__ values,
                                           const uint32_t* __restrict__ masks,
                                           const int32_t* __restrict__ ends, int32_t* out,
                                           int rows, int t, int base, int chunk, int n_items,
                                           int* queue, uint32_t* bits, long long row_words) {
  __shared__ uint32_t s_val[T > 0 ? 1 : kMaxT];
  __shared__ uint32_t s_msk[T > 0 ? 1 : kMaxT];
  __shared__ Item s_item;
  __shared__ int s_first;
  __shared__ unsigned s_warp[kThreads / 32];
  uint32_t val[T > 0 ? T : 1], msk[T > 0 ? T : 1];

  for (;;) {
    if (threadIdx.x == 0) {
      s_item = next_item(queue, n_items, rows, chunk, ends, base, n_pos,
                         kMode == kFindMode ? out : nullptr);
      s_first = kSentinel;
    }
    __syncthreads();
    const Item it = s_item;
    if (it.row < 0) return;
    item_table<T>(values, masks, it.row, t, val, msk, s_val, s_msk);
    const uint32_t* tv = T > 0 ? val : s_val;
    const uint32_t* tm = T > 0 ? msk : s_msk;
    if constexpr (kMode == kFindMode) {
      find_item<T>(hay, n_words, it, tv, tm, t, base, &s_first, out + it.row);
    } else if constexpr (kMode == kCountMode) {
      block_add(count_item<T>(hay, n_words, it, tv, tm, t), out + it.row, s_warp);
    } else {
      uint32_t* bits_row = bits + static_cast<long long>(it.row) * row_words;
      block_add(bitmap_item<T>(hay, n_words, it, tv, tm, t, bits_row), out + it.idx, s_warp);
    }
    __syncthreads();
  }
}

#define SSF_QUEUE_PARAMS                                                                  \
  const uint32_t* __restrict__ hay, int n_words, int n_pos,                               \
      const uint32_t* __restrict__ values, const uint32_t* __restrict__ masks,            \
      const int32_t* __restrict__ ends, int32_t* out, int rows, int t, int base, int chunk, \
      int n_items, int* queue
#define SSF_QUEUE_ARGS \
  hay, n_words, n_pos, values, masks, ends, out, rows, t, base, chunk, n_items, queue

}  // namespace
