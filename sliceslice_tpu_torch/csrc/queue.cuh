// The chunk-major work queues of the port's scan kernels: find's item draw,
// walk and loop over items (row, chunk), and the count and bitmap modes'
// draw, walk and loop over items (group of rows, chunk), with the count
// and bitmap kernels that run it.  Header only; csrc/find.cu builds find's
// kernel from find_loop and instantiates the count and bitmap kernels for
// tables of up to kMaxRegT slots and wider than kMaxGroupT,
// csrc/group_wide.cu those for 5 to kMaxGroupT slots, and csrc/probe.cu
// (the ablation harness) launches the count kernel itself as its baseline
// and strips next_item, item_table and the walks piece by piece.
// csrc/find.cu's header says what the design answers.

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

// find over the chunk-major queue: the block takes items until the queue
// is empty.  Thread 0 draws each live item (next_item) and the block reads
// it from shared memory after one barrier; a barrier at the end of each
// item keeps the shared item, first match and table from being rewritten
// while a thread still reads them.  `out` is the find output per row.
template <int T>
__device__ __forceinline__ void find_loop(const uint32_t* __restrict__ hay, int n_words,
                                          int n_pos, const uint32_t* __restrict__ values,
                                          const uint32_t* __restrict__ masks,
                                          const int32_t* __restrict__ ends, int32_t* out,
                                          int rows, int t, int base, int chunk, int n_items,
                                          int* queue) {
  __shared__ uint32_t s_val[T > 0 ? 1 : kMaxT];
  __shared__ uint32_t s_msk[T > 0 ? 1 : kMaxT];
  __shared__ Item s_item;
  __shared__ int s_first;
  uint32_t val[T > 0 ? T : 1], msk[T > 0 ? T : 1];

  for (;;) {
    if (threadIdx.x == 0) {
      s_item = next_item(queue, n_items, rows, chunk, ends, base, n_pos, out);
      s_first = kSentinel;
    }
    __syncthreads();
    const Item it = s_item;
    if (it.row < 0) return;
    item_table<T>(values, masks, it.row, t, val, msk, s_val, s_msk);
    find_item<T>(hay, n_words, it, T > 0 ? val : s_val, T > 0 ? msk : s_msk, t, base, &s_first,
                 out + it.row);
    __syncthreads();
  }
}

// Rows per item of the count and bitmap queues when a launch groups its
// rows (ssf_queue's `group`; ops/scan_kernel.py GROUP_ROWS), the R of
// group_loop other than 1.
constexpr int kGroupRows = 8;

// The widest table group_loop walks at a width fixed at compile time (T >
// 0), which it needs to group rows (ops/scan_kernel.py MAX_GROUP_T; find
// walks tables of up to kMaxRegT slots so).  8 is PROBE_UNROLL, the
// widest exact width group of BatchedSearcher.
constexpr int kMaxGroupT = 8;

// The slots group_loop's filter tests before a row's exact walk: slot 0
// for tables of up to kMaxRegT slots; slots 0 and 1 for wider ones, whose
// slots 0 and 1 are whole in every needle of an exact width group.  On a
// four-letter text a 4-byte window passes one slot once in 256 windows, so
// most warps of a one-slot filter have a lane with a hit at every tile;
// two slots pass once in 65,536.
template <int T>
constexpr int kFilterSlots = T > kMaxRegT ? 2 : 1;

// The blocks per SM that the kernels running group_loop declare in
// __launch_bounds__: ptxas may then give a thread up to 65536 / (kThreads
// x 4) = 64 registers, which every instantiation needs at most, and spills
// none, where with only a thread bound it trims registers to the next
// blocks-per-SM threshold and spills a few bytes to get there.  Three
// blocks (80 registers) let it take 72-78 and ran 8% slower.
constexpr int kGroupMinBlocks = 4;

// One item of the group queue: chunk c of the rows row0 .. row0 + R - 1;
// row row0 + q scans positions [start, stop[q]), and `last` is the
// largest stop.
template <int R>
struct Group {
  int row0, start, last, c;
  int stop[R];
};

// Thread 0 only: the next item of the group queue in which some row has
// positions to scan, into *g (row0 -1 when the queue is empty).  Item i is
// chunk c = i / groups of the rows R * (i % groups) .., groups =
// ceil(rows / R), so chunk c of every group is handed out before chunk
// c + 1 of any group.  A row's stop is the chunk's end cut at the row's
// limit min(ends[row] - base, n_pos), and the chunk's start for a row at
// or past `rows` or whose limit lies at or before the start.
template <int R>
__device__ __forceinline__ void next_group(int* queue, int n_items, int rows, int chunk,
                                           const int32_t* __restrict__ ends, int base, int n_pos,
                                           Group<R>* g) {
  const int groups = (rows + R - 1) / R;
  for (;;) {
    const int i = atomicAdd(queue, 1);
    if (i >= n_items) {
      g->row0 = -1;
      return;
    }
    const int c = i / groups;
    const int row0 = (i - c * groups) * R;
    const int start = c * chunk;
    int last = start;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long lim =
          row0 + q < rows ? min(static_cast<long long>(__ldg(ends + row0 + q)) - base,
                                static_cast<long long>(n_pos))
                          : 0LL;
      const int stop =
          lim <= start ? start : (lim - start > chunk ? start + chunk : static_cast<int>(lim));
      g->stop[q] = stop;
      last = max(last, stop);
    }
    if (last == start) continue;
    g->row0 = row0;
    g->start = start;
    g->last = last;
    g->c = c;
    return;
  }
}

// One wide-tile group of a row group: the 16 positions p0 .. p0 + 15 of a
// thread (p0 16-byte aligned, below the group's last stop), with their
// words w[0..4] and slot-0 windows win[0..15] formed once for every row of
// the group, and for a two-slot filter the windows win[16..19] of p0 + 16
// .. p0 + 19 (slot 1 of position p is win[p - p0 + 4]); `tail` when the
// group lies at the buffer's end, where none is formed and each row takes
// probe_wide, whose per-word loads read no further than the row's
// positions need.
struct Tile {
  int p0, j;
  bool tail;
  uint32_t w[5], win[20];
};

// Forms the tile at p0 for tables of `width` slots and a filter of S slots.
template <int S>
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ hay, int n_words, int p0,
                                          int width, Tile* tile) {
  tile->p0 = p0;
  tile->j = p0 >> 2;
  tile->tail = tile->j + width + 4 > n_words;
  if (tile->tail) return;
  const uint4 g = __ldg(reinterpret_cast<const uint4*>(hay + tile->j));
  tile->w[0] = g.x;
  tile->w[1] = g.y;
  tile->w[2] = g.z;
  tile->w[3] = g.w;
  tile->w[4] = __ldg(hay + tile->j + 4);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    tile->win[4 * k] = tile->w[k];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      tile->win[4 * k + r] = __funnelshift_r(tile->w[k], tile->w[k + 1], 8 * r);
    }
  }
  if constexpr (S == 2) {
    // One more word, hay[j + 5]: the tail test covers it, since a two-slot
    // filter walks tables of width >= 5.
    const uint32_t w5 = __ldg(hay + tile->j + 5);
    tile->win[16] = tile->w[4];
#pragma unroll
    for (int r = 1; r < 4; ++r) tile->win[16 + r] = __funnelshift_r(tile->w[4], w5, 8 * r);
  }
}

// Bit q set for each row q < live of the group whose filter passes at one
// of the tile's 16 positions, the tile lying below the row's stop (every
// live row with positions there, at the buffer's end).  The filter of S
// slots: a row tests its slot 0 (value v0[q]) and, when S is 2, its slot 1
// (v1[q]) at the same position, by one compare a window (one a pair of
// windows), accumulated into one flag; a row whose bit of `partial` is set
// reads the masks of those slots, msk[q * stride ..], and ANDs each window
// first, so any masked table stays exact.
template <int R, int S>
__device__ __forceinline__ unsigned filter_hits(const Tile& tile, const int* stop, int live,
                                                const uint32_t* v0, const uint32_t* v1,
                                                unsigned partial, const uint32_t* msk,
                                                int stride) {
  unsigned hits = 0u;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (q >= live) break;
    bool hit = true;
    if (!tile.tail) {
      const uint32_t v = v0[q];
      hit = false;
      if constexpr (S == 1) {
        if ((partial >> q) & 1u) {
          const uint32_t m = msk[q * stride];
#pragma unroll
          for (int b = 0; b < 16; ++b) hit |= (tile.win[b] & m) == v;
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b) hit |= tile.win[b] == v;
        }
      } else {
        const uint32_t u = v1[q];
        if ((partial >> q) & 1u) {
          const uint32_t m0 = msk[q * stride], m1 = msk[q * stride + 1];
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            hit |= ((tile.win[b] & m0) == v) & ((tile.win[b + 4] & m1) == u);
          }
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b) hit |= ((tile.win[b] ^ v) | (tile.win[b + 4] ^ u)) == 0u;
        }
      }
    }
    if (hit && tile.p0 < stop[q]) hits |= 1u << q;
  }
  return hits;
}

// The exact walk of one row whose filter passed in the tile: bit b set
// when position p0 + b lies below `stop` and satisfies every slot of the
// row's table (val, msk).  Behind a one-slot filter: its slot-0 bits from
// the tile's windows, then probe_slots from slot 1.  Behind a two-slot
// filter (T > kMaxRegT) the walk is rare, so it reloads the corpus
// (probe_wide) and the tile's 20 windows are dead once every row's filter
// has run, which leaves their registers to the walk.
template <int T>
__device__ __forceinline__ unsigned row_bits(const uint32_t* __restrict__ hay, int n_words,
                                             const Tile& tile, int stop, const uint32_t* val,
                                             const uint32_t* msk, int t) {
  const int width = T > 0 ? T : t;
  if (tile.tail || kFilterSlots<T> == 2) {
    return probe_wide<T>(hay, n_words, tile.p0, stop, val, msk, t);
  }
  const uint32_t v = val[0], m = msk[0];
  unsigned a = 0u;
#pragma unroll
  for (int b = 0; b < 16; ++b) a |= static_cast<unsigned>((tile.win[b] & m) == v) << b;
  a &= live_bits(stop - tile.p0, 16);
  if (width > 1 && a) {
    uint32_t w[5] = {tile.w[0], tile.w[1], tile.w[2], tile.w[3], tile.w[4]};
    a = probe_slots<T, kSlotPlain, 1>(hay, tile.j, w, a, val, msk, width);
  }
  return a;
}

// count or bitmap over the chunk-major queue of row groups, R rows an item
// (T > 0; one row, R = 1, for tables in shared memory): the block takes
// items until the queue is empty.  Thread 0 draws each live item
// (next_group) and the block reads it from shared memory after one
// barrier; a barrier at the end of each item keeps the shared item and
// table from being rewritten while a thread still reads them.  Per tile,
// the rows share its windows (filter_hits, kFilterSlots<T> slots) and only
// a row whose filter passed walks (row_bits).  Per row, each thread sums
// its matches in a register, and
// each warp adds its sums once per item (warp_add): to `out`, the count per
// row, or to the bitmap's item counts int32[n_chunks, rows] at [c, row].
// The bitmap's words: each pair of neighbouring lanes holds the two 16-bit
// halves of one linear word (their 32 positions start at a multiple of
// 32, since chunks are whole wide tiles); for each row with a match in the
// warp's tiles, one __shfl_xor_sync merges them and the even lane stores
// the word when it is nonzero (the wrapper zeroes the bitmap).  A word
// never straddles two items, so no store races another.  The walk over an
// item's tiles is block-uniform, so every lane reaches the reduction and
// the shuffles.
template <Mode kMode, int T, int R>
__device__ __forceinline__ void group_loop(const uint32_t* __restrict__ hay, int n_words,
                                           int n_pos, const uint32_t* __restrict__ values,
                                           const uint32_t* __restrict__ masks,
                                           const int32_t* __restrict__ ends, int32_t* out,
                                           int rows, int t, int base, int chunk, int n_items,
                                           int* queue, uint32_t* bits, long long row_words) {
  static_assert(kMode != kFindMode && (R == 1 || (T > 0 && R == kGroupRows)),
                "count and bitmap take one row an item, or kGroupRows with a register-width table");
  static_assert(T <= kMaxGroupT, "wider tables take the shared-memory walk, T = 0");
  constexpr int S = kFilterSlots<T>;
  __shared__ uint32_t s_val[T > 0 ? 1 : kMaxT];
  __shared__ uint32_t s_msk[T > 0 ? 1 : kMaxT];
  __shared__ Group<R> s_group;
  const int width = T > 0 ? T : t;

  for (;;) {
    if (threadIdx.x == 0) next_group<R>(queue, n_items, rows, chunk, ends, base, n_pos, &s_group);
    __syncthreads();
    const int row0 = s_group.row0;
    if (row0 < 0) return;
    const int start = s_group.start, len = s_group.last - start;
    const int live = min(R, rows - row0);
    if constexpr (T == 0) {
      load_table(values, masks, row0, t, s_val, s_msk);
      __syncthreads();
    }
    // Row q's table: tab_val + q * T (T > 0), or the shared copy.
    const uint32_t* tab_val = T > 0 ? values + row0 * T : s_val;
    const uint32_t* tab_msk = T > 0 ? masks + row0 * T : s_msk;
    uint32_t v0[R], v1[R];
    unsigned partial = 0u;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v0[q] = q < live ? tab_val[q * T] : 0u;
      v1[q] = S == 2 && q < live ? tab_val[q * T + 1] : 0u;
      if (q < live && (tab_msk[q * T] != 0xffffffffu ||
                       (S == 2 && tab_msk[q * T + 1] != 0xffffffffu))) {
        partial |= 1u << q;
      }
    }
    unsigned count[R];
#pragma unroll
    for (int q = 0; q < R; ++q) count[q] = 0u;
    for (int rel0 = 0; rel0 < len; rel0 += kWideTile) {
      const int rel = rel0 + 16 * static_cast<int>(threadIdx.x);
      Tile tile;
      unsigned hits = 0u;
      if (rel < len) {
        load_tile<S>(hay, n_words, start + rel, width, &tile);
        hits = filter_hits<R, S>(tile, s_group.stop, live, v0, v1, partial, tab_msk, T);
      }
      if constexpr (kMode == kCountMode) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if ((hits >> q) & 1u) {
            count[q] += __popc(row_bits<T>(hay, n_words, tile, s_group.stop[q], tab_val + q * T,
                                           tab_msk + q * T, t));
          }
        }
      } else {
        const unsigned warp_hits = __reduce_or_sync(0xffffffffu, hits);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if ((warp_hits >> q) & 1u) {
            const unsigned a = ((hits >> q) & 1u)
                                   ? row_bits<T>(hay, n_words, tile, s_group.stop[q],
                                                 tab_val + q * T, tab_msk + q * T, t)
                                   : 0u;
            const unsigned word = a | (__shfl_xor_sync(0xffffffffu, a, 1) << 16);
            if ((threadIdx.x & 1) == 0 && word != 0u) {
              bits[static_cast<long long>(row0 + q) * row_words + ((start + rel) >> 5)] = word;
            }
            count[q] += __popc(a);
          }
        }
      }
    }
    int32_t* sums = kMode == kCountMode ? out + row0 : out + s_group.c * rows + row0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < live) warp_add(count[q], sums + q);
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

template <int T, int R>
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks) count_kernel(SSF_QUEUE_PARAMS) {
  group_loop<kCountMode, T, R>(SSF_QUEUE_ARGS, nullptr, 0);
}

template <int T, int R>
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
match_bitmap_kernel(SSF_QUEUE_PARAMS, uint32_t* bits, long long row_words) {
  group_loop<kBitmapMode, T, R>(SSF_QUEUE_ARGS, bits, row_words);
}

// The width-T instantiation of the count or bitmap kernel taking `group`
// rows an item: one, or kGroupRows at T > 0 (nullptr for any other).
template <int T>
void* group_fn(int mode, int group) {
  if (group == 1) {
    return mode == kCountMode ? reinterpret_cast<void*>(count_kernel<T, 1>)
                              : reinterpret_cast<void*>(match_bitmap_kernel<T, 1>);
  }
  if constexpr (T > 0) {
    if (group == kGroupRows) {
      return mode == kCountMode ? reinterpret_cast<void*>(count_kernel<T, kGroupRows>)
                                : reinterpret_cast<void*>(match_bitmap_kernel<T, kGroupRows>);
    }
  }
  return nullptr;
}

}  // namespace
