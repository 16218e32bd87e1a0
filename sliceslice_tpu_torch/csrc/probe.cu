// Ablation kernel of the port's find and count loop, for sm_90a, behind a
// plain C interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// It replaces scripts/kernel_probe.py::build, the JAX package's stripped
// copy of its TPU find kernel, which removes one piece of that kernel at a
// time to find which piece costs time.  The TPU pieces (DMA double
// buffering, packed windows, the 128-lane min, SMEM tables) do not exist on
// the card, so the pieces stripped here are those of the port's own loop,
// the one the find, count and match-bitmap kernels run (queue.cuh,
// scan_common.cuh): a persistent grid draws (row, chunk) items from a
// chunk-major queue, and 256 threads walk an item 16 positions at a time
// (probe_wide), tables of up to 4 slots (8 in count) in registers.  Every
// variant but `span` and `word` runs on that queue with the count kernel's
// chunk; each asks the question of one JAX variant, or one that only this
// loop has:
//
//   count       the count kernel itself (count_kernel<T, R>, reached
//               through csrc/find.cu's ssf_queue_kernel) at the rows per
//               item its plan takes (`param`; baseline)      = batched_count
//   first       JAX full: the probes, a first-offset min per thread, a block
//               min and atomicMin, no skip and no early exit  = batched_find
//   nomin       JAX nomin: the probes, OR of the alive bits, one flag per row
//                                                   = (batched_find != SENTINEL)
//   noprobe     JAX noprobe: probe_wide's loads (one 16-byte load and one
//               word) with the table replaced by the constant 0xFFFFFFFF:
//               counts the positions whose 4-byte window is all ones
//   empty       JAX empty: the queue draw, the barriers and the address
//               math, no corpus load: XORs the word indices a row visits (a
//               sum of ones would be folded into the trip count)
//   nomask      JAX premask: no AND on slots whose mask is all ones; only a
//               partial slot (in practice the final one) is masked  = count
//   branchless  JAX premsel: every slot of every position evaluated with
//               selects, no early exit across slots                 = count
//   rows<R>     JAX dedup: R rows of one chunk per item share each 16-byte
//               load (needles sharing a staged corpus tile); the R tables
//               in registers while R * t <= 12, else in shared memory = count
//   smemtab     JAX swpipe, inverted: `count` already holds tables of up to
//               8 slots in registers, so this one reads the table from
//               shared memory at any width, as wider tables are     = count
//   span        probe_wide on the first design's plan, one block per (row,
//               span) and no queue: what the queue itself buys      = count
//   word        the first design as it stood: probe_word, 4 positions per
//               thread per step, 64-bit offsets, the table in shared memory,
//               on the span plan (the anchor to the first ablation) = count
//   prefilter   before the slot walk, a byte-SIMD test (__vcmpeq4) of the
//               needle's first byte and, for needles of 2 bytes or more, its
//               last byte against the group's bytes, 4 positions per
//               instruction; the slot walk runs only on a group that holds
//               a candidate                                         = count
//
// Every variant writes a value derived from its loop, so none can be
// compiled away; ptxas' report (-Xptxas -v, kept in the build log) gives
// each instantiation's registers.  What bounds them is what bounds the
// count kernel: one 32-bit operation per position tested against the INT32
// rate; the variants split the instructions the loop really executes per
// position (PERF.md §5).

#include <cstdint>
#include <cuda_runtime.h>

#include "queue.cuh"

// The queue kernels of csrc/find.cu: the `count` variant launches the
// count kernel itself, so it needs no copy of its own here.
extern "C" void* ssf_queue_kernel(int mode, int t, int group);

namespace {

enum Variant : int {
  kCount = 0,
  kFirst = 1,
  kNomin = 2,
  kNoprobe = 3,
  kEmpty = 4,
  kNomask = 5,
  kBranchless = 6,
  kRows = 7,
  kSmemtab = 8,
  kSpan = 9,
  kWord = 10,
  kPrefilter = 11,
};

constexpr int kMaxRows = 8;  // rows per item, rows<R>
constexpr int kRowsRegWords = 12;  // most table slots rows<R> keeps in registers (R * t)
constexpr int kWarps = kThreads / 32;

// The block's minimum of `v` (kSentinel where no thread has one), plus
// `add`, into *out with one atomicMin.  Every thread of the block calls it.
__device__ __forceinline__ void block_min(int v, int add, int32_t* out, unsigned* s_warp) {
  v = static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(v)));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = static_cast<unsigned>(v);
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned m = threadIdx.x < kWarps ? s_warp[threadIdx.x] : 0xffffffffu;
    m = __reduce_min_sync(0xffffffffu, m);
    if (threadIdx.x == 0 && m < static_cast<unsigned>(kSentinel)) {
      atomicMin(out, static_cast<int>(m) + add);
    }
  }
}

// The block's XOR of `v` into *out with one atomicXor.
__device__ __forceinline__ void block_xor(unsigned v, int32_t* out, unsigned* s_warp) {
  v = __reduce_xor_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned x = threadIdx.x < kWarps ? s_warp[threadIdx.x] : 0u;
    x = __reduce_xor_sync(0xffffffffu, x);
    if (threadIdx.x == 0 && x != 0u) atomicXor(out, static_cast<int>(x));
  }
}

// The matches of one item, as this thread's share of the sum: probe_wide
// over the item's positions, each slot evaluated as S says.
template <int T, int S = kSlotPlain>
__device__ __forceinline__ unsigned count_item(const uint32_t* __restrict__ hay, int n_words,
                                               Item it, const uint32_t* val,
                                               const uint32_t* msk, int t) {
  const int len = it.stop - it.start;
  unsigned count = 0u;
  for (int rel = 16 * static_cast<int>(threadIdx.x); rel < len; rel += kWideTile) {
    count += __popc(probe_wide<T, S>(hay, n_words, it.start + rel, it.stop, val, msk, t));
  }
  return count;
}

// prefilter: the matches of one count item.  A group of 16 positions first
// takes two byte tests, 4 positions per __vcmpeq4: the needle's first byte
// against the bytes at the positions themselves and, when the needle has a
// second byte, its last byte (offset k - 1, in slot ib at bit sb) against
// the bytes k - 1 further on.  Only a group with a candidate walks the
// slots, from the candidates.  A row whose first or last mask byte is not
// 0xFF (an empty or padded row) takes count_item.
template <int T>
__device__ __forceinline__ unsigned prefilter_item(const uint32_t* __restrict__ hay,
                                                   int n_words, Item it, const uint32_t* val,
                                                   const uint32_t* msk, int t) {
  const int width = T > 0 ? T : t;
  const uint32_t pv_a = (val[0] & 0xffu) * 0x01010101u;
  uint32_t pv_b = pv_a;
  uint32_t top = msk[0];  // the last nonzero mask word, from its last byte on
  int ib = 0, sb = 0;
#pragma unroll
  for (int i = 0; i < width; ++i) {
    if (msk[i] != 0u) {
      ib = i;
      sb = (31 - __clz(static_cast<int>(msk[i]))) & ~7;
      pv_b = ((val[i] >> sb) & 0xffu) * 0x01010101u;
      top = msk[i] >> sb;
    }
  }
  if ((msk[0] & top & 0xffu) != 0xffu) return count_item<T>(hay, n_words, it, val, msk, t);
  const bool two = ib > 0 || sb > 0;  // the needle has a byte past its first

  const int len = it.stop - it.start;
  unsigned count = 0u;
  for (int rel = 16 * static_cast<int>(threadIdx.x); rel < len; rel += kWideTile) {
    const int p0 = it.start + rel;
    const int j = p0 >> 2;
    if (j + width + 4 > n_words) {  // the buffer's last group: per-word loads
      count += __popc(probe_wide<T>(hay, n_words, p0, it.stop, val, msk, t));
      continue;
    }
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(hay + j));
    uint32_t w[5] = {q.x, q.y, q.z, q.w, __ldg(hay + j + 4)};
    uint32_t eq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) eq[k] = __vcmpeq4(w[k], pv_a);
    if (two) {
      // u[0..4]: the words ib slots further on, hay[j + ib .. j + ib + 4].
      uint32_t u[5] = {w[0], w[1], w[2], w[3], w[4]};
      if constexpr (T > 0) {
        uint32_t e[4 + T];
#pragma unroll
        for (int k = 0; k < 5; ++k) e[k] = w[k];
#pragma unroll
        for (int i = 1; i < T; ++i) e[4 + i] = i <= ib ? __ldg(hay + j + 4 + i) : 0u;
#pragma unroll
        for (int i = 1; i < T; ++i) {
          if (i == ib) {
#pragma unroll
            for (int k = 0; k < 5; ++k) u[k] = e[k + i];
          }
        }
      } else {
        if (ib > 0) {
#pragma unroll
          for (int k = 0; k < 5; ++k) u[k] = __ldg(hay + j + ib + k);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        eq[k] &= __vcmpeq4(__funnelshift_r(u[k], u[k + 1], sb), pv_b);
      }
    }
    if ((eq[0] | eq[1] | eq[2] | eq[3]) == 0u) continue;
    unsigned alive = 0u;  // byte k of eq[] is 0xFF for a candidate: one bit each
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      alive |= (((eq[k] & 0x08040201u) * 0x01010101u) >> 24) << (4 * k);
    }
    alive &= live_bits(it.stop - p0, 16);
    if (alive) count += __popc(probe_slots<T>(hay, j, w, alive, val, msk, width));
  }
  return count;
}

// One variant over the chunk-major queue of single rows, with find_loop's
// draw and barriers: the block takes items until the queue is empty.
template <int V, int T>
__device__ __forceinline__ void variant_loop(SSF_QUEUE_PARAMS) {
  constexpr bool kTable = V != kEmpty && V != kNoprobe;
  __shared__ uint32_t s_val[(kTable && T == 0) ? kMaxT : 1];
  __shared__ uint32_t s_msk[(kTable && T == 0) ? kMaxT : 1];
  __shared__ Item s_item;
  __shared__ unsigned s_warp[kWarps];
  uint32_t val[T > 0 ? T : 1], msk[T > 0 ? T : 1];

  for (;;) {
    if (threadIdx.x == 0) {
      s_item = next_item(queue, n_items, rows, chunk, ends, base, n_pos, nullptr);
    }
    __syncthreads();
    const Item it = s_item;
    if (it.row < 0) return;
    if constexpr (kTable) item_table<T>(values, masks, it.row, t, val, msk, s_val, s_msk);
    const uint32_t* tv = T > 0 ? val : s_val;
    const uint32_t* tm = T > 0 ? msk : s_msk;
    const int len = it.stop - it.start;
    const int rel0 = 16 * static_cast<int>(threadIdx.x);

    if constexpr (V == kEmpty) {
      unsigned x = 0u;
      for (int rel = rel0; rel < len; rel += kWideTile) {
        const int p0 = it.start + rel;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (p0 + 4 * k < it.stop) x ^= static_cast<unsigned>((p0 >> 2) + k);
        }
      }
      block_xor(x, out + it.row, s_warp);
    } else if constexpr (V == kNoprobe) {
      const uint32_t ones[1] = {0xffffffffu};
      unsigned count = 0u;
      for (int rel = rel0; rel < len; rel += kWideTile) {
        count += __popc(probe_wide<1>(hay, n_words, it.start + rel, it.stop, ones, ones, 1));
      }
      block_add(count, out + it.row, s_warp);
    } else if constexpr (V == kFirst) {
      int best = kSentinel;
      for (int rel = rel0; rel < len; rel += kWideTile) {
        const unsigned a = probe_wide<T>(hay, n_words, it.start + rel, it.stop, tv, tm, t);
        if (a) best = min(best, it.start + rel + __ffs(a) - 1);
      }
      block_min(best, base, out + it.row, s_warp);
    } else if constexpr (V == kNomin) {
      unsigned any = 0u;
      for (int rel = rel0; rel < len; rel += kWideTile) {
        any |= probe_wide<T>(hay, n_words, it.start + rel, it.stop, tv, tm, t);
      }
      if (__syncthreads_or(any != 0u) && threadIdx.x == 0) atomicOr(out + it.row, 1);
    } else if constexpr (V == kPrefilter) {
      block_add(prefilter_item<T>(hay, n_words, it, tv, tm, t), out + it.row, s_warp);
    } else {  // kNomask, kBranchless
      constexpr int kSlot = V == kNomask ? kSlotNomask : kSlotBranchless;
      block_add(count_item<T, kSlot>(hay, n_words, it, tv, tm, t), out + it.row, s_warp);
    }
    __syncthreads();
  }
}

// rows<R>: the R rows of one item evaluated at the same 16 positions, the
// group's words loaded once for all of them.  alive[q] holds row q's
// survivors; a row whose stop (read from shared memory) lies at or before
// p0 has none.
template <int R, int T>
__device__ __forceinline__ void probe_wide_rows(const uint32_t* __restrict__ hay, int n_words,
                                                int p0, const int* stop, const uint32_t* val,
                                                const uint32_t* msk, int t, unsigned* alive) {
  const int width = T > 0 ? T : t;
  const int j = p0 >> 2;
  if (j + width + 4 > n_words) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      alive[q] = p0 < stop[q] ? probe_wide<T>(hay, n_words, p0, stop[q], val + q * width,
                                              msk + q * width, t)
                              : 0u;
    }
    return;
  }
  unsigned any = 0u;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    alive[q] = live_bits(stop[q] - p0, 16);
    any |= alive[q];
  }
  if (!any) return;
  const uint4 g = __ldg(reinterpret_cast<const uint4*>(hay + j));
  uint32_t w[5] = {g.x, g.y, g.z, g.w, __ldg(hay + j + 4)};
  if constexpr (T > 0) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i > 0) {
        if (!any) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = w[k + 1];
        w[4] = __ldg(hay + j + i + 4);
      }
      any = 0u;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (alive[q]) probe_slot16(w, msk[q * T + i], val[q * T + i], &alive[q]);
        any |= alive[q];
      }
    }
  } else {
    for (int i = 0;;) {
      any = 0u;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (alive[q]) probe_slot16(w, msk[q * width + i], val[q * width + i], &alive[q]);
        any |= alive[q];
      }
      if (++i >= width || !any) break;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = w[k + 1];
      w[4] = __ldg(hay + j + i + 4);
    }
  }
}

// rows<R> over the chunk-major queue of row groups: item i is chunk
// i / groups of the rows R * (i % groups) .. + R - 1, `rows` the real rows.
template <int R, int T>
__device__ __forceinline__ void rows_loop(SSF_QUEUE_PARAMS) {
  __shared__ uint32_t s_val[T > 0 ? 1 : R * kMaxT];
  __shared__ uint32_t s_msk[T > 0 ? 1 : R * kMaxT];
  __shared__ int s_row0, s_start, s_last;
  __shared__ int s_stop[R];
  __shared__ unsigned s_warp[R * kWarps];
  uint32_t val[T > 0 ? R * T : 1], msk[T > 0 ? R * T : 1];
  const int groups = (rows + R - 1) / R;

  for (;;) {
    if (threadIdx.x == 0) {
      s_row0 = -1;
      for (;;) {
        const int i = atomicAdd(queue, 1);
        if (i >= n_items) break;
        const int c = i / groups;
        const int row0 = (i - c * groups) * R;
        const int start = c * chunk;
        int last = start;
        for (int q = 0; q < R; ++q) {
          long long lim = row0 + q < rows ? static_cast<long long>(__ldg(ends + row0 + q)) - base : 0;
          if (lim > n_pos) lim = n_pos;
          const int stop = lim <= start ? start
                                        : (lim - start > chunk ? start + chunk : static_cast<int>(lim));
          s_stop[q] = stop;
          last = max(last, stop);
        }
        if (last == start) continue;  // no row of the group reaches this chunk
        s_row0 = row0;
        s_start = start;
        s_last = last;
        break;
      }
    }
    __syncthreads();
    const int row0 = s_row0;
    if (row0 < 0) return;
    const int start = s_start, last = s_last;
    if constexpr (T > 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const bool real = row0 + q < rows;
          val[q * T + i] = real ? __ldg(values + (row0 + q) * T + i) : 0u;
          msk[q * T + i] = real ? __ldg(masks + (row0 + q) * T + i) : 0u;
        }
      }
    } else {
      for (int q = 0; q < R && row0 + q < rows; ++q) {
        load_table(values, masks, row0 + q, t, s_val + q * t, s_msk + q * t);
      }
      __syncthreads();
    }
    const uint32_t* tv = T > 0 ? val : s_val;
    const uint32_t* tm = T > 0 ? msk : s_msk;
    unsigned count[R] = {};
    unsigned alive[R];
    for (int p0 = start + 16 * static_cast<int>(threadIdx.x); p0 < last; p0 += kWideTile) {
      probe_wide_rows<R, T>(hay, n_words, p0, s_stop, tv, tm, t, alive);
#pragma unroll
      for (int q = 0; q < R; ++q) count[q] += __popc(alive[q]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (row0 + q < rows) block_add(count[q], out + row0 + q, s_warp + q * kWarps);
    }
    __syncthreads();
  }
}

template <int V, int T, int R>
__global__ void __launch_bounds__(kThreads) variant_kernel(SSF_QUEUE_PARAMS) {
  if constexpr (V == kRows) {
    rows_loop<R, T>(SSF_QUEUE_ARGS);
  } else {
    variant_loop<V, T>(SSF_QUEUE_ARGS);
  }
}

// span and word: the first design's plan, one block per (row, span), grid
// (rows, n_spans), no queue.  span walks its span with probe_wide (the
// table where the queue kernels hold it), word with probe_word and the
// table in shared memory, as the first count kernel did.
template <int V, int T>
__global__ void __launch_bounds__(kThreads)
span_kernel(const uint32_t* __restrict__ hay, long long n_pos,
            const uint32_t* __restrict__ values, const uint32_t* __restrict__ masks,
            const int32_t* __restrict__ ends, int32_t* out, int t, long long base,
            long long span) {
  __shared__ uint32_t s_val[T > 0 ? 1 : kMaxT];
  __shared__ uint32_t s_msk[T > 0 ? 1 : kMaxT];
  __shared__ unsigned s_warp[kWarps];
  uint32_t val[T > 0 ? T : 1], msk[T > 0 ? T : 1];
  const int row = blockIdx.x;  // the grid holds the real rows only
  long long start, stop;
  if (!row_span(ends, row, n_pos, base, span, &start, &stop)) return;
  item_table<T>(values, masks, row, t, val, msk, s_val, s_msk);
  const uint32_t* tv = T > 0 ? val : s_val;
  const uint32_t* tm = T > 0 ? msk : s_msk;
  unsigned count = 0u;
  if constexpr (V == kSpan) {
    // n_pos is 4 * (n_words - t), so the buffer holds n_pos / 4 + t words.
    const int n_words = static_cast<int>(n_pos >> 2) + t;
    for (long long p0 = start + 16LL * threadIdx.x; p0 < stop; p0 += kWideTile) {
      count += __popc(probe_wide<T>(hay, n_words, static_cast<int>(p0), static_cast<int>(stop),
                                    tv, tm, t));
    }
  } else {  // kWord
    for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
      count += __popc(probe_word(hay, p0, stop, tv, tm, t));
    }
  }
  block_add(count, out + row, s_warp);
}

// The width-T instantiation of a queue variant; rows<R> holds R tables, in
// registers only while they fit without spilling, else in shared memory.
template <int V, int T, int R>
void* variant_at() {
  if constexpr (V == kRows && R * T > kRowsRegWords) {
    return reinterpret_cast<void*>(variant_kernel<V, 0, R>);
  } else {
    return reinterpret_cast<void*>(variant_kernel<V, T, R>);
  }
}

template <int V, int R = 1>
void* queue_variant(int t) {
  switch (t) {
    case 1: return variant_at<V, 1, R>();
    case 2: return variant_at<V, 2, R>();
    case 3: return variant_at<V, 3, R>();
    case 4: return variant_at<V, 4, R>();
  }
  return variant_at<V, 0, R>();
}

// The kernel of a queue variant at width t (nullptr: no such kernel).
void* variant_fn(int variant, int param, int t) {
  switch (variant) {
    case kCount:
      switch (param) {
        case 1: return ssf_queue_kernel(kCountMode, t, 1);
        case kGroupRows: return ssf_queue_kernel(kCountMode, t, kGroupRows);
      }
      return nullptr;
    case kSmemtab: return ssf_queue_kernel(kCountMode, kMaxT, 1);  // count_kernel<0, 1>
    case kFirst: return queue_variant<kFirst>(t);
    case kNomin: return queue_variant<kNomin>(t);
    case kNomask: return queue_variant<kNomask>(t);
    case kBranchless: return queue_variant<kBranchless>(t);
    case kPrefilter: return queue_variant<kPrefilter>(t);
    case kNoprobe: return reinterpret_cast<void*>(variant_kernel<kNoprobe, 1, 1>);
    case kEmpty: return reinterpret_cast<void*>(variant_kernel<kEmpty, 1, 1>);
    case kRows:
      switch (param) {
        case 1: return queue_variant<kRows, 1>(t);
        case 2: return queue_variant<kRows, 2>(t);
        case 4: return queue_variant<kRows, 4>(t);
        case 8: return queue_variant<kRows, kMaxRows>(t);
      }
  }
  return nullptr;
}

// The kernel of span or word at width t: span holds tables of up to
// kMaxRegT slots in registers, word never does.
void* span_fn(int variant, int t) {
  if (variant == kWord) return reinterpret_cast<void*>(span_kernel<kWord, 0>);
  switch (t) {
    case 1: return reinterpret_cast<void*>(span_kernel<kSpan, 1>);
    case 2: return reinterpret_cast<void*>(span_kernel<kSpan, 2>);
    case 3: return reinterpret_cast<void*>(span_kernel<kSpan, 3>);
    case 4: return reinterpret_cast<void*>(span_kernel<kSpan, 4>);
  }
  return reinterpret_cast<void*>(span_kernel<kSpan, 0>);
}

}  // namespace

extern "C" {

// One launch of an ablation variant.  variant: one of Variant; param: R for
// rows (1, 2, 4, 8) and for count (1, or kGroupRows at t <= kMaxGroupT),
// ignored otherwise.  hay, n_words, n_pos, values, masks,
// ends, base are ssf_queue's; `rows` the real rows.  out: int32[rows..]
// holding SENTINEL on entry for first and 0 for every other variant.
// Queue variants: step is the chunk (a multiple of 4,096), n_steps the
// items (row groups of R rows for rows and count, else rows, times
// chunks), grid the blocks, queue one int32 holding 0.  span and word:
// step is the span (a multiple of 4,096 and 1,024), n_steps the spans per
// row; grid and queue are ignored.
int ssf_probe(int variant, int param, const void* hay, int n_words, int n_pos,
              const void* values, const void* masks, const void* ends, void* out, int rows,
              int t, int base, int step, int n_steps, int grid, void* queue, void* stream) {
  if (rows <= 0 || n_pos <= 0 || n_steps <= 0) return static_cast<int>(cudaGetLastError());
  if (t < 1 || t > kMaxT || step <= 0 || n_pos > 4LL * (n_words - t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* h = static_cast<const uint32_t*>(hay);
  const uint32_t* v = static_cast<const uint32_t*>(values);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const int32_t* e = static_cast<const int32_t*>(ends);
  int32_t* o = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == kSpan || variant == kWord) {
    if (step % (variant == kSpan ? kWideTile : kFindTile)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    long long n_pos64 = n_pos, base64 = base, span64 = step;
    void* args[] = {&h, &n_pos64, &v, &m, &e, &o, &t, &base64, &span64};
    err = cudaLaunchKernel(span_fn(variant, t),
                           dim3(static_cast<unsigned>(rows), static_cast<unsigned>(n_steps)),
                           dim3(kThreads), args, 0, s);
  } else {
    void* fn = variant_fn(variant, param, t);
    if (fn == nullptr || step % kWideTile || grid <= 0 || queue == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int* q = static_cast<int*>(queue);
    void* args[] = {&h, &n_words, &n_pos, &v, &m, &e, &o, &rows, &t, &base, &step, &n_steps, &q};
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of a queue variant's width-t kernel that one SM holds at once,
// into *per_sm.
int ssf_probe_blocks(int variant, int param, int t, void* per_sm) {
  void* fn = t >= 1 && t <= kMaxT ? variant_fn(variant, param, t) : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(per_sm), fn, kThreads, 0));
}

}  // extern "C"
