// Hand-written Hopper (sm_90a) kernels of the find, count and positions
// paths, behind a plain C interface loaded with ctypes
// (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// ssf_queue, mode kFindMode, replaces the Pallas find kernel
// sliceslice_tpu/ops/scan_kernel.py::_raw_batched_call (wrapped there by
// batched_find_cols).  For each needle row n < rows it returns the
// smallest position p with p + base < ends[n] such that, for every probe
// slot i < t,
//     (win32(p + 4i) & masks[n, i]) == values[n, i]
// where win32(q) is the little-endian 4-byte window at byte q, as p + base
// (int32), or SENTINEL when there is none.
//
// ssf_queue, mode kCountMode, replaces the Pallas count kernel
// sliceslice_tpu/ops/scan_kernel.py::_raw_count_call (wrapped there by
// batched_count_cols): for each row n < rows, the number of positions p
// with p + base < ends[n] that satisfy every slot (overlapping matches).
//
// ssf_queue, mode kBitmapMode, replaces the plain-XLA match bitmap of the
// positions path, sliceslice_tpu/ops/xla_backend.py::_match_bitmap_cols_impl
// (and its batched vmap): for each row n < rows, bit b of word w of
// bits[n] is set iff position p = 32w + b satisfies every slot with p +
// base < ends[n].  The bitmap is linear, where the TPU's is laid out by
// lane.  In the same pass it writes each row's match count in each chunk
// of positions, which the compaction kernel (positions.cu) turns into
// ranks.
//
// ssf_memchr_find replaces sliceslice_tpu/ops/scan_kernel.py::_memchr_call
// (wrapped by memchr_find_cols): the first p with p + base < end at which
// one byte value occurs, as p + base, or SENTINEL.
//
// What bounds find, count and the bitmap on the H100.  Their work is
// integer: one funnel shift, AND and compare per position per slot tested,
// and almost every position fails at its first slot.  The positions these
// inputs need tested are, per row, its first match + 1 for find and its
// whole limit for count and the bitmap; at one 32-bit operation each
// against the INT32 rate (132 SMs x 64 lanes x 1.98 GHz = 16.7 T op/s)
// that is the bound, above the bytes (the corpus, tables and outputs once
// each at 3.35 TB/s; for the bitmap its words too, one bit per position).
// What kept the first design (one block per (row, span), 4 positions per
// thread per step) far from it was not the compares but, per the ablation
// kernel (probe.cu, PERF.md §5), the loads, their 64-bit address math and
// the table reads from shared memory, and, for find, the serial walk of a
// row whose first match lies late: one block walked it tile by tile.  The
// design answers that:
//   * the wide step: 256 threads each evaluate 16 consecutive positions
//     from one 16-byte load plus one word per slot (probe_wide in
//     scan_common.cuh), with 32-bit offsets; one instantiation per table
//     width up to 4 slots (all but 4 of the 4,585 i386 words) for find,
//     up to 8 for count and the bitmap, which hold the table at a width
//     fixed at compile time, and one for wider tables, in shared memory;
//   * the chunk-major work queue: a persistent grid sized to the card
//     (blocks resident per SM x SMs) takes items (row, chunk of `chunk`
//     positions) from one counter, chunk c of every row before chunk c+1
//     of any row (next_item; the draw, the walks and the loop live in
//     queue.cuh, which the ablation kernel shares).  A late row's chunks
//     spread over every SM
//     instead of one block's walk, and a single-row launch spreads over
//     the card too;
//   * find: an item whose row already holds a match at or before the
//     chunk's start is skipped; within a chunk the block stops at the first
//     wide tile (4,096 positions) that holds a match (one __syncthreads_or
//     per tile), takes its first position by a shared atomicMin and merges
//     it into out[row] by a global atomicMin.  Work is the positions up to
//     each row's first match, plus at most the chunks in flight;
//   * count and bitmap: every position of every row is tested, and at
//     slot 0 almost every test fails, so what a row recomputes per
//     position is what costs: the loads, the funnel shifts and the
//     per-position bit updates.  An item is a group of R consecutive rows
//     (R = kGroupRows, or 1 where the launch is too small to keep the card
//     busy with groups, or the table is wider than kMaxGroupT; the wrapper
//     chooses) and one chunk, chunk c of every group before chunk c+1 of
//     any group (next_group).  A thread forms its 16 positions' slot-0
//     windows once and each row of the group tests them by one compare a
//     window (AND and compare under a partial mask), accumulated into one
//     flag (filter_hits); only a row and 16 positions that pass run the
//     exact walk (row_bits).  Tables of 5 to 8 slots (needles of 17-32
//     bytes) test slots 0 and 1 together, from 4 more windows: on a
//     four-letter text one slot passes a window in 256, so nearly every
//     warp would take the walk at every tile, and two slots pass one in
//     65,536.  Each thread sums a row's matches in a register and each
//     warp adds them once per item (warp_add).  Integer sums and minima in
//     any order are exact;
//   * bitmap: count's walk, where each pair of neighbouring lanes holds the
//     two 16-bit halves of one linear word of a row (their 32 positions
//     start at a multiple of 32, since chunks are whole wide tiles); one
//     __shfl_xor_sync merges them and the even lane stores the word when it
//     is nonzero (the wrapper zeroes the bitmap).  A word never straddles
//     two items, so no store races another.  Each row's matches in the
//     item go to item_counts[c, row].
// The kernels allocate nothing (the wrapper zeroes the queue counter) and
// never synchronise; each entry point returns cudaGetLastError() so the
// caller sees a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "queue.cuh"

// The count and bitmap kernels of tables of 5 to kMaxGroupT slots
// (csrc/group_wide.cu).
extern "C" void* ssf_group_wide_kernel(int mode, int t, int group);

namespace {

constexpr int kMemchrTile = kThreads * 16;   // bytes per memchr step
constexpr int kCheckEvery = 8;               // steps between cross-span checks

template <int T>
__global__ void __launch_bounds__(kThreads) batched_find_kernel(SSF_QUEUE_PARAMS) {
  find_loop<T>(SSF_QUEUE_ARGS);
}

__global__ void __launch_bounds__(kThreads)
memchr_kernel(const uint4* __restrict__ hay, long long lim, uint32_t byte,
              long long base, long long span, int32_t* out) {
  __shared__ int s_first;
  const long long start = static_cast<long long>(blockIdx.x) * span;
  if (start >= lim) return;
  const long long stop = (start + span < lim) ? start + span : lim;
  const uint32_t pattern = byte * 0x01010101u;
  if (threadIdx.x == 0) s_first = kSentinel;
  if (__syncthreads_or(threadIdx.x == 0 &&
                       static_cast<long long>(read_best(out)) <= start + base)) {
    return;
  }

  int step = 0;
  for (long long tile = start; tile < stop; tile += kMemchrTile, ++step) {
    const long long p0 = tile + 16LL * threadIdx.x;  // 16-byte aligned
    int hit = -1;
    if (p0 < stop) {
      const uint4 q = __ldg(hay + (p0 >> 4));
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 3; k >= 0; --k) {  // lowest word last: it wins
        const uint32_t eq = __vcmpeq4(words[k], pattern);
        if (eq) hit = 4 * k + ((__ffs(eq) - 1) >> 3);
      }
      if (hit >= 0 && p0 + hit >= stop) hit = -1;
    }
    if (__syncthreads_or(hit >= 0)) {
      if (hit >= 0) atomicMin(&s_first, static_cast<int>(p0 - start) + hit);
      __syncthreads();
      if (threadIdx.x == 0) atomicMin(out, static_cast<int>(start + s_first + base));
      return;
    }
    if ((step + 1) % kCheckEvery == 0) {
      const long long next = tile + kMemchrTile + base;
      if (__syncthreads_or(threadIdx.x == 0 &&
                           static_cast<long long>(read_best(out)) <= next)) {
        return;
      }
    }
  }
}

// The queue kernel of a mode, width t and `group` rows an item: T = t for
// tables of up to kMaxRegT slots in find and kMaxGroupT in count and the
// bitmap, else 0; find takes one row an item.
void* queue_kernel_for(int mode, int t, int group) {
  if (mode < kFindMode || mode > kBitmapMode || t < 1 || t > kMaxT) return nullptr;
  if (mode == kFindMode) {
    if (group != 1) return nullptr;
    switch (t) {
      case 1: return reinterpret_cast<void*>(batched_find_kernel<1>);
      case 2: return reinterpret_cast<void*>(batched_find_kernel<2>);
      case 3: return reinterpret_cast<void*>(batched_find_kernel<3>);
      case 4: return reinterpret_cast<void*>(batched_find_kernel<4>);
    }
    return reinterpret_cast<void*>(batched_find_kernel<0>);
  }
  static_assert(kMaxRegT == 4, "one case per width below");
  switch (t) {
    case 1: return group_fn<1>(mode, group);
    case 2: return group_fn<2>(mode, group);
    case 3: return group_fn<3>(mode, group);
    case 4: return group_fn<4>(mode, group);
  }
  return t <= kMaxGroupT ? ssf_group_wide_kernel(mode, t, group) : group_fn<0>(mode, group);
}

}  // namespace

extern "C" {

// One launch of a queue kernel (mode: 0 find, 1 count, 2 bitmap).
// hay: n_words 32-bit words of corpus bytes (16-byte aligned).  n_pos: the
// positions whose t windows lie inside hay, 4 * (n_words - t).  values,
// masks: uint32[rows.., t], pre-masked.  ends: int32[rows..].  out: find,
// int32[rows..] holding SENTINEL on entry; count, int32[rows..] holding 0;
// bitmap, the item counts int32[ceil(n_pos / chunk), rows] holding 0.
// chunk: positions per item, a multiple of 4,096; group: rows per item, 1
// or (count and bitmap, t <= 8) 8; n_items: ceil(rows / group) *
// ceil(n_pos / chunk); grid: blocks, at most the resident ones
// (ssf_queue_blocks x SMs); queue: one int32 holding 0 on entry.  bits,
// row_words (bitmap only; find and count ignore them): uint32[rows..,
// row_words] with row_words >= ceil(n_pos / 32), holding 0 on entry.
int ssf_queue(int mode, const void* hay, int n_words, int n_pos, const void* values,
              const void* masks, const void* ends, void* out, int rows, int t, int base,
              int chunk, int group, int n_items, int grid, void* queue, void* bits,
              long long row_words, void* stream) {
  void* fn = queue_kernel_for(mode, t, group);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || n_pos <= 0 || n_items <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || chunk % kWideTile || grid <= 0 ||
      n_pos > 4LL * (n_words - t) ||
      (mode == kBitmapMode && (bits == nullptr || row_words * 32 < n_pos))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* h = static_cast<const uint32_t*>(hay);
  const uint32_t* v = static_cast<const uint32_t*>(values);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const int32_t* e = static_cast<const int32_t*>(ends);
  int32_t* o = static_cast<int32_t*>(out);
  int* q = static_cast<int*>(queue);
  uint32_t* b = static_cast<uint32_t*>(bits);
  // The find and count kernels take the first 13 arguments.
  void* args[] = {&h, &n_words, &n_pos, &v, &m, &e, &o, &rows, &t, &base, &chunk, &n_items, &q,
                  &b, &row_words};
  const cudaError_t err =
      cudaLaunchKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The mode's width-t queue kernel taking `group` rows an item (nullptr:
// none), for the ablation harness's count variant (csrc/probe.cu).
void* ssf_queue_kernel(int mode, int t, int group) { return queue_kernel_for(mode, t, group); }

// Blocks of the mode's width-t queue kernel taking `group` rows an item
// that one SM holds at once, into *per_sm.
int ssf_queue_blocks(int mode, int t, int group, void* per_sm) {
  void* fn = queue_kernel_for(mode, t, group);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(per_sm), fn, kThreads, 0));
}

// hay: 16-byte aligned corpus bytes; lim: bytes to scan (end - base, at
// most the buffer size, which is a multiple of 16).  out: int32[1] holding
// SENTINEL on entry.  span: bytes per block, a multiple of 4096.
int ssf_memchr_find(const void* hay, long long lim, int byte, long long base,
                    long long span, int n_spans, void* out, void* stream) {
  if (lim <= 0) return static_cast<int>(cudaGetLastError());
  memchr_kernel<<<static_cast<unsigned>(n_spans), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(hay), lim, static_cast<uint32_t>(byte & 0xff),
      base, span, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* ssf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
