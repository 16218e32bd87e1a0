// Hand-written Hopper (sm_90a) compaction kernel of the positions path,
// behind a plain C interface loaded with ctypes
// (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// ssf_compact_positions replaces the plain-XLA compact tier of the
// positions path, sliceslice_tpu/ops/xla_backend.py::_compact_positions_impl
// (wrapped by compact_positions_batched): for each row of a linear match
// bitmap (ssf_queue's bitmap mode, find.cu), its `cap` earliest match
// offsets, ascending, into offsets[row, 0 .. cap).  Slots past the row's
// count keep what the wrapper filled them with (SENTINEL).
//
// What bounds it on the H100: bytes.  Per match it does a few integer
// operations; what it must move is the words of the items that hold a
// match with a rank below `cap`, their item counts and ranks, and the
// offsets it writes.  The design:
//   * ranks come from the bitmap kernel's per-item counts: an exclusive
//     cumsum over the chunk axis (one torch op, in the wrapper) gives each
//     item (row, chunk) the rank of its first match within its row, so
//     items are independent and no pass walks a row from its start;
//   * a grid-stride loop hands items to blocks; an item with no match, or
//     whose first rank is at or past `cap`, costs two loads.  A live item
//     is read with 16-byte loads, 1,024 words per block step; a block-wide
//     exclusive scan of their popcounts (warp __shfl_up_sync, then shared
//     memory) gives each thread the rank of its first set bit, and the
//     thread writes its bits' offsets while the rank is below `cap`.  The
//     block leaves the item once the rank reaches `cap`, so the cap-th
//     match may fall inside an item or a word;
//   * every output slot has exactly one writer, so the result does not
//     depend on the order in which blocks run.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The exclusive prefix sum over the block of each thread's v, and the
// block's total in *total.  Every thread calls it; s_warp holds kWarps
// slots; the closing barrier frees them for the next call.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* s_warp,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? s_warp[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) s_warp[lane] = s;
  }
  __syncthreads();
  *total = s_warp[kWarps - 1];
  const unsigned before = warp > 0 ? s_warp[warp - 1] : 0u;
  __syncthreads();
  return before + x - v;
}

// bits: the bitmap as uint4[rows, row_quads]; item i is chunk c = i / rows
// of row i % rows, its words [c * chunk_quads, (c + 1) * chunk_quads) in
// quads, cut at the row's end.  Every condition that steers the block is
// read from global memory or shared memory by every thread alike.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint4* __restrict__ bits, long long row_quads, int rows, int n_items,
               int chunk_quads, const int32_t* __restrict__ item_counts,
               const int32_t* __restrict__ first_rank, int cap, int32_t* __restrict__ offsets) {
  __shared__ unsigned s_warp[kWarps];
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int rank0 = __ldg(first_rank + i);
    if (__ldg(item_counts + i) == 0 || rank0 >= cap) continue;
    const int c = i / rows;
    const int row = i - c * rows;
    const long long q0 = static_cast<long long>(c) * chunk_quads;
    const int n_q = static_cast<int>(min(static_cast<long long>(chunk_quads), row_quads - q0));
    const uint4* src = bits + static_cast<long long>(row) * row_quads + q0;
    int32_t* dst = offsets + static_cast<long long>(row) * cap;
    int rank = rank0;  // the rank of this step's first match
    for (int s = 0; s < n_q && rank < cap; s += kThreads) {
      const int q = s + static_cast<int>(threadIdx.x);
      const uint4 v = q < n_q ? __ldg(src + q) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      unsigned total;
      int r = rank + static_cast<int>(block_exclusive_scan(
                         __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w), s_warp, &total));
      const int p0 = static_cast<int>(128 * (q0 + q));  // the offset of bit 0 of w[0]
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        for (uint32_t x = w[k]; x != 0u && r < cap; x &= x - 1u, ++r) {
          dst[r] = p0 + 32 * k + __ffs(x) - 1;
        }
      }
      rank += static_cast<int>(total);
    }
  }
}

}  // namespace

extern "C" {

// bits: int32[rows, row_words] linear match bitmaps (16-byte aligned,
// row_words a multiple of 4); item_counts, first_rank: int32[n_items],
// item i = chunk i / rows of row i % rows, its match count and the rank of
// its first match within its row; chunk: positions per item, a multiple
// of 128; offsets: int32[rows, cap], filled with SENTINEL on entry; grid:
// blocks of the grid-stride loop.
int ssf_compact_positions(const void* bits, long long row_words, int rows, int n_items,
                          int chunk, const void* item_counts, const void* first_rank, int cap,
                          void* offsets, int grid, void* stream) {
  if (rows <= 0 || n_items <= 0 || cap == 0) return static_cast<int>(cudaGetLastError());
  if (row_words % 4 || chunk <= 0 || chunk % 128 || cap < 0 || grid <= 0 || n_items % rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  compact_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bits), row_words / 4, rows, n_items, chunk / 128,
      static_cast<const int32_t*>(item_counts), static_cast<const int32_t*>(first_rank), cap,
      static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
