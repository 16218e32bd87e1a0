// Hand-written Hopper (sm_90a) kernels of the positions path, behind a
// plain C interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// Together they replace the plain-XLA compact tier of the positions path,
// sliceslice_tpu/ops/xla_backend.py::_compact_positions_impl (wrapped by
// compact_positions_batched, :246): for each row of a linear match bitmap
// (ssf_queue's bitmap mode, find.cu), its match count and its matches'
// offsets, ascending.
//
// ssf_item_ranks (rank_kernel) turns the bitmap kernel's per-item match
// counts (int32[n_chunks, rows], chunk-major) into each row's count and
// each item's first rank, the exclusive prefix sum of its row's earlier
// items, and in capped mode fills the SENTINEL tail offsets[row,
// min(count, cap) .. cap).  What bounds it on the H100: bytes (the item
// counts read once, the ranks and counts written once, the tail), with a
// few integer operations per item.  The design: one warp per row walks its
// chunks 32 at a time, a __shfl_up_sync scan each, carrying the sum, so a
// row of thousands of chunks (a 2 GiB layout holds ~32 K) is a warp's
// 1/32-length walk rather than one thread's or one block's serial one; the
// warp then writes the row's tail with coalesced 4-byte stores.
//
// ssf_compact_positions (compact_kernel) writes the offsets of the ranks in
// one window per row: rank r of row n goes to out[dst(n) + r] for lo(n) <= r
// < hi(n), in one of two modes:
//   * capped (row_base null): lo = 0, hi = cap, dst = n * cap, the JAX
//     contract's [rows, cap] block;
//   * packed (row_base = the exclusive prefix sum of the rows' counts):
//     rank r of row n is packed rank row_base[n] + r, and the launch writes
//     packed ranks [w0, w1) to out[0 .. w1 - w0): every row's offsets in one
//     buffer, a window of it per launch, a dense row split across windows.
// The store's width follows the mode: capped mode writes the contract's
// int32, packed mode int64, the caller's answers as they are, so that a
// window is read back straight into them and the host never widens an
// offset.  The offset itself is an int either way (below 2^31 in a layout).
// What bounds it on the H100: bytes.  Per match it does a few integer
// operations; what it must move is the words of the items that hold a rank
// in their row's window, every item's count and first rank, the row bases
// and the offsets it writes.  The design:
//   * items (row, chunk) are independent, ranked by rank_kernel, so no pass
//     walks a row from its start; a grid-stride loop hands them to blocks,
//     and an item with no rank in its row's window costs two loads;
//   * a live item is read with 16-byte loads, 1,024 words per block step; a
//     block-wide exclusive scan of their popcounts (warp __shfl_up_sync,
//     then shared memory) gives each thread the rank of its first set bit,
//     and the thread writes the offsets of its bits whose ranks lie in the
//     window.  The block leaves the item once the rank reaches the window's
//     end, so a window may end or start inside an item or a word;
//   * every output slot has exactly one writer, so the result does not
//     depend on the order in which blocks run.

#include <climits>
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

// item_counts, first_rank: int32[n_chunks, rows]; one warp per row (a
// grid-stride loop over rows, so every lane of a warp sees the same row).
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ item_counts, int n_chunks, int rows,
            int32_t* __restrict__ counts, int32_t* __restrict__ first_rank,
            int32_t* __restrict__ offsets, int cap) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows; row += stride) {
    int carry = 0;  // the matches of the row's chunks before this step's
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int c = c0 + lane;
      const long long at = static_cast<long long>(c) * rows + row;
      const int v = c < n_chunks ? __ldg(item_counts + at) : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (c < n_chunks) first_rank[at] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) counts[row] = carry;
    if (offsets != nullptr) {
      int32_t* dst = offsets + static_cast<long long>(row) * cap;
      for (int j = min(carry, cap) + lane; j < cap; j += 32) dst[j] = kSentinel;
    }
  }
}

// bits: the bitmap as uint4[rows, row_quads]; item i is chunk c = i / rows
// of row i % rows, its words [c * chunk_quads, (c + 1) * chunk_quads) in
// quads, cut at the row's end.  row_base null: capped mode, else packed
// (see the note above); Out is int32_t in capped mode, long long in packed
// mode.  Every condition that steers the block is read from global memory
// or shared memory by every thread alike.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint4* __restrict__ bits, long long row_quads, int rows, int n_items,
               int chunk_quads, const int32_t* __restrict__ item_counts,
               const int32_t* __restrict__ first_rank, int cap,
               const long long* __restrict__ row_base, long long w0, long long w1,
               Out* __restrict__ out) {
  __shared__ unsigned s_warp[kWarps];
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int cnt = __ldg(item_counts + i);
    if (cnt == 0) continue;
    const int c = i / rows;
    const int row = i - c * rows;
    int lo = 0, hi = cap;                         // the row's window of ranks
    long long dst = static_cast<long long>(row) * cap;  // where rank 0 would go
    if (row_base != nullptr) {
      const long long b = __ldg(row_base + row);
      lo = static_cast<int>(max(0LL, min(w0 - b, static_cast<long long>(INT_MAX))));
      hi = static_cast<int>(max(0LL, min(w1 - b, static_cast<long long>(INT_MAX))));
      dst = b - w0;
    }
    const int rank0 = __ldg(first_rank + i);
    if (rank0 >= hi || rank0 + cnt <= lo) continue;
    const long long q0 = static_cast<long long>(c) * chunk_quads;
    const int n_q = static_cast<int>(min(static_cast<long long>(chunk_quads), row_quads - q0));
    const uint4* src = bits + static_cast<long long>(row) * row_quads + q0;
    int rank = rank0;  // the rank of this step's first match
    for (int s = 0; s < n_q && rank < hi; s += kThreads) {
      const int q = s + static_cast<int>(threadIdx.x);
      const uint4 v = q < n_q ? __ldg(src + q) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const int mine = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      unsigned total;
      int r = rank + static_cast<int>(block_exclusive_scan(mine, s_warp, &total));
      if (r + mine > lo) {
        const int p0 = static_cast<int>(128 * (q0 + q));  // the offset of bit 0 of w[0]
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          for (uint32_t x = w[k]; x != 0u && r < hi; x &= x - 1u, ++r) {
            if (r >= lo) out[dst + r] = static_cast<Out>(p0 + 32 * k + __ffs(x) - 1);
          }
        }
      }
      rank += static_cast<int>(total);
    }
  }
}

}  // namespace

extern "C" {

// item_counts: int32[n_chunks, rows] (chunk-major); counts: int32[rows];
// first_rank: int32[n_chunks, rows]; offsets: null, or int32[rows, cap]
// whose tail past each row's count it fills with SENTINEL; grid: blocks of
// the grid-stride loop over rows (kThreads / 32 rows a block at once).
int ssf_item_ranks(const void* item_counts, int n_chunks, int rows, void* counts,
                   void* first_rank, void* offsets, int cap, int grid, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (n_chunks < 0 || cap < 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rank_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(item_counts), n_chunks, rows, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(first_rank), static_cast<int32_t*>(offsets), cap);
  return static_cast<int>(cudaGetLastError());
}

// bits: int32[rows, row_words] linear match bitmaps (16-byte aligned,
// row_words a multiple of 4); item_counts, first_rank: int32[n_items],
// item i = chunk i / rows of row i % rows, its match count and the rank of
// its first match within its row (ssf_item_ranks); chunk: positions per
// item, a multiple of 128.  Capped mode (row_base null): out is
// int32[rows, cap], each row's ranks below cap written, the rest left as
// they are.  Packed mode: row_base is int64[rows], out int64[w1 - w0], the
// packed ranks [w0, w1) written.  grid: blocks of the grid-stride loop.
int ssf_compact_positions(const void* bits, long long row_words, int rows, int n_items,
                          int chunk, const void* item_counts, const void* first_rank, int cap,
                          const void* row_base, long long w0, long long w1, void* out, int grid,
                          void* stream) {
  if (row_words % 4 || chunk <= 0 || chunk % 128 || cap < 0 || grid <= 0 || w0 < 0 || w1 < w0 ||
      (rows > 0 && n_items % rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool packed = row_base != nullptr;
  if (rows <= 0 || n_items <= 0 || (packed ? w1 == w0 : cap == 0)) {
    return static_cast<int>(cudaGetLastError());
  }
  const auto* b = static_cast<const uint4*>(bits);
  const auto* ic = static_cast<const int32_t*>(item_counts);
  const auto* fr = static_cast<const int32_t*>(first_rank);
  const auto* rb = static_cast<const long long*>(row_base);
  const auto s = static_cast<cudaStream_t>(stream);
  if (packed) {
    compact_kernel<long long><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        b, row_words / 4, rows, n_items, chunk / 128, ic, fr, cap, rb, w0, w1,
        static_cast<long long*>(out));
  } else {
    compact_kernel<int32_t><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        b, row_words / 4, rows, n_items, chunk / 128, ic, fr, cap, rb, w0, w1,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
