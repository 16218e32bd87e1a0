// Hand-written Hopper (sm_90a) kernel of the all-pairs word sweep, behind a
// plain C interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// ssf_pair_block replaces the Pallas pair-block kernel
// sliceslice_tpu/ops/pairwise.py::_pair_block_call (driven there by
// _pair_block_pallas and _fused_runner, one call per block of the plan).
// For every pair (needle n, haystack word h) of every block of the plan it
// finds the smallest i <= min(len(h) - len(n), mi_b - 1) at which every
// probe slot s < tn_b satisfies
//     (win32(h, i + 4s) & masks[n, s]) == values[n, s]
// where win32(h, q) is the little-endian 4-byte window of word h's bytes
// (zero past the word) at byte q.  Matrix mode writes i, or -1 when there
// is none, into first[n, h]; count mode adds the number of matching pairs
// into one int32.
//
// What bounds it on the H100.  The work is integer: a pair needs at most
// len(h) - len(n) + 1 positions tested, almost every position fails at its
// first byte, and most pairs of a length-sorted list have no valid position
// at all.  One 32-bit operation per position tested against the INT32 rate
// is the bound; the bytes are nothing beside it (the i386 word list is
// 4,585 words of at most 24 bytes) except in matrix mode, which writes 4
// bytes per pair (84 MB for the i386 sweep).  So what a pair costs is its
// fixed work, not its probes, and what a sweep costs is its slowest block.
// The design cuts both:
//   * a persistent grid (the blocks the card holds at once) draws tiles of
//     kTileN needles x 256 haystack words from one counter; a tile whose
//     every needle is longer than its every word is dropped at the draw,
//     as is a tile past the matrix's edge;
//   * a pair is rejected before any probe.  A needle can occur in a word
//     only if it is no longer than the word and every byte of it occurs in
//     the word, so each side carries a 32-bit byte signature (bit c mod 32
//     for every byte c) and a pair survives when len(n) <= len(h) and
//     sig(n) & ~sig(h) is 0: 1.6% of the i386 sweep's pairs.  One thread
//     owns one haystack word: it reads the word once per tile (its loads
//     started together), builds its signature in registers and runs the
//     reject for 32 needles at a time, unrolled and without a branch, into
//     a bit mask; each needle's length and signature come from one 8-byte
//     shared-memory read, the same address for every lane (a broadcast).
//     Nothing of the haystack is staged and no table is;
//   * the survivors are spread over the block.  A long word passes many
//     short needles, and a thread that probed all its own survivors held
//     the whole sweep.  So the threads write their survivors, as (needle,
//     word) pairs, into one list in shared memory (offsets from a
//     block-wide prefix sum of the masks' popcounts), and every thread then
//     takes each 256th entry;
//   * a survivor is probed 16 positions at a time, as the scan kernels'
//     wide step: five words read at once (in place: a tile's rows and
//     tables stay in L1), a slot's 16 windows compared side by side, the
//     walk stopping at the first 16 positions that hold a match (the TPU
//     kernel's descending select is a vector-unit device).  An empty needle
//     has an empty signature and all-zero masks: it survives every word at
//     least as long, and position 0 matches;
//   * matrix mode stores only what a survivor's probe finds, into a
//     matrix the wrapper has filled with -1; count mode writes no matrix: a
//     block sums its matches over all its tiles and adds them once.
// Words and tables of any length take the same path.  Measured and left
// out (PERF.md): the word held in registers for the whole tile and probed
// by its own thread, a byte-SIMD (__vcmpeq4) first-byte test before the
// slot walk, words and tables staged in shared memory, the kernel writing
// -1 itself for every rejected pair and skipped block.  The kernel
// allocates nothing (the wrapper zeroes the tile counter and the total) and
// never synchronises; the entry point returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // haystack words per tile, one per thread
// Needles per tile.  Of 16, 32 and 64, 32 measured fastest on the i386 sweep:
// 16 stages twice as often, 64 leaves the tile of the shortest needles and
// the longest words to hold the sweep (PERF.md).
constexpr int kTileN = 32;
constexpr int kSigWords = 16;    // words of a row whose loads are started together
constexpr int kBatch = 32;       // needles per reject mask
constexpr int kWarps = kThreads / 32;

// The bytes of `v` under whole mask bytes of `m`, as a 32-bit signature:
// bit c mod 32 for every such byte c.
__device__ __forceinline__ uint32_t byte_signature(uint32_t v, uint32_t m) {
  uint32_t sig = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (((m >> (8 * b)) & 0xffu) == 0xffu) sig |= 1u << ((v >> (8 * b)) & 31u);
  }
  return sig;
}

// The first match of one pair: hrow, the n_row 32-bit words of the word's
// row, read in place (a tile's rows stay in L1; words past the row read as
// zero); valid positions 0..last (last >= 0); val, msk, the needle's table
// rows, in place too.  16 positions at a time, as the scan kernels' wide
// step: five words are read at once and a slot's 16 windows are compared
// side by side; the walk stops at the first 16 positions that hold a match.
__device__ __forceinline__ int first_match(const uint32_t* __restrict__ hrow, int n_row, int last,
                                           const uint32_t* __restrict__ val,
                                           const uint32_t* __restrict__ msk, int tn_b) {
  for (int p0 = 0; p0 <= last; p0 += 16) {
    const int j = p0 >> 2;
    uint32_t w[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) w[k] = j + k < n_row ? __ldg(hrow + j + k) : 0u;
    const int rem = last - p0 + 1;
    unsigned alive = rem >= 16 ? 0xffffu : (1u << rem) - 1u;
    for (int s = 0; s < tn_b && alive; ++s) {
      if (s > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = w[k + 1];
        w[4] = j + s + 4 < n_row ? __ldg(hrow + j + s + 4) : 0u;
      }
      const uint32_t ms = __ldg(msk + s);
      const uint32_t vs = __ldg(val + s);
      if (ms != 0u) {  // a mask-0 slot is trivially true
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if ((__funnelshift_r(w[k], w[k + 1], 8 * b) & ms) != vs) alive &= ~(1u << (4 * k + b));
          }
        }
      }
    }
    if (alive) return p0 + __ffs(alive) - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
pair_block_kernel(const uint32_t* __restrict__ values, const uint32_t* __restrict__ masks,
                  const int32_t* __restrict__ ln, int n, int tn,
                  const uint32_t* __restrict__ hay, const int32_t* __restrict__ lh, int h,
                  int hw, const int4* __restrict__ plan, int n_tiles, int block,
                  int32_t* first, int32_t* total, int* queue) {
  // Per needle of the tile: (length, byte signature of the slots below tn_b).
  __shared__ int2 s_needle[kTileN];
  __shared__ uint16_t s_list[kBatch * kThreads];  // survivors: needle of the batch << 8 | word
  __shared__ int s_tile, s_min_ln;
  __shared__ int s_warp[kWarps];

  const int tiles_h = (block + kThreads - 1) / kThreads;
  const int tiles = ((block + kTileN - 1) / kTileN) * tiles_h;  // per plan entry
  const int tid = threadIdx.x;
  int matches = 0;

  for (;;) {
    if (tid == 0) {
      s_tile = atomicAdd(queue, 1);
      s_min_ln = INT_MAX;
    }
    __syncthreads();
    const int idx = s_tile;
    if (idx >= n_tiles) break;
    const int e = idx / tiles;
    const int tile = idx - e * tiles;
    const int4 p = plan[e];  // (i0, j0, tn_b, mi_b)
    const int i0 = p.x + (tile / tiles_h) * kTileN;
    const int j0 = p.y + (tile % tiles_h) * kThreads;
    const int rows = min(min(p.x + block, n) - i0, kTileN);
    const int lanes = min(min(p.y + block, h) - j0, kThreads);
    const int tn_b = p.z;
    const int mi_b = p.w;
    // Uniform over the block from here to the closing barrier.
    if (rows > 0 && lanes > 0 && tn_b > 0) {
      const bool active = tid < lanes;
      const int col = j0 + tid;
      const int len_h = active ? __ldg(lh + col) : -1;
      // Positions i < mi_b read words up to (i >> 2) + tn_b of a word's row.
      const int words = ((mi_b - 1) >> 2) + tn_b + 1;
      // The thread's own word, its first kSigWords words read at once,
      // before anything waits on them.
      const uint32_t* hrow = hay + static_cast<long long>(col) * hw;
      uint32_t x[kSigWords];
#pragma unroll
      for (int q = 0; q < kSigWords; ++q) x[q] = active && q < words ? __ldg(hrow + q) : 0u;
      // Valid positions: i <= len(h) - len(n); padded needle rows (len
      // 2**30) and padded words (len -1) have none.  Nothing to do when the
      // shortest needle is longer than the longest word.  Thread r stages
      // needle r: its table's loads are started together.
      int len_n = INT_MAX;
      if (tid >= rows && tid < kTileN) s_needle[tid] = make_int2(INT_MAX, 0);
      for (int r = tid; r < rows; r += kThreads) {
        len_n = __ldg(ln + i0 + r);
        const long long row = static_cast<long long>(i0 + r) * tn;
        uint32_t sig = 0u;
#pragma unroll
        for (int q = 0; q < kSigWords; ++q) {
          if (q < tn_b) sig |= byte_signature(__ldg(values + row + q), __ldg(masks + row + q));
        }
        for (int q = kSigWords; q < tn_b; ++q) {
          sig |= byte_signature(__ldg(values + row + q), __ldg(masks + row + q));
        }
        s_needle[r] = make_int2(len_n, static_cast<int>(sig));
      }
      len_n = static_cast<int>(__reduce_min_sync(0xffffffffu, len_n));
      if ((tid & 31) == 0 && len_n != INT_MAX) atomicMin(&s_min_ln, len_n);
      __syncthreads();
      if (__syncthreads_or(len_h >= s_min_ln)) {
        // The word's byte signature (zero padding only adds the bit of byte 0).
        uint32_t sig_h = 0u;
#pragma unroll
        for (int q = 0; q < kSigWords; ++q) {
          if (q < words) sig_h |= byte_signature(x[q], 0xffffffffu);
        }
        if (active) {
          for (int q = kSigWords; q < words; ++q) {
            sig_h |= byte_signature(__ldg(hrow + q), 0xffffffffu);
          }
        }
        for (int r0 = 0; r0 < rows; r0 += kBatch) {
          // The reject, kBatch needles at a time: bit k of alive is a
          // survivor of this thread's word.  The loop is unrolled over the
          // whole batch: the entries past the tile's last needle hold a
          // length no word reaches.
          unsigned alive = 0u;
          if (active) {
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              const int2 nd = s_needle[r0 + k];
              const bool pass = len_h >= nd.x && (static_cast<uint32_t>(nd.y) & ~sig_h) == 0u;
              alive |= static_cast<unsigned>(pass) << k;
            }
          }
          // The survivors into one list: a block-wide prefix sum of the
          // masks' popcounts gives each thread its place.
          const int mine = __popc(alive);
          int upto = mine;  // inclusive sum over the warp's lanes
#pragma unroll
          for (int d = 1; d < 32; d *= 2) {
            const int y = __shfl_up_sync(0xffffffffu, upto, d);
            if ((tid & 31) >= d) upto += y;
          }
          if ((tid & 31) == 31) s_warp[tid >> 5] = upto;
          __syncthreads();
          int at = upto - mine, n_list = 0;
#pragma unroll
          for (int q = 0; q < kWarps; ++q) {
            const int c = s_warp[q];
            if (q < (tid >> 5)) at += c;
            n_list += c;
          }
          while (alive) {
            s_list[at++] = static_cast<uint16_t>(((__ffs(alive) - 1) << 8) | tid);
            alive &= alive - 1u;
          }
          __syncthreads();
          for (int e = tid; e < n_list; e += kThreads) {
            const int entry = s_list[e];
            const int r = r0 + (entry >> 8);
            const int lane = entry & 0xff;
            const int last = min(__ldg(lh + j0 + lane) - s_needle[r].x, mi_b - 1);  // >= 0: mi_b >= 1
            const long long row = static_cast<long long>(i0 + r) * tn;
            const int found = first_match(hay + static_cast<long long>(j0 + lane) * hw, hw, last,
                                          values + row, masks + row, tn_b);
            if (first != nullptr && found >= 0) {
              first[static_cast<long long>(i0 + r) * h + j0 + lane] = found;
            }
            matches += found >= 0;
          }
          __syncthreads();  // the list and the warp sums are rewritten next
        }
      }
    }
    __syncthreads();
  }

  if (total != nullptr) {
    int sum = __reduce_add_sync(0xffffffffu, matches);
    if ((tid & 31) == 0) s_warp[tid >> 5] = sum;
    __syncthreads();
    if (tid < 32) {
      sum = tid < kWarps ? s_warp[tid] : 0;
      sum = __reduce_add_sync(0xffffffffu, sum);
      if (tid == 0 && sum != 0) atomicAdd(total, sum);
    }
  }
}

static_assert(kTileN % kBatch == 0, "a tile is whole reject batches");

}  // namespace

extern "C" {

// values, masks: uint32[n, tn], pre-masked; ln: int32[n].  hay: uint32[h,
// hw], each word's bytes zero-padded; lh: int32[h].  plan: int32[n_entries,
// 4] of non-skipped blocks (i0, j0, tn_b, mi_b) with 1 <= tn_b <= tn and
// ((mi_b - 1) >> 2) + tn_b + 1 <= hw.  resident: the blocks the card holds
// at once (ssf_pair_blocks x SMs); the grid is that many, or one per tile
// when the plan has fewer tiles.
// Exactly one of first (int32[n, h] holding -1 on entry) and total
// (int32[1], 0 on entry) is non-null.  queue: one int32 holding 0 on entry.
int ssf_pair_block(const void* values, const void* masks, const void* ln, int n, int tn,
                   const void* hay, const void* lh, int h, int hw, const void* plan,
                   int n_entries, int block, int resident, void* first, void* total,
                   void* queue, void* stream) {
  if (n_entries <= 0) return static_cast<int>(cudaGetLastError());
  if (block < 1 || resident < 1 || tn < 1 || hw < 1 || queue == nullptr ||
      (first == nullptr) == (total == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>((block + kTileN - 1) / kTileN) *
                          ((block + kThreads - 1) / kThreads);
  // The counter passes n_tiles by one draw per block.
  if (tiles * n_entries + resident > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = static_cast<int>(tiles * n_entries);
  const int grid = resident < n_tiles ? resident : n_tiles;
  const uint32_t* v = static_cast<const uint32_t*>(values);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const int32_t* l = static_cast<const int32_t*>(ln);
  const uint32_t* hy = static_cast<const uint32_t*>(hay);
  const int32_t* lw = static_cast<const int32_t*>(lh);
  const int4* pl = static_cast<const int4*>(plan);
  int32_t* f = static_cast<int32_t*>(first);
  int32_t* tot = static_cast<int32_t*>(total);
  int* q = static_cast<int*>(queue);
  void* args[] = {&v, &m, &l, &n, &tn, &hy, &lw, &h, &hw, &pl, &n_tiles, &block, &f, &tot, &q};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<void*>(pair_block_kernel), dim3(static_cast<unsigned>(grid)),
                       dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of the kernel that one SM holds at once, into *per_sm.
int ssf_pair_blocks(void* per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      static_cast<int*>(per_sm), reinterpret_cast<void*>(pair_block_kernel), kThreads, 0));
}

}  // extern "C"
