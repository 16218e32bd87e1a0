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
// What bounds it on the H100.  A pair costs at most one probe walk over
// len(h) - len(n) + 1 positions, and almost every position fails at its
// first slot, so the sweep is bound by integer and shared-memory throughput
// (a funnel shift, an AND and a compare per position and slot), not by
// memory: the i386 word list is 4,585 words of at most 24 bytes.  Matrix
// mode also writes 4 bytes per pair (84 MB for the i386 sweep).  The design:
//   * one launch for the whole sweep: blockIdx walks a table of the plan's
//     non-skipped blocks (i0, j0, tn_b, mi_b), each cut into tiles of
//     kTileN needles x kThreads haystack words;
//   * a tile stages its haystack words (row-major bytes, as 32-bit words
//     with an odd stride, so the 32 lanes of a warp hit 32 banks) and its
//     needle tables in shared memory; windows are built from two aligned
//     words by __funnelshift_r, as in the find kernel — no 4x-sized
//     packed-window copy of the words;
//   * one thread owns one haystack word and walks the tile's kTileN needles
//     against it; a needle's positions are scanned 4 at a time, ascending,
//     and the walk stops at the first word of positions holding a match
//     (the TPU kernel's descending select is a vector-unit device);
//   * count mode writes no matrix: warp shuffles and shared memory sum a
//     block's matches, and one atomicAdd adds them to the total.
// Words too long for a tile's shared memory are read from device memory in
// place (same loop, the pointer differs).  Making it fast (cp.async or TMA
// staging, a persistent grid) is later work.  The kernel allocates nothing
// and never synchronises; the entry point returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // haystack words per tile, one per thread
constexpr int kTileN = 16;     // needles per tile: each thread's pairs

__global__ void __launch_bounds__(kThreads)
pair_block_kernel(const uint32_t* __restrict__ values,
                  const uint32_t* __restrict__ masks,
                  const int32_t* __restrict__ ln, int n, int tn,
                  const uint32_t* __restrict__ hay,
                  const int32_t* __restrict__ lh, int h, int hw,
                  const int4* __restrict__ plan, int block, int tiles_n,
                  int tiles_h, int staged, int32_t* first, int32_t* total) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_warp[kThreads / 32];

  const int tiles = tiles_n * tiles_h;
  const int e = blockIdx.x / tiles;
  const int tile = blockIdx.x - e * tiles;
  const int4 p = plan[e];  // (i0, j0, tn_b, mi_b) of one plan block
  const int i0 = p.x + (tile / tiles_h) * kTileN;
  const int j0 = p.y + (tile % tiles_h) * kThreads;
  const int rows = min(min(p.x + block, n) - i0, kTileN);
  const int lanes = min(min(p.y + block, h) - j0, kThreads);
  if (rows <= 0 || lanes <= 0) return;  // uniform: a tile past the edge
  const int tn_b = p.z;
  const int mi_b = p.w;
  // Positions i < mi_b read words up to (i >> 2) + tn_b of a word's row.
  const int words = ((mi_b - 1) >> 2) + tn_b + 1;

  const uint32_t* hrow;
  const uint32_t* vals;
  const uint32_t* msks;
  int vstride;
  if (staged) {
    const int sw = words | 1;  // odd stride: conflict-free across a warp
    uint32_t* s_hay = smem;
    uint32_t* s_val = smem + kThreads * sw;
    uint32_t* s_msk = s_val + kTileN * tn_b;
    for (int q = threadIdx.x; q < lanes * words; q += kThreads) {
      const int l = q / words;
      const int w = q - l * words;
      s_hay[l * sw + w] = hay[static_cast<long long>(j0 + l) * hw + w];
    }
    for (int q = threadIdx.x; q < rows * tn_b; q += kThreads) {
      const int r = q / tn_b;
      const long long src = static_cast<long long>(i0 + r) * tn + (q - r * tn_b);
      s_val[q] = values[src];
      s_msk[q] = masks[src];
    }
    __syncthreads();
    hrow = s_hay + threadIdx.x * sw;
    vals = s_val;
    msks = s_msk;
    vstride = tn_b;
  } else {
    hrow = hay + static_cast<long long>(j0 + threadIdx.x) * hw;
    vals = values + static_cast<long long>(i0) * tn;
    msks = masks + static_cast<long long>(i0) * tn;
    vstride = tn;
  }

  int matches = 0;
  if (static_cast<int>(threadIdx.x) < lanes) {
    const int col = j0 + threadIdx.x;
    const int len_h = lh[col];
    for (int r = 0; r < rows; ++r) {
      // Valid positions: i <= len(h) - len(n); padded needle rows (len
      // 2**30) and padded words (len -1) have none.  Only i < mi_b is
      // scanned, as in the TPU kernel (an empty needle matches at 0).
      const int last = min(len_h - ln[i0 + r], mi_b - 1);
      const uint32_t* v = vals + r * vstride;
      const uint32_t* m = msks + r * vstride;
      int found = -1;
      for (int j = 0; 4 * j <= last; ++j) {
        const int rem = last - 4 * j + 1;
        unsigned alive = rem >= 4 ? 0xFu : ((1u << rem) - 1u);
        uint32_t lo = hrow[j];
        for (int s = 0; s < tn_b && alive; ++s) {
          const uint32_t hi = hrow[j + s + 1];
          const uint32_t ms = m[s];
          const uint32_t vs = v[s];
          if (ms != 0u) {  // a mask-0 slot is trivially true
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const uint32_t w = __funnelshift_r(lo, hi, 8 * b);
              if ((w & ms) != vs) alive &= ~(1u << b);
            }
          }
          lo = hi;
        }
        if (alive) {
          found = 4 * j + __ffs(alive) - 1;
          break;
        }
      }
      if (first != nullptr) first[static_cast<long long>(i0 + r) * h + col] = found;
      matches += found >= 0;
    }
  }

  if (total != nullptr) {
    int sum = __reduce_add_sync(0xffffffffu, matches);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x < 32) {
      sum = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0;
      sum = __reduce_add_sync(0xffffffffu, sum);
      if (threadIdx.x == 0 && sum != 0) atomicAdd(total, sum);
    }
  }
}

}  // namespace

extern "C" {

// values, masks: uint32[n, tn], pre-masked; ln: int32[n].  hay: uint32[h,
// hw], each word's bytes zero-padded; lh: int32[h].  plan: int32[n_entries,
// 4] of non-skipped blocks (i0, j0, tn_b, mi_b) with tn_b <= tn and
// ((mi_b - 1) >> 2) + tn_b + 1 <= max_words <= hw; max_tn: the largest
// tn_b.  Exactly one of first (int32[n, h], -1 outside the plan's blocks
// on entry) and total (int32[1], 0 on entry) is non-null.
int ssf_pair_block(const void* values, const void* masks, const void* ln,
                   int n, int tn, const void* hay, const void* lh, int h,
                   int hw, const void* plan, int n_entries, int block,
                   int max_words, int max_tn, void* first, void* total,
                   void* stream) {
  if (n_entries <= 0) return static_cast<int>(cudaGetLastError());
  if (block < 1 || max_words < 1 || max_tn < 1 || max_words > hw || max_tn > tn ||
      (first == nullptr) == (total == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_n = (block + kTileN - 1) / kTileN;
  const int tiles_h = (block + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(n_entries) * tiles_n * tiles_h;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = sizeof(uint32_t) * (static_cast<size_t>(kThreads) * (max_words | 1) +
                                    2 * static_cast<size_t>(kTileN) * max_tn);
  const size_t reserved = sizeof(int) * (kThreads / 32);
  const int staged = smem + reserved <= static_cast<size_t>(optin);
  if (!staged) smem = 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pair_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pair_block_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(ln), n, tn, static_cast<const uint32_t*>(hay),
      static_cast<const int32_t*>(lh), h, hw, static_cast<const int4*>(plan),
      block, tiles_n, tiles_h, staged, static_cast<int32_t*>(first),
      static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
