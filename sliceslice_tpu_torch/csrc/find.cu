// Hand-written Hopper (sm_90a) kernels of the find path, behind a plain C
// interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// ssf_batched_find replaces the Pallas find kernel
// sliceslice_tpu/ops/scan_kernel.py::_raw_batched_call (wrapped there by
// batched_find_cols).  For each needle row n < n_real it returns the
// smallest position p with p + base < ends[n] such that, for every probe
// slot i < t,
//     (win32(p + 4i) & masks[n, i]) == values[n, i]
// where win32(q) is the little-endian 4-byte window at byte q, as p + base
// (int32), or SENTINEL when there is none.
//
// ssf_memchr_find replaces sliceslice_tpu/ops/scan_kernel.py::_memchr_call
// (wrapped by memchr_find_cols): the first p with p + base < end at which
// one byte value occurs, as p + base, or SENTINEL.
//
// What bounds them on the H100.  The find kernel reads the corpus once per
// needle row until that row's first match, so across a sweep it moves
// (rows x bytes scanned) through L2 and, for corpora larger than the 50 MB
// L2, HBM; per position it spends one funnel shift, one AND and one compare
// per probe slot, and almost every position fails at the first slot.  A
// row is therefore bound by load latency and L2 bandwidth, not by integer
// throughput.  The design answers that simply:
//   * one block per (row, span of positions); 256 threads each own one
//     aligned 32-bit word and evaluate the 4 positions that start in it, so
//     a warp's loads are 128 contiguous bytes and each window comes from
//     two aligned words by __funnelshift_r — no packed-window copy of the
//     corpus in HBM (the TPU layout's 4x-sized windows are not needed);
//   * a position stops at its first failing probe slot;
//   * the block stops at the first tile (1024 positions) holding a match:
//     __syncthreads_or finds the tile, a shared atomicMin its first
//     position, and a global atomicMin merges spans.  That is the
//     per-needle early exit; it subsumes the TPU kernel's per-block exit;
//   * a span block skips tiles that start past the row's current best, so
//     spans behind an early match cost one read of the result.
// Making it fast (TMA tiles shared across needles, a persistent grid) is
// later work.  The kernels allocate nothing and never synchronise; each
// entry point returns cudaGetLastError() so the caller sees a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kFindTile = kThreads * 4;      // positions per find step
constexpr int kMemchrTile = kThreads * 16;   // bytes per memchr step
constexpr int kMaxT = 512;                   // widest probe table
constexpr int kCheckEvery = 8;               // steps between cross-span checks

__device__ __forceinline__ int read_best(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
batched_find_kernel(const uint32_t* __restrict__ hay, long long n_pos,
                    const uint32_t* __restrict__ values,
                    const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ ends, int32_t* out, int t,
                    long long base, long long span) {
  __shared__ uint32_t s_val[kMaxT];
  __shared__ uint32_t s_msk[kMaxT];
  __shared__ int s_first;

  const int row = blockIdx.x;  // the grid holds rows < n_real only
  long long lim = static_cast<long long>(ends[row]) - base;
  if (lim > n_pos) lim = n_pos;
  const long long start = static_cast<long long>(blockIdx.y) * span;
  if (start >= lim) return;
  const long long stop = (start + span < lim) ? start + span : lim;

  for (int i = threadIdx.x; i < t; i += kThreads) {
    s_val[i] = values[static_cast<long long>(row) * t + i];
    s_msk[i] = masks[static_cast<long long>(row) * t + i];
  }
  if (threadIdx.x == 0) s_first = kSentinel;
  // One thread reads the row's best so that the whole block agrees: a span
  // that starts at or past it has nothing to add.
  if (__syncthreads_or(threadIdx.x == 0 &&
                       static_cast<long long>(read_best(out + row)) <= start + base)) {
    return;
  }

  int step = 0;
  for (long long tile = start; tile < stop; tile += kFindTile, ++step) {
    const long long p0 = tile + 4LL * threadIdx.x;  // word aligned
    unsigned alive = 0;
    if (p0 < stop) {
      const long long rem = stop - p0;
      alive = rem >= 4 ? 0xFu : ((1u << rem) - 1u);
      const long long j = p0 >> 2;
      uint32_t lo = __ldg(hay + j);
      for (int i = 0; i < t && alive; ++i) {
        const uint32_t hi = __ldg(hay + j + i + 1);
        const uint32_t m = s_msk[i];
        const uint32_t v = s_val[i];
        if (m != 0u) {  // a mask-0 slot is trivially true
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t w = __funnelshift_r(lo, hi, 8 * r);
            if ((w & m) != v) alive &= ~(1u << r);
          }
        }
        lo = hi;
      }
    }
    if (__syncthreads_or(alive != 0u)) {
      if (alive) {
        atomicMin(&s_first, static_cast<int>(p0 - start) + __ffs(alive) - 1);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        atomicMin(out + row, static_cast<int>(start + s_first + base));
      }
      return;
    }
    if ((step + 1) % kCheckEvery == 0) {
      // Another span already holds a match at or before the next tile:
      // nothing left here can beat it.
      const long long next = tile + kFindTile + base;
      if (__syncthreads_or(threadIdx.x == 0 &&
                           static_cast<long long>(read_best(out + row)) <= next)) {
        return;
      }
    }
  }
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

}  // namespace

extern "C" {

// hay: n_words 32-bit words of corpus bytes (16-byte aligned).  n_pos: the
// positions whose t windows lie inside hay, 4 * (n_words - t).  values,
// masks: uint32[n_real.., t], pre-masked.  ends, out: int32[n_real..]; out
// must hold SENTINEL on entry.  span: positions per block, a multiple of
// 1024; n_spans: blocks per row.
int ssf_batched_find(const void* hay, long long n_pos, const void* values,
                     const void* masks, const void* ends, void* out,
                     int n_real, int t, long long base, long long span,
                     int n_spans, void* stream) {
  if (n_real <= 0 || n_pos <= 0) return static_cast<int>(cudaGetLastError());
  if (t < 1 || t > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_real), static_cast<unsigned>(n_spans));
  batched_find_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), n_pos,
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(out), t, base,
      span);
  return static_cast<int>(cudaGetLastError());
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
