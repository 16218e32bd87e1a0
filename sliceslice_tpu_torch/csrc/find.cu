// Hand-written Hopper (sm_90a) kernels of the find and count paths, behind
// a plain C interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
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
// ssf_batched_count replaces the Pallas count kernel
// sliceslice_tpu/ops/scan_kernel.py::_raw_count_call (wrapped there by
// batched_count_cols): for each row n < n_real, the number of positions p
// with p + base < ends[n] that satisfy every slot (overlapping matches).
//
// ssf_memchr_find replaces sliceslice_tpu/ops/scan_kernel.py::_memchr_call
// (wrapped by memchr_find_cols): the first p with p + base < end at which
// one byte value occurs, as p + base, or SENTINEL.
//
// ssf_match_bitmap replaces the plain-XLA match bitmap of the positions
// path, sliceslice_tpu/ops/xla_backend.py::_match_bitmap_cols_impl (and its
// batched vmap): for each row n < n_real, bit b of word w of out[n] is set
// iff position p = 32w + b satisfies every slot with p + base < ends[n].
// The bitmap is linear, where the TPU's is laid out by lane.  It is a
// kernel here because the plain torch version evaluates every position of
// every row in chunked tensor ops (137x this kernel's time over an i386
// positions sweep on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md); this one
// is the shared loop plus a shuffle merge and a store.
//
// What bounds them on the H100.  The find kernel reads the corpus once per
// needle row until that row's first match, so across a sweep it moves
// (rows x bytes scanned) through L2 and, for corpora larger than the 50 MB
// L2, HBM; per position it spends one funnel shift, one AND and one compare
// per probe slot, and almost every position fails at the first slot.  A
// row is therefore bound by load latency and L2 bandwidth, not by integer
// throughput.  The count kernel has no early exit: every row reads the
// whole corpus, so a sweep moves rows x corpus bytes through L1/L2 and is
// bound by that traffic.  The design answers that simply:
//   * one block per (row, span of positions); 256 threads each own one
//     aligned 32-bit word and evaluate the 4 positions that start in it, so
//     a warp's loads are 128 contiguous bytes and each window comes from
//     two aligned words by __funnelshift_r — no packed-window copy of the
//     corpus in HBM (the TPU layout's 4x-sized windows are not needed);
//     every kernel but memchr shares that loop (probe_word, in
//     scan_common.cuh with the ablation kernel of probe.cu);
//   * a position stops at its first failing probe slot;
//   * find: the block stops at the first tile (1024 positions) holding a
//     match: __syncthreads_or finds the tile, a shared atomicMin its first
//     position, and a global atomicMin merges spans.  That is the
//     per-needle early exit; it subsumes the TPU kernel's per-block exit.
//     A span block skips tiles that start past the row's current best, so
//     spans behind an early match cost one read of the result;
//   * count: each thread adds the popcount of its surviving positions in a
//     register, walking its span with no barrier; the block sums by warp
//     shuffles and shared memory and adds its sum to the row with one
//     atomicAdd.  Integer sums in any order are exact.  The TPU kernel's
//     clean-segment split only saves vector passes there; here the end
//     bound is one compare per word, so it is not carried over;
//   * match bitmap: the count kernel's walk, with one 4-byte store per 32
//     positions that hold a match instead of a sum, so it costs a count
//     plus the stores of its matches.
// Making them fast (TMA tiles shared across needles, a persistent grid) is
// later work.  The kernels allocate nothing and never synchronise; each
// entry point returns cudaGetLastError() so the caller sees a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

constexpr int kMemchrTile = kThreads * 16;   // bytes per memchr step
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
  long long start, stop;
  if (!row_span(ends, row, n_pos, base, span, &start, &stop)) return;

  load_table(values, masks, row, t, s_val, s_msk);
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
    const unsigned alive =
        p0 < stop ? probe_word(hay, p0, stop, s_val, s_msk, t) : 0u;
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
count_kernel(const uint32_t* __restrict__ hay, long long n_pos,
             const uint32_t* __restrict__ values,
             const uint32_t* __restrict__ masks,
             const int32_t* __restrict__ ends, int32_t* out, int t,
             long long base, long long span) {
  __shared__ uint32_t s_val[kMaxT];
  __shared__ uint32_t s_msk[kMaxT];
  __shared__ unsigned s_warp[kThreads / 32];

  const int row = blockIdx.x;  // the grid holds rows < n_real only
  long long start, stop;
  if (!row_span(ends, row, n_pos, base, span, &start, &stop)) return;

  load_table(values, masks, row, t, s_val, s_msk);
  __syncthreads();

  unsigned count = 0;
  for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
    count += __popc(probe_word(hay, p0, stop, s_val, s_msk, t));
  }
  block_add(count, out + row, s_warp);
}

// One row's match bitmap over one span: each thread's 4 surviving
// positions become a nibble, and the 8 nibbles of a lane group (32
// consecutive positions, since lane l owns positions 4l .. 4l+3 of its
// warp's 128) are merged by three XOR shuffles into one linear word, which
// lane 8g writes.  Only words holding a match are written: the wrapper
// zeroes the output, and a 32-position word never straddles two spans
// (spans are multiples of 1024), so no store races another.
__global__ void __launch_bounds__(kThreads)
match_bitmap_kernel(const uint32_t* __restrict__ hay, long long n_pos,
                    const uint32_t* __restrict__ values,
                    const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ ends, uint32_t* out, int t,
                    long long base, long long span, long long row_words) {
  __shared__ uint32_t s_val[kMaxT];
  __shared__ uint32_t s_msk[kMaxT];

  const int row = blockIdx.x;  // the grid holds rows < n_real only
  long long start, stop;
  if (!row_span(ends, row, n_pos, base, span, &start, &stop)) return;
  load_table(values, masks, row, t, s_val, s_msk);
  __syncthreads();

  uint32_t* bits_row = out + static_cast<long long>(row) * row_words;
  const int sub = threadIdx.x & 7;  // this lane's nibble in its word
  // The walk is block-uniform, so every lane reaches every shuffle.
  for (long long tile = start; tile < stop; tile += kFindTile) {
    const long long p0 = tile + 4LL * threadIdx.x;
    unsigned bits = p0 < stop ? probe_word(hay, p0, stop, s_val, s_msk, t) : 0u;
    bits <<= 4 * sub;
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
    if (sub == 0 && bits != 0u) bits_row[p0 >> 5] = bits;
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

// The same operands as ssf_batched_find; out must hold 0 on entry.
int ssf_batched_count(const void* hay, long long n_pos, const void* values,
                      const void* masks, const void* ends, void* out,
                      int n_real, int t, long long base, long long span,
                      int n_spans, void* stream) {
  if (n_real <= 0 || n_pos <= 0) return static_cast<int>(cudaGetLastError());
  if (t < 1 || t > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_real), static_cast<unsigned>(n_spans));
  count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), n_pos,
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(ends), static_cast<int32_t*>(out), t, base,
      span);
  return static_cast<int>(cudaGetLastError());
}

// The same operands as ssf_batched_find; out: uint32[n_real.., row_words]
// with row_words >= ceil(n_pos / 32), holding 0 on entry.
int ssf_match_bitmap(const void* hay, long long n_pos, const void* values,
                     const void* masks, const void* ends, void* out,
                     int n_real, int t, long long base, long long span,
                     int n_spans, long long row_words, void* stream) {
  if (n_real <= 0 || n_pos <= 0) return static_cast<int>(cudaGetLastError());
  if (t < 1 || t > kMaxT || row_words * 32 < n_pos) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_real), static_cast<unsigned>(n_spans));
  match_bitmap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), n_pos,
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(ends), static_cast<uint32_t*>(out), t, base,
      span, row_words);
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
