// Ablation kernel of the port's find and count loop, for sm_90a, behind a
// plain C interface loaded with ctypes (sliceslice_tpu_torch/ops/cuda_lib.py).
//
// It replaces scripts/kernel_probe.py::build, the JAX package's stripped
// copy of its TPU find kernel, which removes one piece of that kernel at a
// time to find which piece costs time.  The TPU pieces (DMA double
// buffering, packed windows, the 128-lane min, SMEM tables) do not exist on
// the card, so the pieces stripped here are those of the port's own loop:
// probe_word (scan_common.cuh) walked as the first count kernel walked it,
// one block per (row, span), 256 threads, 4 positions per thread per step.
// Each variant asks the question of one JAX variant:
//
//   count       that first count loop as is (baseline)             = batched_count
//   first       JAX full: probes, a first-offset min per thread, a block
//               min and atomicMin, no early exit                  = batched_find
//   nomin       JAX nomin: probes, OR of the alive bits, one flag per row
//                                                   = (batched_find != SENTINEL)
//   noprobe     JAX noprobe: probe_word's loads and address math with the
//               table replaced by the constant 0xFFFFFFFF: counts the
//               positions whose 4-byte window is all ones
//   empty       JAX empty: the walk and address math only, no corpus load:
//               XORs the word indices a row visits (a sum of ones would be
//               folded into the trip count and the loop removed)
//   nomask      JAX premask: no AND on slots whose mask is all ones; only a
//               partial slot (in practice the final one) is masked = count
//   branchless  JAX premsel: every slot of every position evaluated with
//               selects, no early exit across slots               = count
//   rows<R>     JAX dedup: R rows per block share each loaded word (the
//               "needles sharing a staged corpus tile" question)  = count
//   regtab<T>   JAX swpipe: the table read into registers before the loop
//               (t = T <= 4, unrolled) instead of from shared memory = count
//   wide        the find and count kernels' loop, probe_wide: 16 positions
//               per thread from one 16-byte load plus one word per slot,
//               on this kernel's plan                             = count
//
// Every variant writes a value derived from its loop, so none can be
// compiled away; ptxas' report (-Xptxas -v, kept in the build log) gives
// each instantiation's registers.  What bounds them is what bounds the
// count kernel: the issue rate of the per-word loop (PERF.md §5), which is
// the quantity the variants split.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

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
  kRegtab = 8,
  kWide = 9,
};

constexpr int kMaxRows = 8;  // rows per block, rows<R>

// The block's minimum of `v` (kSentinel where no thread has one) into
// *out with one atomicMin.
__device__ __forceinline__ void block_min(int v, long long add, int32_t* out,
                                          unsigned* s_warp) {
  v = static_cast<int>(__reduce_min_sync(0xffffffffu, static_cast<unsigned>(v)));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = static_cast<unsigned>(v);
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned m = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0xffffffffu;
    m = __reduce_min_sync(0xffffffffu, m);
    if (threadIdx.x == 0 && m < static_cast<unsigned>(kSentinel)) {
      atomicMin(out, static_cast<int>(m + add));
    }
  }
}

// The block's XOR of `v` into *out with one atomicXor.
__device__ __forceinline__ void block_xor(unsigned v, int32_t* out, unsigned* s_warp) {
  v = __reduce_xor_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned x = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0u;
    x = __reduce_xor_sync(0xffffffffu, x);
    if (threadIdx.x == 0 && x != 0u) atomicXor(out, static_cast<int>(x));
  }
}

// probe_word without the AND on all-ones slots (nomask), or with every slot
// evaluated by selects and no early exit (branchless).
template <int V>
__device__ __forceinline__ unsigned probe_word_variant(const uint32_t* __restrict__ hay,
                                                       long long p0, long long stop,
                                                       const uint32_t* s_val,
                                                       const uint32_t* s_msk, int t) {
  unsigned alive = live_bits(stop - p0, 4);
  const long long j = p0 >> 2;
  uint32_t lo = __ldg(hay + j);
  if (V == kNomask) {
    for (int i = 0; i < t && alive; ++i) {
      const uint32_t hi = __ldg(hay + j + i + 1);
      const uint32_t m = s_msk[i];
      const uint32_t v = s_val[i];
      if (m == 0xffffffffu) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (__funnelshift_r(lo, hi, 8 * r) != v) alive &= ~(1u << r);
        }
      } else if (m != 0u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if ((__funnelshift_r(lo, hi, 8 * r) & m) != v) alive &= ~(1u << r);
        }
      }
      lo = hi;
    }
  } else {  // kBranchless
    for (int i = 0; i < t; ++i) {
      const uint32_t hi = __ldg(hay + j + i + 1);
      const uint32_t m = s_msk[i];
      const uint32_t v = s_val[i];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned miss = (__funnelshift_r(lo, hi, 8 * r) & m) != v;
        alive &= ~(miss << r);
      }
      lo = hi;
    }
  }
  return alive;
}

// rows<R>: the R rows of one block evaluated at the same 4 positions, each
// word loaded once for all of them.  alive[q] holds row q's survivors.
template <int R>
__device__ __forceinline__ void probe_word_rows(const uint32_t* __restrict__ hay,
                                                long long p0, const long long* stop,
                                                const uint32_t* s_val,
                                                const uint32_t* s_msk, int t,
                                                unsigned* alive) {
  unsigned any = 0u;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    alive[q] = live_bits(stop[q] - p0, 4);
    any |= alive[q];
  }
  const long long j = p0 >> 2;
  uint32_t lo = __ldg(hay + j);
  for (int i = 0; i < t && any; ++i) {
    const uint32_t hi = __ldg(hay + j + i + 1);
    any = 0u;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const uint32_t m = s_msk[q * t + i];
      const uint32_t v = s_val[q * t + i];
      if (alive[q] && m != 0u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if ((__funnelshift_r(lo, hi, 8 * r) & m) != v) alive[q] &= ~(1u << r);
        }
      }
      any |= alive[q];
    }
    lo = hi;
  }
}

template <int V, int P>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ hay, long long n_pos,
             const uint32_t* __restrict__ values,
             const uint32_t* __restrict__ masks,
             const int32_t* __restrict__ ends, int32_t* out, int n_real, int t,
             long long base, long long span) {
  constexpr int kTab = V == kRows ? P * kMaxT : (V == kRegtab ? 1 : kMaxT);
  __shared__ uint32_t s_val[kTab];
  __shared__ uint32_t s_msk[kTab];
  __shared__ unsigned s_warp[(V == kRows ? P : 1) * (kThreads / 32)];

  if constexpr (V == kRows) {
    const int row0 = blockIdx.x * P;
    const long long start = static_cast<long long>(blockIdx.y) * span;
    long long stop[P];
    long long last = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      long long lim = row0 + q < n_real ? static_cast<long long>(ends[row0 + q]) - base : 0;
      if (lim > n_pos) lim = n_pos;
      stop[q] = start + span < lim ? start + span : lim;
      if (stop[q] > last) last = stop[q];
    }
    if (start >= last) return;
    for (int q = 0; q < P && row0 + q < n_real; ++q) {
      load_table(values, masks, row0 + q, t, s_val + q * t, s_msk + q * t);
    }
    __syncthreads();
    unsigned count[P] = {};
    unsigned alive[P];
    for (long long p0 = start + 4LL * threadIdx.x; p0 < last; p0 += kFindTile) {
      probe_word_rows<P>(hay, p0, stop, s_val, s_msk, t, alive);
#pragma unroll
      for (int q = 0; q < P; ++q) count[q] += __popc(alive[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (row0 + q < n_real) block_add(count[q], out + row0 + q, s_warp + q * (kThreads / 32));
    }
    return;
  } else {
    const int row = blockIdx.x;  // the grid holds rows < n_real only
    long long start, stop;
    if (!row_span(ends, row, n_pos, base, span, &start, &stop)) return;

    if constexpr (V == kEmpty) {
      unsigned x = 0u;
      for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
        x ^= static_cast<unsigned>(p0 >> 2);
      }
      block_xor(x, out + row, s_warp);
    } else if constexpr (V == kNoprobe) {
      const uint32_t ones[1] = {0xffffffffu};
      unsigned count = 0u;
      for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
        count += __popc(probe_word<1>(hay, p0, stop, ones, ones, 1));
      }
      block_add(count, out + row, s_warp);
    } else if constexpr (V == kRegtab) {
      uint32_t val[P], msk[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        val[i] = __ldg(values + static_cast<long long>(row) * P + i);
        msk[i] = __ldg(masks + static_cast<long long>(row) * P + i);
      }
      unsigned count = 0u;
      for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
        count += __popc(probe_word<P>(hay, p0, stop, val, msk, P));
      }
      block_add(count, out + row, s_warp);
    } else {
      load_table(values, masks, row, t, s_val, s_msk);
      __syncthreads();
      if constexpr (V == kWide) {
        // The find and count kernels' loop (probe_wide) on this plan; n_pos
        // is 4 * (n_words - t), so the buffer holds n_pos / 4 + t words.
        const int n_words = static_cast<int>(n_pos >> 2) + t;
        unsigned count = 0u;
        for (long long p0 = start + 16LL * threadIdx.x; p0 < stop; p0 += kWideTile) {
          count += __popc(probe_wide(hay, n_words, static_cast<int>(p0),
                                     static_cast<int>(stop), s_val, s_msk, t));
        }
        block_add(count, out + row, s_warp);
      } else if constexpr (V == kFirst) {
        int best = kSentinel;  // relative to start
        for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
          const unsigned a = probe_word(hay, p0, stop, s_val, s_msk, t);
          if (a) best = min(best, static_cast<int>(p0 - start) + __ffs(a) - 1);
        }
        block_min(best, start + base, out + row, s_warp);
      } else if constexpr (V == kNomin) {
        unsigned any = 0u;
        for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
          any |= probe_word(hay, p0, stop, s_val, s_msk, t);
        }
        if (__syncthreads_or(any != 0u) && threadIdx.x == 0) atomicOr(out + row, 1);
      } else {  // kCount, kNomask, kBranchless
        unsigned count = 0u;
        for (long long p0 = start + 4LL * threadIdx.x; p0 < stop; p0 += kFindTile) {
          count += __popc(V == kCount ? probe_word(hay, p0, stop, s_val, s_msk, t)
                                      : probe_word_variant<V>(hay, p0, stop, s_val, s_msk, t));
        }
        block_add(count, out + row, s_warp);
      }
    }
  }
}

template <int V, int P = 0>
int launch(dim3 grid, cudaStream_t stream, const void* hay, long long n_pos,
           const void* values, const void* masks, const void* ends, void* out,
           int n_real, int t, long long base, long long span) {
  probe_kernel<V, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(hay), n_pos, static_cast<const uint32_t*>(values),
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(ends),
      static_cast<int32_t*>(out), n_real, t, base, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// variant: one of Variant; param: R for rows (1, 2, 4, 8), ignored
// otherwise (regtab takes T = t).  The operands are those of
// ssf_batched_count; out must hold SENTINEL on entry for first and 0 for
// every other variant.  n_pos: positions whose windows lie in hay,
// 4 * (n_words - t).  span: positions per block, a multiple of 4096 for
// wide and of 1024 otherwise; n_spans: blocks per row (per R rows for
// rows).
int ssf_probe(int variant, int param, const void* hay, long long n_pos,
              const void* values, const void* masks, const void* ends, void* out,
              int n_real, int t, long long base, long long span, int n_spans,
              void* stream) {
  if (n_real <= 0 || n_pos <= 0) return static_cast<int>(cudaGetLastError());
  if (t < 1 || t > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_real), static_cast<unsigned>(n_spans));
#define SSF_LAUNCH(V, P) launch<V, P>(grid, s, hay, n_pos, values, masks, ends, out, n_real, t, base, span)
  switch (variant) {
    case kCount: return SSF_LAUNCH(kCount, 0);
    case kFirst: return SSF_LAUNCH(kFirst, 0);
    case kNomin: return SSF_LAUNCH(kNomin, 0);
    case kNoprobe: return SSF_LAUNCH(kNoprobe, 0);
    case kEmpty: return SSF_LAUNCH(kEmpty, 0);
    case kNomask: return SSF_LAUNCH(kNomask, 0);
    case kBranchless: return SSF_LAUNCH(kBranchless, 0);
    case kWide: return SSF_LAUNCH(kWide, 0);
    case kRegtab:
      switch (t) {
        case 1: return SSF_LAUNCH(kRegtab, 1);
        case 2: return SSF_LAUNCH(kRegtab, 2);
        case 3: return SSF_LAUNCH(kRegtab, 3);
        case 4: return SSF_LAUNCH(kRegtab, 4);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    case kRows: {
      if (param < 1 || param > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
      const dim3 rgrid(static_cast<unsigned>((n_real + param - 1) / param),
                       static_cast<unsigned>(n_spans));
#define SSF_ROWS(R) launch<kRows, R>(rgrid, s, hay, n_pos, values, masks, ends, out, n_real, t, base, span)
      switch (param) {
        case 1: return SSF_ROWS(1);
        case 2: return SSF_ROWS(2);
        case 4: return SSF_ROWS(4);
        case 8: return SSF_ROWS(8);
      }
      return static_cast<int>(cudaErrorInvalidValue);
#undef SSF_ROWS
    }
  }
#undef SSF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
