// The count and bitmap kernels of tables of 5 to kMaxGroupT slots
// (needles of 17-32 bytes), whose group walk filters each position on
// slots 0 and 1 (csrc/queue.cuh group_loop, kFilterSlots), for sm_90a.
// csrc/find.cu's queue_kernel_for reaches them through
// ssf_group_wide_kernel; their design is find.cu's.  They are a
// translation unit of their own so that nvcc builds them beside find.cu's
// narrower ones (ops/cuda_lib.py compiles every source in parallel).

#include <cstdint>
#include <cuda_runtime.h>

#include "queue.cuh"

extern "C" {

// The count or bitmap kernel (mode 1 or 2) of width t, kMaxRegT < t <=
// kMaxGroupT, taking `group` rows an item (1 or kGroupRows); nullptr for
// any other.
void* ssf_group_wide_kernel(int mode, int t, int group) {
  if (mode != kCountMode && mode != kBitmapMode) return nullptr;
  static_assert(kMaxRegT == 4 && kMaxGroupT == 8, "one case per width below");
  switch (t) {
    case 5: return group_fn<5>(mode, group);
    case 6: return group_fn<6>(mode, group);
    case 7: return group_fn<7>(mode, group);
    case 8: return group_fn<8>(mode, group);
  }
  return nullptr;
}

}  // extern "C"
