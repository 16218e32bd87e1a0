"""Single-byte searcher — the ``MemchrSearcher`` analogue (src/lib.rs:119-142):
a dedicated 1-byte path through the memchr kernel, which compares raw bytes
with no window building.  Counts go through the count kernel with the
1-byte probe table, as in the JAX package."""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import scan_kernel
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase


class MemchrSearcher(SearcherBase):
    def __init__(self, needle, position=None, *, device="cuda"):
        super().__init__(needle, position, device=device)
        if self.needle.size != 1:
            raise ValueError(
                f"MemchrSearcher requires a 1-byte needle, got {self.needle.size}"
            )
        self._byte = self.needle.data[0]

    def _find_device(self, dh: DeviceHaystack):
        return scan_kernel.memchr_find(dh.flat, self._byte, dh.length)  # end = len - k + 1, k = 1

    def _count_device(self, dh: DeviceHaystack):
        vals, msks = probe_program(self.needle.data)
        return scan_kernel.batched_count(
            dh.flat,
            np.asarray([vals], np.uint32),
            np.asarray([msks], np.uint32),
            np.asarray([dh.length], np.int32),
        )[0]
