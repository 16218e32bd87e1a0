"""Single-byte searcher — the ``MemchrSearcher`` analogue (src/lib.rs:119-142):
a dedicated 1-byte path through the memchr kernel, which compares raw bytes
with no window building."""

from __future__ import annotations

from ..needle import probe_program
from ..ops import scan_kernel, torch_backend
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase


class MemchrSearcher(SearcherBase):
    def __init__(self, needle, position=None, *, device="cpu"):
        super().__init__(needle, position, device=device)
        if self.needle.size != 1:
            raise ValueError(
                f"MemchrSearcher requires a 1-byte needle, got {self.needle.size}"
            )
        self._byte = self.needle.data[0]

    def _find_device(self, dh: DeviceHaystack):
        end = dh.length  # end = len - k + 1 with k = 1
        if not dh.tiled:
            vals, msks = probe_program(self.needle.data)
            return torch_backend.find_flat(dh.flat, vals, msks, end)
        return scan_kernel.memchr_find(dh.flat, self._byte, end)
