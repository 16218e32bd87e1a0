"""The kernel searcher family: the find kernel behind the reference's
``Avx2Searcher``-shaped API (src/x86.rs:266-395), the counterpart of the JAX
package's ``PallasSearcher``.

Like the reference's per-haystack-length ladder (src/x86.rs:361-375),
``CudaSearcher`` short-circuits trivial haystack lengths; every other
haystack, short or long, runs the find kernel with a one-row probe table
over the one layout.  ``count_in`` runs the count kernel with the same
table, where the layout lives.

``Searcher2`` .. ``Searcher16`` are the analogue of the reference's
const-specialized N2..N16 arms (src/x86.rs:411-439): each pins its needle
length, and its table has exactly ``ceil(k/4)`` probe slots.
"""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import scan_kernel
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase

#: Needle lengths with a dedicated specialized class (reference N2..N16).
SPECIALIZED_SIZES = tuple(range(2, 17))


class CudaSearcher(SearcherBase):
    """Generic single-needle searcher (the reference's fallback ``N`` arm)."""

    def __init__(self, needle, position=None, *, device="cuda"):
        super().__init__(needle, position, device=device)
        if self.needle.size == 0:
            raise ValueError(
                "empty needle (reference: Avx2Searcher::new panics, src/x86.rs:300)"
            )
        vals, msks = probe_program(self.needle.data)
        self._values = np.asarray([vals], np.uint32)
        self._masks = np.asarray([msks], np.uint32)

    def _find_device(self, dh: DeviceHaystack):
        k = self.needle.size
        end = dh.length - k + 1
        dh = dh.ensure_kh(k)
        return scan_kernel.batched_find(
            dh.flat, self._values, self._masks, np.asarray([end], np.int32)
        )[0]

    def _count_device(self, dh: DeviceHaystack):
        k = self.needle.size
        end = dh.length - k + 1
        dh = dh.ensure_kh(k)
        return scan_kernel.batched_count(
            dh.flat, self._values, self._masks, np.asarray([end], np.int32)
        )[0]


def _make_specialized(k: int):
    class _Specialized(CudaSearcher):
        def __init__(self, needle, position=None, *, device="cuda"):
            super().__init__(needle, position, device=device)
            if self.needle.size != k:
                raise ValueError(
                    f"{type(self).__name__} requires needle length {k}, got "
                    f"{self.needle.size} (reference SIZE/len assert, "
                    "src/x86.rs:303-305)"
                )

    _Specialized.__name__ = f"Searcher{k}"
    _Specialized.__qualname__ = f"Searcher{k}"
    return _Specialized


#: SearcherK classes for k in 2..=16 — the reference's N2..N16 family.
SPECIALIZED = {k: _make_specialized(k) for k in SPECIALIZED_SIZES}


def searcher_for_size(k: int):
    """Class implementing the specialization for needle length k (generic
    CudaSearcher when no dedicated variant exists)."""
    return SPECIALIZED.get(k, CudaSearcher)
