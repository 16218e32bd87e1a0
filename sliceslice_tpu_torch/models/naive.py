"""Naive oracle searcher — the test oracle, equivalent to the reference's
``haystack.windows(needle.len()).position(|w| w == needle)`` oracle
(tests/i386.rs:6-16, src/lib.rs:370-374).  CPython's ``bytes.find`` is an
independent, exact implementation, so differential tests against it cannot
share a bug with the probe kernels."""

from __future__ import annotations

from typing import Optional

from ..ops.layout import DeviceHaystack
from ..searcher import HaystackLike, SearcherBase, _hay_bytes


class NaiveSearcher(SearcherBase):
    def __init__(self, needle, position=None, *, device="cpu"):
        super().__init__(needle, position, device=device)
        if self.needle.size == 0:
            raise ValueError("empty needle")

    def find(self, hay: HaystackLike) -> Optional[int]:
        if isinstance(hay, DeviceHaystack):
            if hay.host_bytes is None:
                raise ValueError("NaiveSearcher needs host bytes")
            data = hay.host_bytes
        else:
            data = _hay_bytes(hay)
        pos = data.find(self.needle.data)
        return None if pos < 0 else pos


def naive_find(hay: bytes, needle: bytes) -> Optional[int]:
    """Module-level oracle used throughout the tests."""
    if len(needle) == 0:
        return 0
    pos = hay.find(needle)
    return None if pos < 0 else pos
