"""Dynamic needle-length dispatch — the ``DynamicAvx2Searcher`` analogue
(src/x86.rs:397-526): pick the right specialization at construction time.

Arms: empty needle -> always-true N0 (src/x86.rs:470,500); one byte ->
MemchrSearcher (src/x86.rs:471-475); 2..=16 -> the specialized kernel
searchers (src/x86.rs:476-490); otherwise the generic kernel searcher
(src/x86.rs:491); needles longer than ``MAX_NEEDLE_LEN`` -> the
huge-needle filter and verify (models/huge.py), the reference's arbitrary
needle lengths (src/lib.rs:52-59).

Haystacks of at most :data:`HOST_HAY_BYTES` that arrive as host bytes are
searched on the host by the native SWAR tier (utils/native.py), and counted
and scanned for positions on the host: a device round trip costs more than
a sub-4 KB host scan.
Preprocessed :class:`DeviceHaystack` inputs always take the device path.
"""

from __future__ import annotations

from typing import Optional

from ..needle import MAX_NEEDLE_LEN, NeedleLike, as_bytes
from ..ops.layout import DeviceHaystack
from ..searcher import (
    EmptyNeedleSearcher,
    HaystackLike,
    _hay_bytes,
    _host_positions,
    overlapping_count,
    resolve_device,
)
from .cuda_searcher import searcher_for_size
from .huge import HugeNeedleSearcher
from .memchr import MemchrSearcher
from .naive import naive_find

#: Host-bytes haystacks at or below this size skip the device entirely.
HOST_HAY_BYTES = 4096


class DynamicSearcher:
    def __init__(
        self, needle: NeedleLike, position: Optional[int] = None, *, device="cuda"
    ):
        device = resolve_device(device)  # raises without a card unless "cpu"
        data = as_bytes(needle)
        #: the full needle bytes: a huge needle's ``_inner.needle.data``
        #: holds only its device-filter prefix, so the host rungs read this.
        self._data = data
        k = len(data)
        if k == 0:
            if position not in (None, 0):
                raise ValueError("invalid position for empty needle")
            self._inner = EmptyNeedleSearcher()
        elif k == 1:
            self._inner = MemchrSearcher(data, position, device=device)
        elif k > MAX_NEEDLE_LEN:
            self._inner = HugeNeedleSearcher(data, position, device=device)
        else:
            self._inner = searcher_for_size(k)(data, position, device=device)

    @classmethod
    def with_position(cls, needle: NeedleLike, position: int, *, device="cuda"):
        return cls(needle, position, device=device)

    @property
    def inner(self):
        return self._inner

    @property
    def size(self) -> int:
        return self._inner.size

    @property
    def position(self) -> int:
        return self._inner.position

    def search_in(self, hay: HaystackLike) -> bool:
        return self.find(hay) is not None

    inlined_search_in = search_in

    def find(self, hay: HaystackLike) -> Optional[int]:
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                return self._host_find(data)
        return self._inner.find(hay)

    def count_in(self, hay: HaystackLike) -> int:
        """Overlapping occurrence count (see ``SearcherBase.count_in``);
        host-bytes haystacks of at most :data:`HOST_HAY_BYTES` count on the
        host."""
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                return overlapping_count(data, self._data)
        return self._inner.count_in(hay)

    def positions(self, hay: HaystackLike):
        """All (overlapping) match offsets, ascending (see
        ``SearcherBase.positions``); host-bytes haystacks of at most
        :data:`HOST_HAY_BYTES` are scanned on the host."""
        if self._inner.size and not isinstance(hay, DeviceHaystack):
            data = _hay_bytes(hay)
            if len(data) <= HOST_HAY_BYTES:
                return _host_positions(data, self._data)
        return self._inner.positions(hay)

    def find_iter(self, hay: HaystackLike):
        return iter(self.positions(hay).tolist())

    def _host_find(self, data: bytes) -> Optional[int]:
        from ..utils import native

        if native.available():
            return native.swar_find(data, self._data, self._inner.position)
        return naive_find(data, self._data)

    def __repr__(self):
        return f"DynamicSearcher({self._inner!r})"
