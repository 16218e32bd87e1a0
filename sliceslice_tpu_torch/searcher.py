"""Searcher base machinery: preprocess a needle once, search many haystacks.

API parity with the JAX package's ``searcher.py`` (itself the reference's
searcher objects, src/x86.rs:266-526):

* ``Searcher(needle)`` / ``Searcher.with_position(needle, position)``;
* ``search_in(haystack) -> bool`` and ``find(haystack) -> Optional[int]``;
* ``count_in(haystack) -> int``, the number of overlapping occurrences;
* ``positions(haystack)`` / ``find_iter(haystack)``, every overlapping
  occurrence, ascending;
* ``inlined_search_in``, an alias kept for parity;
* empty needles are rejected by concrete searchers and handled by the
  dynamic dispatcher's N0 arm.

Haystacks may be bytes-like or a preprocessed
:class:`~sliceslice_tpu_torch.ops.layout.DeviceHaystack`, which carries its
device.  A bytes-like haystack is laid out on the searcher's ``device``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .config import SENTINEL
from .needle import Needle, NeedleLike, needed_halo, probe_program
from .ops import scan_kernel, torch_backend
from .ops.layout import SHORT_HAY_BYTES, DeviceHaystack, preprocess

HaystackLike = Union[bytes, bytearray, memoryview, np.ndarray, str, DeviceHaystack]
DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a torch.device with its index: ``"cuda"`` names the
    current CUDA device, so it compares equal to a tensor's device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def overlapping_count(data: bytes, needle: bytes) -> int:
    """Host oracle-grade overlapping occurrence count (``bytes.count`` is
    non-overlapping, so it is NOT the right primitive here)."""
    if len(needle) == 0:
        return len(data) + 1
    c = 0
    p = data.find(needle)
    while p != -1:
        c += 1
        p = data.find(needle, p + 1)
    return c


def _host_positions(data: bytes, needle: bytes) -> np.ndarray:
    """Host oracle-grade overlapping match offsets (ascending)."""
    if len(needle) == 0:
        return np.arange(len(data) + 1, dtype=np.int64)
    out = []
    p = data.find(needle)
    while p != -1:
        out.append(p)
        p = data.find(needle, p + 1)
    return np.asarray(out, dtype=np.int64)


def _hay_bytes(hay: HaystackLike) -> bytes:
    if isinstance(hay, str):
        return hay.encode("utf-8")
    if isinstance(hay, np.ndarray):
        if hay.dtype != np.uint8:
            raise TypeError(f"haystack ndarray must be uint8, got {hay.dtype}")
        return hay.tobytes()
    return bytes(hay)


class SearcherBase:
    """Common contract: validation, trivial-length short-circuits, and the
    bytes/DeviceHaystack plumbing.  Subclasses implement ``_find_device``
    and, where they have a device count, ``_count_device``."""

    def __init__(
        self,
        needle: NeedleLike,
        position: Optional[int] = None,
        *,
        device: DeviceLike = "cpu",
    ):
        self.needle = Needle(needle, position)
        self.device = resolve_device(device)

    @classmethod
    def with_position(cls, needle: NeedleLike, position: int, *, device: DeviceLike = "cpu"):
        """Reference ``with_position`` (src/x86.rs:296-316)."""
        return cls(needle, position, device=device)

    @property
    def size(self) -> int:
        return self.needle.size

    @property
    def position(self) -> int:
        return self.needle.position

    def search_in(self, hay: HaystackLike) -> bool:
        return self.find(hay) is not None

    #: #[inline] variant kept for API parity (reference src/x86.rs:353-356).
    inlined_search_in = search_in

    def find(self, hay: HaystackLike) -> Optional[int]:
        k = self.needle.size
        if isinstance(hay, DeviceHaystack):
            if hay.length <= k:
                return self._trivial_find(hay.host_bytes, k)
            off = int(self._find_device(hay))
            return None if off >= SENTINEL else off
        data = _hay_bytes(hay)
        if len(data) <= k:
            return self._trivial_find(data, k)
        off = int(self._find_device(self._layout(data)))
        return None if off >= SENTINEL else off

    def count_in(self, hay: HaystackLike) -> int:
        """Number of OVERLAPPING occurrences of the needle (the JAX
        package's extension of the reference's bool ``search_in``).  A
        layout on the card is counted on the card, a flat rung re-laid
        there into the kernel layout.  Elsewhere a searcher without a
        device count (``_count_device`` raises ``NotImplementedError``),
        and any flat layout, counts on the host, as in the JAX package."""
        k = self.needle.size
        if isinstance(hay, DeviceHaystack):
            if hay.length <= k:
                return self._trivial_count(hay.host_bytes, k)
            if hay.device.type == "cuda":
                return int(self._count_device(hay.kernel_layout(needed_halo(k))))
            if hay.tiled:
                try:
                    return int(self._count_device(hay))
                except NotImplementedError:
                    pass
            data = hay.host_bytes
            if data is None:
                raise ValueError(
                    "counting on this DeviceHaystack requires host bytes "
                    "(preprocess with keep_host=True)"
                )
            return overlapping_count(data, self.needle.data)
        data = _hay_bytes(hay)
        if len(data) <= k:
            return self._trivial_count(data, k)
        if len(data) <= SHORT_HAY_BYTES:
            return overlapping_count(data, self.needle.data)
        dh = self._layout(data)
        try:
            return int(self._count_device(dh))
        except NotImplementedError:
            return overlapping_count(data, self.needle.data)

    def positions(self, hay: HaystackLike) -> np.ndarray:
        """ALL (overlapping) match offsets, ascending (int64[M]) — the
        ``find_iter`` capability of memchr-class libraries.  Device path:
        one match bitmap per needle (the match-bitmap kernel on the card),
        read back as the ``SPARSE_POSITIONS_CAP`` earliest offsets when the
        needle has no more, else whole and decoded on the host.  Host bytes
        of at most ``SHORT_HAY_BYTES`` are scanned on the host, as are a
        flat layout and a trivially short haystack off the card; a flat
        layout on the card is re-laid there (``kernel_layout``)."""
        k = self.needle.size
        if isinstance(hay, DeviceHaystack):
            if hay.length <= k or not (hay.tiled or hay.device.type == "cuda"):
                data = hay.host_bytes
                if data is None:
                    raise ValueError(
                        "positions on this DeviceHaystack requires host "
                        "bytes (preprocess with keep_host=True)"
                    )
                return _host_positions(data, self.needle.data)
            dh = hay.kernel_layout(needed_halo(k))
        else:
            data = _hay_bytes(hay)
            if len(data) <= SHORT_HAY_BYTES:
                return _host_positions(data, self.needle.data)
            dh = self._layout(data)
        return self._positions_device(dh)

    def find_iter(self, hay: HaystackLike):
        """Iterator over all (overlapping) match offsets, ascending."""
        return iter(self.positions(hay).tolist())

    #: The wrapper that makes a match bitmap for :meth:`positions`.
    _bitmap = staticmethod(scan_kernel.match_bitmap)

    def _positions_device(self, dh: DeviceHaystack) -> np.ndarray:
        values, masks = probe_program(self.needle.data)
        end = np.asarray([dh.length - self.needle.size + 1], np.int32)
        return torch_backend.two_tier_positions(
            dh.flat, np.asarray([values], np.uint32), np.asarray([masks], np.uint32), end,
            torch_backend.SPARSE_POSITIONS_CAP, self._bitmap,
        )[0]

    def _trivial_count(self, data: Optional[bytes], k: int) -> int:
        if data is None:
            raise ValueError(
                "DeviceHaystack shorter than needle requires host bytes "
                "(preprocess with keep_host=True)"
            )
        if len(data) < k:
            return 0
        return 1 if data == self.needle.data else 0

    def _count_device(self, dh: DeviceHaystack):
        raise NotImplementedError

    def _trivial_find(self, data: Optional[bytes], k: int) -> Optional[int]:
        # hay shorter than needle -> no match; equal length -> whole-slice
        # equality (reference src/x86.rs:356-359).
        if data is None:
            raise ValueError(
                "DeviceHaystack shorter than needle requires host bytes "
                "(preprocess with keep_host=True)"
            )
        if len(data) < k:
            return None
        return 0 if data == self.needle.data else None

    def _layout(self, data: bytes) -> DeviceHaystack:
        # One-slot layout cache: repeated searches of the SAME bytes object
        # reuse one upload.  Keyed by identity with the bytes kept alive in
        # the slot, so ids can't alias.
        slot = getattr(self, "_dh_slot", None)
        if slot is not None and slot[0] is data:
            return slot[1]
        dh = preprocess(data, kh=needed_halo(self.needle.size), device=self.device)
        self._dh_slot = (data, dh)
        return dh

    def _find_device(self, dh: DeviceHaystack):
        raise NotImplementedError

    def __repr__(self):
        return (
            f"{type(self).__name__}(needle={self.needle.data!r}, "
            f"position={self.needle.position})"
        )


class EmptyNeedleSearcher:
    """N0 arm: the empty needle matches every haystack at offset 0
    (reference src/x86.rs:470,500).  Only reachable via dynamic dispatch."""

    size = 0
    position = 0

    def search_in(self, hay: HaystackLike) -> bool:
        return True

    inlined_search_in = search_in

    def find(self, hay: HaystackLike) -> Optional[int]:
        return 0

    def count_in(self, hay: HaystackLike) -> int:
        # The empty needle matches at every gap: len + 1 positions.
        if isinstance(hay, DeviceHaystack):
            return hay.length + 1
        return len(_hay_bytes(hay)) + 1

    def positions(self, hay: HaystackLike) -> np.ndarray:
        n = hay.length if isinstance(hay, DeviceHaystack) else len(_hay_bytes(hay))
        return np.arange(n + 1, dtype=np.int64)

    def find_iter(self, hay: HaystackLike):
        return iter(self.positions(hay).tolist())

    def __repr__(self):
        return "EmptyNeedleSearcher()"
