"""Searcher base machinery: preprocess a needle once, search many haystacks.

API parity with the JAX package's ``searcher.py`` (itself the reference's
searcher objects, src/x86.rs:266-526):

* ``Searcher(needle)`` / ``Searcher.with_position(needle, position)``;
* ``search_in(haystack) -> bool`` and ``find(haystack) -> Optional[int]``;
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
from .needle import Needle, NeedleLike, needed_halo
from .ops.layout import DeviceHaystack, preprocess

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
    bytes/DeviceHaystack plumbing.  Subclasses implement ``_find_device``."""

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

    def __repr__(self):
        return "EmptyNeedleSearcher()"
