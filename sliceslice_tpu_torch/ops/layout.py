"""Haystack device layout: one flat, zero-padded uint8 tensor.

The JAX package lays the corpus out column-major over the TPU's 128 lanes,
with halo rows per segment and precomputed 4x-sized packed windows.  All of
that serves the TPU's vector unit.  On Hopper the natural layout is the
byte stream itself: the find kernel builds each unaligned 4-byte window
from two aligned 32-bit loads, so the port keeps the semantics of the
layout and nothing else:

* ``length`` logical bytes, followed by at least ``kh`` zero bytes of halo
  (``kh`` >= ``needed_halo_for_t(t)`` for every probe table searched over
  it), rounded up to a multiple of :data:`ALIGN` bytes so that word and
  16-byte loads never leave the buffer;
* every haystack takes this one layout, from 0 bytes up: the JAX
  package's flat rung for short haystacks serves the minimum size of its
  TPU tiles, which this layout does not have;
* a single layout keeps every position inside int32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

#: Minimum halo: a window reads the 3 bytes after its position.
MIN_KH = 3
#: Default halo supports needles up to 64 bytes without relayout.
DEFAULT_KH = 64
#: Host bytes of at most this many bytes handed to a single-needle
#: searcher's ``count_in`` or ``positions`` are scanned on the host (the
#: JAX package's threshold, kept as that policy only: it picks no layout).
SHORT_HAY_BYTES = 8192
#: Buffer sizes are multiples of this many bytes (the kernels' 16-byte
#: loads and word pairs stay inside the buffer).
ALIGN = 128

#: A single device layout must keep every position (including trailing pad)
#: inside int32 — the kernels' offset math and SENTINEL live there.
MAX_DEVICE_POSITIONS = 2**31 - 1


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device with its index: ``"cuda"`` names the
    current CUDA device, so it compares equal to a tensor's device.  The
    port's entry points default to ``"cuda"``; without a card that raises,
    and the CPU (the kernels' plain versions) is used only when asked for."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device; pass device='cpu' to run the plain versions")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_total(length: int, kh: int) -> int:
    """Buffer bytes of the layout :func:`preprocess` builds for a corpus of
    ``length`` bytes: the corpus plus its rounded halo plus one aligned
    block of slack."""
    kh_r = round_up(max(kh, MIN_KH), 32)
    return round_up(length + kh_r, ALIGN) + ALIGN


@dataclasses.dataclass
class DeviceHaystack:
    """A haystack resident on one device, preprocessed once and searched many
    times (the analogue of the reference's mmap-once-scan-often usage,
    examples/grep.rs:49-50)."""

    length: int
    kh: int
    #: uint8 (padded_total,) on ``device``; bytes past ``length`` are zero.
    flat: torch.Tensor
    host_bytes: Optional[bytes] = None
    #: one-slot cache for ensure_halo re-lays: repeated calls reuse one
    #: widened layout instead of copying the corpus per call.
    _rehalo: Optional["DeviceHaystack"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @classmethod
    def from_buffer(cls, flat: torch.Tensor, length: int, kh: int,
                    host_bytes: Optional[bytes] = None) -> "DeviceHaystack":
        """The layout of a ``length``-byte corpus that already lies in
        ``flat``, with no copy and no allocation: ``flat`` is uint8 of
        ``padded_total(length, kh)`` bytes, and its bytes past ``length``
        must be zero (a streamed window in a pooled
        buffer, utils/streaming.py)."""
        kh = round_up(max(kh, MIN_KH), 32)
        total = padded_total(length, kh)
        if flat.dtype != torch.uint8 or flat.dim() != 1 or flat.numel() != total:
            raise ValueError(f"a {length}-byte layout takes a 1-D uint8 buffer of {total} bytes")
        return cls(length=length, kh=kh, flat=flat, host_bytes=host_bytes)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def supports_needle_len(self, k: int) -> bool:
        from ..needle import needed_halo

        return needed_halo(k) <= self.kh

    def ensure_halo(self, min_kh: int) -> "DeviceHaystack":
        """Return a layout with at least ``min_kh`` halo bytes: this one
        when it suffices, else this one re-laid on its own device from its
        device bytes, with no host copy (cached on this object, so repeated
        sweeps reuse ONE widened layout)."""
        if self.kh >= min_kh:
            return self
        if self._rehalo is not None and self._rehalo.kh >= min_kh:
            return self._rehalo
        kh = round_up(max(min_kh, MIN_KH), 32)
        flat = torch.zeros((padded_total(self.length, kh),), dtype=torch.uint8, device=self.device)
        flat[: self.length] = self.flat[: self.length]
        self._rehalo = DeviceHaystack(self.length, kh, flat, self.host_bytes)
        return self._rehalo

    def ensure_kh(self, k: int) -> "DeviceHaystack":
        """Return a layout whose halo supports needles of length ``k``."""
        from ..needle import needed_halo

        return self.ensure_halo(needed_halo(k))


def preprocess(
    hay: Union[bytes, bytearray, memoryview, np.ndarray],
    kh: int = DEFAULT_KH,
    keep_host: bool = True,
    force_cols: bool = False,
    length: Optional[int] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> DeviceHaystack:
    """Build the layout of a haystack on ``device`` (the card unless the
    caller passes ``device="cpu"``).  O(len) once, amortized over all
    later searches.

    ``force_cols``: accepted for the JAX package's callers and has no
    effect, since every haystack takes the one layout (in the JAX package
    it forces its tiled layout on a short haystack).

    ``length``: logical corpus length when ``hay`` is an ndarray LONGER
    than it (a caller-padded buffer).

    ``keep_host``: retain the host bytes, which the trivial-length rules
    and host verify steps of the searchers read."""
    if isinstance(hay, np.ndarray):
        if hay.dtype != np.uint8:
            raise TypeError(f"haystack ndarray must be uint8, got {hay.dtype}")
        arr = hay.reshape(-1)
        data = None
        length = arr.size if length is None else int(length)
        if length > arr.size:
            raise ValueError(f"length={length} exceeds the {arr.size}-byte buffer")
    else:
        data = bytes(hay)
        if length is not None and length != len(data):
            raise ValueError("length only applies to pre-padded ndarrays")
        length = len(data)
        arr = np.frombuffer(data, dtype=np.uint8)
    device = resolve_device(device)
    kh = round_up(max(kh, MIN_KH), 32)
    total = padded_total(length, kh)
    if total > MAX_DEVICE_POSITIONS:
        raise ValueError(
            f"haystack of {length} bytes exceeds the int32 position range of "
            "a single device layout"
        )
    flat = torch.zeros((total,), dtype=torch.uint8, device=device)
    if length:
        flat[:length] = torch.from_numpy(np.array(arr[:length], copy=True)).to(device)
    if keep_host:
        host = data if data is not None else arr[:length].tobytes()
    else:
        host = None
    return DeviceHaystack(length=length, kh=kh, flat=flat, host_bytes=host)
