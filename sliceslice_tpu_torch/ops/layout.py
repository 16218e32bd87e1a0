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
* haystacks of at most :data:`SHORT_HAY_BYTES` bytes take the flat rung: a
  power-of-two buffer searched with plain torch ops, exactly as the JAX
  package searches its flat layout;
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
#: Haystacks at or below this many bytes use the flat (plain torch) rung.
SHORT_HAY_BYTES = 8192
#: Buffer sizes are multiples of this many bytes (the kernels' 16-byte
#: loads and word pairs stay inside the buffer).
ALIGN = 128

#: A single device layout must keep every position (including trailing pad)
#: inside int32 — the kernels' offset math and SENTINEL live there.
MAX_DEVICE_POSITIONS = 2**31 - 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def padded_total(length: int, kh: int, force_cols: bool = False) -> int:
    """Buffer bytes of the layout :func:`preprocess` builds for a corpus of
    ``length`` bytes: a power of two (at least 128) on the flat rung, else
    the corpus plus its rounded halo plus one aligned block of slack."""
    if length <= SHORT_HAY_BYTES and not force_cols:
        return max(128, next_pow2(length))
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
    #: False for the flat short-haystack rung, True for the kernel layout.
    tiled: bool
    host_bytes: Optional[bytes] = None
    #: one-slot cache for ensure_halo rebuilds: repeated calls reuse one
    #: widened layout instead of re-uploading the corpus per call.
    _rehalo: Optional["DeviceHaystack"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def supports_needle_len(self, k: int) -> bool:
        from ..needle import needed_halo

        return needed_halo(k) <= self.kh

    def ensure_halo(self, min_kh: int) -> "DeviceHaystack":
        """Return a layout with at least ``min_kh`` halo bytes — this one
        when it suffices, else a rebuilt layout from the host bytes (cached
        on this object, so repeated sweeps reuse ONE widened layout)."""
        if not self.tiled or self.kh >= min_kh:
            return self
        if self._rehalo is not None and self._rehalo.kh >= min_kh:
            return self._rehalo
        if self.host_bytes is None:
            raise ValueError(
                f"layout halo kh={self.kh} < required {min_kh} and no host "
                "bytes retained to rebuild; preprocess with a larger kh"
            )
        self._rehalo = preprocess(self.host_bytes, kh=min_kh, device=self.device)
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
    device: Union[str, torch.device] = "cpu",
) -> DeviceHaystack:
    """Build the layout of a haystack on ``device``.  O(len) once, amortized
    over all later searches.

    ``force_cols``: take the kernel layout even at or below
    :data:`SHORT_HAY_BYTES` (the name of the JAX package's switch).

    ``length``: logical corpus length when ``hay`` is an ndarray LONGER
    than it (a caller-padded buffer).

    ``keep_host``: retain the host bytes, which :meth:`DeviceHaystack.
    ensure_halo` and the trivial-length rules of the searchers read."""
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
    kh = round_up(max(kh, MIN_KH), 32)
    tiled = not (length <= SHORT_HAY_BYTES and not force_cols)
    total = padded_total(length, kh, force_cols)
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
    return DeviceHaystack(length=length, kh=kh, flat=flat, tiled=tiled, host_bytes=host)
