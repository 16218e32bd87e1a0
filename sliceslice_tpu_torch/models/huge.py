"""Huge-needle searcher: needles longer than ``MAX_NEEDLE_LEN``, answered
exactly by a device filter and a verify, in three tiers.

Counterpart of ``sliceslice_tpu/models/huge.py``.  The probe kernels verify
in the kernel with a table whose width grows with the needle; past
``MAX_NEEDLE_LEN`` this searcher splits the work:

* **filter (device)**: the count kernel counts the positions where the
  needle's first ``PREFIX_LEN`` bytes occur, one full scan and one scalar
  read.  A 64-byte prefix is a strong filter, so candidates are rare;
* **sparse verify (host)**: when there are at most ``HOST_VERIFY_MAX``
  candidates and the caller's host bytes are at hand, the match-bitmap and
  compaction kernels list them (one launch each, one readback of the used
  slots), and the host compares the whole needle at each;
* **dense verify (device)**: otherwise (a prefix repeated through the
  corpus), the chained match bitmap (``ops/chained.py``): the needle's
  ``CHUNK``-byte chunks scanned by the match-bitmap kernel, their bitmaps
  shifted and ANDed on the device.  Identical chunks share one bitmap row.

A haystack handed over as host bytes of at most ``max(SHORT_HAY_BYTES, k)``
bytes, or a flat layout off the card, is scanned on the host (``hostscan``),
as in the JAX package; a flat layout on the card is re-laid there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SENTINEL
from ..needle import MAX_NEEDLE_LEN, Needle, NeedleLike, as_bytes, build_probe_table, needed_halo_for_t
from ..ops import chained, torch_backend
from ..ops.layout import SHORT_HAY_BYTES, DeviceHaystack
from ..searcher import (
    DeviceLike,
    HaystackLike,
    SearcherBase,
    _hay_bytes,
    _host_positions,
    overlapping_count,
    resolve_device,
)
from .cuda_searcher import searcher_for_size

#: Width of the device filter's prefix: 16 probe slots, within the default
#: layout halo (``needed_halo(64) = 63``), so a default layout needs no
#: relayout for the filter.
PREFIX_LEN = 64

#: Chunk width of the dense tier: a multiple of 32 (chunk offsets must be
#: whole-word shifts of the bitmaps), tables of 128 slots, whose layout halo
#: is ``needed_halo_for_t(128) = 511`` bytes.
CHUNK = 512

#: Candidate budget of the sparse tier (host compares of the whole
#: needle); past it the dense tier runs on the device.
HOST_VERIFY_MAX = 16384


class HugeNeedleSearcher(SearcherBase):
    """Exact searcher for needles longer than ``MAX_NEEDLE_LEN``."""

    def __init__(self, needle: NeedleLike, position: Optional[int] = None, *,
                 device: DeviceLike = "cuda"):
        data = as_bytes(needle)
        k = len(data)
        if k <= MAX_NEEDLE_LEN:
            raise ValueError(f"HugeNeedleSearcher is for needles > {MAX_NEEDLE_LEN} bytes")
        if position is None:
            position = k - 1
        if not (0 <= position < k):
            raise ValueError(
                f"invalid position {position} for needle of length {k} "
                "(reference contract: position < needle.size(), src/x86.rs:300)"
            )
        self.device = resolve_device(device)
        # The device filter runs on the prefix; the full bytes live here.
        self.needle = Needle(data[:PREFIX_LEN], min(position, PREFIX_LEN - 1))
        self._full = data
        self._position = position
        self._prefix = searcher_for_size(PREFIX_LEN)(
            self.needle.data, self.needle.position, device=self.device)
        self._chunk_plan_cache = None

    @property
    def size(self) -> int:
        return len(self._full)

    @property
    def position(self) -> int:
        return self._position

    # -- candidate machinery --------------------------------------------------

    def _as_layout(self, hay: HaystackLike):
        """(kernel layout | None, host bytes | None): None for the layout
        means the host scans the bytes."""
        if isinstance(hay, DeviceHaystack):
            if hay.tiled:
                return hay, hay.host_bytes
            if hay.device.type == "cuda":
                return hay.kernel_layout(needed_halo_for_t(CHUNK // 4)), hay.host_bytes
            if hay.host_bytes is None:
                raise ValueError(
                    "huge-needle search on a flat DeviceHaystack requires "
                    "host bytes (preprocess with keep_host=True)"
                )
            return None, hay.host_bytes
        data = _hay_bytes(hay)
        if len(data) <= max(SHORT_HAY_BYTES, len(self._full)):
            return None, data
        return self._layout(data), data

    def _candidate_count(self, dh: DeviceHaystack) -> int:
        """Device count of the prefix filter's survivors (one count-kernel
        launch, one scalar read)."""
        return self._prefix.count_in(dh)

    def _host_candidates(self, dh: DeviceHaystack, ncand: int) -> np.ndarray:
        """The ``ncand`` candidate offsets, ascending: one bitmap and one
        compaction launch at cap ``HOST_VERIFY_MAX``, then one readback of
        the used slots (the caller has checked ``ncand <= HOST_VERIFY_MAX``)."""
        pk = self.needle.size
        dh2 = dh.ensure_kh(pk)
        values, masks, _ = build_probe_table([self.needle.data])
        ends = np.asarray([dh2.length - pk + 1], np.int32)
        _, offsets = torch_backend.compact_positions_batched(dh2.flat, values, masks, ends, HOST_VERIFY_MAX)
        return offsets[0, :ncand].cpu().numpy().astype(np.int64)

    def _verified(self, data: bytes, candidates):
        """The candidates at which the whole needle occurs, in order."""
        full = self._full
        return (int(c) for c in candidates if data.startswith(full, c))

    def _dense(self, dh: DeviceHaystack):
        """Dense tier: device ``(count, first, words)`` of the chained
        bitmap, over a layout whose halo covers the chunk tables."""
        uniq_tables, uniq_lens, chunk_map, offsets = self._chunk_plan()
        dh2 = dh.ensure_halo(needed_halo_for_t(CHUNK // 4))
        return chained.chained_match_bitmap(dh2.flat, uniq_tables, uniq_lens, chunk_map, offsets, dh2.length)

    def _chunk_plan(self):
        """The needle split into CHUNK-byte tables, identical chunks
        deduplicated (a periodic needle collapses to about one table)."""
        if self._chunk_plan_cache is None:
            uniq: dict[bytes, int] = {}
            chunk_map = []
            offsets = []
            for o in range(0, len(self._full), CHUNK):
                cb = self._full[o : o + CHUNK]
                chunk_map.append(uniq.setdefault(cb, len(uniq)))
                offsets.append(o)
            tables = []
            for cb in uniq:  # insertion order
                vals, msks, _ = build_probe_table([cb])
                tables.append((vals[0], msks[0]))
            self._chunk_plan_cache = (
                tuple(tables), tuple(len(cb) for cb in uniq), tuple(chunk_map), tuple(offsets)
            )
        return self._chunk_plan_cache

    def _route(self, dh: Optional[DeviceHaystack], data: Optional[bytes],
               ncand: Optional[int] = None):
        """``('hostscan' | 'empty' | 'host' | 'dense', payload)``: the
        three-tier decision.  ``ncand``: the prefix's candidate count when
        the caller already has it."""
        if dh is None:
            return "hostscan", data
        if dh.length < len(self._full):
            return "empty", None
        if ncand is None:
            ncand = self._candidate_count(dh)
        if ncand == 0:
            return "empty", None
        if ncand <= HOST_VERIFY_MAX and data is not None:
            return "host", self._host_candidates(dh, ncand)
        return "dense", None

    # -- public API (SearcherBase signatures) ---------------------------------

    def find(self, hay: HaystackLike) -> Optional[int]:
        dh, data = self._as_layout(hay)
        return self._find_tiers(dh, data, self._route(dh, data))

    def find_with_candidates(self, dh: DeviceHaystack, ncand: int) -> Optional[int]:
        """``find`` over a kernel layout whose prefix-candidate count is
        already known."""
        data = dh.host_bytes
        return self._find_tiers(dh, data, self._route(dh, data, ncand))

    def _find_tiers(self, dh, data, route) -> Optional[int]:
        tier, payload = route
        if tier == "empty":
            return None
        if tier == "hostscan":
            p = data.find(self._full)
            return None if p < 0 else p
        if tier == "host":
            return next(self._verified(data, payload), None)
        f = int(self._dense(dh)[1])
        return None if f >= SENTINEL else f

    def count_in(self, hay: HaystackLike) -> int:
        dh, data = self._as_layout(hay)
        return self._count_tiers(dh, data, self._route(dh, data))

    def count_with_candidates(self, dh: DeviceHaystack, ncand: int) -> int:
        data = dh.host_bytes
        return self._count_tiers(dh, data, self._route(dh, data, ncand))

    def _count_tiers(self, dh, data, route) -> int:
        tier, payload = route
        if tier == "empty":
            return 0
        if tier == "hostscan":
            return overlapping_count(data, self._full)
        if tier == "host":
            return sum(1 for _ in self._verified(data, payload))
        return int(self._dense(dh)[0])

    def positions(self, hay: HaystackLike) -> np.ndarray:
        dh, data = self._as_layout(hay)
        return self._positions_tiers(dh, data, self._route(dh, data))

    def positions_with_candidates(self, dh: DeviceHaystack, ncand: int) -> np.ndarray:
        data = dh.host_bytes
        return self._positions_tiers(dh, data, self._route(dh, data, ncand))

    def _positions_tiers(self, dh, data, route) -> np.ndarray:
        tier, payload = route
        if tier == "empty":
            return np.empty((0,), np.int64)
        if tier == "hostscan":
            return _host_positions(data, self._full)
        if tier == "host":
            return np.fromiter(self._verified(data, payload), np.int64)
        words = self._dense(dh)[2]
        return torch_backend.decode_match_bitmap(words.cpu().numpy())
