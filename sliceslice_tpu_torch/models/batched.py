"""Batched multi-needle searcher — the main path of the port: first
offsets (``find_all``), overlapping counts (``count_all``) and every
offset (``positions_all``).

N needles are scanned over one device-resident haystack.  Needles are
grouped by probe-table width T = ceil(k/4) at construction (exact widths up
to 8, then buckets 16..512, as in the JAX package); each group's tables
live on the searcher's device, padded to the JAX package's row plan, and
each sweep launches the find (or count) kernel once per group, then
scatters the group results back to input order in one indexed assignment.
The per-needle early exit of find lives inside the kernel; a count scans
everything, and is exact in any row order.  Needles longer than
``MAX_NEEDLE_LEN`` stay out of the groups: each takes the huge-needle
filter and verify (models/huge.py), as in the JAX package.

Each of the three calls is a span (``sliceslice.find_all``,
``sliceslice.count_all``, ``sliceslice.positions_all``;
:mod:`..utils.tracing`), the program's root of a request, with the
scatter, the placing of each batch's positions in input order and the
huge needles as spans inside it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SENTINEL
from ..needle import (
    MAX_NEEDLE_LEN,
    as_bytes,
    build_probe_table,
    needed_halo_for_t,
    num_probes,
)
from ..ops import scan_kernel, torch_backend
from ..ops.layout import DeviceHaystack, preprocess
from ..ops.scan_math import table_bits
from ..ops.transfer import to_device, to_host
from ..searcher import DeviceLike, HaystackLike, _hay_bytes, resolve_device
from ..utils.tracing import span
from .huge import PREFIX_LEN, HugeNeedleSearcher

#: Widths beyond the exact-width limit are bucketed.
WIDE_T_BUCKETS = (16, 32, 64, 128, 256, 512)


def _t_bucket(t: int) -> int:
    if t <= scan_kernel.PROBE_UNROLL:
        return max(t, 1)
    for b in WIDE_T_BUCKETS:
        if t <= b:
            return b
    raise ValueError(f"needle needs {t} probes > max bucket {WIDE_T_BUCKETS[-1]}")


class _Group:
    """Needles sharing one probe-table width: device-resident tables,
    pre-padded to the JAX row plan, plus host copies of every row-ordered
    array so a reorder never reads the device back."""

    #: retained per-haystack-length device ends (FIFO-evicted; a serving
    #: loop over many distinct corpus lengths must not grow unboundedly).
    _ENDS_CACHE_CAP = 16

    def __init__(
        self,
        indices: np.ndarray,
        values: np.ndarray,
        masks: np.ndarray,
        lengths: np.ndarray,
        device: torch.device,
    ):
        self.indices = indices
        self.n, self.t = values.shape
        self.device = device
        self.lengths = lengths
        self.values_host = values
        self.masks_host = masks
        _, self.n_pad = scan_kernel.plan_block(self.n, self.t)
        self._upload_tables()

    @classmethod
    def from_needles(cls, indices, needles: List[bytes], t: int, device) -> "_Group":
        vals, msks, lens = build_probe_table(needles, t_max=t)
        return cls(indices, vals, msks, lens, device)

    def _upload_tables(self) -> None:
        rowpad = ((0, self.n_pad - self.n), (0, 0))
        self.values_dev = table_bits(np.pad(self.values_host, rowpad), self.device)
        self.masks_dev = table_bits(np.pad(self.masks_host, rowpad), self.device)
        self._ends_cache: dict[int, torch.Tensor] = {}

    def reorder(self, key: np.ndarray) -> None:
        """Permute this group's rows ascending by ``key`` (stable); padded
        rows stay at the end.  Device tables are rebuilt from the permuted
        host copies."""
        perm = np.argsort(key, kind="stable")
        self.indices = self.indices[perm]
        self.lengths = self.lengths[perm]
        self.values_host = self.values_host[perm]
        self.masks_host = self.masks_host[perm]
        self._upload_tables()

    def ends_dev(self, hay_len: int) -> torch.Tensor:
        """int32[n_pad] ends ``max(len - k + 1, 0)``; padded rows get 0."""
        e = self._ends_cache.get(hay_len)
        if e is None:
            ends = np.maximum(hay_len - self.lengths.astype(np.int64) + 1, 0)
            ends = np.pad(ends.astype(np.int32), (0, self.n_pad - self.n))
            e = to_device(ends, self.device)
            self._ends_cache[hay_len] = e
            while len(self._ends_cache) > self._ENDS_CACHE_CAP:
                self._ends_cache.pop(next(iter(self._ends_cache)))
        return e


class BatchedSearcher:
    def __init__(
        self,
        needles: Sequence,
        position: Optional[int] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        self.needles = [as_bytes(n) for n in needles]
        self.device = resolve_device(device)
        if position is not None:
            # The single-needle searchers' contract (reference: position <
            # needle.size(), src/x86.rs:300).
            for nd in self.needles:
                if not (0 <= position < len(nd)):
                    raise ValueError(
                        f"invalid position {position} for needle of length {len(nd)}"
                    )
        # Needles beyond the probe tables' budget take the filter and
        # verify of models/huge.py; they stay out of the width groups and
        # of the groups' halo.
        self._huge: List[tuple] = []
        buckets: dict[int, list[int]] = {}
        for i, nd in enumerate(self.needles):
            if len(nd) > MAX_NEEDLE_LEN:
                self._huge.append((i, HugeNeedleSearcher(nd, position, device=self.device)))
            else:
                buckets.setdefault(_t_bucket(max(1, num_probes(len(nd)))), []).append(i)
        self.groups = [
            _Group.from_needles(
                np.asarray(idx, np.int64), [self.needles[i] for i in idx], t, self.device
            )
            for t, idx in sorted(buckets.items())
        ]
        self._finish_init()

    def _finish_init(self) -> None:
        self.max_t = max((g.t for g in self.groups), default=1)
        #: bumped by every reschedule: caches keyed by row order (the
        #: sharded searcher's placed tables) compare it.
        self._epoch = 0
        #: true (unpadded) row count per group — static across reorders.
        self._order_sizes = tuple(g.n for g in self.groups)
        self._rebuild_order()

    def _rebuild_order(self) -> None:
        """Device copy of the concatenated group->input scatter order."""
        idx = [g.indices for g in self.groups]
        order = np.concatenate(idx).astype(np.int64) if idx else np.zeros((0,), np.int64)
        self._order_dev = torch.from_numpy(order).to(self.device)

    def __len__(self) -> int:
        return len(self.needles)

    def _halo(self) -> int:
        """Halo the widest group's probe table needs, and the huge
        needles' prefix filter, so that their scans share one layout."""
        need = needed_halo_for_t(self.max_t)
        if self._huge:
            need = max(need, PREFIX_LEN - 1)
        return need

    def _layout(self, hay: HaystackLike) -> DeviceHaystack:
        need = self._halo()
        if isinstance(hay, DeviceHaystack):
            if hay.device != self.device:
                raise ValueError(
                    f"haystack lives on {hay.device}, the searcher's tables on {self.device}"
                )
            return hay.ensure_halo(need)
        return preprocess(_hay_bytes(hay), kh=need, device=self.device)

    def find_all(self, hay: HaystackLike) -> np.ndarray:
        """First-match offset per needle (int64[N]); -1 where absent."""
        n = len(self.needles)
        if n == 0:
            return np.zeros((0,), np.int64)
        with span("sliceslice.find_all"):
            dh = self._layout(hay)  # one layout for the groups and the huge needles
            out = to_host(self.find_all_device(dh, _allow_huge=True)).astype(np.int64)
            out[out >= SENTINEL] = -1
            if self._huge:
                with span("sliceslice.huge"):
                    for i, hs in self._huge:
                        f = hs.find(dh)
                        out[i] = -1 if f is None else f
        return out

    def _fence_huge(self, what: str, use: str) -> None:
        if self._huge:
            raise ValueError(
                f"{what} cannot evaluate needles longer than "
                f"MAX_NEEDLE_LEN={MAX_NEEDLE_LEN} (host verify step); use {use}"
            )

    def find_all_device(self, hay: HaystackLike, _allow_huge: bool = False) -> torch.Tensor:
        """Device-resident int32[N] first offsets (SENTINEL where absent),
        with no host transfer and no synchronisation: the building block
        for pipelined sweeps.  Huge needles have a host verify step, so a
        batch holding one raises (use :meth:`find_all`)."""
        if not _allow_huge:
            self._fence_huge("find_all_device", "find_all")
        dh = self._layout(hay)
        parts = [
            scan_kernel.batched_find(
                dh.flat, g.values_dev, g.masks_dev, g.ends_dev(dh.length), n_real=g.n
            )
            for g in self.groups
        ]
        return _scatter(len(self.needles), self._order_sizes, self._order_dev, parts)

    def search_all(self, hay: HaystackLike) -> np.ndarray:
        return self.find_all(hay) >= 0

    def count_all_device(self, hay: HaystackLike, _allow_huge: bool = False) -> torch.Tensor:
        """Device-resident int32[N] overlapping-occurrence counts: one count
        kernel launch per width group, then the scatter, with no host
        transfer and no synchronisation.  A batch holding a huge needle
        raises (use :meth:`count_all`)."""
        if not _allow_huge:
            self._fence_huge("count_all_device", "count_all")
        dh = self._layout(hay)
        parts = [
            scan_kernel.batched_count(
                dh.flat, g.values_dev, g.masks_dev, g.ends_dev(dh.length), n_real=g.n
            )
            for g in self.groups
        ]
        return _scatter(len(self.needles), self._order_sizes, self._order_dev, parts)

    def count_all(self, hay: HaystackLike) -> np.ndarray:
        """Overlapping occurrence count per needle (int64[N]), counted
        where the layout lives."""
        with span("sliceslice.count_all"):
            dh = self._layout(hay)  # one layout for the groups and the huge needles
            out = to_host(self.count_all_device(dh, _allow_huge=True)).astype(np.int64)
            if self._huge:
                with span("sliceslice.huge"):
                    for i, hs in self._huge:
                        out[i] = hs.count_in(dh)
        return out

    def positions_all(
        self,
        hay: HaystackLike,
        batch: Optional[int] = None,
        sparse_cap: int = torch_backend.SPARSE_POSITIONS_CAP,
    ) -> List[np.ndarray]:
        """ALL (overlapping) match offsets per needle, in input order — the
        batched ``find_iter`` capability, with the answers of the JAX
        package's two tiers: per width group, as many rows at a time as the
        positions budget holds (at most ``batch`` when given;
        ``torch_backend.position_batches``), one bitmap and one rank launch
        each on the layout's device, then every row compacted there, sparse
        and dense alike, and read back as packed offsets
        (``torch_backend.two_tier_positions``).  ``sparse_cap`` is the JAX
        signature's: a negative one is refused, and it changes nothing
        else, since no row falls back to its bitmap."""
        with span("sliceslice.positions_all"):
            dh = self._layout(hay)
            out: List[Optional[np.ndarray]] = [None] * len(self.needles)
            for g in self.groups:
                ends = g.ends_dev(dh.length)
                batches = torch_backend.position_batches(g.n, dh.flat.numel(), g.t, batch)
                for i0, i1 in batches:
                    res = torch_backend.two_tier_positions(
                        dh.flat, g.values_dev[i0:i1], g.masks_dev[i0:i1], ends[i0:i1], sparse_cap
                    )
                    with span("sliceslice.positions.place"):
                        for j, p in zip(g.indices[i0:i1].tolist(), res):
                            out[j] = p
            if self._huge:
                with span("sliceslice.huge"):
                    for i, hs in self._huge:
                        out[i] = hs.positions(dh)
        return out  # type: ignore[return-value]

    def optimize_for(
        self, hay: HaystackLike, firsts: Optional[np.ndarray] = None
    ) -> "BatchedSearcher":
        """Adaptive block scheduling: reorder each width group's rows
        ascending by measured first-match offsets (absent rows last), so
        needles that finish together sit together.  Results are exact in
        any row order — only scheduling changes.

        ``firsts``: offsets from a prior :meth:`find_all` (-1 absent).
        Omitted, one measuring sweep (:meth:`find_all`) runs and its firsts
        are read back once.  Either way the rows are permuted on the host
        copies and each group's tables are uploaded again.  Returns self."""
        if firsts is None:
            firsts = self.find_all(hay)
        self._epoch += 1
        firsts = np.asarray(firsts)
        key = np.where(firsts < 0, np.iinfo(np.int64).max, firsts)
        for g in self.groups:
            g.reorder(key[g.indices])
        self._rebuild_order()
        return self


def _scatter(n: int, sizes: tuple, order: torch.Tensor, parts: list) -> torch.Tensor:
    """Unpad the group results, concatenate them, and scatter them back to
    input order with one indexed assignment (the span
    ``sliceslice.scatter``)."""
    with span("sliceslice.scatter"):
        out = torch.zeros((n,), dtype=torch.int32, device=order.device)
        if parts:
            out[order] = torch.cat([p[:sz] for p, sz in zip(parts, sizes)])
    return out
