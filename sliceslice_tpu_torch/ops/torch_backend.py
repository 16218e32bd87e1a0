"""Portable search paths written as plain torch ops.

Counterpart of ``sliceslice_tpu/ops/xla_backend.py``: the flat
short-haystack rung (on any device), the differential path behind
``TorchSearcher``, whose count (:func:`count_cols`) keeps a layout on the
card from being counted on the host, and the two-tier positions protocol.
These were plain XLA in the JAX package, so they stay plain tensor code
here, but for the match bitmap, its ranks and its compaction under the
positions, which are kernels (``scan_kernel.match_bitmap_counted``,
``scan_kernel.item_ranks`` and ``scan_kernel.compact_window``, capped as
``scan_kernel.compact_positions``); their wrappers live in
:mod:`.scan_kernel`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SENTINEL
from ..utils.tracing import span
from . import scan_kernel
from .scan_math import (
    first_offsets,
    match_counts,
    packed_windows,
    position_limit,
    table_bits,
)
from .transfer import to_device, to_host


def _rolled_windows(flat: torch.Tensor) -> torch.Tensor:
    """int32[Lp] windows with wrap-around, as the JAX flat path builds them
    with ``jnp.roll``: wrapped bytes only reach positions masked by ``end``
    or bytes masked out of the final probe, so results are exact."""
    ext = torch.cat([flat, flat[:3]])
    return packed_windows(ext)


def find_batched_flat(flat, values, masks, ends) -> torch.Tensor:
    """int32[N] first offsets (SENTINEL absent) of N probe programs over a
    flat zero-padded uint8 haystack (the JAX ``find_batched_flat``)."""
    device = flat.device
    values = table_bits(values, device)
    masks = table_bits(masks, device)
    ends = torch.as_tensor(ends, dtype=torch.int64, device=device).reshape(-1)
    n, t = values.shape
    p = _rolled_windows(flat)
    lp = p.shape[0]
    shifted = [torch.roll(p, -4 * ti) if ti else p for ti in range(t)]
    idx = torch.arange(lp, dtype=torch.int64, device=device)
    out = torch.empty((n,), dtype=torch.int32, device=device)
    rows = max(1, (1 << 22) // max(lp, 1))
    for r0 in range(0, n, rows):
        v, m = values[r0 : r0 + rows], masks[r0 : r0 + rows]
        acc = idx[None, :] < ends[r0 : r0 + rows, None]
        for ti, pt in enumerate(shifted):
            acc &= (pt[None, :] & m[:, ti : ti + 1]) == v[:, ti : ti + 1]
        first = torch.where(acc, idx[None, :], SENTINEL).amin(dim=1)
        out[r0 : r0 + rows] = first.to(torch.int32)
    return out


def find_flat(flat, values, masks, end) -> torch.Tensor:
    """First match offset (0-d int32, SENTINEL absent) of one probe program
    over a flat zero-padded uint8 haystack (the JAX ``find_flat``)."""
    values = table_bits(values, flat.device).reshape(1, -1)
    masks = table_bits(masks, flat.device).reshape(1, -1)
    return find_batched_flat(flat, values, masks, [int(end)])[0]


def find_cols(flat, values, masks, end) -> torch.Tensor:
    """First match (0-d int32, SENTINEL absent) over the kernel layout — the
    same answer the find kernel gives, as plain torch ops (the JAX
    ``find_cols``).  The layout's halo must cover the probe width."""
    device = flat.device
    values = table_bits(values, device).reshape(1, -1)
    masks = table_bits(masks, device).reshape(1, -1)
    bound = position_limit(flat.numel(), values.shape[1])
    limit = torch.tensor([min(int(end), bound)], dtype=torch.int64)
    return first_offsets(flat, values, masks, limit)[0].to(torch.int32)


def count_cols(flat, values, masks, end) -> torch.Tensor:
    """Overlapping match count (0-d int64) over the kernel layout — the
    same answer the count kernel gives, as plain torch ops.  The layout's
    halo must cover the probe width."""
    device = flat.device
    values = table_bits(values, device).reshape(1, -1)
    masks = table_bits(masks, device).reshape(1, -1)
    bound = position_limit(flat.numel(), values.shape[1])
    limit = torch.tensor([min(int(end), bound)], dtype=torch.int64)
    return match_counts(flat, values, masks, limit)[0]


# -- all-occurrence positions: linear match bitmaps --------------------------
#
# The JAX package's two tiers: rows with at most ``cap`` matches read back
# their ``cap`` earliest offsets, denser rows their packed bitmap for a host
# decode.  Here every row is compacted on the card: the match-bitmap kernel
# writes one bitmap per row with each queue item's match count, the rank
# kernel turns those into each row's count and each item's first rank, and
# the compaction kernel packs every row's offsets into one buffer, row after
# row (their plain versions on the CPU).  One bitmap and one rank launch per
# batch of rows, as many rows as :data:`POSITIONS_BUDGET_BYTES` allows, and
# one compaction launch per window of the packed offsets.

#: Default sparse-positions budget of every two-tier positions path.
SPARSE_POSITIONS_CAP = 4096
#: Device bytes the positions protocol may hold at once: one launch
#: batch's bitmaps, item counts, ranks, counts and row bases, and one
#: window of its packed offsets.
POSITIONS_BUDGET_BYTES = 1 << 30
#: The share of the budget one window of packed offsets takes (a quarter);
#: the launch batch's rows hold the rest.
WINDOW_SHARE = 4


def window_entries() -> int:
    """Offsets (int32) per window of the packed compaction: a
    :data:`WINDOW_SHARE` of the budget, at least one."""
    return max(1, POSITIONS_BUDGET_BYTES // WINDOW_SHARE // 4)


def position_batches(rows: int, nbytes: int, t: int,
                     batch: Optional[int] = None) -> List[Tuple[int, int]]:
    """Row ranges ``[i0, i1)`` of the launch batches of ``rows`` width-``t``
    rows over an ``nbytes`` layout: as many rows per batch as the budget
    holds beside one window of packed offsets (each row's bitmap, its item
    counts and first ranks, its count and its int64 row base), at most
    ``batch`` when given, at least one."""
    words = scan_kernel.bitmap_words(nbytes, t)
    chunks = -(-position_limit(nbytes, t) // scan_kernel.BITMAP_CHUNK)
    room = POSITIONS_BUDGET_BYTES - 4 * window_entries()
    per = max(1, room // (4 * (words + 2 * chunks + 3)))
    if batch is not None:
        per = min(per, max(1, int(batch)))
    return [(i0, min(i0 + per, rows)) for i0 in range(0, rows, per)]


def match_bitmap_batched(flat, values, masks, ends):
    """Linear match bitmaps of N probe programs over a kernel layout:
    int32[N, W] uint32 bit patterns, bit ``b`` of word ``w`` set iff a
    valid match starts at ``32w + b`` (``pos < ends[n]`` applied; the JAX
    ``match_bitmap_batched``, whose TPU layout is by lane).  N * corpus/8
    bytes: callers batch N (:func:`position_batches`)."""
    _, values, masks, ends = scan_kernel._operands(flat, values, masks, ends, 0)
    return scan_kernel.match_bitmap(flat, values, masks, ends)


def compact_positions_batched(flat, values, masks, ends, cap: int):
    """Size-bounded all-positions scan (the JAX contract): ``(counts
    int32[N], offsets int32[N, cap])`` ascending, SENTINEL-filled.  Rows
    with at most ``cap`` matches get all of them; denser rows their ``cap``
    earliest."""
    words, item_counts, chunk = scan_kernel.match_bitmap_counted(flat, values, masks, ends)
    return scan_kernel.compact_positions(words, item_counts, chunk, int(cap))


def two_tier_positions(flat, values, masks, ends, cap: int, plain: bool = False) -> List[np.ndarray]:
    """Every match offset of each row of one launch batch, as int64
    ascending arrays, one per row: the answers of the JAX package's two
    tiers, with every row, sparse or dense, compacted on the layout's
    device.  One bitmap launch and one rank launch, then readback 1, the
    rows' counts; the packed bases on the host; then per window of
    :func:`window_entries` packed offsets, one compaction launch and one
    readback.  ``plain`` runs the kernels' plain versions on the layout's
    device.  ``cap`` (the JAX sparse cap) is validated, a negative one
    refused, and changes nothing else: no row falls back to its bitmap.
    The call is the span ``sliceslice.positions.batch``, with the bases
    (``sliceslice.positions.bases``), the row slices
    (``sliceslice.positions.split``) and the copies of
    :mod:`.transfer` inside it."""
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"cap={cap} is negative")
    with span("sliceslice.positions.batch"):
        _, values, masks, ends = scan_kernel._operands(flat, values, masks, ends, 0)
        if plain:
            bitmap = scan_kernel.match_bitmap_counted_plain
            ranks, compact = scan_kernel.item_ranks_plain, scan_kernel.compact_window_plain
        else:
            bitmap = scan_kernel.match_bitmap_counted
            ranks, compact = scan_kernel.item_ranks, scan_kernel.compact_window
        words, item_counts, chunk = bitmap(flat, values, masks, ends)
        counts, first = ranks(item_counts)
        cnt = to_host(counts).astype(np.int64)
        if not cnt.size:
            return []
        with span("sliceslice.positions.bases"):
            stops = np.cumsum(cnt)
            total = int(stops[-1])
            packed = np.empty((total,), np.int64)
            row_base = to_device(stops - cnt, words.device) if total else None
        step = window_entries()
        for lo in range(0, total, step):
            hi = min(lo + step, total)
            out = torch.empty((hi - lo,), dtype=torch.int32, device=words.device)
            compact(words, item_counts, first, chunk, out, row_base=row_base, window=(lo, hi))
            packed[lo:hi] = to_host(out)
        with span("sliceslice.positions.split"):
            bounds = [0] + stops.tolist()
            # Row slices by hand: np.split costs several times more per row.
            return [packed[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def decode_match_bitmap(words: np.ndarray) -> np.ndarray:
    """Decode one linear bitmap (int32 bit patterns or uint32) to ascending
    int64 offsets (the huge-needle dense tier's): the native C++ decoder
    (csrc/swarscan.cpp) when it builds, else
    :func:`decode_match_bitmap_numpy`."""
    from ..utils import native

    out = native.decode_bitmap(words)
    if out is not None:
        return out
    return decode_match_bitmap_numpy(words)


def decode_match_bitmap_numpy(words: np.ndarray) -> np.ndarray:
    """Pure-numpy decode of one linear bitmap (the no-toolchain fallback
    and the differential oracle of the native decoder)."""
    w = np.ascontiguousarray(np.asarray(words).view(np.uint32).reshape(-1))
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)
