"""Portable search paths written as plain torch ops.

Counterpart of ``sliceslice_tpu/ops/xla_backend.py``: the flat
short-haystack rung (on any device), the differential path behind
``TorchSearcher``, whose count (:func:`count_cols`) keeps a layout on the
card from being counted on the host, and the two-tier positions protocol.
These were plain XLA in the JAX package, so they stay plain tensor code
here, but for the match bitmap under the positions, which is a kernel
(``scan_kernel.match_bitmap``); the hand-written kernels live in
:mod:`.scan_kernel`.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import SENTINEL
from . import scan_kernel
from .scan_math import (
    first_offsets,
    match_counts,
    packed_windows,
    popcount32,
    position_limit,
    table_bits,
)


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
# decode.  Here both tiers come from one bitmap per row, made by the match
# bitmap kernel on the card (its plain version on the CPU): the compact
# offsets are cut from it with torch ops on its device.

#: Default sparse-positions budget of every two-tier positions path.
SPARSE_POSITIONS_CAP = 4096


def match_bitmap_batched(flat, values, masks, ends, bitmap: Callable = scan_kernel.match_bitmap):
    """Linear match bitmaps of N probe programs over a kernel layout:
    int32[N, W] uint32 bit patterns, bit ``b`` of word ``w`` set iff a
    valid match starts at ``32w + b`` (``pos < ends[n]`` applied; the JAX
    ``match_bitmap_batched``, whose TPU layout is by lane).  ``bitmap`` is
    the wrapper that makes them (``scan_kernel.match_bitmap_plain`` keeps
    even a CUDA layout off the kernel).  N * corpus/8 bytes: callers chunk
    N."""
    _, values, masks, ends = scan_kernel._operands(flat, values, masks, ends, 0)
    return bitmap(flat, values, masks, ends)


def compact_from_bitmap(words: torch.Tensor, cap: int):
    """``(counts int32[N], offsets int32[N, cap])`` of linear bitmaps: each
    row's match count and its ``cap`` earliest offsets, ascending,
    SENTINEL-filled past the count, on the bitmap's device.  Only the words
    up to a row's ``cap``-th match are expanded (nonzero words, then
    bits), so a dense row costs no more than a sparse one; the two
    ``nonzero`` calls are the only host syncs."""
    n = words.shape[0]
    device = words.device
    pc = popcount32(words)
    counts = pc.sum(dim=1, dtype=torch.int32)
    before = torch.cumsum(pc, dim=1, dtype=torch.int32) - pc  # matches in earlier words
    r, w = torch.nonzero((words != 0) & (before < cap), as_tuple=True)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    bits = ((words[r, w].to(torch.int64)[:, None] >> shifts) & 1).to(torch.int32)
    rank = before[r, w][:, None] + torch.cumsum(bits, dim=1, dtype=torch.int32) - bits
    k, b = torch.nonzero((bits != 0) & (rank < cap), as_tuple=True)
    offsets = torch.full((n, cap), SENTINEL, dtype=torch.int32, device=device)
    offsets[r[k], rank[k, b]] = (32 * w[k] + b).to(torch.int32)
    return counts, offsets


def compact_positions_batched(flat, values, masks, ends, cap: int):
    """Size-bounded all-positions scan (the JAX contract): ``(counts
    int32[N], offsets int32[N, cap])`` ascending, SENTINEL-filled.  Rows
    with at most ``cap`` matches get all of them; denser rows their ``cap``
    earliest, and the caller falls back to the bitmap for them."""
    return compact_from_bitmap(match_bitmap_batched(flat, values, masks, ends), int(cap))


def two_tier_positions(flat, values, masks, ends, cap: int,
                       bitmap: Callable = scan_kernel.match_bitmap) -> List[np.ndarray]:
    """The two-tier all-positions protocol over one batch: one bitmap per
    row on the layout's device; rows with at most ``cap`` matches take
    their compact offsets (``cap`` words of readback each), denser rows
    their bitmap (corpus/8 bytes each), decoded on the host.  Returns int64
    ascending offset arrays, one per row."""
    words = match_bitmap_batched(flat, values, masks, ends, bitmap)
    counts, offsets = compact_from_bitmap(words, int(cap))
    # One readback of the counts and every row's compact offsets; the
    # dense rows' bitmaps follow in a second.
    both = torch.cat([counts[:, None], offsets], dim=1).cpu().numpy()
    out: List[Optional[np.ndarray]] = [
        row[1 : 1 + row[0]].astype(np.int64) if row[0] <= cap else None for row in both
    ]
    dense = [j for j, row in enumerate(both) if row[0] > cap]
    if dense:
        rows = words[torch.tensor(dense, device=words.device)].cpu().numpy()
        for j, row in zip(dense, rows):
            out[j] = decode_match_bitmap(row)
    return out  # type: ignore[return-value]


def decode_match_bitmap(words: np.ndarray) -> np.ndarray:
    """Decode one linear bitmap (int32 bit patterns or uint32) to ascending
    int64 offsets: the native C++ decoder (csrc/swarscan.cpp) when it
    builds, else :func:`decode_match_bitmap_numpy`."""
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
