"""Chained match bitmaps: the device verify of needles longer than the
probe tables allow.

Counterpart of ``sliceslice_tpu/ops/xla_backend.py``'s
``chained_match_bitmap``.  A needle is split into chunks at byte offsets
that are multiples of 32; it matches at ``p`` iff chunk ``j`` matches at
``p + offsets[j]``.  In the linear bitmap (bit ``b`` of word ``w`` marks
position ``32w + b``) a chunk offset of ``32d`` bytes is a shift of ``d``
whole words, so the needle's bitmap is the AND of every chunk's bitmap
shifted left by its word offset.  Identical chunks share one bitmap, so a
periodic needle costs about one scan.

The unique chunks' bitmaps come from the match-bitmap kernel
(``scan_kernel.match_bitmap_counted``), all rows in one launch per batch of
:data:`~.torch_backend.POSITIONS_BUDGET_BYTES`; the shift, the AND, the
popcount and the first set bit are torch ops, as they were plain XLA in the
JAX package.  Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import SENTINEL
from . import scan_kernel, torch_backend
from .scan_math import popcount32, position_limit


def _table(uniq_tables: Sequence[tuple]) -> tuple:
    """uint32 ``(values, masks)`` of the unique chunks as one table, each
    row padded with mask-0 slots (always true) to the widest chunk."""
    t = max(len(v) for v, _ in uniq_tables)
    values = np.zeros((len(uniq_tables), t), np.uint32)
    masks = np.zeros((len(uniq_tables), t), np.uint32)
    for u, (v, m) in enumerate(uniq_tables):
        values[u, : len(v)] = np.asarray(v, np.uint32)
        masks[u, : len(m)] = np.asarray(m, np.uint32)
    return values, masks


def first_set_bit(words: torch.Tensor) -> torch.Tensor:
    """0-d int32: the offset ``32w + b`` of the lowest set bit of a linear
    bitmap (int32 bit patterns), SENTINEL when none is set.  The ctz of the
    first nonzero word is taken in int64, so a word whose only set bit is
    bit 31 (INT_MIN as int32) gives 31."""
    nonzero = words != 0
    w = torch.argmax(nonzero.to(torch.uint8)).view(1)  # the first nonzero word (0 if none)
    word = words.index_select(0, w).to(torch.int64) & 0xFFFFFFFF
    ctz = popcount32((word & -word) - 1)  # 32 when the word is 0
    first = 32 * w + ctz
    return torch.where(nonzero.any(), first, SENTINEL).to(torch.int32)[0]


def chained_match_bitmap(flat, uniq_tables, uniq_lens, chunk_map, offsets, hay_len: int,
                         plain: bool = False):
    """Combined match bitmap of a chunked needle over a kernel layout.

    ``flat``: the layout's uint8 buffer, whose halo covers the widest
    chunk's table (``needed_halo_for_t``); ``uniq_tables``: ``[(values,
    masks)]`` uint32 probe tables, one per unique chunk; ``uniq_lens``:
    each unique chunk's byte length; ``chunk_map[j]``: the unique chunk of
    needle chunk ``j``; ``offsets[j]``: its byte offset in the needle, a
    multiple of 32.  Unique chunk ``u`` matches at positions below
    ``max(hay_len - uniq_lens[u] + 1, 0)``, so the last chunk's end bound
    enforces ``p <= hay_len - k`` exactly, and a chunk wholly past the
    corpus leaves an all-zero bitmap.

    Returns device ``(count int32, first int32 (SENTINEL when absent),
    words int32[W])``: the linear bitmap of the needle's matches, ``W =
    scan_kernel.bitmap_words(flat.numel(), t)``.  ``plain`` runs the
    bitmap kernel's plain version on ``flat``'s device."""
    for o in offsets:
        if o % 32:
            raise ValueError(f"chunk offset {o} not a multiple of 32")
    if len(chunk_map) != len(offsets) or not chunk_map:
        raise ValueError("chunk_map and offsets must describe the same chunks, at least one")
    values, masks = _table(uniq_tables)
    t = values.shape[1]
    if position_limit(flat.numel(), t) < hay_len:
        raise ValueError(f"layout halo too small for width-{t} chunk tables")
    ends = np.maximum(hay_len - np.asarray(uniq_lens, np.int64) + 1, 0).astype(np.int32)
    _, values, masks, ends = scan_kernel._operands(flat, values, masks, ends, 0)
    bitmap = scan_kernel.match_bitmap_counted_plain if plain else scan_kernel.match_bitmap_counted
    n_words = scan_kernel.bitmap_words(flat.numel(), t)
    shifts = [o // 32 for o in offsets]
    acc = None
    for u0, u1 in torch_backend.position_batches(len(uniq_tables), flat.numel(), t, 0):
        words = bitmap(flat, values[u0:u1], masks[u0:u1], ends[u0:u1])[0]
        for u, d in zip(chunk_map, shifts):
            if not u0 <= u < u1:
                continue
            row, d = words[u - u0], min(d, n_words)
            if acc is None:
                acc = torch.zeros_like(row)
                acc[: n_words - d] = row[d:]
            else:
                acc[: n_words - d] &= row[d:]
                acc[n_words - d :] = 0
    count = popcount32(acc).sum(dtype=torch.int32)
    return count, first_set_bit(acc), acc
