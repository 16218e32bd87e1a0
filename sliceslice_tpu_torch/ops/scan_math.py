"""Packed-window, first-offset, count and match-bitmap math as plain
torch ops.

The single source of the probe evaluation for every plain (non-kernel)
path of the port: the flat rung, ``TorchSearcher`` and the plain versions
of the CUDA find, count, match-bitmap and ablation kernels.  Counterpart
of ``sliceslice_tpu/ops/scan_math.py``.

torch's CPU build has no ``<<`` or ``min`` for ``uint32``, so windows and
probe tables are carried as int32 BIT PATTERNS: windows are assembled in
int64 and wrapped to int32 (two's complement), tables are numpy uint32
viewed as int32.  ``&`` and ``==`` on bit patterns give the uint32 answers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SENTINEL

#: Positions evaluated per step of :func:`first_offsets` (rows times
#: positions per step stays near ``_STEP_ELEMS``).
_STEP_ELEMS = 1 << 23


def table_bits(table, device) -> torch.Tensor:
    """A uint32 probe table (numpy, or an int32 tensor of bit patterns) as
    an int32 tensor on ``device``."""
    if isinstance(table, torch.Tensor):
        if table.dtype != torch.int32:
            raise TypeError(f"probe tables must be int32 bit patterns, got {table.dtype}")
        return table.to(device)
    arr = np.ascontiguousarray(np.asarray(table, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def position_limit(nbytes: int, t: int) -> int:
    """Positions of an ``nbytes`` buffer whose ``t`` probe windows all lie
    inside it, counted the way the find kernel reads them: position ``p``
    reads the aligned words ``p//4`` .. ``p//4 + t``."""
    return max(0, 4 * (nbytes // 4 - t))


def packed_windows(hay_u8: torch.Tensor) -> torch.Tensor:
    """uint8[..., L] -> int32[..., L-3] little-endian 4-byte windows (bit
    patterns) along the last axis:
    ``P[p] = b[p] | b[p+1]<<8 | b[p+2]<<16 | b[p+3]<<24``."""
    b = hay_u8.to(torch.int64)
    n = b.shape[-1]
    w = (b[..., 0 : n - 3] | (b[..., 1 : n - 2] << 8) | (b[..., 2 : n - 1] << 16)
         | (b[..., 3:n] << 24))
    return w.to(torch.int32)


def first_offsets(
    hay_u8: torch.Tensor,
    values: torch.Tensor,
    masks: torch.Tensor,
    limits: torch.Tensor,
) -> torch.Tensor:
    """int64[N]: for each row the smallest ``p < limits[n]`` at which every
    probe slot matches, ``(window(p + 4t) & masks[n, t]) == values[n, t]``,
    or SENTINEL.

    The caller guarantees that every window of every position below
    ``limits`` lies inside ``hay_u8``.  Positions are scanned in steps, and
    rows drop out once found — the plain analogue of the kernels' early
    exit, which keeps a CPU sweep over a long corpus affordable."""
    n, t = values.shape
    device = hay_u8.device
    out = torch.full((n,), SENTINEL, dtype=torch.int64, device=device)
    if n == 0:
        return out
    limits = limits.to(device=device, dtype=torch.int64)
    lim_max = int(limits.max())
    if lim_max <= 0:
        return out
    rows = torch.nonzero(limits > 0).flatten()
    step = max(4096, min(1 << 16, _STEP_ELEMS // max(1, rows.numel())))
    for c0 in range(0, lim_max, step):
        rows = rows[limits[rows] > c0]
        if rows.numel() == 0:
            break
        c1 = min(c0 + step, lim_max)
        width = c1 - c0
        win = packed_windows(hay_u8[c0 : c1 + 4 * t - 1])
        pos = torch.arange(c0, c1, dtype=torch.int64, device=device)
        chunk = max(1, _STEP_ELEMS // width)
        for r0 in range(0, rows.numel(), chunk):
            sel = rows[r0 : r0 + chunk]
            v, m = values[sel], masks[sel]
            acc = pos[None, :] < limits[sel, None]
            for ti in range(t):
                w = win[4 * ti : 4 * ti + width]
                acc &= (w[None, :] & m[:, ti : ti + 1]) == v[:, ti : ti + 1]
            first = torch.where(acc, pos[None, :], SENTINEL).amin(dim=1)
            out[sel] = torch.minimum(out[sel], first)
        rows = rows[out[rows] == SENTINEL]
    return out


def _match_chunks(hay_u8, values, masks, limits):
    """Yield ``(rows, c0, acc)`` over the probe evaluation, step by step:
    ``acc[i, c]`` is True when row ``rows[i]`` matches at position ``c0 +
    c`` below its limit.  Steps are multiples of 32 positions and rows are
    cut into chunks of about ``_STEP_ELEMS`` elements.  The guarantee of
    :func:`first_offsets` on ``limits`` applies."""
    n, t = values.shape
    device = hay_u8.device
    if n == 0:
        return
    limits = limits.to(device=device, dtype=torch.int64)
    lim_max = int(limits.max())
    rows = torch.nonzero(limits > 0).flatten()
    step = max(4096, min(1 << 16, _STEP_ELEMS // max(1, rows.numel())))
    step -= step % 32
    for c0 in range(0, max(lim_max, 0), step):
        rows = rows[limits[rows] > c0]
        if rows.numel() == 0:
            break
        c1 = min(c0 + step, lim_max)
        width = c1 - c0
        win = packed_windows(hay_u8[c0 : c1 + 4 * t - 1])
        pos = torch.arange(c0, c1, dtype=torch.int64, device=device)
        chunk = max(1, _STEP_ELEMS // width)
        for r0 in range(0, rows.numel(), chunk):
            sel = rows[r0 : r0 + chunk]
            v, m = values[sel], masks[sel]
            acc = pos[None, :] < limits[sel, None]
            for ti in range(t):
                w = win[4 * ti : 4 * ti + width]
                acc &= (w[None, :] & m[:, ti : ti + 1]) == v[:, ti : ti + 1]
            yield sel, c0, acc


def match_counts(
    hay_u8: torch.Tensor,
    values: torch.Tensor,
    masks: torch.Tensor,
    limits: torch.Tensor,
) -> torch.Tensor:
    """int64[N]: for each row the number of positions ``p < limits[n]`` at
    which every probe slot matches (overlapping matches), the full-scan
    counterpart of :func:`first_offsets`, chunked the same way with no
    early exit.  The same guarantee on ``limits`` applies."""
    out = torch.zeros((values.shape[0],), dtype=torch.int64, device=hay_u8.device)
    for sel, _, acc in _match_chunks(hay_u8, values, masks, limits):
        out[sel] += acc.sum(dim=1)
    return out


def match_spans(
    hay_u8: torch.Tensor,
    values: torch.Tensor,
    masks: torch.Tensor,
    limits: torch.Tensor,
    span: int,
) -> torch.Tensor:
    """int64[N]: for each row the number of spans ``[s * span, (s + 1) *
    span)`` that hold a position ``p < limits[n]`` at which every probe
    slot matches.  The guarantee of :func:`first_offsets` on ``limits``
    applies."""
    n = values.shape[0]
    device = hay_u8.device
    spans = -(-max(int(limits.max()), 0) // span) if n else 0
    hit = torch.zeros((n, spans), dtype=torch.bool, device=device)
    for sel, c0, acc in _match_chunks(hay_u8, values, masks, limits):
        i, c = torch.nonzero(acc, as_tuple=True)
        hit[sel[i], (c0 + c) // span] = True
    return hit.sum(dim=1)


def match_bits(
    hay_u8: torch.Tensor,
    values: torch.Tensor,
    masks: torch.Tensor,
    limits: torch.Tensor,
    n_words: int,
) -> torch.Tensor:
    """int32[N, n_words] linear match bitmaps (uint32 bit patterns): bit
    ``b`` of word ``w`` of row ``n`` is set when every probe slot matches
    at ``p = 32w + b`` and ``p < limits[n]``.  ``n_words`` must cover
    ``limits``; the guarantee of :func:`first_offsets` on them applies."""
    device = hay_u8.device
    out = torch.zeros((values.shape[0], n_words), dtype=torch.int32, device=device)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    for sel, c0, acc in _match_chunks(hay_u8, values, masks, limits):
        width = acc.shape[1]
        nw = -(-width // 32)
        bits = torch.nn.functional.pad(acc, (0, 32 * nw - width)).view(len(sel), nw, 32)
        words = (bits.to(torch.int64) << shifts).sum(dim=2)
        out[sel, c0 // 32 : c0 // 32 + nw] = words.to(torch.int32)
    return out


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """int32 population count of each element of an int32 tensor of uint32
    bit patterns (torch has no popcount; SWAR steps in int64)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)
