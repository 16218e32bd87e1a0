"""Portable search paths written as plain torch ops.

Counterpart of the find half of ``sliceslice_tpu/ops/xla_backend.py``: the
flat short-haystack rung (on any device) and the differential path behind
``TorchSearcher``.  These were plain XLA in the JAX package, so they stay
plain tensor code here; the hand-written kernels live in
:mod:`.scan_kernel`.
"""

from __future__ import annotations

import torch

from ..config import SENTINEL
from .scan_math import first_offsets, packed_windows, position_limit, table_bits


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
