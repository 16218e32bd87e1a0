"""Put the port on the JAX package's state.

The JAX package and the port build the same probe tables and layouts from
the same inputs; these functions take that state as numpy arrays and bytes
(as a test reads it off the JAX objects) and build the port's equivalents,
so both packages can be run on identical tables — for instance after the
JAX ``optimize_for`` has permuted a searcher's rows.  Nothing here imports
the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .models.batched import BatchedSearcher, _Group
from .needle import as_bytes
from .ops.layout import DeviceHaystack, preprocess
from .ops.pairwise import PairwiseSearcher
from .searcher import DeviceLike, resolve_device


def haystack(host_bytes, length: int, kh: int, *, device: DeviceLike = "cuda") -> DeviceHaystack:
    """The port's layout of a JAX ``DeviceHaystack``: its host bytes,
    logical ``length`` and halo ``kh`` (the port has one layout, whether
    the JAX one is tiled or flat)."""
    buf = np.frombuffer(bytes(host_bytes), dtype=np.uint8)
    return preprocess(buf, kh=kh, length=length, device=device)


def batched_searcher(
    needles: Sequence, groups: Sequence[tuple], *, device: DeviceLike = "cuda"
) -> BatchedSearcher:
    """A port ``BatchedSearcher`` whose width groups hold the given tables in
    the given row order.  ``groups``: one ``(values_host, masks_host,
    lengths, indices)`` tuple per JAX group, in the JAX group order."""
    bs = BatchedSearcher.__new__(BatchedSearcher)
    bs.needles = [as_bytes(n) for n in needles]
    bs.device = resolve_device(device)
    bs._huge = []
    bs.groups = [
        _Group(
            np.asarray(idx, np.int64),
            np.asarray(v, np.uint32),
            np.asarray(m, np.uint32),
            np.asarray(lens, np.int32),
            bs.device,
        )
        for v, m, lens, idx in groups
    ]
    covered = np.sort(np.concatenate([g.indices for g in bs.groups] or [np.zeros(0, np.int64)]))
    if not np.array_equal(covered, np.arange(len(bs.needles))):
        raise ValueError("group indices must cover every needle exactly once")
    bs._finish_init()
    return bs


def pairwise_searcher(
    needles: Sequence, valt, mskt, ln, block: int, *, device: DeviceLike = "cuda"
) -> PairwiseSearcher:
    """A port ``PairwiseSearcher`` holding a JAX searcher's needle tables:
    ``valt``/``mskt`` uint32 (tn, N) as the JAX package keeps them
    (``_valt``, ``_mskt``), ``ln`` int32 (N,) (``_ln``) and its ``block``."""
    valt = np.asarray(valt, np.uint32)
    mskt = np.asarray(mskt, np.uint32)
    ln = np.asarray(ln, np.int32).reshape(-1)
    ps = PairwiseSearcher.__new__(PairwiseSearcher)
    ps.needles = [bytes(w) for w in needles]
    ps.block = int(block)
    ps.device = resolve_device(device)
    n = len(ps.needles)
    if valt.ndim != 2 or valt.shape != mskt.shape or valt.shape[1] != n or ln.shape[0] != n:
        raise ValueError("valt, mskt (tn, N) and ln (N,) must describe the N needles")
    ps._set_tables(valt.T, mskt.T, ln)
    return ps
