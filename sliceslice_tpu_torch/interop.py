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
from .searcher import DeviceLike, resolve_device


def haystack(
    host_bytes, length: int, kh: int, tiled: bool, *, device: DeviceLike = "cpu"
) -> DeviceHaystack:
    """The port's layout of a JAX ``DeviceHaystack``: its host bytes,
    logical ``length``, halo ``kh`` and whether it is tiled (the kernel
    layout) or flat."""
    buf = np.frombuffer(bytes(host_bytes), dtype=np.uint8)
    return preprocess(buf, kh=kh, force_cols=tiled, length=length, device=device)


def batched_searcher(
    needles: Sequence, groups: Sequence[tuple], *, device: DeviceLike = "cpu"
) -> BatchedSearcher:
    """A port ``BatchedSearcher`` whose width groups hold the given tables in
    the given row order.  ``groups``: one ``(values_host, masks_host,
    lengths, indices)`` tuple per JAX group, in the JAX group order."""
    bs = BatchedSearcher.__new__(BatchedSearcher)
    bs.needles = [as_bytes(n) for n in needles]
    bs.device = resolve_device(device)
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
