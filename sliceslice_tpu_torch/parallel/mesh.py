"""The device mesh of a sharded corpus: a ``(data, needle)`` grid of cells.

Counterpart of ``sliceslice_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is a
grid of devices; the port's :class:`Mesh` is a grid of **cells**.  Each
cell is owned by one rank of a ``torch.distributed`` group (rank 0 when
there is none) and placed on one ``torch.device`` of that rank, and a
device may hold several cells.  Several cells on one device are the port's
counterpart of the JAX package's virtual CPU devices, and they are how one
card runs a 4x1 or a 2x2 mesh:

* ``data`` axis: the corpus cut into contiguous shards, one per data row;
  each cell scans its row's shard, and the first offsets and counts are
  combined with one MIN or SUM per query batch;
* ``needle`` axis: the needle rows split into blocks, one per column;
  needle tables are small, so this axis only partitions the work.

Across processes the data axis is cut into contiguous blocks of rows: rank
``r`` of ``W`` owns data rows ``[r * D / W, (r + 1) * D / W)``, every
needle column of them, so each process holds a contiguous byte range of
the corpus.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.layout import resolve_device

DATA_AXIS = "data"
NEEDLE_AXIS = "needle"

DeviceLike = Union[str, torch.device]


def world() -> Tuple[int, int]:
    """(world size, rank) of the initialized process group, (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def visible_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """Every visible device of ``device``'s type: each card for CUDA (the
    no-card ``ValueError`` without one), the one CPU for ``"cpu"``."""
    d = resolve_device(device)
    if d.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [d]


class Mesh:
    """A ``(n_data, n_needle)`` grid of cells, each owned by one rank and
    placed on one device of it (``devices``: an object array of
    ``torch.device``; ``owners``: an int array of ranks).  ``shape`` maps
    the axis names to their sizes, as a JAX mesh's does."""

    axis_names = (DATA_AXIS, NEEDLE_AXIS)

    def __init__(self, devices: np.ndarray, owners: np.ndarray, rank: int):
        self.devices = devices
        self.owners = owners
        self.rank = rank
        n_data, n_needle = devices.shape
        self.shape = {DATA_AXIS: n_data, NEEDLE_AXIS: n_needle}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, cells of rank {self.rank} on {sorted({str(d) for _, _, d in self.local_cells()})})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.rank == other.rank
                and np.array_equal(self.owners, other.owners)
                and self.devices.tolist() == other.devices.tolist())

    def local_cells(self) -> List[Tuple[int, int, torch.device]]:
        """``(data row, needle column, device)`` of every cell this rank
        owns, in row-major order (so data rows ascend)."""
        n_data, n_needle = self.devices.shape
        return [(d, j, self.devices[d, j]) for d in range(n_data) for j in range(n_needle)
                if self.owners[d, j] == self.rank]

    @property
    def home(self) -> torch.device:
        """The device of this rank's first cell, where its answers are
        combined and returned."""
        cells = self.local_cells()
        if not cells:
            raise ValueError(f"rank {self.rank} owns no cell of this mesh")
        return cells[0][2]

    @property
    def local_rows(self) -> List[int]:
        """The data rows this rank owns, ascending (contiguous)."""
        return sorted({d for d, _, _ in self.local_cells()})


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    *,
    device: DeviceLike = "cuda",
) -> Mesh:
    """Build a ``(data, needle)`` mesh of cells for this process group (one
    process unless ``torch.distributed`` is initialized).

    Default: one cell per visible device of ``device``'s type, all on the
    data axis (1x1 on one H100).  An explicit ``shape`` places this rank's
    cells round-robin on ``devices`` (default: the visible devices of
    ``device``'s type), so one card may hold several.  The cells must
    cover those devices evenly, else ``ValueError``.  In a group of ``W``
    processes the data axis must divide by ``W``: rank ``r`` owns data rows
    ``[r * D / W, (r + 1) * D / W)`` and places them on its own devices."""
    if devices is None:
        devs = visible_devices(device)
    else:
        devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n_world, rank = world()
    if shape is None:
        shape = (len(devs) * n_world, 1)
    n_data, n_needle = (int(x) for x in shape)
    if n_data < 1 or n_needle < 1:
        raise ValueError(f"mesh shape {tuple(shape)} has an empty axis")
    if n_data % n_world:
        raise ValueError(f"mesh shape {tuple(shape)}: a data axis of {n_data} rows does not divide "
                         f"over {n_world} processes")
    rows = n_data // n_world
    per_rank = rows * n_needle
    if per_rank % len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {len(devs)} devices "
                         f"({per_rank} cells per process)")
    owners = np.repeat(np.arange(n_world), rows)[:, None].repeat(n_needle, axis=1)
    cells = np.empty((n_data, n_needle), dtype=object)
    for d in range(n_data):
        for j in range(n_needle):
            cells[d, j] = devs[((d % rows) * n_needle + j) % len(devs)]
    return Mesh(cells, owners, rank)


def corpus_sharding(mesh: Mesh) -> dict:
    """Where the corpus lies: ``{data row: [(needle column, device, owning
    rank), ...]}``.  Data row ``d`` holds shard ``d`` of the corpus,
    replicated over its needle columns (the JAX ``P(data, None, None)``)."""
    n_data, n_needle = mesh.devices.shape
    return {d: [(j, mesh.devices[d, j], int(mesh.owners[d, j])) for j in range(n_needle)]
            for d in range(n_data)}


def table_sharding(mesh: Mesh) -> dict:
    """Where the needle tables lie: ``{needle column: [(data row, device,
    owning rank), ...]}``.  Column ``j`` holds needle row block ``j``,
    replicated over the data axis (the JAX ``P(needle, None)``)."""
    n_data, n_needle = mesh.devices.shape
    return {j: [(d, mesh.devices[d, j], int(mesh.owners[d, j])) for d in range(n_data)]
            for j in range(n_needle)}
