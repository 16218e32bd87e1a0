"""Multi-process set-up and the collectives of a sharded scan, on
``torch.distributed``.

Counterpart of ``sliceslice_tpu/parallel/distributed.py``.  The scan needs
nothing beyond ``shard_scan.py``: :func:`initialize` starts a process
group (NCCL when the cells are on the card, gloo on the CPU), a mesh made
in it spans every process (``mesh.make_mesh``), and
:func:`assemble_global_corpus` builds each process's shards from its own
contiguous byte range plus the bytes that follow it (the peek), so no
process ever holds the whole corpus.  :func:`all_reduce` and
:func:`all_gather` are the only collectives: a process with no group
calls none.  Stateless like the reference: recovery from a failure is
running the shard again.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.layout import ALIGN, MAX_DEVICE_POSITIONS, MIN_KH, padded_total, resolve_device, round_up
from .mesh import DeviceLike, Mesh, make_mesh, visible_devices, world

#: Seconds a collective may wait for the other processes before it raises
#: (collectives issued in a different order on two ranks hang, not fail).
DEFAULT_TIMEOUT_S = 300
#: Bytes copied to a device per step when shards are uploaded from host
#: bytes.
UPLOAD_STEP = 64 << 20

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Start the process group (a no-op for ``num_processes <= 1``, as in
    the JAX package, unless ``backend`` is named: then a group of one
    starts, which is how one card runs NCCL).

    ``coordinator_address``: ``"host:port"`` of rank 0's rendezvous
    (``init_method="tcp://..."``); None reads ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` from the environment.
    ``backend`` defaults to NCCL when ``device`` is a card and to gloo on
    the CPU; NCCL binds this process to ``device``.  A failure raises:
    nothing falls back to another backend."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1 and backend is None:
        return
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
        kw["rank"] = int(process_id or 0)
    elif init_method != "env://":
        kw["world_size"] = int(os.environ["WORLD_SIZE"])
        kw["rank"] = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def global_mesh(needle_axis: int = 1, *, cells_per_process: Optional[int] = None,
                device: DeviceLike = "cuda") -> Mesh:
    """A mesh over every process of the group: ``cells_per_process`` cells
    each (default: one per visible device of ``device``'s type), the data
    axis spanning the processes in rank order."""
    n_world, _ = world()
    per = cells_per_process or len(visible_devices(device))
    n = n_world * per
    if n % needle_axis:
        raise ValueError(f"{n} cells not divisible by needle axis {needle_axis}")
    return make_mesh((n // needle_axis, needle_axis), device=device)


# -- collectives -------------------------------------------------------------


def _group_backend() -> Optional[str]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def _comm_device(backend: str) -> torch.device:
    """Where a collective's tensor must lie: the bound card for NCCL, the
    CPU for gloo."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced in place across the group's processes with ``op``
    (``"min"`` or ``"sum"``; int64 reduces exactly), on ``x``'s device.
    Without a group, ``x`` as it is: no collective.  NCCL reduces a card's
    tensor where it lies; gloo takes a CPU copy (one small copy of N int64
    values, never a corpus)."""
    import torch.distributed as dist

    backend = _group_backend()
    if backend is None:
        return x
    reduce_op = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}[op]
    comm = _comm_device(backend)
    y = x if x.device == comm else x.to(comm)
    dist.all_reduce(y, op=reduce_op)
    all_reduce.calls += 1
    if y is not x:
        x.copy_(y)
    return x


all_reduce.calls = 0


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``(processes, *x.shape)``: every process's ``x``, in rank order, on
    ``x``'s device; ``x[None]`` without a group (no collective)."""
    import torch.distributed as dist

    backend = _group_backend()
    if backend is None:
        return x[None]
    comm = _comm_device(backend)
    y = x.contiguous().to(comm)
    out = torch.empty((dist.get_world_size(),) + tuple(y.shape), dtype=y.dtype, device=comm)
    if backend == "nccl":
        dist.all_gather_into_tensor(out, y)
    else:
        dist.all_gather(list(out.unbind(0)), y)
    all_gather.calls += 1
    return out.to(x.device)


all_gather.calls = 0


def allgather_i64(arr: np.ndarray) -> np.ndarray:
    """Every process's int64 host array, ``(processes, *arr.shape)``, exact
    past 2^31 (``torch.distributed`` carries int64 as it is: the JAX
    package's two int32 limbs are not needed).  One process with no group
    returns ``arr[None]`` without a collective."""
    a = np.ascontiguousarray(np.asarray(arr, np.int64))
    return all_gather(torch.from_numpy(a)).numpy()


def gather_positions(parts: list, axis_name: Optional[str] = None) -> list:
    """Gather per-process position lists (``sharded_positions`` /
    ``ShardedBatchedSearcher.positions_all`` output: one int64 array per
    needle, each process holding the offsets of its own shards) into the
    global ascending list on every process.

    Without a group, ``parts`` unchanged.  Otherwise two collectives: the
    lengths, then the arrays padded to the longest; processes own disjoint
    ascending byte ranges, so the merge concatenates in rank order (and
    sorts, defensively).  ``axis_name`` is accepted for the JAX
    signature."""
    if _group_backend() is None:
        return list(parts)
    n = len(parts)
    counts = np.asarray([int(p.size) for p in parts], np.int64)
    all_counts = allgather_i64(counts)  # (P, n)
    m = int(all_counts.max()) if all_counts.size else 0
    padded = np.zeros((n, max(m, 1)), np.int64)
    for i, p in enumerate(parts):
        padded[i, : p.size] = np.asarray(p, np.int64)
    allp = allgather_i64(padded)  # (P, n, m)
    out = []
    for i in range(n):
        arr = np.concatenate([allp[q, i, : all_counts[q, i]] for q in range(allp.shape[0])])
        arr.sort(kind="stable")
        out.append(arr)
    return out


# -- globally sharded corpora -------------------------------------------------


@dataclasses.dataclass
class ShardSet:
    """This process's shards of a globally sharded corpus: one zero-padded
    uint8 buffer per (data row, device) of its cells.  ``shape`` is the
    global ``(data rows, bytes per buffer)``."""

    shape: Tuple[int, int]
    buffers: dict


def _upload(row: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host uint8 row as a tensor on ``device``, copied in steps of
    :data:`UPLOAD_STEP` bytes."""
    if device.type == "cpu":
        return torch.from_numpy(np.array(row, dtype=np.uint8, copy=True))
    out = torch.empty((row.size,), dtype=torch.uint8, device=device)
    for a in range(0, row.size, UPLOAD_STEP):
        out[a:a + UPLOAD_STEP].copy_(torch.from_numpy(np.array(row[a:a + UPLOAD_STEP], copy=True)))
    return out


def make_global_corpus(local_rows: Iterable[np.ndarray], mesh: Mesh) -> ShardSet:
    """Place this process's shard rows on its cells: row ``i`` of
    ``local_rows`` (uint8, one buffer each, in data-row order) is shard
    ``mesh.local_rows[i]`` of the global corpus, uploaded once to every
    device that holds a cell of that row.  Rows may come from a generator,
    so only one is on the host at a time; no process touches the rest of
    the corpus."""
    rows = mesh.local_rows
    buffers = {}
    width = None
    count = 0
    for d, row in zip(rows, local_rows):
        row = np.asarray(row, dtype=np.uint8).reshape(-1)
        if width is None:
            width = row.size
        elif row.size != width:
            raise ValueError("every shard row must have the same length")
        for dev in dict.fromkeys(dv for dd, _, dv in mesh.local_cells() if dd == d):
            buffers[(d, dev)] = _upload(row, dev)
        count += 1
    if count != len(rows):
        raise ValueError(f"{count} shard rows for the {len(rows)} data rows this process owns")
    return ShardSet((mesh.shape["data"], width or 0), buffers)


def local_shard_rows(local_bytes: BytesLike, peek: BytesLike, shard_bytes: int, kh: int,
                     rows: int) -> Iterable[np.ndarray]:
    """This process's ``rows`` shard buffers, one at a time, from its
    contiguous byte range ``local_bytes`` and the ``peek`` bytes that follow
    it in the global stream (shorter or empty at the corpus's end): shard
    ``i`` holds range bytes ``[i * shard_bytes, (i + 1) * shard_bytes)``,
    then ``kh`` halo bytes of what follows (the next shard, or the peek),
    then zeros, ``padded_total(shard_bytes, kh)`` bytes in all.  The halo
    is read-only context: a match belongs to the shard holding its first
    byte."""
    local = np.frombuffer(memoryview(local_bytes).cast("B"), dtype=np.uint8)
    pk = np.frombuffer(memoryview(peek).cast("B"), dtype=np.uint8)
    kh = round_up(max(kh, MIN_KH), 32)
    total = padded_total(shard_bytes, kh)
    if local.size > rows * shard_bytes:
        raise ValueError(f"local range of {local.size} bytes exceeds rows * shard_bytes = {rows * shard_bytes}")
    for i in range(rows):
        buf = np.zeros((total,), dtype=np.uint8)
        lo, hi = i * shard_bytes, i * shard_bytes + shard_bytes + kh
        body = local[lo:min(hi, local.size)]
        buf[: body.size] = body
        if hi > local.size and lo < local.size + pk.size:
            tail = pk[max(lo - local.size, 0):hi - local.size]
            at = max(local.size - lo, 0)
            buf[at:at + tail.size] = tail
        yield buf


@dataclasses.dataclass
class GlobalCorpus:
    """A corpus sharded over a mesh's data axis across processes: the
    multi-process counterpart of ``DeviceHaystack``, built by
    :func:`assemble_global_corpus`.  ``length`` is the true global byte
    length (a Python int: offsets past 2 GiB take the int64 combine);
    shard ``d`` covers bytes ``[d * shard_bytes, (d + 1) * shard_bytes)``
    and this process holds only the shards of its own data rows.

    ``local_bytes`` / ``local_peek`` / ``local_base`` (references the caller
    already holds, not copies) let huge needles verify candidates against
    this process's range: a candidate is verified by the process holding
    its first byte, reading into the peek across the range's end (the peek
    must then cover ``len(needle) - 1`` bytes, or reach the corpus end)."""

    length: int
    kh: int
    shard_bytes: int
    mesh: Mesh
    shards: ShardSet
    local_bytes: Optional[BytesLike] = None
    local_peek: BytesLike = b""
    local_base: int = 0

    @property
    def own_end(self) -> int:
        """Global end of this process's byte range (exclusive)."""
        rows = len(self.mesh.local_rows)
        return min(self.local_base + rows * self.shard_bytes, self.length)


def assemble_global_corpus(
    local_bytes: BytesLike,
    peek: BytesLike,
    global_length: int,
    kh: int,
    mesh: Mesh,
    shard_bytes: Optional[int] = None,
    keep_local: bool = True,
) -> GlobalCorpus:
    """Each process's bring-up of a sharded corpus: every process calls
    this with its contiguous byte range (in rank order), the bytes that
    follow it (at least ``kh`` for the halo; longer peeks let huge needles
    verify across the range's end) and the true global length; no process
    ever holds the whole corpus.

    ``shard_bytes`` (a multiple of 128, the same on every process; it
    replaces the JAX package's TPU segment geometry ``s``, ``g_local``):
    the bytes of each data row's shard; default the least that holds every
    process's range.  Every range but the last must be exactly ``rows *
    shard_bytes`` bytes, ``rows`` being the data rows a process owns.  One
    collective checks this on every process alike (each raises the same
    ``ValueError``).  ``keep_local`` keeps the byte references for huge
    needles."""
    kh = round_up(max(kh, MIN_KH), 32)
    n_world, rank = world()
    rows = len(mesh.local_rows)
    if rows == 0:
        raise ValueError(f"rank {rank} owns no data row of this mesh")
    size = memoryview(local_bytes).nbytes
    guess = max(ALIGN, round_up(-(-size // rows), ALIGN))
    asked = -1 if shard_bytes is None else int(shard_bytes)
    info = allgather_i64(np.asarray([size, guess, asked], np.int64))
    sizes = info[:, 0]
    if shard_bytes is None:
        if (info[:, 2] != -1).any():
            raise ValueError("every process must pass the same shard_bytes")
        shard_bytes = int(info[:, 1].max())
    elif (info[:, 2] != asked).any():
        raise ValueError("every process must pass the same shard_bytes")
    if shard_bytes <= 0 or shard_bytes % ALIGN:
        raise ValueError(f"shard_bytes={shard_bytes} is not a positive multiple of {ALIGN}")
    if padded_total(shard_bytes, kh) > MAX_DEVICE_POSITIONS:
        raise ValueError(
            f"shard of {shard_bytes} bytes exceeds the int32 device-offset range; "
            "use more data-axis shards (or smaller shards)")
    span = rows * shard_bytes
    for q in range(n_world):
        if sizes[q] > span or (q < n_world - 1 and sizes[q] != span):
            raise ValueError(f"process {q}'s range of {int(sizes[q])} bytes is not "
                             f"{rows} shards of {shard_bytes} bytes")
    if int(sizes.sum()) != int(global_length):
        raise ValueError(f"the processes' ranges hold {int(sizes.sum())} bytes, "
                         f"not global_length={global_length}")
    base = rank * span
    pk = memoryview(peek).cast("B")[: max(0, int(global_length) - base - size)]
    shards = make_global_corpus(local_shard_rows(local_bytes, pk, shard_bytes, kh, rows), mesh)
    return GlobalCorpus(
        length=int(global_length), kh=kh, shard_bytes=shard_bytes, mesh=mesh, shards=shards,
        local_bytes=local_bytes if keep_local else None,
        local_peek=peek if keep_local else b"", local_base=base,
    )
