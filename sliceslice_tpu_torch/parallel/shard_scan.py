"""Sharded corpus scanner: first offsets, counts and positions of N needles
over a corpus cut into shards along a mesh's data axis.

Counterpart of ``sliceslice_tpu/parallel/shard_scan.py``.  Each cell of the
mesh runs the port's kernels (``scan_kernel.batched_find``,
``batched_count``, ``match_bitmap_counted``, ``item_ranks``,
``compact_window``) over its
row's shard for its column's block of needle rows, with shard-local int32
offsets and ``base = 0``; the shard's int64 base is added when the cells
are combined, on the device, and one ``torch.distributed`` collective per
query batch combines the processes (none without a process group).

* **Exactly once at a shard boundary.**  Shard ``d`` covers bytes ``[d *
  shard_bytes, (d + 1) * shard_bytes)`` and carries the next ``kh`` bytes
  as read-only halo; each needle's bound is clipped to the shard, ``clip(end
  - d * shard_bytes, 0, shard_bytes)`` in int64, so a match belongs to the
  shard holding its first byte.
* **First offsets** are the least global offset ``d * shard_bytes +
  local``: shard bases ascend with ``d``, so this is the JAX package's
  lexicographic (shard, local offset) minimum, taken with one int64 MIN
  (absent: the int64 maximum).  Counts are one int64 SUM.
* **Return types** are the JAX package's: a device int32 tensor
  (``SENTINEL`` absent) when the padded global corpus fits int32 and
  ``force_int64`` is off, else a host int64 ndarray (-1 absent).
* **Positions** are compacted per (needle, shard) cell: the bitmap, rank
  and compaction kernels of ``torch_backend.two_tier_positions``, the shard's
  base added in int64, lists joined in shard order.  A process returns the
  offsets of its own shards (``gather_positions`` joins them).

A shard of a ``DeviceHaystack`` is a view of its layout: bytes ``[d *
shard_bytes, d * shard_bytes + padded_total(shard_bytes, kh))``, whose tail
past the shard is the next shard's bytes (the halo) or the layout's zero
padding; a cell on another device takes a copy of that view.  A
``GlobalCorpus`` brings its shards built (``distributed.py``).
"""

from __future__ import annotations

import weakref
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import SENTINEL
from ..needle import build_probe_table, needed_halo_for_t
from ..ops import layout as layout_mod
from ..ops import scan_kernel, torch_backend
from ..ops.layout import ALIGN, MAX_DEVICE_POSITIONS, DeviceHaystack, padded_total, round_up
from ..ops.scan_math import table_bits
from .distributed import GlobalCorpus, all_reduce, gather_positions
from .mesh import DATA_AXIS, NEEDLE_AXIS, Mesh

#: The find combine's "absent": larger than any global offset.
INT64_MAX = torch.iinfo(torch.int64).max
FIND, COUNT = "find", "count"


class Placement(NamedTuple):
    """A corpus cut into a mesh's shards, as this process holds it."""

    length: int
    kh: int
    shard_bytes: int
    n_data: int
    #: (data row, device) -> uint8 tensor: the shard, its halo, padding.
    shards: dict

    @property
    def fits32(self) -> bool:
        """Whether every offset of the padded global corpus fits int32."""
        return self.n_data * self.shard_bytes <= SENTINEL


class Cell(NamedTuple):
    """One cell's part of one probe table: needle rows ``[row0, row0 +
    rows)`` over shard ``d`` (global base ``base``), its tables and clipped
    int32 ends on ``device``."""

    d: int
    device: torch.device
    base: int
    values: torch.Tensor
    masks: torch.Tensor
    ends: torch.Tensor
    row0: int
    rows: int


def shard_bytes_for(length: int, n_data: int) -> int:
    """Bytes per shard of a ``length``-byte corpus cut ``n_data`` ways:
    the least multiple of 128 that covers it."""
    return max(ALIGN, round_up(-(-int(length) // n_data), ALIGN))


def place_corpus(corpus, mesh: Mesh) -> Placement:
    """The shards of ``corpus`` on this process's cells of ``mesh``.  A
    ``DeviceHaystack`` is cut into views of its layout (a cell on another
    device takes a copy); a ``GlobalCorpus`` must have been assembled for
    this mesh."""
    n_data = mesh.shape[DATA_AXIS]
    if isinstance(corpus, GlobalCorpus):
        if corpus.mesh != mesh:
            raise ValueError("the global corpus was assembled for another mesh")
        return Placement(corpus.length, corpus.kh, corpus.shard_bytes, n_data, corpus.shards.buffers)
    if not isinstance(corpus, DeviceHaystack):
        raise TypeError(f"a sharded scan takes a DeviceHaystack or a GlobalCorpus, not {type(corpus).__name__}")
    sb = shard_bytes_for(corpus.length, n_data)
    span = padded_total(sb, corpus.kh)
    if span > MAX_DEVICE_POSITIONS:
        raise ValueError(f"shard of {sb} bytes exceeds the int32 device-offset range; "
                         "use more data-axis shards (or smaller shards)")
    shards = {}
    for d, _, dev in mesh.local_cells():
        lo = d * sb
        if lo >= corpus.length or (d, dev) in shards:
            continue  # a pad shard: every position lies past every needle's end
        view = corpus.flat[lo:min(lo + span, corpus.flat.numel())]
        shards[(d, dev)] = view if dev == corpus.device else view.to(dev)
    return Placement(corpus.length, corpus.kh, sb, n_data, shards)


def _tables(values, masks, device: torch.device):
    """Probe tables as re-masked int32 bit-pattern tensors on ``device``."""
    if isinstance(values, np.ndarray) or isinstance(masks, np.ndarray):
        v = np.asarray(values, np.uint32) & np.asarray(masks, np.uint32)
        return table_bits(v, device), table_bits(masks, device)
    m = table_bits(masks, device)
    return table_bits(values, device) & m, m


def cells_of(place: Placement, mesh: Mesh, values: torch.Tensor, masks: torch.Tensor,
             ends) -> List[Cell]:
    """This process's cells for one probe table (int32 tensors of ``n``
    rows) with global int64 ``ends``: column ``j`` takes rows ``[j * ceil(n /
    N), ...)``; a cell whose shard is missing (past the corpus) or whose
    clipped ends are all 0 has no work and is left out."""
    n, t = values.shape
    if needed_halo_for_t(t) > place.kh:
        raise ValueError(f"probe table width {t} needs {needed_halo_for_t(t)} halo bytes, layout has {place.kh}")
    ends64 = np.asarray(ends, dtype=np.int64).reshape(-1)
    if ends64.shape[0] != n:
        raise ValueError("values, masks and ends must describe the same rows")
    per = -(-n // mesh.shape[NEEDLE_AXIS]) if n else 0
    sb = place.shard_bytes
    out = []
    for d, j, dev in mesh.local_cells():
        r0, r1 = j * per, min((j + 1) * per, n)
        if (d, dev) not in place.shards or r1 <= r0:
            continue
        local = np.clip(ends64[r0:r1] - d * sb, 0, sb)
        if not local.any():
            continue
        out.append(Cell(d, dev, d * sb, values[r0:r1].to(dev), masks[r0:r1].to(dev),
                        torch.from_numpy(local.astype(np.int32)).to(dev), r0, r1 - r0))
    return out


def combine_cells(acc: torch.Tensor, offset: int, place: Placement, cells: Sequence[Cell],
                  mode: str) -> None:
    """Run one find (or count) launch per cell and fold its answers into
    ``acc[offset + row]`` (int64, on its own device): the least global
    offset (find) or the sum (count)."""
    kernel = scan_kernel.batched_find if mode == FIND else scan_kernel.batched_count
    for c in cells:
        out = kernel(place.shards[(c.d, c.device)], c.values, c.masks, c.ends).to(acc.device)
        seg = acc[offset + c.row0: offset + c.row0 + c.rows]
        if mode == FIND:
            torch.minimum(seg, torch.where(out < SENTINEL, out.to(torch.int64) + c.base, INT64_MAX), out=seg)
        else:
            seg += out


def new_acc(n: int, mode: str, device: torch.device) -> torch.Tensor:
    if mode == FIND:
        return torch.full((n,), INT64_MAX, dtype=torch.int64, device=device)
    return torch.zeros((n,), dtype=torch.int64, device=device)


def reduce_acc(acc: torch.Tensor, mode: str) -> torch.Tensor:
    """The processes' partial answers combined: one MIN or SUM."""
    return all_reduce(acc, "min" if mode == FIND else "sum")


def sweep(place: Placement, cells: Sequence[Sequence[Cell]], sizes: Sequence[int], mode: str, mesh: Mesh,
          mark=None) -> torch.Tensor:
    """One sharded find (or count) sweep of every width group: each
    group's cells launched and folded into one int64 vector on
    ``mesh.home`` (group ``k``'s rows from ``sum(sizes[:k])``), then one
    collective across the processes.  ``mark(stage)``, when given, is
    called after the launches and combine and after the collective (a
    timing hook)."""
    acc = new_acc(sum(sizes), mode, mesh.home)
    off = 0
    for n, gc in zip(sizes, cells):
        combine_cells(acc, off, place, gc, mode)
        off += n
    if mark is not None:
        mark("launches_and_combine")
    acc = reduce_acc(acc, mode)
    if mark is not None:
        mark("collective")
    return acc


def finish(acc: torch.Tensor, mode: str, fits32: bool):
    """The JAX return types: a device int32 tensor (SENTINEL absent) when
    ``fits32``, else a host int64 ndarray (-1 absent)."""
    if fits32:
        if mode == FIND:
            return torch.where(acc == INT64_MAX, SENTINEL, acc).to(torch.int32)
        return acc.to(torch.int32)
    out = acc.cpu().numpy()
    return np.where(out == INT64_MAX, -1, out) if mode == FIND else out


def _homogeneous(place, values, masks, ends, mesh, mode, force_int64):
    v, m = _tables(values, masks, mesh.home)
    acc = sweep(place, [cells_of(place, mesh, v, m, ends)], [v.shape[0]], mode, mesh)
    return finish(acc, mode, place.fits32 and not force_int64)


def _sharded(place, values, masks, ends, mesh, mode, force_int64, assume_homogeneous):
    if assume_homogeneous:
        return _homogeneous(place, values, masks, ends, mesh, mode, force_int64)
    masks_np = masks.cpu().numpy() if isinstance(masks, torch.Tensor) else np.asarray(masks)
    eff = (masks_np != 0).sum(axis=1)  # active slots are contiguous from 0
    real = eff > 0  # all-zero rows are padding (end 0: never match)
    if (eff[real] == masks_np.shape[1]).all():
        return _homogeneous(place, values, masks, ends, mesh, mode, force_int64)
    # Mixed widths: one homogeneous table per effective width (a narrow row
    # then pays only for its own slots), merged in input order.
    values_np = values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
    ends_np = np.asarray(ends, np.int64).reshape(-1)
    n = values_np.shape[0]
    parts = []
    for w in np.unique(eff[real]):
        idx = np.nonzero(eff == w)[0]
        w = max(int(w), 1)
        parts.append((idx, _homogeneous(place, values_np[idx, :w].view(np.uint32),
                                        masks_np[idx, :w].view(np.uint32), ends_np[idx], mesh, mode,
                                        force_int64)))
    if parts and isinstance(parts[0][1], np.ndarray):
        out = np.full((n,), -1 if mode == FIND else 0, np.int64)
        for idx, p in parts:
            out[idx] = p
        return out
    out = torch.full((n,), SENTINEL if mode == FIND else 0, dtype=torch.int32, device=mesh.home)
    for idx, p in parts:
        out[torch.from_numpy(idx).to(mesh.home)] = p
    return out


def sharded_find_cols(dh, values, masks, ends, mesh: Mesh, mode: str = FIND,
                      force_int64: bool = False, assume_homogeneous: bool = False):
    """Exact global first-match offsets of N needles over ``dh`` (a
    ``DeviceHaystack`` or a ``GlobalCorpus``) cut into ``mesh``'s shards
    (``mode="count"``: overlapping counts instead).

    ``values`` / ``masks``: uint32 numpy tables or int32 bit-pattern
    tensors; ``ends``: global int64 bounds per needle (the kernels see
    only shard-local clipped int32 ends).  Returns a device int32 tensor
    (SENTINEL absent) on ``mesh.home`` when the padded global corpus fits
    int32, else a host int64 ndarray (-1 absent); ``force_int64`` takes
    the second path on any corpus.  Mixed-width tables are regrouped by
    effective width unless ``assume_homogeneous`` (a grouped table: no
    width detection, so no readback of a device table)."""
    return _sharded(place_corpus(dh, mesh), values, masks, ends, mesh, mode, force_int64,
                    assume_homogeneous)


def sharded_count_cols(dh, values, masks, ends, mesh: Mesh, force_int64: bool = False,
                       assume_homogeneous: bool = False):
    """Overlapping occurrence counts over a sharded corpus: the count
    analogue of :func:`sharded_find_cols`, with its return types."""
    return sharded_find_cols(dh, values, masks, ends, mesh, mode=COUNT, force_int64=force_int64,
                             assume_homogeneous=assume_homogeneous)


def positions_of_cells(place: Placement, cells: Sequence[Cell], n: int, cap: int,
                       batch: Optional[int] = None) -> List[np.ndarray]:
    """Every offset of each of ``n`` rows over this process's cells: per
    cell, launch batches of at most ``batch`` rows (and of the positions
    budget, ``torch_backend.position_batches``), each compacted on the
    cell's device by ``torch_backend.two_tier_positions``; the cell's base
    added in int64, lists joined in shard order."""
    parts: List[list] = [[] for _ in range(n)]
    for c in sorted(cells, key=lambda c: c.d):
        shard = place.shards[(c.d, c.device)]
        for i0, i1 in torch_backend.position_batches(c.rows, shard.numel(), c.values.shape[1], batch):
            res = torch_backend.two_tier_positions(shard, c.values[i0:i1], c.masks[i0:i1], c.ends[i0:i1], cap)
            for k, p in enumerate(res):
                if p.size:
                    parts[c.row0 + i0 + k].append(p + c.base)
    return [np.concatenate(p) if p else np.empty((0,), np.int64) for p in parts]


def sharded_positions(dh, values, masks, ends, mesh: Mesh, sparse_cap: Optional[int] = None) -> list:
    """ALL (overlapping) match offsets per needle over a sharded corpus,
    int64 ascending, every (needle, shard) cell compacted on its device
    (``torch_backend.two_tier_positions``: the answers of the JAX two
    tiers; ``sparse_cap``, the JAX signature's, is only validated).  This
    process's shards only (``gather_positions`` joins the processes)."""
    cap = torch_backend.SPARSE_POSITIONS_CAP if sparse_cap is None else int(sparse_cap)
    place = place_corpus(dh, mesh)
    v, m = _tables(values, masks, mesh.home)
    return positions_of_cells(place, cells_of(place, mesh, v, m, ends), v.shape[0], cap)


class ShardedBatchedSearcher:
    """``BatchedSearcher`` over a mesh: the same API, sharded execution.

    Per corpus (and per row order: ``optimize_for`` bumps the inner
    searcher's epoch) the shards and every cell's tables and clipped ends
    are built once and cached, so a repeated sweep is one launch per cell
    and width group, the on-device combine, one collective and one
    readback.  Needles longer than ``MAX_NEEDLE_LEN`` take the huge-needle
    filter and verify over the mesh: one sharded count of every prefix
    decides each needle's tier from the global candidate count; the host
    tier verifies each candidate in the process holding its first byte,
    the dense tier runs on this process's own byte range."""

    _PLACED_CACHE_CAP = 16

    def __init__(self, needles, mesh: Mesh, position=None):
        from ..models.batched import BatchedSearcher

        self.mesh = mesh
        #: where answers are combined: the device of this process's first cell.
        self.device = mesh.home
        self.inner = BatchedSearcher(needles, position, device=self.device)
        #: test hook: the int64 host combine on any corpus.
        self.force_int64 = False
        self._placed_corpus: dict = {}
        self._huge_local_layouts: dict = {}
        self._huge_table = None

    def __len__(self) -> int:
        return len(self.inner)

    def _corpus(self, hay):
        """A ``GlobalCorpus`` as it is, after a halo check (re-laying it
        would assemble the corpus on one process); anything else through
        the inner searcher's layout (its halo sized for the needle set)."""
        if isinstance(hay, GlobalCorpus):
            need = self.inner._halo()
            if hay.kh < need:
                raise ValueError(f"global corpus halo kh={hay.kh} < required {need}; "
                                 "assemble with a larger kh for this needle set")
            return hay
        return self.inner._layout(hay)

    def _placed(self, corpus):
        """(placement, cells per width group), cached per (corpus identity,
        epoch) with a weak reference to the corpus: a dropped corpus's
        entry is purged at the next insert, and a recycled id never pairs
        a new corpus with stale tables.  FIFO cap of 16 entries."""
        key = (id(corpus), self.inner._epoch)
        hit = self._placed_corpus.get(key)
        if hit is None or hit[0]() is not corpus:
            place = place_corpus(corpus, self.mesh)
            cells = []
            for g in self.inner.groups:
                ends = np.maximum(np.int64(corpus.length) - g.lengths.astype(np.int64) + 1, 0)
                cells.append(cells_of(place, self.mesh, g.values_dev[:g.n], g.masks_dev[:g.n], ends))
            self._placed_corpus[key] = (weakref.ref(corpus), place, cells)
            for k in [k for k, v in self._placed_corpus.items() if v[0]() is None]:
                del self._placed_corpus[k]
            while len(self._placed_corpus) > self._PLACED_CACHE_CAP:
                self._placed_corpus.pop(next(iter(self._placed_corpus)))
        return self._placed_corpus[key][1:]

    def _sweep(self, corpus, mode: str, mark=None) -> np.ndarray:
        """int64 answers in input order (find: -1 absent) of every width
        group: one :func:`sweep` (its cells' launches into one on-device
        vector, one collective), then one readback.  ``mark`` is
        :func:`sweep`'s timing hook, called once more after the
        readback."""
        n = len(self.inner)
        init = -1 if mode == FIND else 0
        if not self.inner.groups:
            return np.full((n,), init, np.int64)
        place, cells = self._placed(corpus)
        acc = sweep(place, cells, [g.n for g in self.inner.groups], mode, self.mesh, mark)
        res = finish(acc, mode, place.fits32 and not self.force_int64)
        if isinstance(res, torch.Tensor):
            res = res.cpu().numpy().astype(np.int64)
            if mode == FIND:
                res[res >= SENTINEL] = -1
        if mark is not None:
            mark("finish_and_readback")
        out = np.full((n,), init, np.int64)
        off = 0
        for g in self.inner.groups:
            out[g.indices] = res[off:off + g.n]
            off += g.n
        return out

    # -- huge needles: sharded prefix filter, verify where the bytes are ------

    def _huge_ctx(self, corpus, place: Placement) -> tuple:
        """(bytes, global offset of their first byte, own range start, own
        range end, peek): the bytes this process verifies candidates
        against and the global range whose candidates it owns (those whose
        first byte it holds: exactly once, as at shard boundaries)."""
        if isinstance(corpus, GlobalCorpus):
            if corpus.local_bytes is None:
                raise ValueError("huge-needle search over a GlobalCorpus requires the local byte range "
                                 "for the verify step; assemble_global_corpus with keep_local=True")
            return (corpus.local_bytes, corpus.local_base, corpus.local_base, corpus.own_end,
                    corpus.local_peek)
        if corpus.host_bytes is None:
            raise ValueError("huge-needle search requires host bytes for the verify step "
                             "(preprocess with keep_host=True)")
        rows = self.mesh.local_rows
        sb = place.shard_bytes
        return (corpus.host_bytes, 0, min(rows[0] * sb, corpus.length),
                min((rows[-1] + 1) * sb, corpus.length), b"")

    @staticmethod
    def _huge_match_at(data, peek, rel: int, full: bytes) -> bool:
        """Compare ``full`` at offset ``rel`` of ``data``, reading into the
        peek for a candidate across the range's end."""
        k = len(full)
        view = memoryview(data).cast("B")
        if rel + k <= view.nbytes:
            return view[rel:rel + k] == full
        head = bytes(view[rel:])
        tail = k - len(head)
        pk = memoryview(peek).cast("B")
        if tail > pk.nbytes:
            raise ValueError(
                f"huge-needle verify needs {tail} bytes past this process's local range but the "
                f"peek holds {pk.nbytes}; assemble_global_corpus with a peek of at least "
                "len(needle) - 1 bytes")
        return head == full[:len(head)] and pk[:tail] == full[len(head):]

    def _huge_prefix_table(self):
        """One probe table of every huge needle's 64-byte prefix (t = 16),
        on the mesh's home device."""
        if self._huge_table is None:
            vals, msks, _ = build_probe_table([hs.needle.data for _, hs in self.inner._huge])
            self._huge_table = _tables(vals, msks, self.mesh.home)
        return self._huge_table

    def _huge_positions_local(self, corpus, first_only: bool = False) -> dict:
        """{needle index: verified global offsets (int64 ascending) that
        this process owns}.  One sharded count of every prefix (one SUM)
        gives each needle's global candidate count, identical on every
        process, so every process takes the same tier: none, the host
        verify (one sharded positions pass over the host-tier needles'
        prefixes, each candidate compared where its first byte lies) or,
        past ``HOST_VERIFY_MAX`` candidates, the dense tier over this
        process's own range.  ``first_only`` stops a needle at its first
        verified candidate."""
        from ..models.huge import HOST_VERIFY_MAX

        huge = self.inner._huge
        if not huge:
            return {}
        place = self._placed(corpus)[0]
        data, data_base, own_lo, own_hi, peek = self._huge_ctx(corpus, place)
        v, m = self._huge_prefix_table()
        ks = np.asarray([hs.size for _, hs in huge], np.int64)
        ends = np.maximum(np.int64(corpus.length) - ks + 1, 0)
        ncand = _homogeneous(place, v, m, ends, self.mesh, COUNT, True)
        host = [r for r in range(len(huge)) if 0 < ncand[r] <= HOST_VERIFY_MAX]
        cands = {}
        if host:
            sel = torch.tensor(host, device=v.device)
            got = positions_of_cells(place, cells_of(place, self.mesh, v[sel], m[sel], ends[host]), len(host),
                                     HOST_VERIFY_MAX)
            cands = dict(zip(host, got))
        out = {}
        for r, (i, hs) in enumerate(huge):
            if ncand[r] > HOST_VERIFY_MAX:
                out[i] = self._huge_dense_local(hs, first_only, corpus, data, data_base, own_lo, own_hi, peek,
                                                place.shard_bytes)
                continue
            good = []
            for c in cands.get(r, ()):
                c = int(c)
                if not own_lo <= c < own_hi:
                    # This process's cells ARE its own contiguous range: a
                    # candidate outside it means the mesh broke that
                    # contract; fail rather than miss a match.
                    raise RuntimeError(f"candidate offset {c} outside this process's range "
                                       f"[{own_lo}, {own_hi}); the mesh does not match the corpus's ranges")
                if self._huge_match_at(data, peek, c - data_base, hs._full):
                    good.append(c)
                    if first_only:
                        break
            out[i] = np.asarray(good, np.int64)
        return out

    def _huge_dense_local(self, hs, first_only, corpus, data, data_base, own_lo, own_hi, peek,
                          shard_bytes) -> np.ndarray:
        """Dense tier over this process's own range: the huge searcher's
        tiers over local layouts of its bytes plus ``k - 1`` bytes past
        each piece's end (from the next bytes or the peek); ownership keeps
        results exactly once.  A single process over a ``DeviceHaystack``
        searches the layout itself.  Local layouts are cached per (bytes
        identity, peek identity, range, tail): a repeated dense query
        uploads nothing."""
        if own_hi <= own_lo:
            return np.empty((0,), np.int64)
        if isinstance(corpus, DeviceHaystack) and own_lo == 0 and own_hi == corpus.length:
            if first_only:
                f = hs.find(corpus)
                return np.empty((0,), np.int64) if f is None else np.asarray([f], np.int64)
            return hs.positions(corpus)
        k = hs.size
        key = (id(data), id(peek), own_lo, own_hi, k - 1)
        hit = self._huge_local_layouts.get(key)
        if hit is not None and hit[0] is data and hit[1] is peek:
            pieces = hit[2]
        else:
            pieces = self._dense_pieces(data, data_base, own_lo, own_hi, peek, k, shard_bytes)
            # Strong references to the bytes and the peek keep the id()
            # keys valid (bytes take no weak reference); FIFO capacity bounds
            # what a dropped corpus can pin.
            self._huge_local_layouts[key] = (data, peek, pieces)
            while len(self._huge_local_layouts) > self._PLACED_CACHE_CAP:
                self._huge_local_layouts.pop(next(iter(self._huge_local_layouts)))
        found = []
        for lo, hi, dhl in pieces:
            if first_only:
                f = hs.find(dhl)
                if f is not None and f < hi - lo:
                    return np.asarray([lo + f], np.int64)
                continue
            pos = hs.positions(dhl)
            found.append(pos[pos < hi - lo] + lo)
        return np.concatenate(found) if found else np.empty((0,), np.int64)

    def _dense_pieces(self, data, data_base, own_lo, own_hi, peek, k, shard_bytes) -> list:
        """[(global start, global end, local layout)] covering ``[own_lo,
        own_hi)``: one piece when the range fits one layout, else one per
        shard."""
        from ..models.huge import CHUNK

        kh = needed_halo_for_t(CHUNK // 4)
        step = own_hi - own_lo
        if padded_total(step + k, kh) > MAX_DEVICE_POSITIONS:
            step = shard_bytes
        view = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
        pk = np.frombuffer(memoryview(peek).cast("B"), dtype=np.uint8)
        pieces = []
        for lo in range(own_lo, own_hi, step):
            hi = min(lo + step, own_hi)
            a, b = lo - data_base, hi - data_base + k - 1
            body = view[a:min(b, view.size)]
            if b > view.size:
                body = np.concatenate([body, pk[:b - view.size]])
            pieces.append((lo, hi, layout_mod.preprocess(body, kh=kh, device=self.mesh.home)))
        return pieces

    def _fill_huge(self, out: np.ndarray, corpus, mode: str) -> np.ndarray:
        """The huge needles' answers: each process's own, combined with one
        MIN (find) or SUM (count)."""
        pos = self._huge_positions_local(corpus, first_only=mode == FIND)
        if not pos:
            return out
        idx = sorted(pos)
        if mode == FIND:
            local = torch.tensor([int(pos[i][0]) if pos[i].size else INT64_MAX for i in idx], dtype=torch.int64)
        else:
            local = torch.tensor([pos[i].size for i in idx], dtype=torch.int64)
        got = reduce_acc(local, mode).numpy()
        out[idx] = np.where(got == INT64_MAX, -1, got) if mode == FIND else got
        return out

    # -- public API ------------------------------------------------------------

    def find_all(self, hay) -> np.ndarray:
        """First-match offset per needle (int64[N]); -1 where absent."""
        corpus = self._corpus(hay)
        return self._fill_huge(self._sweep(corpus, FIND), corpus, FIND)

    def count_all(self, hay) -> np.ndarray:
        """Overlapping occurrence counts (int64[N]) across the sharded
        corpus: one SUM per query batch."""
        corpus = self._corpus(hay)
        return self._fill_huge(self._sweep(corpus, COUNT), corpus, COUNT)

    def positions_all(self, hay, batch: Optional[int] = None, gather: bool = False,
                      sparse_cap: int = torch_backend.SPARSE_POSITIONS_CAP) -> list:
        """ALL (overlapping) match offsets per needle (int64[M] ascending,
        input order) across the sharded corpus.  ``batch`` caps the rows
        of one launch batch (default: the positions budget, as
        ``BatchedSearcher.positions_all``); every cell's rows are compacted
        on the card, sparse and dense alike, so ``sparse_cap`` (the JAX
        signature's) is only validated.  In a group of processes each
        returns the offsets of its own shards; ``gather=True`` gives every
        process the global lists (two collectives)."""
        corpus = self._corpus(hay)
        place, cells = self._placed(corpus)
        out: list = [None] * len(self.inner)
        for g, gc in zip(self.inner.groups, cells):
            for j, p in zip(g.indices.tolist(), positions_of_cells(place, gc, g.n, sparse_cap, batch)):
                out[j] = p
        for i, pos in self._huge_positions_local(corpus).items():
            out[i] = pos
        return gather_positions(out) if gather else out

    def optimize_for(self, hay, firsts=None) -> "ShardedBatchedSearcher":
        """Reorder each width group's rows by first offset (see
        ``BatchedSearcher.optimize_for``), measured by a sharded sweep when
        ``firsts`` is not given; the epoch bump invalidates the cache."""
        if firsts is None:
            firsts = self.find_all(hay)
        self.inner.optimize_for(hay, firsts)
        return self

    def search_all(self, hay) -> np.ndarray:
        return self.find_all(hay) >= 0
