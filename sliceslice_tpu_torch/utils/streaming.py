"""Streaming corpus scanner: byte streams of any length through a bounded
device footprint.

Counterpart of ``sliceslice_tpu/utils/streaming.py``, with the same public
API and answers.  A file (or an iterator of byte chunks) is cut into
windows of ``window`` bytes, each carrying a ``k_max - 1``-byte overlap
peek so that every match lies whole in the window where it starts;
per-window ``ends`` mask the overlap, so a match is counted once, in the
window that holds its first byte (the final window takes the stream's true
end).  Each window is scanned by the port's kernels: the find and count
kernels (one launch per width group), the match-bitmap, rank and
compaction kernels for positions, and the huge needles' prefix filter and verify
(models/huge.py).  Kernel offsets stay window-local int32; the window's
int64 base is added by the device folds (find, count) or on the host
(positions), so offsets past 2^31 and 2^32 are exact.  With a ``mesh``,
each window is cut into the mesh's shards and scanned by the sharded find,
count and positions (parallel/shard_scan.py): the exactly-once rule holds
at window and shard boundaries alike, and one collective per window
combines the processes of a group.

Every window, the final short one too, takes the kernel layout at one
fixed size (``_wcap = window + overlap`` bytes, zero-padded), on any
device: the JAX package scans windows of up to 8 KiB with flat ops and
counts them on the host, the port never does (no full scan of the card's
bytes on the host).  Folds stay on the device as int64 tensors: the count
adds each window's counts, the find keeps the least ``base + local``
offset, since windows arrive in stream order.  Nothing is read back per
window but the positions and the huge needles' candidate counts; the
stream reads its folds once at its end, and the find's every
``check_every`` windows only when ``early_stop`` needs them.

Ingest on the card (:meth:`StreamingScanner._ingest`): a background thread
reads each window into a pinned host buffer from a pool; the consumer
thread copies it into one of two device buffers on a copy stream, makes
the compute stream wait for the copy, and scans it, so the file read, the
copy of window N + 1 and the scans of window N overlap.  Two rules keep
the answers right: a host buffer returns to its pool only after its copy's
event has completed, and a device buffer is refilled only after an event
recorded on the compute stream after the last launch that read it (a
positions window's readbacks included).  On the CPU the same pools and
steps run with plain copies and the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SENTINEL
from ..models.batched import BatchedSearcher, _Group, _scatter
from ..models.huge import CHUNK, PREFIX_LEN
from ..needle import needed_halo_for_t
from ..ops import cuda_lib, scan_kernel, torch_backend
from ..ops.layout import MAX_DEVICE_POSITIONS, DeviceHaystack, padded_total, resolve_device
from ..parallel import shard_scan
from ..searcher import DeviceLike

#: The find fold's "absent": larger than any stream offset.
INT64_MAX = torch.iinfo(torch.int64).max
#: Device window buffers: one scanned while the next is copied in.
DEVICE_BUFFERS = 2
#: Seconds a stream waits for its reader thread to stop; a reader stuck
#: in a slow read past it ends on its own and writes only its own
#: stream's stats.
READER_JOIN_S = 5.0


class _IngestStopped(Exception):
    """Raised inside a window source when the stream shut down early
    (buffer pool drained on purpose); never escapes _ingest."""


def _file_windows(
    path, window: int, overlap: int, start: int, alloc,
) -> Iterator[Tuple[torch.Tensor, int, bool]]:
    """Yield ``(buffer, window_len, is_last)`` — the window's bytes read
    DIRECTLY into a pooled host buffer from ``alloc()`` (uint8 tensor;
    one copy from the page cache), its stale tail zeroed.  ``is_last``
    must be computed from the file size, NOT from a short read: a window
    whose remaining bytes fall in (window, window + overlap) short-reads
    yet is followed by one more window — inferring finality from length
    would lift the exactly-once clamp there and double-count
    overlap-region matches."""
    size = os.path.getsize(path)
    span = window + overlap
    with open(path, "rb") as f:
        base = start
        while base < size:
            f.seek(base)
            buf = alloc()
            arr = buf.numpy()
            want = min(span, size - base)
            got = int(f.readinto(memoryview(arr)[:want]) or 0)
            arr[got:] = 0  # recycled buffer: clear the stale tail
            yield buf, got, base + window >= size
            base += window


def _chunk_windows(
    chunks: Iterable[bytes], window: int, overlap: int, alloc,
) -> Iterator[Tuple[torch.Tensor, int, bool]]:
    """Re-chunk an arbitrary byte-chunk iterator into overlapping windows,
    yielding ``(buffer, window_len, is_last)`` (pooled, zero-padded host
    buffers, as :func:`_file_windows`).  Amortized O(stream) copying:
    append + in-place front deletion on a bytearray (a bytes buffer would
    re-copy the whole pending window per chunk — quadratic for small
    chunks).  Full windows are never final here: the while loop always
    keeps ``max(overlap, 1)`` trailing bytes behind, so the stream's true
    end is ALWAYS the final short yield — including ``overlap == 0`` (all
    needles length <= 1) with a stream length an exact multiple of
    ``window``, where a ``>=``-with-0 loop would consume the final window
    and mark it non-final."""

    def emit(view: bytes | bytearray, wlen: int, is_last: bool):
        out = alloc()
        arr = out.numpy()
        arr[wlen:] = 0  # recycled buffer: clear the stale tail
        arr[:wlen] = np.frombuffer(memoryview(view)[:wlen], np.uint8)
        return out, wlen, is_last

    buf = bytearray()
    keep = max(overlap, 1)  # invariant: the final yield carries is_last
    for c in chunks:
        buf += c
        while len(buf) >= window + keep:
            yield emit(buf, window + overlap, False)
            del buf[:window]
    if buf:
        yield emit(buf, len(buf), True)


def _count_fold(totals: torch.Tensor, local: torch.Tensor) -> None:
    """Add one window's int32 counts (input order) into the int64 device
    totals, in place: the JAX package's two uint32 limbs
    (``_count_fold64``) as one int64 add."""
    totals += local.to(torch.int64)


def _first_fold(best: torch.Tensor, local: torch.Tensor, base: int) -> None:
    """Fold one window's int32 first offsets (SENTINEL absent) into the
    int64 device minimum of stream offsets, in place.  Windows arrive in
    stream order with growing ``base``, so this minimum is the JAX
    package's lexicographic (window, local) minimum (``_first_fold``)."""
    cand = torch.where(local < SENTINEL, local.to(torch.int64) + int(base), INT64_MAX)
    torch.minimum(best, cand, out=best)


class StreamingScanner:
    """Windowed scan of byte streams of any length, on ``device`` (the
    card unless the caller passes ``device="cpu"``).

    ``window_bytes`` is raised to the overlap (longest needle - 1) when a
    needle exceeds it, bounding read amplification at 2x.  ``prefetch``:
    windows read ahead on a background thread (0 reads on the calling
    thread).  ``mesh``: a mesh of cells (``parallel.make_mesh``) over which
    each window is sharded; the windows lie on ``device`` and a cell on
    another device takes a copy of its shard.  Huge needles (beyond
    MAX_NEEDLE_LEN) keep each window's host bytes for the verify step of
    their filter and verify."""

    #: per-window sparse-positions budget: needles with at most this many
    #: matches in a window read back their offsets instead of the
    #: window/8-byte bitmap.
    sparse_cap = torch_backend.SPARSE_POSITIONS_CAP

    def __init__(
        self,
        needles: Sequence,
        window_bytes: int = 32 * 1024 * 1024,
        check_every: int = 4,
        mesh=None,
        prefetch: int = 2,
        *,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        #: the cells of a full window over the mesh, built at the first one.
        self._mesh_full = None
        self.batched = BatchedSearcher(needles, device=self.device)
        bs = self.batched
        self.overlap = max(max(map(len, bs.needles), default=0) - 1, 0)
        # A needle longer than the window would otherwise make every window
        # mostly overlap; growing the window bounds re-read at <= 2x.
        self.window = max(int(window_bytes), self.overlap)
        #: every window, the final short one too, is laid out at this many
        #: bytes, zero-padded: one layout and one queue plan per stream.
        self._wcap = self.window + self.overlap
        self.check_every = check_every
        self.prefetch = max(int(prefetch), 0)
        self.stats: dict = {}
        self._stats_lock = threading.Lock()
        # The halo of the widest group and the huge needles' prefix filter,
        # and of their dense tier's 128-slot chunk tables: no window is
        # ever re-laid (DeviceHaystack.ensure_halo) to widen it.
        self._kh = bs._halo()
        if bs._huge:
            self._kh = max(self._kh, needed_halo_for_t(CHUNK // 4))
        self._buf_total = padded_total(self._wcap, self._kh)
        if self._buf_total > MAX_DEVICE_POSITIONS:
            raise ValueError(
                f"a window of {self._wcap} bytes exceeds the int32 position range of one layout"
            )
        if bs._huge:
            # ONE batched prefix-filter table over all huge needles: each
            # window runs a single count launch + a single readback for the
            # tier decisions, instead of one of each per needle.
            self._huge_prefix_grp = _Group.from_needles(
                np.arange(len(bs._huge), dtype=np.int64),
                [hs.needle.data for _, hs in bs._huge], 16, self.device,
            )
            self._huge_slot = {i: k for k, (i, _) in enumerate(bs._huge)}
            grp = self._huge_prefix_grp
            ends = np.full((grp.n_pad,), max(self._wcap - PREFIX_LEN + 1, 0), np.int32)
            ends[grp.n:] = 0
            self._huge_pref_ends = torch.from_numpy(ends).to(self.device)
        # Kernel-group slots: the per-window scatter zero-fills the huge
        # slots, so the find's combine never reads them as offset-0 hits.
        self._kernel_slot = np.zeros((len(bs),), dtype=bool)
        for grp in bs.groups:
            self._kernel_slot[grp.indices] = True
        # Ends of every full, non-final window, uploaded once per scanner.
        self._ends_full_dev = self._upload_ends(self._wcap, False)
        #: window buffers allocated so far, host and device: a stream after
        #: :meth:`warmup` allocates none.
        self.buffer_allocations = 0
        self._host_q: Optional[queue.Queue] = None
        self._dev_pool: List[torch.Tensor] = []
        #: per device buffer, the compute-stream event after its last reader.
        self._dev_free: List[Optional[torch.cuda.Event]] = []
        self._next_slot = 0
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # -- instrumentation ---------------------------------------------------

    def _reset_stats(self, mode: str) -> None:
        self.stats = {
            "mode": mode, "windows": 0, "bytes": 0, "read_s": 0.0,
            "buf_wait_s": 0.0, "prep_s": 0.0, "upload_s": 0.0,
            "dispatch_s": 0.0, "drain_s": 0.0, "window_ms": [],
        }

    def _stats_add(self, key: str, dt: float, stats: Optional[dict] = None) -> None:
        """Add ``dt`` seconds to ``key`` of ``stats``, by default the
        current stream's: a reader thread passes the dict of the stream
        that started it, so a late read never lands in the next one's."""
        with self._stats_lock:
            stats = self.stats if stats is None else stats
            stats[key] = stats.get(key, 0.0) + dt

    def stats_summary(self) -> dict:
        """Per-stream attribution of the LAST stream run: seconds in file
        read (``read_s``, which includes ``buf_wait_s``, the wait for a
        free host buffer: pure IO is their difference), window wrapping
        (``prep_s``), host-to-device copy issue and host-buffer retirement
        (``upload_s``), kernel dispatch and folds (``dispatch_s``) and
        device drains (``drain_s``), plus p50/p90 per-window wall latency.
        Reads run on the prefetch thread when pipelining is on, so the sum
        can exceed the stream's wall time (overlap).  ``bytes`` counts the
        window bytes scanned, each window's overlap peek included, so it
        exceeds the corpus by about ``overlap`` per window (the JAX
        package's value)."""
        s = dict(self.stats)
        wm = s.pop("window_ms", [])
        out = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in s.items()}
        if wm:
            q = np.percentile(np.asarray(wm), [50, 90])
            out["window_p50_ms"] = round(float(q[0]), 2)
            out["window_p90_ms"] = round(float(q[1]), 2)
        return out

    def _timed_windows(self, it: Iterator, stats: dict) -> Iterator:
        """Attribute time spent pulling from the raw window source (file
        read / chunk assembly) to ``read_s`` of ``stats``; closes the
        source when closed itself."""
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    self._stats_add("read_s", time.perf_counter() - t0, stats)
                yield item
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    # -- window geometry -----------------------------------------------------

    def _end_h(self, k: int, wlen: int, is_last: bool) -> int:
        """Window-local valid-position bound for a length-``k`` needle:
        matches starting in the overlap peek belong to the next window,
        EXCEPT in the stream's final window, where the true end applies —
        a final window may be longer than ``window`` (a chunk stream
        shorter than window + overlap arrives as one window), so the
        clamp must be lifted there exactly as :meth:`_group_ends` does."""
        end = wlen - k + 1
        return end if is_last else min(self.window, end)

    def _group_ends(self, grp, wlen: int, is_last: bool) -> np.ndarray:
        """Window-local valid-position bounds (int32[n_pad], padded rows
        0) for one width group: positions in [0, window) — the overlap
        peek belongs to the next window — except in the final window,
        where the stream's true end applies."""
        lens = grp.lengths.astype(np.int64)
        end_local = wlen - lens + 1 if is_last else np.minimum(self.window, wlen - lens + 1)
        ends = np.maximum(end_local, 0).astype(np.int32)
        return np.pad(ends, (0, grp.n_pad - grp.n))

    def _ends_dev(self, wlen: int, is_last: bool) -> tuple:
        """Per-group device ends of one window: the hoisted ends for a
        full non-final window, an upload for the final window and a short
        non-final one."""
        if not is_last and wlen >= self._wcap:
            return self._ends_full_dev
        return self._upload_ends(wlen, is_last)

    def _upload_ends(self, wlen: int, is_last: bool) -> tuple:
        return tuple(
            torch.from_numpy(self._group_ends(g, wlen, is_last)).to(self.device)
            for g in self.batched.groups
        )

    # -- public API --------------------------------------------------------

    def _file(self, path, start_offset: int = 0):
        return lambda alloc: _file_windows(
            path, self.window, self.overlap, start_offset, alloc
        )

    def _chunks(self, chunks: Iterable[bytes]):
        return lambda alloc: _chunk_windows(
            chunks, self.window, self.overlap, alloc
        )

    def find_in_file(self, path, early_stop: bool = True, start_offset: int = 0) -> np.ndarray:
        """First-match offset per needle (int64[N], -1 absent) over the
        file's bytes from ``start_offset`` on; offsets are absolute file
        offsets (scan a tail / resume a partitioned scan)."""
        return self._scan(self._file(path, start_offset), early_stop, base0=start_offset)

    def find_in_chunks(self, chunks: Iterable[bytes], early_stop: bool = True,
                       start_offset: int = 0) -> np.ndarray:
        """``start_offset``: global offset of the stream's first byte —
        reported offsets are start_offset + stream position (int64 end to
        end, so offsets past 2^32 are exact)."""
        return self._scan(self._chunks(chunks), early_stop, base0=start_offset)

    def count_in_file(self, path, start_offset: int = 0) -> np.ndarray:
        """Overlapping occurrence counts (int64[N]) over the whole stream,
        exact past 2 GiB (int32 window counts, int64 device totals)."""
        return self._count(self._file(path, start_offset))

    def count_in_chunks(self, chunks: Iterable[bytes]) -> np.ndarray:
        return self._count(self._chunks(chunks))

    def positions_in_file(self, path, start_offset: int = 0) -> list:
        """ALL (overlapping) match offsets per needle (int64[M] ascending,
        input order), the streamed ``find_iter``: each window's two-tier
        positions with the window's int64 base added on the host."""
        return self._positions(self._file(path, start_offset), base0=start_offset)

    def positions_in_chunks(self, chunks: Iterable[bytes], start_offset: int = 0) -> list:
        return self._positions(self._chunks(chunks), base0=start_offset)

    def warmup(self, modes: Sequence[str] = ("find", "count", "positions")) -> "StreamingScanner":
        """Build or load the kernels, fill (and on the card pin) both
        buffer pools, and run a stream of one full ``_wcap`` window and one
        final short one through each mode asked for, and each huge
        needle's host and dense tiers over a window.  After it a stream
        allocates no window buffer (:attr:`buffer_allocations`).  Use
        before timed runs."""
        if self.device.type == "cuda":
            cuda_lib.load()
        self._ensure_pools()
        zeros = self._chunks([bytes(self._wcap)])
        runs = {"find": lambda: self._scan(zeros, early_stop=False),
                "count": lambda: self._count(zeros), "positions": lambda: self._positions(zeros)}
        unknown = set(modes) - set(runs)
        if unknown:
            raise ValueError(f"unknown stream modes {sorted(unknown)}; choose from {sorted(runs)}")
        for mode in modes:
            runs[mode]()
        if self.batched._huge:
            self._sync()
            dh = DeviceHaystack.from_buffer(self._dev_pool[0], self._wcap, self._kh, bytes(self._wcap))
            for _, hs in self.batched._huge:
                hs._host_candidates(dh, 1)
                hs._dense(dh)
            self._release(0)
        self._sync()
        self.stats = {}
        return self

    # -- ingest --------------------------------------------------------------

    def _new_buffers(self, n: int, pinned: bool) -> torch.Tensor:
        self.buffer_allocations += 1
        if not pinned:
            return torch.zeros((n,), dtype=torch.uint8, device=self.device)
        # No quiet fallback to pageable memory: an allocation that cannot
        # pin raises.
        t = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
        if not t.is_pinned():
            raise RuntimeError("a window host buffer could not be pinned")
        return t

    def _ensure_pools(self) -> queue.Queue:
        """The pool of ``max(prefetch, 1) + 2`` host window buffers (pinned
        on the card; the worker, the hand-off queue and the copy in flight
        never starve) and the ``DEVICE_BUFFERS`` device buffers, each of
        the layout's ``_buf_total`` bytes.  A stream returns every buffer
        it took; one lost to a read that raised, or to a reader stuck past
        the join, is replaced here."""
        if self._host_q is None:
            self._host_q = queue.Queue()
        on_card = self.device.type == "cuda"
        while self._host_q.qsize() < max(self.prefetch, 1) + 2:
            self._host_q.put(self._new_buffers(self._buf_total, pinned=on_card))
        while len(self._dev_pool) < DEVICE_BUFFERS:
            self._dev_pool.append(self._new_buffers(self._buf_total, pinned=False))
            self._dev_free.append(None)
        return self._host_q

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _copy_in(self, host: torch.Tensor, slot: int) -> Optional[torch.cuda.Event]:
        """Copy a host window into device buffer ``slot``; on the card on
        the copy stream, after the buffer's last reader, with the compute
        stream made to wait for the copy.  Returns the copy's event (None
        on the CPU, where the copy is done on return)."""
        dev = self._dev_pool[slot]
        if self._copy_stream is None:
            dev.copy_(host)
            return None
        free = self._dev_free[slot]
        with torch.cuda.stream(self._copy_stream):
            if free is not None:
                self._copy_stream.wait_event(free)
            dev.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        torch.cuda.current_stream(self.device).wait_event(done)
        return done

    def _release(self, slot: int) -> None:
        """Mark device buffer ``slot`` free once the launches issued so
        far on the compute stream, its last readers, have run."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._dev_free[slot] = ev

    def _drain(self) -> None:
        """Wait for the compute stream (an event synchronize, not a
        readback): bounds the windows queued on the card."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        self._stats_add("drain_s", time.perf_counter() - t0)

    def _ingest(self, factory) -> Iterator[Tuple[DeviceHaystack, int, bool]]:
        """Yield ``(dh, window_len, is_last)`` in stream order from a
        window-source factory (``factory(alloc) -> iterator of (buf, wlen,
        is_last)``).  With ``prefetch > 0`` a background thread reads the
        next windows into pooled host buffers (and touches no device)
        while this thread copies and scans the current one; with 0 the
        reads run here.  Every host buffer returns to the pool, on an
        early stop and a reader error too, and no thread outlives the
        stream."""
        host_q = self._ensure_pools()
        stop = threading.Event()
        stats = self.stats  # a reader that outlives this stream still writes here

        def alloc():
            t0 = time.perf_counter()
            try:
                while True:
                    if stop.is_set():
                        raise _IngestStopped()
                    try:
                        return host_q.get(timeout=0.05)
                    except queue.Empty:
                        continue
            finally:
                # Pool backpressure (the consumer still scanning) — also
                # inside read_s, so pure file IO = read_s - buf_wait_s.
                self._stats_add("buf_wait_s", time.perf_counter() - t0, stats)

        windows = self._timed_windows(iter(factory(alloc)), stats)
        copying: List[tuple] = []  # (copy event, host buffer): copies in flight

        def scan(buf, wlen, is_last):
            t0 = time.perf_counter()
            slot = self._next_slot
            self._next_slot = (slot + 1) % DEVICE_BUFFERS
            copying.append((self._copy_in(buf, slot), buf))
            # A host buffer returns to the pool only after its copy's event
            # has completed: the one before this window's, waited for here
            # (by now queued behind at most one window's scans).
            while len(copying) > 1:
                ev, old = copying.pop(0)
                if ev is not None:
                    ev.synchronize()
                host_q.put(old)
            t1 = time.perf_counter()
            self._stats_add("upload_s", t1 - t0)
            # Huge needles verify against the window's host bytes: copied
            # out of the pinned buffer here, so that the buffer can return
            # to its pool before their work is done.
            host = bytes(memoryview(buf.numpy())[: self._wcap]) if self.batched._huge else None
            dh = DeviceHaystack.from_buffer(self._dev_pool[slot], self._wcap, self._kh, host)
            self._stats_add("prep_s", time.perf_counter() - t1)
            try:
                yield dh, wlen, is_last
            finally:
                self._release(slot)

        try:
            if self.prefetch == 0:
                for item in windows:
                    yield from scan(*item)
                return
            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            done = object()
            failure: List[BaseException] = []

            def hand_off(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except queue.Full:
                        continue
                return False

            def worker():
                try:
                    for item in windows:  # (buf, wlen, is_last): host only
                        if not hand_off(item):
                            host_q.put(item[0])  # stopped: the buffer goes back
                            return
                except _IngestStopped:
                    return
                except BaseException as e:  # surfaced on the consumer side
                    failure.append(e)
                finally:
                    windows.close()
                    hand_off(done)

            t = threading.Thread(target=worker, name="sliceslice-ingest", daemon=True)
            t.start()

            def give_back():
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        return
                    if item is not done:
                        host_q.put(item[0])

            try:
                while True:
                    item = q.get()
                    if item is done:
                        if failure:
                            raise failure[0]
                        return
                    yield from scan(*item)
            finally:
                # Early stop (or consumer error): unblock and retire the
                # worker, returning the buffers still in the hand-off queue.
                stop.set()
                give_back()
                t.join(timeout=READER_JOIN_S)
                give_back()
        finally:
            stop.set()
            if self.prefetch == 0:
                windows.close()
            for ev, buf in copying:
                if ev is not None:
                    ev.synchronize()
                host_q.put(buf)
            copying.clear()

    # -- per-window steps -------------------------------------------------------

    def _group_launches(self, kernel, dh, ends) -> torch.Tensor:
        """One ``kernel`` launch per width group over the window, scattered
        to input order (int32[N]; huge slots 0)."""
        bs = self.batched
        parts = [kernel(dh.flat, g.values_dev, g.masks_dev, e, n_real=g.n)
                 for g, e in zip(bs.groups, ends)]
        return _scatter(len(bs), bs._order_sizes, bs._order_dev, parts)

    def _mesh_cells(self, dh, wlen: int, is_last: bool):
        """The window's shards over the mesh (views of its buffer) and each
        width group's cells: their tables and shard-clipped window ends,
        built once for a full window (every window has the same shard
        geometry, its layout being ``_wcap`` bytes)."""
        place = shard_scan.place_corpus(dh, self.mesh)
        full = not is_last and wlen >= self._wcap
        if full and self._mesh_full is not None:
            return place, self._mesh_full
        cells = [shard_scan.cells_of(place, self.mesh, g.values_dev[:g.n], g.masks_dev[:g.n],
                                     self._group_ends(g, wlen, is_last)[:g.n])
                 for g in self.batched.groups]
        if full:
            self._mesh_full = cells
        return place, cells

    def _window_launches(self, mode: str, dh, wlen: int, is_last: bool) -> torch.Tensor:
        """Window-local int32[N] first offsets (SENTINEL absent) or counts
        in input order (huge slots 0): one launch per width group, or with a
        mesh one per cell and width group, combined on the device with one
        collective for the window."""
        if self.mesh is None:
            kernel = scan_kernel.batched_find if mode == "find" else scan_kernel.batched_count
            return self._group_launches(kernel, dh, self._ends_dev(wlen, is_last))
        bs = self.batched
        place, cells = self._mesh_cells(dh, wlen, is_last)
        acc = shard_scan.sweep(place, cells, bs._order_sizes, mode, self.mesh)
        local = shard_scan.finish(acc, mode, True).to(self.device)
        return _scatter(len(bs), bs._order_sizes, bs._order_dev, list(torch.split(local, bs._order_sizes)))

    def _huge_prefix_counts(self, dh) -> np.ndarray:
        """Per-window prefix-candidate counts of ALL huge needles: one
        count launch, one int32[H] readback — the tier decisions of every
        needle at the cost one needle used to pay."""
        grp = self._huge_prefix_grp
        out = scan_kernel.batched_count(dh.flat, grp.values_dev, grp.masks_dev,
                                        self._huge_pref_ends, n_real=grp.n)
        return out[: grp.n].cpu().numpy()

    def _huge_positions(self, dh, wlen: int, is_last: bool):
        """``(slot, window-local positions)`` of each huge needle with a
        match in this window, clipped to the window's bound."""
        cnts = self._huge_prefix_counts(dh)
        for i, hs in self.batched._huge:
            nc = int(cnts[self._huge_slot[i]])
            if nc == 0:
                continue  # prefix absent -> needle absent in window
            pos = hs.positions_with_candidates(dh, nc)
            pos = pos[pos < self._end_h(hs.size, wlen, is_last)]
            if pos.size:
                yield i, pos

    def _fold_huge_find(self, best: np.ndarray, dh, wlen: int, base: int, is_last: bool) -> None:
        pending = [(i, hs) for i, hs in self.batched._huge if best[i] < 0]
        if not pending:
            return
        cnts = self._huge_prefix_counts(dh)
        for i, hs in pending:
            nc = int(cnts[self._huge_slot[i]])
            if nc == 0:
                continue  # prefix absent -> needle absent in window
            p = hs.find_with_candidates(dh, nc)
            if p is not None and p < self._end_h(hs.size, wlen, is_last):
                best[i] = base + p

    def _close_window(self, tw0: float, wlen: int) -> None:
        self.stats["windows"] += 1
        self.stats["bytes"] += wlen
        self.stats["window_ms"].append(1e3 * (time.perf_counter() - tw0))

    def _scan(self, factory, early_stop: bool, base0: int = 0) -> np.ndarray:
        bs = self.batched
        n = len(bs)
        # Host int64 answers of the huge needles; the kernel groups fold on
        # the device into one int64 minimum.
        best = np.full((n,), -1, dtype=np.int64)
        best_dev = torch.full((n,), INT64_MAX, dtype=torch.int64, device=self.device) if bs.groups else None
        base = int(base0)
        since_check = 0
        self._reset_stats("find")
        with contextlib.closing(self._ingest(factory)) as windows:
            for dh, wlen, is_last in windows:
                tw0 = time.perf_counter()
                self._fold_huge_find(best, dh, wlen, base, is_last)
                if bs.groups:
                    t0 = time.perf_counter()
                    _first_fold(best_dev, self._window_launches("find", dh, wlen, is_last), base)
                    self._stats_add("dispatch_s", time.perf_counter() - t0)
                base += self.window
                since_check += 1
                stop = False
                if since_check >= self.check_every:
                    since_check = 0
                    self._drain()
                    stop = early_stop and self._all_found(best, best_dev)
                self._close_window(tw0, wlen)
                if stop:
                    break
        t0 = time.perf_counter()
        self._combine_device_first(best, best_dev)
        self._stats_add("drain_s", time.perf_counter() - t0)
        return best

    def _all_found(self, best: np.ndarray, best_dev) -> bool:
        """Early-stop check: one int64[N] readback of the device fold."""
        if best_dev is None:
            return bool((best >= 0).all())
        found_dev = best_dev.cpu().numpy() < INT64_MAX
        ok = np.where(self._kernel_slot, (best >= 0) | found_dev, best >= 0)
        return bool(ok.all())

    def _combine_device_first(self, best: np.ndarray, best_dev) -> None:
        """One final readback of the device minimum into the kernel-group
        slots."""
        if best_dev is None:
            return
        bd = best_dev.cpu().numpy()
        upd = (bd < INT64_MAX) & self._kernel_slot & (best < 0)
        best[upd] = bd[upd]

    def _count(self, factory) -> np.ndarray:
        bs = self.batched
        n = len(bs)
        totals = np.zeros((n,), dtype=np.int64)  # the huge needles'
        totals_dev = torch.zeros((n,), dtype=torch.int64, device=self.device) if bs.groups else None
        since = 0
        self._reset_stats("count")
        with contextlib.closing(self._ingest(factory)) as windows:
            for dh, wlen, is_last in windows:
                tw0 = time.perf_counter()
                if bs._huge:
                    for i, pos in self._huge_positions(dh, wlen, is_last):
                        totals[i] += pos.size
                if bs.groups:
                    t0 = time.perf_counter()
                    _count_fold(totals_dev, self._window_launches("count", dh, wlen, is_last))
                    self._stats_add("dispatch_s", time.perf_counter() - t0)
                since += 1
                if since >= self.check_every:
                    since = 0
                    self._drain()
                self._close_window(tw0, wlen)
        if totals_dev is not None:
            t0 = time.perf_counter()
            totals += totals_dev.cpu().numpy()
            self._stats_add("drain_s", time.perf_counter() - t0)
        return totals

    def _window_positions(self, dh, wlen: int, is_last: bool, cap: int):
        """``(needle index, window-local positions)`` of each kernel-group
        needle with a match in the window: per width group and launch batch
        (per cell and launch batch with a mesh), one bitmap, one rank and
        one compaction launch (``torch_backend.two_tier_positions``)."""
        bs = self.batched
        if self.mesh is not None:
            place, cells = self._mesh_cells(dh, wlen, is_last)
            res = [shard_scan.positions_of_cells(place, gc, g.n, cap) for g, gc in zip(bs.groups, cells)]
        else:
            res = [[p for i0, i1 in torch_backend.position_batches(g.n, dh.flat.numel(), g.t)
                    for p in torch_backend.two_tier_positions(
                        dh.flat, g.values_dev[i0:i1], g.masks_dev[i0:i1], ends[i0:i1], cap)]
                   for g, ends in zip(bs.groups, self._ends_dev(wlen, is_last))]
        for g, rows in zip(bs.groups, res):
            for j, pos in zip(g.indices.tolist(), rows):
                if pos.size:
                    yield j, pos

    def _positions(self, factory, base0: int = 0) -> list:
        """Per-window positions (one bitmap, one rank and one compaction
        launch per launch batch of a width group), window-local clipped
        ends for the exactly-once rule, the int64 window base added on the
        host."""
        bs = self.batched
        out: List[List[np.ndarray]] = [[] for _ in range(len(bs))]
        base = int(base0)
        cap = self.sparse_cap
        self._reset_stats("positions")
        with contextlib.closing(self._ingest(factory)) as windows:
            for dh, wlen, is_last in windows:
                tw0 = time.perf_counter()
                if bs._huge:
                    for i, pos in self._huge_positions(dh, wlen, is_last):
                        out[i].append(pos + base)
                t0 = time.perf_counter()
                for j, pos in self._window_positions(dh, wlen, is_last, cap):
                    out[j].append(pos + base)
                self._stats_add("dispatch_s", time.perf_counter() - t0)
                base += self.window
                self._close_window(tw0, wlen)
        return [np.concatenate(p) if p else np.empty((0,), np.int64) for p in out]
