"""Times of the find, count and positions sweeps over i386.

    python3 sliceslice_tpu_torch/scripts/sweep_times.py [--tree DIR] [--chunks 16384,32768,65536]
    python3 sliceslice_tpu_torch/scripts/sweep_times.py --positions [--tree DIR]
    python3 sliceslice_tpu_torch/scripts/sweep_times.py --pairs [--tree DIR]
    python3 sliceslice_tpu_torch/scripts/sweep_times.py --sharded [--tree DIR]

All 4,585 words of ``data/words.txt`` over ``data/i386.txt`` on the first
CUDA card, after ``optimize_for``, as the smoke's sweeps run them: per
width group, ``batched_find``, ``batched_count`` and
``match_bitmap_counted`` called ``--reps`` times between two CUDA events
(5 samples: low, median, high ms per call), then the sustained
``find_all_device`` and ``count_all_device`` sweeps, one-row launches (the
word i386 holds last, at 857,156, and an absent one), and a torch.profiler
trace of 8 sweeps of each and of 8 bitmap sweeps (every group's
``match_bitmap_counted``; device µs per sweep, the card's idle share, µs
per kernel, so per width group's instantiation).  ``sliceslice_tpu_torch`` is imported from ``--tree``
(default: the checkout holding this script), so one call can time two
checkouts one after the other on the same card.  ``--chunks`` times the find and
count kernels with both work-queue chunks set to each value in turn (a
checkout whose kernels have no queue ignores it).  Prints the card's name and power limit, then one JSON line
per chunk.  It checks every find answer against ``bytes.find`` first.

``--positions`` times the positions sweep instead: ``positions_all`` of
the same words after ``optimize_for`` (each call reads its answers back),
``--reps`` calls between two CUDA events, 5 samples, after checking every
answer against the host positions scan; then a torch.profiler trace of 4
calls (device µs per call, the card's idle share, device events per call,
and the device µs per call of the match-bitmap, rank and compaction
kernels), a cProfile run of 4 calls (the host functions with the most own
time, ms per call; cProfile slows the host's Python), and the positions
functions over one sweep's bitmaps (``positions_kernel_times``: the
kernels alone behind a spin kernel and their wrapper calls, capped at
4,096 and packed, beside the first design's torch ops) with their bounds
(``positions_bounds``).  One JSON line.

``--pairs`` times the all-pairs sweep of the length-sorted words instead
(21,022,225 pairs), after checking the count against ``bytes.find``: the
wrapper call ``pair_block`` with a host plan in both modes (ms per call,
and the kernel's device µs from a trace of 8 calls), the sustained
``count_matches_device`` sweep (``--reps`` calls, one sync), its device
time (``--reps`` sweeps queued behind a spin kernel between two CUDA
events, so the host's dispatch is hidden; each sweep carries its small
fill; a sweep that uploads its plan waits for the card and reads its host
time instead) and a trace of 8 sweeps (the kernel's device µs, the card's
idle share).  One JSON line.

``--sharded`` times ``ShardedBatchedSearcher``'s ``find_all`` and
``count_all`` of the same words after ``optimize_for``, on meshes of 1x1,
2x1, 4x1 and 2x2 cells on the card, beside ``BatchedSearcher``'s: ms per
call (CUDA events around each call, which reads its answers back; median
of 5, then low and high), and the stages of the searcher's own sweep on
the host clock, each ended by a synchronisation in its timing hook (the
cells' launches and the on-device combine, the collective, the finish and
the readback; median of 5).  Three rounds:
with no process group, in an NCCL group of one, with no group again (the
first and the last bound the drift of the card and the host).  One JSON
line per round.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def group_times(torch, bs, dh, device, reps: int = 32, samples: int = 5) -> dict:
    """{"find": {t: [low, median, high]}, "count": {...}, "bitmap": {...}}:
    ms per call of each width group's find, count and match-bitmap wrapper
    over ``dh`` (the bitmap's call zeroes its words too)."""
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.utils.profiling import measure

    out = {}
    for name, fn in (("find", scan_kernel.batched_find), ("count", scan_kernel.batched_count),
                     ("bitmap", scan_kernel.match_bitmap_counted)):
        per = {}
        for g in bs.groups:
            args = (dh.flat, g.values_dev, g.masks_dev, g.ends_dev(dh.length), 0, g.n)
            m = measure(lambda: [fn(*args) for _ in range(reps)], f"{name} t={g.t}", warmup=1,
                        samples=samples, device=device)
            per[g.t] = [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]
        out[name] = per
    return out


def sweep_times(torch, bs, dh, device, reps: int = 32, samples: int = 5) -> dict:
    """{"find": [low, median, high], "count": [...]}: ms per sustained
    ``find_all_device`` / ``count_all_device`` sweep (``reps`` sweeps, one
    sync)."""
    from sliceslice_tpu_torch.utils.profiling import measure

    out = {}
    for name, fn in (("find", bs.find_all_device), ("count", bs.count_all_device)):
        m = measure(lambda: [fn(dh) for _ in range(reps)], f"{name} sweep", warmup=1,
                    samples=samples, device=device)
        out[name] = [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]
    return out


def trace_share(torch, fn, reps: int = 8, groups: Optional[dict] = None) -> dict:
    """One torch.profiler trace of ``reps`` calls of ``fn``: per call, the
    device time of its kernels (overlaps merged), the span from the first
    kernel's start to the last one's end, the card's idle share of that
    span, the device events, the device µs per kernel name, and for each
    ``groups`` entry (label: substring of kernel names) the device µs of
    the kernels whose names hold it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_us": None, "note": "the trace holds no device activity"}
    busy, end, by_name = 0.0, spans[0][0], {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / reps
    span = end - spans[0][0]
    grouped = {label: sum(us for name, us in by_name.items() if part in name)
               for label, part in (groups or {}).items()}
    return {"device_us": busy / reps, "span_us": span / reps, "idle_share": 1 - busy / span,
            "device_events": len(spans) / reps, "grouped_us": grouped,
            "kernels_us": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


def positions_times(torch, bs, hay: bytes, dh, device, reps: int = 4, samples: int = 5) -> dict:
    """The sustained positions sweep (``reps`` ``positions_all`` calls
    between two CUDA events; low, median, high ms per call) and a trace of
    it, after checking every answer against the host positions scan."""
    import numpy as np

    from sliceslice_tpu_torch.searcher import _host_positions
    from sliceslice_tpu_torch.utils.profiling import measure

    got = bs.positions_all(dh)
    bad = sum(not np.array_equal(g, _host_positions(hay, w)) for g, w in zip(got, bs.needles))
    if bad:
        raise SystemExit(f"positions of {bad} words differ from the host scan")
    m = measure(lambda: [bs.positions_all(dh) for _ in range(reps)], "positions sweep", warmup=1,
                samples=samples, device=device)
    trace = trace_share(torch, lambda: bs.positions_all(dh), reps=4,
                        groups={"match_bitmap": "match_bitmap_kernel", "ranks": "rank_kernel",
                                "compaction": "compact_kernel"})
    calls = positions_calls(bs, dh)
    return {"sweep_ms": [x * 1e3 / reps for x in (m.low, m.estimate, m.high)],
            "matches": sum(len(p) for p in got), "trace": trace,
            "host_ms": host_profile(torch, lambda: bs.positions_all(dh)),
            "kernels": positions_kernel_times(torch, calls, device),
            "bounds": positions_bounds(torch, calls)}


def positions_calls(bs, dh) -> list:
    """The match-bitmap kernel's ``(words, item_counts, chunk)`` for each
    width group of ``bs`` over ``dh``, in one launch batch each (as one
    i386 positions sweep takes them)."""
    from sliceslice_tpu_torch.ops import scan_kernel

    return [scan_kernel.match_bitmap_counted(dh.flat, g.values_dev, g.masks_dev, g.ends_dev(dh.length))
            for g in bs.groups]


def positions_kernel_times(torch, calls, device, cap: int = 4096, reps: int = 32) -> dict:
    """{name: {"device_ms", "call_ms"}} for one sweep's worth of ``calls``
    (``positions_calls``): ``device_ms`` [low, median, high] is the device
    time of ``reps`` sweeps queued behind a spin kernel long enough for the
    host to enqueue them all (``device_ms``: the kernel alone where a call
    launches nothing else), ``call_ms`` the same
    sweeps between two CUDA events without the spin (host dispatch
    included).  Both trees: the capped wrapper ``compact_positions`` (cap
    ``cap``, fills included) and the torch ops of the first design's
    wrapper around its kernel (the counts, the first ranks, the SENTINEL
    fill); a tree with the rank kernel also: ``item_ranks`` packed (no
    tail) and capped, ``compact_window`` capped (after the ranks) and
    packed (every row, one window), and the plain versions of the packed
    pair (``call_ms`` only)."""
    import numpy as np

    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.ops import scan_kernel as sk
    from sliceslice_tpu_torch.utils.profiling import measure

    out = {}

    def timed(name, fn, on_device=True):
        m = measure(lambda: [fn() for _ in range(reps)], name, warmup=1, samples=5, device=device)
        out[name] = {"call_ms": [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]}
        if on_device:  # a spin of ~50 ms: the host enqueues up to 12 wrapper calls a sweep
            out[name]["device_ms"] = device_ms(torch, fn, reps=reps, spin_cycles=100_000_000)

    def torch_ops():
        for words, ic, _ in calls:
            ic.sum(dim=0, dtype=torch.int32)
            torch.cumsum(ic, dim=0, dtype=torch.int32) - ic
            torch.full((words.shape[0], cap), SENTINEL, dtype=torch.int32, device=words.device)

    timed("first_design_torch_ops", torch_ops)
    timed("compact_positions_capped", lambda: [sk.compact_positions(*c, cap) for c in calls])
    if not hasattr(sk, "item_ranks"):
        return out
    ranks = [sk.item_ranks(ic) for _, ic, _ in calls]
    offsets = [torch.empty((w.shape[0], cap), dtype=torch.int32, device=w.device) for w, _, _ in calls]
    packed = []
    for (words, ic, ch), (counts, first) in zip(calls, ranks):
        cnt = counts.cpu().numpy().astype(np.int64)
        total = int(cnt.sum())
        base = torch.from_numpy(np.cumsum(cnt) - cnt).to(words.device)
        dtype = packed_dtype(torch, sk, words, ic, first, ch, base)
        packed.append((base, total, torch.empty((total,), dtype=dtype, device=words.device)))
    timed("item_ranks_packed", lambda: [sk.item_ranks(ic) for _, ic, _ in calls])
    timed("item_ranks_capped", lambda: [sk.item_ranks(ic, o) for (_, ic, _), o in zip(calls, offsets)])
    timed("compact_window_capped", lambda: [sk.compact_window(w, ic, r[1], ch, o, cap=cap)
                                            for (w, ic, ch), r, o in zip(calls, ranks, offsets)])
    timed("compact_window_packed", lambda: [sk.compact_window(w, ic, r[1], ch, buf, row_base=b, window=(0, t))
                                            for (w, ic, ch), r, (b, t, buf) in zip(calls, ranks, packed)])
    timed("item_ranks_plain", lambda: [sk.item_ranks_plain(ic) for _, ic, _ in calls], on_device=False)
    timed("compact_window_plain_packed",
          lambda: [sk.compact_window_plain(w, ic, r[1], ch, buf, row_base=b, window=(0, t))
                   for (w, ic, ch), r, (b, t, buf) in zip(calls, ranks, packed)], on_device=False)
    return out


def packed_dtype(torch, sk, words, item_counts, first, chunk, row_base):
    """The type the tree's packed compaction stores: int64 since the
    compaction writes the answers' type, int32 before (an empty window
    tells them apart without a launch)."""
    try:
        sk.compact_window(words, item_counts, first, chunk, torch.empty((0,), dtype=torch.int64,
                          device=words.device), row_base=row_base, window=(0, 0))
    except ValueError:
        return torch.int32
    return torch.int64


def positions_bounds(torch, calls, cap: int = 4096) -> dict:
    """{name: (bound ms, "bytes" or "operations")} of the positions
    functions over ``calls`` (``positions_calls``), each input byte read
    once and each output byte written once, for what these inputs need
    (``utils.profiling.bound_ms``): the ranks (the item counts read, the
    first ranks and counts written; capped, also the SENTINEL tail), the
    packed compaction (every item's count and first rank, the row bases,
    the words of every item holding a match, the int64 offsets written:
    one op per word read and per offset written), the capped one (the words of
    items holding a rank below ``cap``, each row's first ``cap`` offsets),
    and the JAX contract's capped function as a whole (the item counts and
    live words read, counts and every ``N x cap`` slot written)."""
    from sliceslice_tpu_torch.utils.profiling import bound_ms

    acc = dict.fromkeys(("ranks", "ranks_tail", "packed", "packed_ops", "capped", "capped_ops",
                         "contract"), 0)
    for words, ic, chunk in calls:
        n_chunks, n = ic.shape
        cw = chunk // 32
        per_item = (words.shape[1] - cw * torch.arange(n_chunks, device=ic.device)).clamp(0, cw)
        first = torch.cumsum(ic, dim=0) - ic
        counts = ic.sum(dim=0)
        taken = torch.minimum(counts, torch.tensor(cap, device=ic.device))
        live = int((per_item[:, None] * (ic > 0)).sum())
        live_capped = int((per_item[:, None] * ((ic > 0) & (first < cap))).sum())
        total, kept = int(counts.sum()), int(taken.sum())
        acc["ranks"] += 4 * (2 * ic.numel() + n)
        acc["ranks_tail"] += 4 * (n * cap - kept)
        acc["packed"] += 4 * live + 8 * ic.numel() + 8 * n + 8 * total
        acc["packed_ops"] += live + total
        acc["capped"] += 4 * live_capped + 8 * ic.numel() + 4 * kept
        acc["capped_ops"] += live_capped + kept
        acc["contract"] += 4 * live_capped + 4 * ic.numel() + 4 * n + 4 * n * cap
    return {"item_ranks_packed": bound_ms(0, acc["ranks"]),
            "item_ranks_capped": bound_ms(0, acc["ranks"] + acc["ranks_tail"]),
            "compact_window_packed": bound_ms(acc["packed_ops"], acc["packed"]),
            "compact_window_capped": bound_ms(acc["capped_ops"], acc["capped"]),
            "compact_positions_capped": bound_ms(acc["capped_ops"], acc["contract"])}


def host_profile(torch, fn, reps: int = 4, top: int = 10) -> dict:
    """{"total": ms, "file:line:function": own ms, ...} per call of
    ``fn`` under cProfile (host clock), the ``top`` functions by own
    time."""
    import cProfile
    import pstats
    import time

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    out = {"total": (time.perf_counter() - t0) * 1e3 / reps}
    stats = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    for (path, line, name), (_, _, own, _, _) in stats:
        out[f"{os.path.basename(path)}:{line}:{name}"] = own * 1e3 / reps
    return out


def device_ms(torch, fn, reps: int = 32, samples: int = 5, spin_cycles: int = 20_000_000) -> list:
    """[low, median, high] ms of device time per call of ``fn``: ``reps``
    calls are queued behind a spin kernel (``spin_cycles`` of the card's
    clock, about 10 ms) between two CUDA events, so the card runs them back
    to back however long the host takes to enqueue them."""
    out = []
    fn()
    for _ in range(samples):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    out.sort()
    return [out[0], out[len(out) // 2], out[-1]]


def pair_times(torch, words, device, reps: int = 32, samples: int = 5) -> dict:
    """The all-pairs sweep of the length-sorted ``words``: the wrapper call
    and the kernel's traced device time in both modes, the sustained
    ``count_matches_device`` sweep, its device time and a trace of it; the
    count is checked against ``bytes.find`` first."""
    from sliceslice_tpu_torch import PairwiseSearcher
    from sliceslice_tpu_torch.ops import pairwise
    from sliceslice_tpu_torch.utils.profiling import measure

    ws = sorted(words, key=len)
    ps = PairwiseSearcher(ws, device=device)
    total = int(ps.count_matches_device())
    exp = sum(h.find(n) >= 0 for n in ws for h in ws)
    if total != exp or int(ps.contains_matrix().sum()) != exp:
        raise SystemExit(f"pair sweep counts {total} matches, bytes.find {exp}")
    hay, lh, _, _ = ps._pack_hay(None)
    args = (ps._values, ps._masks, ps._ln, hay, lh, ps._plan(None), ps.block)
    out = {"pairs": len(ws) ** 2, "matches": total}
    pair_kernel = {"pair": "pair_block_kernel"}
    for mode, count in (("count", True), ("matrix", False)):
        call = functools.partial(pairwise.pair_block, *args, count=count)
        m = measure(lambda: [call() for _ in range(reps)], mode, warmup=1, samples=samples,
                    device=device)
        out[mode] = {"kernel_us": trace_share(torch, call, groups=pair_kernel)["grouped_us"]["pair"],
                     "call_ms": [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]}
    m = measure(lambda: [ps.count_matches_device() for _ in range(reps)], "pair sweep", warmup=1,
                samples=samples, device=device)
    out["sweep_ms"] = [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]
    out["sweep_device_ms"] = device_ms(torch, ps.count_matches_device, reps, samples)
    out["trace"] = trace_share(torch, ps.count_matches_device, groups=pair_kernel)
    return out


def one_row_times(torch, hay: bytes, dh, device, reps: int = 32, samples: int = 5) -> dict:
    """{needle: {"find": [low, median, high], "count": [...]}}: ms per
    launch of a one-row find and count over ``dh`` (the single-needle
    searchers' launch), for the word i386 holds last and an absent one."""
    from sliceslice_tpu_torch.needle import build_probe_table
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.utils.profiling import measure

    out = {}
    for nd in (b"Greater", b"\xfe\xfe\xfe\xfe\xfe"):
        vals, msks, lens = build_probe_table([nd])
        v, m = table_bits(vals, device), table_bits(msks, device)
        e = torch.tensor([len(hay) - len(nd) + 1], dtype=torch.int32, device=device)
        row = {}
        for name, fn in (("find", scan_kernel.batched_find), ("count", scan_kernel.batched_count)):
            t = measure(lambda: [fn(dh.flat, v, m, e) for _ in range(reps)], name, warmup=1,
                        samples=samples, device=device)
            row[name] = [x * 1e3 / reps for x in (t.low, t.estimate, t.high)]
        out[repr(nd)] = row
    return out


def sharded_times(torch, bs, words, dh, device, label: str, samples: int = 5) -> dict:
    """{mesh: {op: {"call_ms": [low, median, high], "stages_ms": {...}}}}
    for ``ShardedBatchedSearcher`` over ``dh`` (see ``--sharded``), and
    the single layout's calls as mesh ``"single"``."""
    import time

    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh
    from sliceslice_tpu_torch.parallel import shard_scan as ss
    from sliceslice_tpu_torch.utils.profiling import measure

    def call_ms(fn, name):
        m = measure(fn, name, warmup=2, samples=samples, device=device)
        return [x * 1e3 for x in (m.low, m.estimate, m.high)]

    out = {"single": {op: {"call_ms": call_ms(lambda op=op: getattr(bs, op)(dh), op)}
                      for op in ("find_all", "count_all")}}
    for shape in ((1, 1), (2, 1), (4, 1), (2, 2)):
        sb = ShardedBatchedSearcher(words, make_mesh(shape, device=device)).optimize_for(dh)
        row = {}
        for op, mode in (("find_all", ss.FIND), ("count_all", ss.COUNT)):
            stages = {"launches_and_combine": [], "collective": [], "finish_and_readback": []}
            for _ in range(samples + 1):
                stamps = []

                def mark(stage, stamps=stamps):
                    torch.cuda.synchronize()
                    stamps.append((stage, time.perf_counter()))

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sb._sweep(dh, mode, mark)  # the sweep of find_all / count_all, stage by stage
                for stage, t in stamps:
                    stages[stage].append((t - t0) * 1e3)
                    t0 = t
            row[op] = {"call_ms": call_ms(lambda op=op: getattr(sb, op)(dh), f"{shape} {op}"),
                       "stages_ms": {k: sorted(v[1:])[samples // 2] for k, v in stages.items()}}
        out[f"{shape[0]}x{shape[1]}"] = row
    return {"round": label, "times": out}


def sharded_rounds(torch, bs, words, dh, device) -> list:
    """:func:`sharded_times` in three rounds: with no process group, in an
    NCCL group of one (on a free local port, destroyed after), and with no
    group again."""
    import socket

    import torch.distributed as dist

    from sliceslice_tpu_torch.parallel.distributed import initialize

    rounds = [sharded_times(torch, bs, words, dh, device, "no group")]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl", device=device)
    try:
        rounds.append(sharded_times(torch, bs, words, dh, device, "NCCL group of one"))
    finally:
        dist.destroy_process_group()
    rounds.append(sharded_times(torch, bs, words, dh, device, "no group, again"))
    return rounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--chunks", default="")
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--positions", action="store_true")
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from sliceslice_tpu_torch import BatchedSearcher, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.utils.profiling import card

    device = torch.device("cuda", 0)
    print(card(0), flush=True)
    hay = open(os.path.join(tree, "data", "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(tree, "data", "words.txt"), "rb").read().split(b"\n") if w]
    if args.pairs:
        print(json.dumps({"tree": tree, "pairs": pair_times(torch, words, device, args.reps)}), flush=True)
        return 0
    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    exp = np.array([hay.find(w) for w in words])
    if not np.array_equal(bs.find_all(dh), exp):
        raise SystemExit("find answers differ from bytes.find")
    bs.optimize_for(dh)
    if args.sharded:
        for row in sharded_rounds(torch, bs, words, dh, device):
            print(json.dumps(row), flush=True)
        return 0
    if args.positions:
        reps = min(args.reps, 4)
        row = {"tree": tree, "groups": {g.t: g.n for g in bs.groups},
               "positions": positions_times(torch, bs, hay, dh, device, reps)}
        print(json.dumps(row), flush=True)
        return 0
    queued = hasattr(scan_kernel, "FIND_CHUNK")
    chunks = [int(c) for c in args.chunks.split(",") if c] if queued else []
    for chunk in chunks or [None]:
        if chunk is not None:
            scan_kernel.FIND_CHUNK = scan_kernel.COUNT_CHUNK = chunk
        if not np.array_equal(bs.find_all(dh), exp):
            raise SystemExit(f"find answers differ from bytes.find at chunk {chunk}")
        chunks_now = [scan_kernel.FIND_CHUNK, scan_kernel.COUNT_CHUNK] if queued else None
        row = {"tree": tree, "chunks": chunks_now, "groups": {g.t: g.n for g in bs.groups},
               "kernel_ms": group_times(torch, bs, dh, device, args.reps),
               "sweep_ms": sweep_times(torch, bs, dh, device, args.reps),
               "one_row_ms": one_row_times(torch, hay, dh, device, args.reps),
               "trace": {"find": trace_share(torch, lambda: bs.find_all_device(dh)),
                         "count": trace_share(torch, lambda: bs.count_all_device(dh)),
                         "bitmap": trace_share(torch, lambda: positions_calls(bs, dh))}}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
