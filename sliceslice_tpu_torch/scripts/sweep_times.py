"""Times of the find and count kernels over the i386 sweep, per width group.

    python3 sliceslice_tpu_torch/scripts/sweep_times.py [--tree DIR] [--chunks 16384,32768,65536]

All 4,585 words of ``data/words.txt`` over ``data/i386.txt`` on the first
CUDA card, after ``optimize_for``, as the smoke's sweeps run them: per
width group, ``batched_find`` and ``batched_count`` launched ``--reps``
times between two CUDA events (5 samples: low, median, high ms per
launch), then the sustained ``find_all_device`` and ``count_all_device``
sweeps, one-row launches (the word i386 holds last, at 857,156, and an
absent one), and a torch.profiler trace of 8 sweeps of each (device µs
per sweep, the card's idle share, µs per kernel).  ``sliceslice_tpu_torch`` is imported from ``--tree``
(default: the checkout holding this script), so one call can time two
checkouts one after the other on the same card.  ``--chunks`` times the find and
count kernels with both work-queue chunks set to each value in turn (a
checkout whose kernels have no queue ignores it).  Prints the card's name and power limit, then one JSON line
per chunk.  It checks every find answer against ``bytes.find`` first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def group_times(torch, bs, dh, device, reps: int = 32, samples: int = 5) -> dict:
    """{"find": {t: [low, median, high]}, "count": {...}}: ms per launch of
    each width group's find and count kernel over ``dh``."""
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.utils.profiling import measure

    out = {}
    for name, fn in (("find", scan_kernel.batched_find), ("count", scan_kernel.batched_count)):
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


def trace_share(torch, fn, reps: int = 8) -> dict:
    """One torch.profiler trace of ``reps`` calls of ``fn``: per call, the
    device time of its kernels (overlaps merged), the span from the first
    kernel's start to the last one's end, the card's idle share of that
    span, and the device µs per kernel name."""
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
    return {"device_us": busy / reps, "span_us": span / reps, "idle_share": 1 - busy / span,
            "kernels_us": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--chunks", default="")
    ap.add_argument("--reps", type=int, default=32)
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
    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    exp = np.array([hay.find(w) for w in words])
    if not np.array_equal(bs.find_all(dh), exp):
        raise SystemExit("find answers differ from bytes.find")
    bs.optimize_for(dh)
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
                         "count": trace_share(torch, lambda: bs.count_all_device(dh))}}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
