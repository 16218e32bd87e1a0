"""Run the sharded scan across two real processes on ``torch.distributed``
(gloo), each laying out only its own half of the corpus plus a peek past
it, and hold find, count, positions (gathered) and a huge needle across
the process boundary against the corpus's plants.

    python -m sliceslice_tpu_torch.scripts.multihost_check [--device cpu|cuda]
        [--bytes N] [--cells-per-process C] [--timeout S]

Launcher (the default): picks a free local port, starts the two workers,
checks their exit codes and prints one line per worker and the parity
line.  Worker: ``--worker PORT RANK``.  Each worker joins a gloo group of
two (the collectives run on CPU tensors, even with the cells on the card:
NCCL will not put two ranks on one card), builds a global mesh of ``C``
cells per process on ``--device`` (``2C x 1``) and assembles its range of
the corpus; no process ever holds the whole corpus.

The corpus is one seeded lowercase block repeated, with uppercase needles
planted at boundary-critical offsets (:func:`make_plants`: past 2^31 and
2^32 when the corpus is that long, across the shard and process
boundaries), so the plants are the oracle: they occur nowhere else.  A
corpus of at most :data:`ORACLE_MAX` bytes is also built whole by each
worker, to hold frequent lowercase needles against ``bytes.find``.  Each
worker prints one JSON line with its timings (assembly, find and count
sweeps, a collective).  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

from sliceslice_tpu_torch.scripts.bigscan_check import make_plants

#: Bytes of the seeded block the corpus repeats (at most the corpus).
BLOCK = 64 << 20
#: Corpora up to this size are also built whole for a bytes.find oracle.
ORACLE_MAX = 64 << 20
#: A huge needle (over MAX_NEEDLE_LEN = 2,048 bytes) planted across the
#: process boundary and once more inside process 0's range.
HUGE_LEN = 2548
NPROC = 2
#: Timed sweeps per mode (after one warm-up); the median is reported.
SAMPLES = 3
KH = 64  # the huge needles' 64-byte prefix filter needs 63 halo bytes


def plant_range(block: np.ndarray, plants, lo: int, hi: int) -> np.ndarray:
    """Bytes ``[lo, hi)`` of the corpus: ``block`` repeated from offset 0,
    with the plants that touch the range written in."""
    out = np.empty((max(hi - lo, 0),), np.uint8)
    size = block.size
    at = lo
    while at < hi:
        a = at % size
        n = min(size - a, hi - at)
        out[at - lo:at - lo + n] = block[a:a + n]
        at += n
    for off, nd in plants:
        a, b = max(off, lo), min(off + len(nd), hi)
        if a < b:
            out[a - lo:b - lo] = np.frombuffer(nd, np.uint8)[a - off:b - off]
    return out


def plant_chunks(total: int, plants, block: np.ndarray):
    """The corpus as a stream of ``block``-sized chunks (memoryviews),
    never more than one chunk on the host."""
    for base in range(0, total, block.size):
        yield plant_range(block, plants, base, min(base + block.size, total)).data


def layout(total: int, cells: int):
    """(shard bytes, each process's range [lo, hi)) of a ``total``-byte
    corpus over ``NPROC`` processes of ``cells`` data rows each."""
    from sliceslice_tpu_torch.parallel.shard_scan import shard_bytes_for

    sb = shard_bytes_for(total, NPROC * cells)
    return sb, [(min(r * cells * sb, total), min((r + 1) * cells * sb, total)) for r in range(NPROC)]


def case(total: int, cells: int):
    """The corpus's block and plants: make_plants' own, the huge needle
    across the process boundary and once inside process 0, and a plant
    across each shard boundary that no other plant covers."""
    rng = np.random.default_rng(4545)
    block = rng.integers(97, 123, min(BLOCK, total), dtype=np.uint8)
    sb, ranges = layout(total, cells)
    mid = ranges[1][0]
    huge = rng.integers(65, 91, HUGE_LEN, dtype=np.uint8).tobytes()
    extra = [(mid - 900, huge), (mid // 3, huge)]
    extra += [(d * sb - 7, b"SHARD-EDGE-%03d!" % d) for d in range(1, NPROC * cells)]
    plants = make_plants(total)
    taken = [(o, o + len(n)) for o, n in plants]
    for o, n in extra:  # no plant overwrites another
        if 0 <= o and o + len(n) <= total and all(o + len(n) <= a or b <= o for a, b in taken):
            plants.append((o, n))
            taken.append((o, o + len(n)))
    return block, plants, huge, sb, ranges


def worker(port: int, rank: int, args) -> None:
    import torch

    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.needle import build_probe_table
    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, gather_positions
    from sliceslice_tpu_torch.parallel.distributed import (
        all_reduce, allgather_i64, assemble_global_corpus, global_mesh, initialize)
    from sliceslice_tpu_torch.parallel.shard_scan import sharded_count_cols, sharded_find_cols, sharded_positions
    from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

    torch.set_num_threads(1)
    total, cells = args.bytes, args.cells_per_process
    initialize(f"127.0.0.1:{port}", NPROC, rank, backend="gloo", device=args.device,
               timeout_s=args.timeout)
    mesh = global_mesh(cells_per_process=cells, device=args.device)
    block, plants, huge, sb, ranges = case(total, cells)
    lo, hi = ranges[rank]
    mid = ranges[1][0]
    t0 = time.perf_counter()
    local = plant_range(block, plants, lo, hi)
    peek = plant_range(block, plants, hi, min(hi + max(KH, HUGE_LEN - 1), total))
    t1 = time.perf_counter()
    gc = assemble_global_corpus(local, peek, total, KH, mesh, shard_bytes=sb)
    if args.device != "cpu":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    assert gc.local_base == lo and gc.shard_bytes == sb, (gc.local_base, gc.shard_bytes)

    # The oracle: every plant needle's offsets (they occur nowhere else),
    # and for a small corpus a few lowercase needles over the whole corpus.
    offsets = {}
    for off, nd in plants:
        offsets.setdefault(nd, []).append(off)
    # A 10-byte piece of the huge needle crosses the process boundary
    # inside the huge plant there.
    piece = huge[895:905]
    short = sorted(nd for nd in offsets if len(nd) <= 2048) + [piece, b"ABSENT-NEEDLE-Z!"]
    exp_pos = {nd: np.asarray(sorted(offsets.get(nd, [])), np.int64) for nd in offsets}
    exp_pos[piece] = np.asarray(sorted(o + q for o in offsets[huge] for q in _host_positions(huge, piece)), np.int64)
    exp_pos[b"ABSENT-NEEDLE-Z!"] = np.empty((0,), np.int64)
    assert any(o < mid < o + len(piece) for o in exp_pos[piece]), "no short plant crosses the process boundary"
    if total <= ORACLE_MAX:
        full = plant_range(block, plants, 0, total).tobytes()
        for nd in (full[10:22], full[mid - 5:mid + 5], full[total - 8:], full[:2]):
            short.append(nd)
            exp_pos[nd] = _host_positions(full, nd)
            assert exp_pos[nd].size == overlapping_count(full, nd)

    values, masks, lengths = build_probe_table(short)
    ends = np.maximum(total - lengths.astype(np.int64) + 1, 0)
    got = sharded_find_cols(gc, values, masks, ends, mesh)
    cnt = sharded_count_cols(gc, values, masks, ends, mesh)
    if isinstance(got, torch.Tensor):  # the padded corpus fits int32
        got = np.where(got.cpu().numpy() >= SENTINEL, -1, got.cpu().numpy())
        cnt = cnt.cpu().numpy()
    for nd, f, c in zip(short, got, cnt):
        e = exp_pos[nd]
        assert int(f) == (int(e[0]) if e.size else -1), (nd, int(f), e[:3])
        assert int(c) == e.size, (nd, int(c), e.size)
    per_proc = sharded_positions(gc, values, masks, ends, mesh)
    merged = gather_positions(per_proc)
    for nd, p in zip(short, merged):
        assert np.array_equal(p, exp_pos[nd]), (nd, p[:5], exp_pos[nd][:5])
    n_local = sum(p.size for p in per_proc)
    n_glob = sum(p.size for p in merged)
    assert 0 < n_local < n_glob, (n_local, n_glob)  # the gather added the other's

    # The huge needle across the process boundary, among short needles:
    # the sharded prefix filter, verified by the process holding each
    # candidate's first byte (reading into the peek), combined.
    needles = [huge, bytes(HUGE_LEN), short[0], short[-1]]
    exp = [np.asarray(sorted(offsets.get(huge, [])), np.int64), np.empty((0,), np.int64),
           exp_pos[short[0]], exp_pos[short[-1]]]
    assert any(o < mid < o + HUGE_LEN for o in exp[0]), "the huge needle does not cross the process boundary"
    sb_search = ShardedBatchedSearcher(needles, mesh)
    f = sb_search.find_all(gc)
    c = sb_search.count_all(gc)
    p = sb_search.positions_all(gc, gather=True)
    for nd, e, ff, cc, pp in zip(needles, exp, f, c, p):
        assert int(ff) == (int(e[0]) if e.size else -1), (len(nd), int(ff))
        assert int(cc) == e.size, (len(nd), int(cc))
        assert np.array_equal(pp, e), (len(nd), pp[:3])

    # int64 collectives exact past 2^31.
    rows = allgather_i64(np.asarray([2**40 + rank, -1, 2**31 + 5], np.int64))
    assert rows.tolist() == [[2**40 + q, -1, 2**31 + 5] for q in range(NPROC)], rows.tolist()

    # Timings: find and count sweeps of the short needles (each with its
    # collective and readback), one collective of 4,585 int64 alone.
    times = {}
    for name, fn in (("find", lambda: sb_search.find_all(gc)), ("count", lambda: sb_search.count_all(gc))):
        fn()
        ts = []
        for _ in range(SAMPLES):
            s0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - s0)
        times[f"{name}_s"] = sorted(ts)[len(ts) // 2]
        times[f"{name}_GBps"] = total * len(needles) / times[f"{name}_s"] / 1e9
    vec = torch.zeros((4585,), dtype=torch.int64)
    all_reduce(vec, "min")
    s0 = time.perf_counter()
    for _ in range(32):
        all_reduce(vec, "min")
    times["collective_us"] = (time.perf_counter() - s0) / 32 * 1e6
    print(json.dumps({"rank": rank, "device": args.device, "bytes": total, "local_bytes": hi - lo,
                      "cells": cells, "mesh": mesh.shape, "shard_bytes": sb,
                      "generate_s": t1 - t0, "assemble_s": t2 - t1, "plants": len(plants),
                      "max_offset": max(o for o, _ in plants), "positions_local": n_local,
                      "positions_global": n_glob, "sweep_needles": len(needles), **times}), flush=True)
    print(f"process {rank}: multihost parity ok — find/count/positions(+gather)/huge({HUGE_LEN}B, "
          f"cross-process straddle), {len(short)} needles, mesh {mesh.shape}", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


def launch(args) -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "sliceslice_tpu_torch.scripts.multihost_check", "--device", args.device,
           "--bytes", str(args.bytes), "--cells-per-process", str(args.cells_per_process),
           "--timeout", str(args.timeout), "--worker", str(port)]
    procs = [subprocess.Popen(cmd + [str(r)], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(NPROC)]
    ok = True
    try:
        outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
    finally:
        for p in procs:  # a worker past its time (or left behind by an error) is stopped
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.splitlines()
        if p.returncode != 0:
            ok = False
            print(f"-- worker {r} FAILED (rc={p.returncode}) --\n" + "\n".join(lines[-12:]))
        else:
            print("\n".join(ln for ln in lines if ln.startswith("{") or ln.startswith("process ")))
    if not ok:
        return 1
    print("multihost_check: 2-process sharded scan parity ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--bytes", type=int, default=600_000)
    ap.add_argument("--cells-per-process", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=170.0)
    ap.add_argument("--worker", nargs=2, type=int, metavar=("PORT", "RANK"))
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker[0], args.worker[1], args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
