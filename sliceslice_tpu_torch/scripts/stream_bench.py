"""Stream throughput over a generated file: GB/s per mode of
``StreamingScanner``, with its own split of the time.

    python -m sliceslice_tpu_torch.scripts.stream_bench [long_bytes=1073741824] [--fast] [--device cpu|cuda] [--window B]

The port of ``scripts/stream_bench.py``, in one process: a seeded random
file of ``long_bytes`` (written once under the system's temporary
directory), 48 needles cut from its head and middle and an absent decoy
(the JAX script's draw), then one warmed-up stream per row: find and count
over the whole file, find over a short prefix twice (best of the two) and
positions over a small prefix with 9 needles.  Each row: bytes, seconds,
GB/s on the host clock and ``stats_summary()`` (read, copy, dispatch and
drain seconds; p50 and p90 window latency).  Each stream is spot-checked:
the drawn needles are found, the decoy is not.  Prints the card's name and
power limit, a table and one JSON line; exits 1 on a failed check.
Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

#: The streams' windows.
WINDOW = 32 << 20
#: The short streams' and the positions stream's bytes (cut to the file).
SHORT = 256 << 20
POSITIONS = 64 << 20


def corpus_path(size: int) -> str:
    """A file of exactly ``size`` seeded random bytes under the temporary
    directory, written once (its name holds the size)."""
    path = os.path.join(tempfile.gettempdir(), f"sliceslice_tpu_torch_stream_{size}.bin")
    if not (os.path.exists(path) and os.path.getsize(path) == size):
        rng = np.random.default_rng(42)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "wb") as f:
            left = size
            while left:
                n = min(left, 256 << 20)
                f.write(rng.bytes(n))
                left -= n
        os.replace(tmp, path)
    return path


def draw_needles(path: str, size: int) -> list:
    """48 substrings of 8-64 bytes, four of each length from the first
    4 MiB and from 1 MiB at the middle, then an absent decoy."""
    with open(path, "rb") as f:
        head = f.read(min(4 << 20, size))
        f.seek(size // 2)
        mid = f.read(min(1 << 20, size - size // 2))
    rng = np.random.default_rng(7)
    return [bytes(src[o:o + k]) for src in (head, mid) for k in (8, 12, 16, 24, 33, 64)
            for o in map(int, rng.integers(0, len(src) - 64, (4,)))] + [b"\x00absent!" + bytes(8) + b"q" * 9]


def stream(mode: str, size: int, device, window: int) -> dict:
    """One warmed-up stream of ``mode`` over the first ``size`` bytes."""
    from sliceslice_tpu_torch import StreamingScanner

    path = corpus_path(size)
    needles = draw_needles(path, size)
    if mode == "positions":
        needles = needles[:8] + needles[-1:]
    sc = StreamingScanner(needles, window_bytes=window, device=device)
    t0 = time.perf_counter()
    sc.warmup(modes=(mode,))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    if mode == "find":
        out = sc.find_in_file(path, early_stop=False)
        ok = int(out[-1]) == -1 and all(int(x) >= 0 for x in out[:-1])
    elif mode == "count":
        out = sc.count_in_file(path)
        ok = int(out[-1]) == 0 and all(int(x) >= 1 for x in out[:-1])
    else:
        out = sc.positions_in_file(path)
        ok = out[-1].size == 0 and all(p.size >= 1 and (np.diff(p) > 0).all() for p in out[:-1])
    wall = time.perf_counter() - t0
    return {"mode": mode, "bytes": size, "needles": len(needles), "window": sc.window,
            "warmup_s": warm, "wall_s": wall, "GBps": size / wall / 1e9, "ok": bool(ok),
            "stats": sc.stats_summary()}


def run(long_bytes: int, device, fast: bool = False, window: int = WINDOW) -> dict:
    """Every row (``fast``: count over the short prefix, one short find)."""
    short = min(SHORT, long_bytes)
    res = {"window_bytes": window, "find_long": stream("find", long_bytes, device, window),
           "count_long": stream("count", short if fast else long_bytes, device, window)}
    res["find_short"] = [stream("find", short, device, window) for _ in range(1 if fast else 2)]
    res["find_short_best_GBps"] = max(r["GBps"] for r in res["find_short"])
    res["positions_small"] = stream("positions", min(POSITIONS, long_bytes), device, window)
    return res


def rows(res: dict) -> list:
    return [res["find_long"], res["count_long"], *res["find_short"], res["positions_small"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("long_bytes", nargs="?", type=int, default=1 << 30)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--window", type=int, default=WINDOW)
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    res = run(args.long_bytes, device, args.fast, args.window)
    for r in rows(res):
        s = r["stats"]
        print(f"{r['mode']:9s} {r['bytes'] / 2**20:8.1f} MiB: {r['GBps']:7.3f} GB/s ({r['wall_s']:.3f} s; "
              f"read {s.get('read_s')} upload {s.get('upload_s')} dispatch {s.get('dispatch_s')} "
              f"drain {s.get('drain_s')} s; window p50 {s.get('window_p50_ms')} p90 "
              f"{s.get('window_p90_ms')} ms){'' if r['ok'] else '  MISMATCH'}", flush=True)
    print(json.dumps(res), flush=True)
    return 0 if all(r["ok"] for r in rows(res)) else 1


if __name__ == "__main__":
    sys.exit(main())
