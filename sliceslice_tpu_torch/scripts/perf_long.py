"""The three regimes of the find kernel on i386, each beside its bound.

    python -m sliceslice_tpu_torch.scripts.perf_long [K=32] [--device cpu|cuda] [--words N] [--bytes B]

The port of ``scripts/perf_long.py``, over 857,425-byte ``data/i386.txt``
with as many needles as ``data/words.txt`` holds (4,585):

* real: the words themselves;
* floor: distinct 8-byte needles cut from the first 32 KiB, so every
  needle stops in the queue's first chunk;
* fullscan: 8-byte needles that begin with 0xFF, a byte the manual does
  not hold, so no needle stops early.

For each: ms per sustained ``find_all_device`` sweep (K sweeps, one
synchronisation, CUDA events; median of 5, then low and high), the
effective GB/s (needles x bytes / sweep), and the sweep's bound from
:func:`find_bound`.  Prints the card's name and power limit, one line and
one JSON line per regime; exits 1 if a regime's answers differ from
``bytes.find``.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def find_bound(bs, dh, firsts) -> tuple:
    """(ms, "operations" or "bytes"): ``utils.profiling.bound_ms`` of one
    find sweep: one 32-bit operation per position the answers need tested
    (up to each row's first match, else its limit), and per width group the
    corpus, tables, ends and answers moved once."""
    from sliceslice_tpu_torch.ops.scan_math import position_limit
    from sliceslice_tpu_torch.utils.profiling import bound_ms

    numel = dh.flat.numel()
    ops = nbytes = 0
    for g in bs.groups:
        lim = np.minimum(np.maximum(dh.length - g.lengths.astype(np.int64) + 1, 0), position_limit(numel, g.t))
        f = np.asarray(firsts)[g.indices]
        ops += int(np.where(f >= 0, np.minimum(f + 1, lim), lim).sum())
        nbytes += numel + 4 * g.n_pad * (2 * g.t + 2)
    return bound_ms(ops, nbytes)


def regimes(hay: bytes, words, rng) -> dict:
    """{name: needles} of the three regimes, ``len(words)`` needles each."""
    floor, seen = [], set()
    head = min(32 * 1024, len(hay))
    while len(floor) < len(words):
        off = int(rng.integers(0, head - 8))
        w = hay[off:off + 8]
        if w not in seen:
            seen.add(w)
            floor.append(w)
    fullscan = [bytes([0xFF]) + bytes(rng.integers(1, 255, 7).tolist()) for _ in range(len(words))]
    return {"real": list(words), "floor": floor, "fullscan": fullscan}


def run(name: str, needles, hay: bytes, dh, sweeps: int, device) -> dict:
    from sliceslice_tpu_torch import BatchedSearcher
    from sliceslice_tpu_torch.utils.profiling import per_call_ms

    bs = BatchedSearcher(needles, device=device)
    firsts = bs.find_all(dh)
    parity = bool(np.array_equal(firsts, [hay.find(w) for w in needles]))
    ms = per_call_ms(lambda: bs.find_all_device(dh), sweeps, device)
    bound, by = find_bound(bs, dh, firsts)
    row = {"regime": name, "needles": len(needles), "sweep_ms": ms,
           "GBps": len(needles) * len(hay) / (ms[1] * 1e-3) / 1e9, "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / ms[1], "parity": parity}
    if not parity:
        print(f"MISMATCH [{name}]: find_all differs from bytes.find", flush=True)
    print(f"{name:9s}: {ms[1]:8.4f} ms/sweep [{ms[0]:.4f} {ms[2]:.4f}] ({row['GBps']:9.1f} GB/s eff), "
          f"bound {bound:.4f} ms ({by}), {100 * row['share_of_bound']:.1f}% of it", flush=True)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sweeps", nargs="?", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--words", type=int, default=None, help="the first N words only")
    ap.add_argument("--bytes", type=int, default=None, help="the first B bytes of i386 only")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch import preprocess
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.scripts.conformance import corpus
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    hay, words = corpus()
    hay, words = hay[:args.bytes], words[:args.words]
    dh = preprocess(hay, kh=24, device=device)
    rows = [run(name, nds, hay, dh, args.sweeps, device)
            for name, nds in regimes(hay, words, np.random.default_rng(0)).items()]
    return 0 if all(r["parity"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
