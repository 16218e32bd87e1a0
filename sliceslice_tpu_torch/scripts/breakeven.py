"""The break-even point of ``BatchedSearcher.optimize_for`` on the i386
word sweep (4,585 needles x 857,425 bytes).

    python -m sliceslice_tpu_torch.scripts.breakeven [--device cpu|cuda] [--sweeps K] [--words N] [--bytes B]

The port of ``scripts/breakeven.py``.  ``optimize_for`` reorders each
width group's rows by first offset so that rows which stop early share
work items of the find kernel's queue.  Two protocols:

* cold: ``optimize_for(dh)`` runs one measuring sweep and reorders on the
  device;
* piggyback: ``optimize_for(dh, firsts)`` reuses the answers a serving
  loop already holds (a host permute and an upload).

For each: ``t_base`` (ms per sustained sweep before; K sweeps, one
synchronisation, CUDA events, the lowest of 5 samples), ``c_opt`` (the
reschedule, host clock, synchronised), ``t_opt`` (after) and ``N* = c_opt
/ (t_base - t_opt)`` sweeps to break even, "never" when ``t_opt >=
t_base``.  The cold protocol runs twice; the first pays whatever the
process pays once.  Answers are checked equal before and after.  Prints
the card's name and power limit, then one line and one JSON line per
protocol; exits 1 on a mismatch.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def protocol(name: str, words, hay: bytes, piggyback: bool, device, sweeps: int) -> dict:
    """One protocol on a fresh searcher; the dict of its numbers (ms),
    ``"mismatch": True`` when the answers changed."""
    from sliceslice_tpu_torch import BatchedSearcher, preprocess
    from sliceslice_tpu_torch.needle import needed_halo_for_t
    from sliceslice_tpu_torch.utils.profiling import per_call_ms, sync

    bs = BatchedSearcher(words, device=device)
    dh = preprocess(hay, kh=needed_halo_for_t(bs.max_t), device=device)

    def run():
        return bs.find_all_device(dh)

    baseline = run().cpu().numpy()
    t_base = per_call_ms(run, sweeps, device)[0]
    firsts = bs.find_all(dh) if piggyback else None
    sync(device)
    t0 = time.perf_counter()
    bs.optimize_for(dh, firsts)
    sync(device)
    c_opt = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(run().cpu().numpy(), baseline)
    t_opt = per_call_ms(run, sweeps, device)[0]
    gain = t_base - t_opt
    row = {"protocol": name, "t_base_ms": t_base, "c_opt_ms": c_opt, "t_opt_ms": t_opt,
           "gain_ms": gain, "n_star": c_opt / gain if gain > 0 else "never"}
    if not same:
        row["mismatch"] = True
        print(f"MISMATCH [{name}]: optimize_for changed the answers", flush=True)
    n_star = f"{row['n_star']:.1f} sweeps" if gain > 0 else "never"
    print(f"[{name}] t_base {t_base:.4f} ms/sweep, c_opt {c_opt:.4f} ms, t_opt {t_opt:.4f} ms/sweep, "
          f"gain {gain:.4f} ms/sweep ({t_base / t_opt:.3f}x), N* {n_star}", flush=True)
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweeps", type=int, default=32)
    ap.add_argument("--words", type=int, default=None, help="the first N words only")
    ap.add_argument("--bytes", type=int, default=None, help="the first B bytes of i386 only")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.scripts.conformance import corpus
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    hay, words = corpus()
    hay, words = hay[:args.bytes], words[:args.words]
    rows = [protocol(name, words, hay, piggy, device, args.sweeps)
            for name, piggy in (("cold, first in the process", False),
                                ("cold: optimize_for(dh), one measuring sweep", False),
                                ("piggyback: optimize_for(dh, firsts)", True))]
    return 1 if any(r.get("mismatch") for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
