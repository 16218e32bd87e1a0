"""Where the milliseconds of one cold ``find_all`` go: the i386 word sweep
(4,585 needles x 857,425 bytes) split into device compute, a launch round
trip, host dispatch and the readback.

    python -m sliceslice_tpu_torch.scripts.oneshot_decompose [--device cpu|cuda] [--samples N] [--sweeps K]
        [--words N] [--bytes B]

The port of ``scripts/oneshot_decompose.py``:

* compute: ms per sweep of K (32) ``find_all_device`` sweeps and one
  synchronisation (CUDA events), where the host's dispatch overlaps the
  kernels;
* launch round trip: one trivial torch op on the device and a
  synchronisation (the JAX script's link round trip), host clock;
* host dispatch: one ``find_all_device`` without a synchronisation, host
  clock (the kernels still run after it returns);
* readback and remap: the device answers copied to the host and made
  ``find_all``'s int64 array with -1 for absent;
* one-shot: ``find_all`` itself.

Each host-clock row is the lowest and the median of ``--samples``.
Prints the card's name and power limit, the table, and one JSON line.
Exits 1 if ``find_all`` differs from ``bytes.find``.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

def best(fn, samples: int, warm: int = 2, after=None) -> tuple:
    """(lowest, median) host-clock ms of ``samples`` calls; ``after`` runs
    untimed after each."""
    for _ in range(warm):
        fn()
        if after:
            after()
    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
        if after:
            after()
    ts.sort()
    return ts[0], ts[len(ts) // 2]


def decompose(words, hay: bytes, device, samples: int = 8, sweeps: int = 32) -> dict:
    import torch

    from sliceslice_tpu_torch import BatchedSearcher, preprocess
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.utils.profiling import per_call_ms, sync

    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    out = {"parity": bool(np.array_equal(bs.find_all(dh), [hay.find(w) for w in words]))}
    out["compute_ms"] = per_call_ms(lambda: bs.find_all_device(dh), sweeps, device,
                                    samples=max(3, samples // 2))[0]
    x = torch.zeros((8,), dtype=torch.int32, device=device)
    out["round_trip_ms"] = best(lambda: (x + 1, sync(device)), samples)
    out["dispatch_ms"] = best(lambda: bs.find_all_device(dh), samples, after=lambda: sync(device))
    ready = bs.find_all_device(dh)
    sync(device)

    def readback():
        a = ready.cpu().numpy().astype(np.int64)
        a[a >= SENTINEL] = -1
        return a

    out["readback_remap_ms"] = best(readback, samples)
    out["oneshot_ms"] = best(lambda: bs.find_all(dh), samples)
    model = out["compute_ms"] + out["round_trip_ms"][0] + out["dispatch_ms"][0] + out["readback_remap_ms"][0]
    out["model_ms"] = model
    out["residual_ms"] = out["oneshot_ms"][0] - model
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=32)
    ap.add_argument("--words", type=int, default=None, help="the first N words only")
    ap.add_argument("--bytes", type=int, default=None, help="the first B bytes of i386 only")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.bench import REFERENCE_SWEEP_S
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.scripts.conformance import corpus
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    hay, words = corpus()
    hay, words = hay[:args.bytes], words[:args.words]
    d = decompose(words, hay, device, args.samples, args.sweeps)
    if not d["parity"]:
        print("MISMATCH: find_all differs from bytes.find", flush=True)
    print(f"device compute (sustained, per sweep): {d['compute_ms']:9.4f} ms\n"
          f"launch round trip (trivial op + sync): {d['round_trip_ms'][0]:9.4f} ms low, "
          f"{d['round_trip_ms'][1]:.4f} med\n"
          f"host dispatch (no sync):               {d['dispatch_ms'][0]:9.4f} ms low, "
          f"{d['dispatch_ms'][1]:.4f} med\n"
          f"readback and remap:                    {d['readback_remap_ms'][0]:9.4f} ms low, "
          f"{d['readback_remap_ms'][1]:.4f} med\n"
          f"one-shot find_all:                     {d['oneshot_ms'][0]:9.4f} ms low, "
          f"{d['oneshot_ms'][1]:.4f} med\n"
          f"model (the four above):                {d['model_ms']:9.4f} ms (residual "
          f"{d['residual_ms']:+.4f} ms); the reference's sweep: {REFERENCE_SWEEP_S * 1e3:.3f} ms", flush=True)
    print(json.dumps(d), flush=True)
    return 0 if d["parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
