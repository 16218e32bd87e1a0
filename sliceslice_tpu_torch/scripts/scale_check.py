"""The batched find sweep at scale: ~134 MiB of seeded lowercase x 502
needles of 8-24 bytes.

    python -m sliceslice_tpu_torch.scripts.scale_check [CHUNK|default] [mb=134] [k=8] [samples=5] [--device cpu|cuda]

The port of ``scripts/scale_check.py`` (seed 42, its corpus and needles):
a parity gate against ``bytes.find``, then ms per sustained
``find_all_device`` sweep (k sweeps, one synchronisation, CUDA events;
median of the samples, then low and high) and the effective GB/s
(needles x bytes / sweep).  The JAX script's segment geometry becomes the find kernel's
work-queue chunk: ``CHUNK`` positions (a multiple of 4,096; ``default``
keeps ``scan_kernel.FIND_CHUNK``).  Prints the card's name and power limit
and one JSON line; exits 1 if the gate fails.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def make_case(mb: float) -> tuple:
    """(corpus, needles): ``mb`` MiB of seeded lowercase and 502 needles
    of 8-24 bytes cut from it, as the JAX script draws them."""
    rng = np.random.default_rng(42)
    hay = rng.integers(97, 123, (int(mb * 2**20),), dtype=np.uint8).tobytes()
    needles = [hay[int(i):int(i) + int(kk)]
               for i, kk in zip(rng.integers(0, len(hay) - 24, (502,)), rng.integers(8, 25, (502,)))]
    return hay, needles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("args", nargs="*", help="CHUNK|default, mb=N, k=N, samples=N")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    chunk, mb, sweeps, samples = None, 134, 8, 5
    for a in args.args:
        if a.startswith("mb="):
            mb = float(a[3:])
        elif a.startswith("samples="):
            samples = int(a[8:])
        elif a.startswith("k="):
            sweeps = int(a[2:])
        elif a != "default":
            chunk = int(a)
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    default_chunk = scan_kernel.FIND_CHUNK
    scan_kernel.FIND_CHUNK = default_chunk if chunk is None else chunk
    try:
        return sweep(make_case(mb), sweeps, samples, device)
    finally:
        scan_kernel.FIND_CHUNK = default_chunk


def sweep(case, sweeps: int, samples: int, device) -> int:
    """The parity gate and the sustained sweep of one case; 0 or 1."""
    from sliceslice_tpu_torch import BatchedSearcher, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.utils.profiling import per_call_ms

    hay, needles = case
    t0 = time.perf_counter()
    dh = preprocess(hay, kh=24, keep_host=False, device=device)
    bs = BatchedSearcher(needles, device=device)
    got = bs.find_all(dh)
    exp = np.array([hay.find(nd) for nd in needles])
    gate_s = time.perf_counter() - t0
    if not np.array_equal(got, exp):
        print(f"MISMATCH: {int((got != exp).sum())} of {len(needles)} needles differ from bytes.find", flush=True)
        return 1
    ms = per_call_ms(lambda: bs.find_all_device(dh), sweeps, device, samples=samples)
    row = {"bytes": len(hay), "needles": len(needles), "chunk": scan_kernel.FIND_CHUNK,
           "sweeps": sweeps, "gate_s": gate_s, "sweep_ms": ms,
           "GBps": len(needles) * len(hay) / (ms[1] * 1e-3) / 1e9, "parity": True}
    print(f"chunk {row['chunk']}: {ms[1]:.3f} ms/sweep [{ms[0]:.3f} {ms[2]:.3f}] "
          f"({row['GBps']:.0f} GB/s effective); layout, first sweep and parity gate {gate_s:.1f} s", flush=True)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
