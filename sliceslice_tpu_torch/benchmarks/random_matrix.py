"""The random needle/haystack size matrix (the reference's
bench/benches/random.rs) on the port.

    python -m sliceslice_tpu_torch.benchmarks.random_matrix [--device cpu|cuda]

Needle sizes {1, 5, 10, 20, 50, 100, 1000} (prefixes of data/needle) x
haystack sizes at least the needle's (prefixes of the 1000-byte
data/haystack): one ``DynamicSearcher.find`` per cell, held to match and
offset against ``naive_find``, and timed beside ``bytes.find`` and the
native SWAR scanner.  Haystacks this small arrive as host bytes, so the
searcher takes its host rung (a device round trip costs more than a
1 KB scan): this is the latency regime, the batched and pairwise sweeps
the throughput one.  Prints the card's name and power limit and a
markdown table (µs per search); exits 1 on any mismatch.  Imports no jax.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NEEDLE_SIZES = (1, 5, 10, 20, 50, 100, 1000)
HAY_SIZES = (1, 5, 10, 20, 50, 100, 1000)


class Mismatch(AssertionError):
    """A cell's answer differs from the oracle."""


def _us(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def collect(device="cuda") -> list:
    """Every cell: rows of {needle, haystack, match, offset, py_us,
    swar_us (when the native helper builds), port_us}."""
    from sliceslice_tpu_torch import DynamicSearcher, naive_find
    from sliceslice_tpu_torch.utils import native

    needle_data = open(os.path.join(REPO, "data/needle"), "rb").read()
    hay_data = open(os.path.join(REPO, "data/haystack"), "rb").read()
    rows = []
    for ks in NEEDLE_SIZES:
        nd = needle_data[:ks]
        searcher = DynamicSearcher(nd, device=device)
        for hs in HAY_SIZES:
            if hs < ks:
                continue
            hay = hay_data[:hs]
            exp = naive_find(hay, nd)
            row = {"needle": ks, "haystack": hs, "py_us": round(_us(lambda: hay.find(nd), 100), 2)}
            if native.available():
                native.swar_find(hay, nd)
                row["swar_us"] = round(_us(lambda: native.swar_find(hay, nd), 100), 2)
            got = searcher.find(hay)
            if got != exp:
                raise Mismatch(f"needle {ks} B in haystack {hs} B: {got}, naive_find {exp}")
            row["match"] = got is not None
            row["offset"] = -1 if got is None else got
            row["port_us"] = round(_us(lambda: searcher.find(hay), 3), 1)
            rows.append(row)
    return rows


def table(rows) -> str:
    out = ["| needle | haystack | match | python find | SWAR | port dynamic |",
           "|--------|----------|-------|-------------|------|--------------|"]
    for r in rows:
        out.append(f"| {r['needle']} | {r['haystack']} | {r['match']} | {r['py_us']:.2f} us "
                   f"| {r.get('swar_us', float('nan')):.2f} us | {r['port_us']:.1f} us |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    try:
        rows = collect(device)
    except Mismatch as e:
        print(f"MISMATCH {e}", flush=True)
        return 1
    print(table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
