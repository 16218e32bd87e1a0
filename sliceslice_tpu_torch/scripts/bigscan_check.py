"""Stream a corpus past 4 GiB through ``StreamingScanner`` and check exact
int64 first offsets.

    python -m sliceslice_tpu_torch.scripts.bigscan_check [total_gib=4.5] [--device cpu|cuda]

The port of ``scripts/bigscan_check.py``.  The corpus is made chunk by
chunk and never whole: seeded lowercase filler with uppercase needles
planted at boundary-critical offsets (:func:`make_plants`: across 2^31,
past 2^31 and 2^32, at the end, one needle twice for first-occurrence
semantics), plus a needle planted nowhere.  Prints the card's name and
power limit, the GB/s (host generation included) and one line per needle;
exits 1 on any mismatch.  Imports no jax.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

#: Bytes of one generated chunk.
CHUNK = 64 * 1024 * 1024
#: The stream's windows.
WINDOW = 128 * 1024 * 1024
ABSENT = b"ABSENT-NEEDLE-Z!"


def make_plants(total: int) -> list:
    """(offset, needle) plants at boundary-critical offsets, those that fit
    in ``total`` bytes: a straddle of the int32 boundary, offsets past 2^31
    and 2^32 and at ``total - 20``, and DELTA twice (the earlier offset is
    its first)."""
    plants = [
        (1_000, b"ALPHA-NEEDLE-01!"),
        (2**31 - 8, b"STRADDLE-2GIB-XX"),
        (2**31 + 12_345, b"BETA-NEEDLE-002!"),
        (2**32 + 777, b"GAMMA-NEEDLE-03!"),
        (total - 20, b"OMEGA-NEEDLE-04!"),
        (2**31 + 9_999_999, b"DELTA-NEEDLE-05!"),
        (2**32 + 50_000_000, b"DELTA-NEEDLE-05!"),
    ]
    return [(o, n) for o, n in plants if o + len(n) <= total]


def expected(plants) -> tuple:
    """(needles, first offsets): every planted needle, sorted, then
    :data:`ABSENT` (-1)."""
    first = {}
    for off, nd in plants:
        first[nd] = min(first.get(nd, off), off)
    needles = sorted(first) + [ABSENT]
    return needles, [first.get(nd, -1) for nd in needles]


def chunks(total: int, plants, chunk: int = CHUNK):
    """The corpus as ``chunk``-byte pieces, each seeded by its own offset
    (lowercase), with the plants that touch it written in."""
    for base in range(0, total, chunk):
        size = min(chunk, total - base)
        buf = np.random.default_rng(base).integers(97, 123, (size,), dtype=np.uint8)
        for off, nd in plants:
            a = np.frombuffer(nd, dtype=np.uint8)
            s, e = max(off, base), min(off + len(nd), base + size)
            if s < e:
                buf[s - base:e - base] = a[s - off:e - off]
        yield buf.tobytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("total_gib", nargs="?", type=float, default=4.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--window", type=int, default=WINDOW)
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch import StreamingScanner
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    total = int(args.total_gib * 2**30)
    plants = make_plants(total)
    needles, exp = expected(plants)
    sc = StreamingScanner(needles, window_bytes=args.window, device=device)
    t0 = time.perf_counter()
    got = sc.find_in_chunks(chunks(total, plants), early_stop=False)
    dt = time.perf_counter() - t0
    print(f"total {total / 2**30:.2f} GiB in {dt:.3f} s ({total / dt / 1e9:.3f} GB/s end to end, "
          "host generation included)", flush=True)
    for nd, g, e in zip(needles, got, exp):
        print(f"  {nd.decode():18s} -> {int(g):>13d}  {'ok' if g == e else f'MISMATCH (expected {e})'}")
    if list(got) != exp:
        return 1
    print("bigscan: exact int64 offsets" + (" past 4 GiB" if total > 2**32 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
