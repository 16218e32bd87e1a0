"""The control of ``correct``: the plain reference put in the program's place
with the one guarantee the configurations state broken, exactness.  It
keeps sliceslice's candidate filter, a needle's first and last byte at
their distance, and leaves out the verification of the bytes between: the
step that would tempt a faster program.  Every cell has to come out as not
correct with it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 0]

runs the cell once per seed with the control as the system under test (a
window of one request when ``--seconds`` is 0) and prints one JSON line per
seed with the numbers compared and their limits.  It needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .inputs import Inputs


def filter_positions(hay: np.ndarray, needle: bytes) -> np.ndarray:
    """Offsets whose first and last bytes match the needle's, unverified."""
    k = len(needle)
    n = hay.size - k + 1
    if k == 0:
        return np.arange(hay.size + 1, dtype=np.int64)
    if n <= 0:
        return np.zeros((0,), np.int64)
    hit = (hay[:n] == needle[0]) & (hay[k - 1 : k - 1 + n] == needle[-1])
    return np.flatnonzero(hit).astype(np.int64)


class Control:
    """The system-under-test interface over :func:`filter_positions`."""

    def __init__(self, config: dict, op: str, inputs: Inputs, device):
        self.op = op
        self.hay = np.frombuffer(inputs.corpus, np.uint8)
        self.needles = inputs.needles

    def request(self):
        pos = [filter_positions(self.hay, n) for n in self.needles]
        if self.op == "positions":
            return pos
        if self.op == "count":
            return np.array([p.size for p in pos], np.int64)
        return np.array([p[0] if p.size else -1 for p in pos], np.int64)

    def close(self) -> None:
        self.hay = None


build = Control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    from . import harness, spec

    failed_all = True
    for seed in map(int, args.seeds.split(",")):
        cell = spec.cell(args.workload)
        cell.traffic = dict(cell.traffic, warmup_requests=0)
        result, _ = harness.run_cell(cell, seed, args.seconds, False, "cpu",
                                     time.perf_counter(), build=build)
        failed_all &= not result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
