"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's NVIDIA cards.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the device's busy and traced seconds and a breakdown.
The numbers compared with the reference, each beside its limit, are the
last lines of standard error and the result's last key.  Exits non-zero,
printing no result, without the cards the cell asks for, when the run
fails, or when the process holds JAX or the JAX package once the window
has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (0 without it)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: The clock at this process's start.
T0 = time.perf_counter() - _process_age_s()

from .spec import ROOT

#: Top-level module names a run may not hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "sliceslice_tpu")
#: CUDA's just-in-time kernel cache, at a fixed path inside the checkout
#: (the program builds its kernels into its own ``csrc/build/`` there).
CUDA_CACHE = ROOT / ".portbench_cache" / "nv"


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules`` (the part of each
    module's name before the first dot, compared whole)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    os.environ["CUDA_CACHE_PATH"] = str(CUDA_CACHE)


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    from . import harness, spec

    cell = spec.cell(args.workload)
    import sliceslice_tpu_torch  # noqa: F401  (the system under test; none, no result)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
