"""The port's headline benchmark: the i386 long-haystack sweep, with the
rows of the JAX ``bench.py`` beside it.

    python -m sliceslice_tpu_torch.bench [--device cpu|cuda] [--detail PATH] [--stream-bytes B]

Every one of the 4,585 dictionary words searched for its first offset in
the 857,425-byte Intel 80386 manual, the reference's long-haystack bench
(its README: 35.181 ms on an i7-6700).  The metric is the effective scan
throughput, needles x haystack bytes / seconds per sustained sweep, in
GB/s; ``vs_baseline`` is its ratio to the reference's (4,585 x 857,425 B /
35.181 ms = 111.7 GB/s, a CPU number).  In order:

1. the parity gate against ``bytes.find`` (``FAILED_CONFORMANCE`` and exit
   1 on any mismatch);
2. ``optimize_for``, then the gate again;
3. the sustained sweep: K ``find_all_device`` sweeps and one
   synchronisation, timed with CUDA events, 5 samples (low, median, high);
4. one ``find_all`` (answers read back), host clock, 3 samples;
5. the all-pairs sweep of the length-sorted words: K ``count_matches_device``
   calls (the reference's short-haystack bench, 79.4 ms);
6. ms per launch of each width group's find and count kernel, and the
   sustained find and count sweeps (``scripts/sweep_times.py``);
7. the random size matrix, the same-host CPU competitors and one
   torch.profiler trace of a sweep (written under the temporary directory);
8. the stream rows of ``scripts/stream_bench.py`` over a generated file;
9. the full conformance run (``scripts/conformance.py``): 4,585 words and
   21,022,225 pairs against ``bytes.find``.

Prints the card's name and power limit first, the detail object as one
JSON line before the last, and last ``{"metric", "value", "unit",
"vs_baseline"}``, the JAX bench's line, its metric naming the card.
Writes no file in the repository; ``--detail PATH`` writes the detail where
the caller says.  ``--device cpu`` runs a labelled reduced slice (the first
64 words over the first 64 KiB, 4 sweeps, the reduced conformance slice,
a 2 MiB stream at 1 MiB windows); nothing falls back to it.  Imports no
jax.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: The Rust reference's long-haystack sweep on its i7-6700 (criterion).
REFERENCE_SWEEP_S = 0.035181
REFERENCE_GBPS = 4585 * 857425 / REFERENCE_SWEEP_S / 1e9
#: Sweeps per sustained sample on the card (4 on the CPU's reduced slice).
SWEEPS = 32


def failed(metric: str) -> int:
    print(json.dumps({"metric": metric, "value": 0.0, "unit": "GB/s", "vs_baseline": 0.0}), flush=True)
    return 1


def main(argv=None, *, oracle=None) -> int:
    """Run the bench; 0, or 1 after a ``FAILED_*`` line.  ``oracle``: the
    conformance run's ``(exp_long, exp_short)`` (``scripts/conformance.py``)
    from a caller that already holds them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", default=None, help="write the detail object to this path")
    ap.add_argument("--stream-bytes", type=int, default=None, help="default 1 GiB; 2 MiB on the CPU")
    args = ap.parse_args(argv)
    import torch

    from sliceslice_tpu_torch import BatchedSearcher, PairwiseSearcher, preprocess
    from sliceslice_tpu_torch.benchmarks import competitors, random_matrix
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.scripts import conformance, stream_bench
    from sliceslice_tpu_torch.scripts.sweep_times import group_times, sweep_times
    from sliceslice_tpu_torch.utils.profiling import device_line, trace

    device = resolve_device(args.device)
    card = device_line(device)
    print(card, flush=True)
    reduced = device.type != "cuda"
    hay, words = conformance.corpus(full=True)
    if reduced:
        hay, words = hay[:64 * 1024], words[:64]
    K = 4 if reduced else SWEEPS
    stream_bytes = args.stream_bytes or ((2 << 20) if reduced else (1 << 30))
    stream_window = (1 << 20) if reduced else stream_bench.WINDOW

    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    exp = np.array([hay.find(w) for w in words])
    if not np.array_equal(bs.find_all(dh), exp):
        return failed("FAILED_CONFORMANCE")
    bs.optimize_for(dh)
    if not np.array_equal(bs.find_all(dh), exp):
        return failed("FAILED_CONFORMANCE_AFTER_OPTIMIZE")

    port = competitors.collect_port(bs, dh, PairwiseSearcher(sorted(words, key=len), device=device), device, K)
    sweep_ms = port["long_port_batched_sustained_ms"]
    gbps = len(words) * len(hay) / (sweep_ms[1] / 1e3) / 1e9

    workload = (f"REDUCED slice on the CPU: {len(words)} words x {len(hay)} B" if reduced
                else f"{len(words)} words x {len(hay)} B")
    detail = {
        "card": card, "workload": workload, "sweeps": K,
        "sustained_ms_per_sweep": sweep_ms[1], "sustained_ms_per_sweep_triple": sweep_ms,
        "sustained_gbps": gbps, "oneshot_ms": port["long_port_oneshot_ms"],
        "short_sweep_ms": port["short_port_pairwise_sustained_ms"][1],
        "short_sweep_ms_triple": port["short_port_pairwise_sustained_ms"],
        "short_pairs": len(words) ** 2,
        "kernels_ms": {"groups": {g.t: g.n for g in bs.groups},
                       **group_times(torch, bs, dh, device, reps=K),
                       "sweeps": sweep_times(torch, bs, dh, device, reps=K)},
        "random_matrix": random_matrix.collect(device),
    }
    detail["competitors"] = {**competitors.collect_host(hay, words), **port}
    detail["trace_logdir"] = trace(lambda: bs.find_all_device(dh))
    detail["streaming"] = stream_bench.run(stream_bytes, device, window=stream_window)
    exp_long, exp_short = oracle if oracle is not None else (None, None)
    conf = conformance.run_conformance(full=not reduced, device=device, exp_long=exp_long, exp_short=exp_short)
    detail["conformance"] = conf
    line = json.dumps(detail, default=float)
    print(line, flush=True)
    if args.detail:
        with open(args.detail, "w") as f:
            f.write(line + "\n")
    if conf["long_mismatches"] or conf["short_mismatches"]:
        return failed("FAILED_FULL_CONFORMANCE")
    if not all(r["ok"] for r in stream_bench.rows(detail["streaming"])):
        return failed("FAILED_STREAM_CHECK")
    print(json.dumps({
        "metric": f"effective GB/s on one {card}, i386 long-haystack sweep, sustained ({workload}, "
                  "optimize_for, first-offset parity enforced)",
        "value": round(gbps, 2), "unit": "GB/s", "vs_baseline": round(gbps / REFERENCE_GBPS, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
