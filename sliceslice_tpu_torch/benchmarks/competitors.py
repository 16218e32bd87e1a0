"""The competitor table (the reference's criterion benches,
bench/benches/i386.rs and random.rs) on the port: the two reference
sweeps run by every implementation on this machine.

    python -m sliceslice_tpu_torch.benchmarks.competitors [--device cpu|cuda]

Rows: CPython ``bytes.find``, the native SWAR and Two-Way scanners of the
port's own host helper (``csrc/host/``, C++ on this machine's CPU), then
the port's batched sweep (sustained and one-shot) and its pairwise
sweep on ``--device``, measured as the bench measures them.
:func:`collect_host` gives the same-host CPU rows and :func:`collect_port`
the port's, both as low / median / high ms triples for ``bench.py``.
Prints the card's name and power limit and a markdown table.  Imports no
jax.
"""

from __future__ import annotations

import argparse
import sys

from sliceslice_tpu_torch.utils.profiling import per_call_ms


def collect_host(hay: bytes = None, words=None, short: bool = True) -> dict:
    """Same-host CPU rows, [low, median, high] ms of 3 samples (host
    clock): the long sweep of ``words`` over ``hay`` (default: the 4,585
    words over i386) by ``bytes.find`` and, when the helper builds, SWAR
    and Two-Way; with ``short``, SWAR's all-pairs sweep of the
    length-sorted words (one sample)."""
    from sliceslice_tpu_torch.scripts.conformance import corpus
    from sliceslice_tpu_torch.utils import native

    if hay is None:
        hay, words = corpus()

    def ms(fn):
        return per_call_ms(fn, 1, None, samples=3)

    out = {"long_py_bytes_find_ms": ms(lambda: [hay.find(w) for w in words])}
    if native.available():
        out["long_native_swar_ms"] = ms(lambda: native.swar_find_batch(hay, words))
        out["long_native_twoway_ms"] = ms(lambda: native.twoway_find_batch(hay, words))
        if short:
            ws = sorted(words, key=len)
            out["short_native_swar_allpairs_ms"] = per_call_ms(lambda: native.swar_pairwise(ws), 1, None,
                                                               samples=1, warmup=0)[0]
    return out


def collect_port(bs, dh, ps, device, sweeps: int) -> dict:
    """The port's rows, [low, median, high] ms per sweep: ``sweeps``
    ``bs.find_all_device(dh)`` sweeps and one synchronisation (5 samples,
    CUDA events on the card), one ``bs.find_all(dh)`` with its answers read
    back (3 samples, host clock), and ``sweeps``
    ``ps.count_matches_device()`` all-pairs sweeps (5 samples)."""
    return {
        "long_port_batched_sustained_ms": per_call_ms(lambda: bs.find_all_device(dh), sweeps, device),
        "long_port_oneshot_ms": per_call_ms(lambda: bs.find_all(dh), 1, None, samples=3),
        "short_port_pairwise_sustained_ms": per_call_ms(ps.count_matches_device, sweeps, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np

    from sliceslice_tpu_torch import BatchedSearcher, PairwiseSearcher, preprocess
    from sliceslice_tpu_torch.bench import REFERENCE_SWEEP_S, SWEEPS
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.scripts.conformance import corpus
    from sliceslice_tpu_torch.utils import native
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    hay, words = corpus()
    ws = sorted(words, key=len)
    host = collect_host(hay, words)
    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    bs.optimize_for(dh)  # the bench's schedule
    if not np.array_equal(bs.find_all(dh), [hay.find(w) for w in words]):
        print("MISMATCH: the batched sweep differs from bytes.find", flush=True)
        return 1
    port = collect_port(bs, dh, PairwiseSearcher(ws, device=device), device, SWEEPS)
    rows = [(f"**long haystack** (ref sliceslice: {REFERENCE_SWEEP_S * 1e3:.3f} ms)", ""),
            ("python bytes.find", host["long_py_bytes_find_ms"])]
    if native.available():
        rows += [("native SWAR (C++)", host["long_native_swar_ms"]),
                 ("native Two-Way (C++)", host["long_native_twoway_ms"])]
    rows += [(f"port batched ({device.type}, sustained, per sweep)", port["long_port_batched_sustained_ms"]),
             ("port batched (one-shot, answers read back)", port["long_port_oneshot_ms"]),
             ("**short haystack** (ref sliceslice: 79.28 / 79.42 / 79.60 ms)", "")]
    if native.available():
        rows.append(("native SWAR (C++) all-pairs", [host["short_native_swar_allpairs_ms"]] * 3))
    rows.append((f"port pairwise ({device.type}, per sweep)", port["short_port_pairwise_sustained_ms"]))
    width = max(len(r[0]) for r in rows)
    print(f"| {'implementation':<{width}} | time (low / median / high) |")
    print(f"|{'-' * (width + 2)}|----------------------------|")
    for name, val in rows:
        print(f"| {name:<{width}} | {' / '.join(f'{x:.3f}' for x in val) + ' ms' if val else ''} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
