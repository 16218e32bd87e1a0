"""The full i386 conformance run on the port: every word of the 4,585-word
dictionary searched in the 857,425-byte i386 manual, and the full ordered
N x N matrix of the length-sorted words searched in each other (21,022,225
pairs, of which ``short_pairs`` are same-or-longer), both at first-offset
granularity against ``bytes.find``.

    python -m sliceslice_tpu_torch.scripts.conformance [--device cpu|cuda] [--out PATH]

Prints the card's name and power limit, then the result as one JSON line;
exits 1 on any mismatch.  On the card it runs the full sweeps; ``--device
cpu`` runs the JAX script's reduced slice, the first 96 words over the
first 96 KiB (``run_conformance(full=False)`` from Python).  Writes a file
only where ``--out`` names one.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def corpus(full: bool = True) -> tuple:
    """(i386 bytes, words): the whole files, or the reduced slice."""
    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(REPO, "data/words.txt"), "rb").read().split(b"\n") if w]
    if not full:
        words, hay = words[:96], hay[:96 * 1024]
    return hay, words


def pair_oracle(ws) -> np.ndarray:
    """int32[N, N]: ``ws[j].find(ws[i])`` at ``[i, j]``."""
    exp = np.empty((len(ws), len(ws)), np.int32)
    for i, nd in enumerate(ws):
        exp[i] = [h.find(nd) for h in ws]
    return exp


def run_conformance(full: bool = True, device="cuda", exp_long: Optional[np.ndarray] = None,
                    exp_short: Optional[np.ndarray] = None) -> dict:
    """Both sweeps on ``device``; the counts of the JAX script's artifact
    (without its round number).  ``exp_long`` (the words' offsets in the
    manual) and ``exp_short`` (:func:`pair_oracle` of the length-sorted
    words) may be passed in by a caller that already holds them."""
    from sliceslice_tpu_torch import BatchedSearcher, PairwiseSearcher, preprocess

    hay, words = corpus(full)
    dh = preprocess(hay, kh=24, device=device)
    got_long = BatchedSearcher(words, device=device).find_all(dh)
    if exp_long is None:
        exp_long = np.asarray([hay.find(w) for w in words])
    long_mm = int((got_long != np.asarray(exp_long)).sum())

    ws = sorted(words, key=len)
    got_short = np.asarray(PairwiseSearcher(ws, device=device).first_matrix())
    lens = np.asarray([len(w) for w in ws])
    if exp_short is None:
        exp_short = pair_oracle(ws)
    short_mm = int((got_short != exp_short).sum())
    return {
        "platform": str(dh.device.type),
        "full": bool(full),
        "long_words": len(words),
        "long_mismatches": long_mm,
        "short_words": len(ws),
        "short_pairs": int((lens[None, :] >= lens[:, None]).sum()),
        "short_total_checked": int(np.asarray(exp_short).size),
        "short_mismatches": short_mm,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the result to this path")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    result = run_conformance(full=device.type == "cuda", device=device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if result["long_mismatches"] or result["short_mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
