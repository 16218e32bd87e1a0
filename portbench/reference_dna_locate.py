"""The plain reference of the ``seeded_dna_locate`` kind: every overlapping
offset of needles over a text of the four letters ``ACGT``, by 2-bit
k-mer keys, in plain PyTorch.  It imports nothing of the program and
nothing of JAX.

The keys are :mod:`portbench.reference_dna`'s (``codes``, ``kmer_keys``,
``needle_keys``): over four letters equal keys are equal k-mers.  The
text is taken in blocks of ``reference_dna.BLOCK`` positions; each
position's key is looked up among the needles' distinct keys
(``unique``, ``searchsorted``), and the hits' offsets and key indices are
kept.  The hits of all blocks are then stable-sorted by key index, so
that each key's offsets stay ascending, split into one int64 array per
key, and handed to the needles through ``unique``'s inverse: a needle
given twice gets its key's offsets twice.

It runs on the card when one is present (the harness calls it once the
program's state is freed), else on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from portbench.reference_dna import BLOCK, MAX_K, codes, kmer_keys, needle_keys


def positions_all(hay: bytes, needles: Sequence[bytes],
                  device: Optional[torch.device] = None) -> List[np.ndarray]:
    """Each needle's overlapping offsets in ``hay``, ascending int64, in the
    needles' order; the needles all have one length, 1 to ``MAX_K`` bytes."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if not needles:
        return []
    k = len(needles[0])
    if not 1 <= k <= MAX_K:
        raise ValueError(f"needle of {k} bytes: keys hold 1 to {MAX_K}")
    if any(len(nd) != k for nd in needles):
        raise ValueError(f"needles of unequal length: keys of one length k = {k} are compared")
    uniq, inv = torch.unique(needle_keys(needles, dev), return_inverse=True)
    c = codes(hay, dev)
    n = len(hay) - k + 1
    offsets = [torch.zeros((0,), dtype=torch.int64, device=dev)]
    keys = [torch.zeros((0,), dtype=torch.int64, device=dev)]
    for start in range(0, max(n, 0), BLOCK):
        block = kmer_keys(c[start : min(n, start + BLOCK) + k - 1], k)
        at = torch.searchsorted(uniq, block).clamp_(max=uniq.numel() - 1)
        hit = torch.nonzero(uniq[at] == block).flatten()
        offsets.append(hit + start)
        keys.append(at[hit])
    key = torch.cat(keys)
    order = torch.sort(key, stable=True).indices
    per_key = torch.cat(offsets)[order].cpu().split(
        torch.bincount(key, minlength=uniq.numel()).tolist())
    return [per_key[i].numpy() for i in inv.tolist()]
