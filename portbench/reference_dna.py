"""The plain reference of the ``seeded_dna`` kind: exact overlapping counts
of needles over a text of the four letters ``ACGT``, by 2-bit k-mer keys,
in plain PyTorch.  It imports nothing of the program and nothing of JAX.

Each byte maps to a 2-bit code, and any byte outside ``ACGT`` is refused.
The key of the k-mer at position ``p`` (k <= 32) packs the codes of bytes
``p .. p + k - 1``, the first in the highest bits; every position's key is
built at once by doubling (the keys of 1, 2, 4, ... letters, each shifted
and OR-ed with the one ``span`` positions on), and the powers of two that
make up k are joined left to right.  The needles share one length k, and
a needle's key is packed apart, one letter at a time.  Over four letters equal keys are equal k-mers, so a
needle's count is the number of positions whose key is its own: each
position's key is looked up among the needles' distinct keys (``unique``,
``searchsorted``) and the hits are summed per key (``bincount``), as
int64.  The text is taken in blocks of :data:`BLOCK` positions, so that
only one block's keys are held at a time.

It runs on the card when one is present (the harness calls it once the
program's state is freed), else on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: The letters, in the order of their codes.
LETTERS = b"ACGT"
#: The longest needle whose key fits 64 bits.
MAX_K = 32
#: Positions whose keys are held at once.
BLOCK = 1 << 24


def codes(data: bytes, device) -> torch.Tensor:
    """uint8 codes 0-3 of ``data``'s bytes; raises on a byte outside ``ACGT``."""
    if not data:
        return torch.zeros((0,), dtype=torch.uint8, device=device)
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    out = torch.zeros_like(raw)
    valid = torch.zeros_like(raw, dtype=torch.bool)
    for code, letter in enumerate(LETTERS):
        hit = raw == letter
        out += hit.to(torch.uint8) * code
        valid |= hit
    if not bool(valid.all()):
        bad = int(raw[~valid][0])
        raise ValueError(f"byte {bad!r} is outside {LETTERS.decode()}")
    return out


def kmer_keys(c: torch.Tensor, k: int) -> torch.Tensor:
    """int64 keys of the ``len(c) - k + 1`` k-mers of the codes ``c``."""
    n = c.numel() - k + 1
    keys, span = c.to(torch.int64), 1  # the keys of `span` letters at each start
    out, width = None, 0  # the keys of the first `width` letters of each k-mer
    while True:
        if k & span:
            part = keys[width : width + n]
            out = part if out is None else (out << (2 * span)) | part
            width += span
        if 2 * span > k:
            return out
        keys = (keys[:-span] << (2 * span)) | keys[span:]
        span *= 2


def needle_keys(needles: Sequence[bytes], device) -> torch.Tensor:
    """int64 keys of equal-length needles, packed one letter at a time."""
    c = codes(b"".join(needles), device).view(len(needles), -1).to(torch.int64)
    key = torch.zeros((len(needles),), dtype=torch.int64, device=device)
    for j in range(c.shape[1]):
        key = (key << 2) | c[:, j]
    return key


def count_all(hay: bytes, needles: Sequence[bytes], device: Optional[torch.device] = None) -> np.ndarray:
    """Each needle's overlapping occurrences in ``hay`` (int64[N]); the
    needles all have one length, 1 to :data:`MAX_K` bytes."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if not needles:
        return np.zeros((0,), np.int64)
    k = len(needles[0])
    if not 1 <= k <= MAX_K:
        raise ValueError(f"needle of {k} bytes: keys hold 1 to {MAX_K}")
    if any(len(nd) != k for nd in needles):
        raise ValueError(f"needles of unequal length: keys of one length k = {k} are compared")
    uniq, inv = torch.unique(needle_keys(needles, dev), return_inverse=True)
    counts = torch.zeros_like(uniq)
    c = codes(hay, dev)
    n = len(hay) - k + 1
    for start in range(0, max(n, 0), BLOCK):
        block = kmer_keys(c[start : min(n, start + BLOCK) + k - 1], k)
        at = torch.searchsorted(uniq, block).clamp_(max=uniq.numel() - 1)
        counts += torch.bincount(at[uniq[at] == block], minlength=uniq.numel())
    return counts[inv].cpu().numpy()
