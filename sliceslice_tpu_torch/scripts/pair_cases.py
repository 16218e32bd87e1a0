"""The pair-block kernel's hard cases, as seeded word lists.

One list of cases serves the CPU tests (the plain version against the JAX
package and ``bytes.find``), the card tests and the smoke run (the kernel
against the plain version and ``bytes.find``): :func:`cases` names them and
:func:`operands` turns one into :func:`..ops.pairwise.pair_block`'s
arguments on a device, beside the answers ``bytes.find`` gives.

* ``tiles``: more needles than one tile holds and more words than one tile
  and one plan block hold, so the tile queue walks both directions;
* ``exact``: unsorted words whose lengths are exactly the plan's scan
  buckets and whole multiples of 4, needles equal to their words, 1-byte
  needles, the empty needle and the empty word, in small blocks with
  different buckets;
* ``long_rows``: words and needles past 64 bytes, so a word's row and a
  needle's table hold more than the 16 32-bit words whose loads the kernel
  unrolls (the tail loops of both byte signatures), and a pair's positions
  span several 16-position groups of the probe;
* ``mixed``: a length-sorted list against itself in blocks of 16, short
  blocks and such long ones in one plan (every probe width and scan bucket
  from 2 bytes to 96);
* ``unsorted``: a shuffled list against a shuffled list;
* ``skipped``: sorted lists whose plan skips blocks (every needle of the
  block longer than every word of it);
* ``padded``: padded needle rows (length ``2**30``) and padded words
  (length -1), which never match.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pairwise import PairwiseSearcher

#: The plan's scan-length buckets a word's length can sit exactly on.
BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32)


class PairCase(NamedTuple):
    name: str
    needles: list
    haystacks: Optional[list]  # None: the needles against themselves
    block: int
    pad: tuple = (0, 0)  # padded needle rows, padded words


def random_words(rng, count: int, max_len: int, min_len: int = 0) -> list:
    """Seeded words over a 3-letter alphabet, so short ones occur in long ones."""
    return [bytes(rng.integers(97, 100, int(rng.integers(min_len, max_len + 1)), dtype=np.uint8))
            for _ in range(count)]


def cases(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    exact = [w for k in BUCKETS for w in random_words(rng, 3, k, k)]
    exact_needles = (exact[::2] + [w[1:] for w in exact[1::3]] + [w[:-1] for w in exact[::4]]
                     + [b"a", b"b", b"c", b"", b"ab"])
    order = rng.permutation(len(exact_needles))
    long_words = random_words(rng, 60, 80, 30)
    sorted_mixed = sorted(random_words(rng, 90, 40) + long_words[:20], key=len)
    return [
        PairCase("tiles", sorted(random_words(rng, 150, 12), key=len),
                 sorted(random_words(rng, 600, 16), key=len), 512),
        PairCase("exact", [exact_needles[i] for i in order], exact + [b""], 16),
        PairCase("long_rows", random_words(rng, 40, 70) + long_words[:5], long_words, 32),
        PairCase("mixed", sorted_mixed, None, 16),
        PairCase("unsorted", random_words(rng, 200, 10), random_words(rng, 300, 14), 64),
        PairCase("skipped", sorted(random_words(rng, 100, 20), key=len),
                 sorted(random_words(rng, 120, 10), key=len), 32),
        PairCase("padded", random_words(rng, 20, 6) + [b""], random_words(rng, 30, 9) + [b""], 8,
                 (3, 5)),
    ]


def operands(case: PairCase, device):
    """``(args, expected)``: ``pair_block``'s arguments ``(values, masks, ln,
    hay, lh, plan, block)`` for one case on ``device``, and the int32 (N, H)
    answers of ``bytes.find`` (-1 in padded rows and columns)."""
    ps = PairwiseSearcher(case.needles, block=case.block, device=device)
    hay, lh, _, _ = ps._pack_hay(case.haystacks)
    values, masks, ln = ps._values, ps._masks, ps._ln
    plan = ps._plan(case.haystacks)
    hs = case.needles if case.haystacks is None else case.haystacks
    exp = np.array([[h.find(n) for h in hs] for n in case.needles], np.int32).reshape(
        len(case.needles), len(hs))
    pad_n, pad_h = case.pad
    if pad_n:
        values = torch.nn.functional.pad(values, (0, 0, 0, pad_n))
        masks = torch.nn.functional.pad(masks, (0, 0, 0, pad_n))
        ln = torch.nn.functional.pad(ln, (0, pad_n), value=1 << 30)
    if pad_h:
        hay = torch.nn.functional.pad(hay, (0, 0, 0, pad_h))
        lh = torch.nn.functional.pad(lh, (0, pad_h), value=-1)
    exp = np.pad(exp, ((0, pad_n), (0, pad_h)), constant_values=-1)
    return (values, masks, ln, hay, lh, plan, case.block), exp
