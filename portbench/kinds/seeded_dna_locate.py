"""``seeded_dna_locate``: the ``seeded_dna`` text made from the seed, held on
the card and located with one batch of patterns cut from it.

Inputs, system and tiny cut are ``seeded_dna``'s (``kinds/seeded_dna.py``:
the seeded ACGT text with its planted repeat families, needles cut from
it at offsets drawn from the seed; ``held_corpus``'s ``preprocess`` and
one ``BatchedSearcher``), but for the tiny cut, which keeps the
configuration's patterns.  Answers: every overlapping offset of each
pattern by :mod:`portbench.reference_dna_locate`, or its count by
:mod:`portbench.reference_dna`.  Compared exactly by
``reference.wrong_answers``, which a positions answer passes only as an
int64 array too: the configuration guarantees int64 offsets, so an
answer of equal values in another dtype is wrong.
"""

from __future__ import annotations

import numpy as np

from portbench import reference, reference_dna, reference_dna_locate
from portbench.inputs import Inputs
from portbench.spec import load_kind

_DNA = load_kind("seeded_dna")

inputs = _DNA.inputs
build = _DNA.build


def answers(op: str, inputs: Inputs):
    if op == "positions":
        return reference_dna_locate.positions_all(inputs.corpus, inputs.needles)
    if op == "count":
        return reference_dna.count_all(inputs.corpus, inputs.needles)
    raise ValueError(f"seeded_dna_locate answers positions and count only, not {op}")


def wrong_answers(op: str, got, want) -> int:
    """``reference.wrong_answers``, with each positions answer that is not
    an int64 array counted wrong besides."""
    if op != "positions" or len(got) != len(want):
        return reference.wrong_answers(op, got, want)
    return sum(not (isinstance(g, np.ndarray) and g.dtype == np.int64 and np.array_equal(g, w))
               for g, w in zip(got, want))


def tiny(config: dict) -> dict:
    """``seeded_dna``'s 64 KiB and 4 families of at most 4 copies, with the
    configuration's own patterns."""
    return dict(_DNA.tiny(config), needles=dict(config["needles"]))
