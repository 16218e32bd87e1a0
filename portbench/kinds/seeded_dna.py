"""``seeded_dna``: a DNA text made from the seed, held on the card and
counted with one batch of guides cut from it.

Inputs, all from the seed (no data file): ``corpus.bytes`` bytes drawn
uniformly from ``ACGT`` (``rng(seed, 1)``); then ``repeats.families``
repeat families pasted in (``rng(seed, 4)``), each a random element of
``repeats.element_bytes`` letters with ``min(zipf(repeats.zipf_a),
repeats.max_copies)`` exact copies at uniform offsets, family after family,
so that later copies overwrite earlier ones; then ``needles.count``
needles of ``needles.bytes`` bytes cut from the finished corpus at offsets
drawn without replacement (``rng(seed, 3)``), in the order drawn.  Every
count is thus at least 1, and a needle cut from a family counts at least
that family's surviving copies.  The draws are refused when the copies
would write more than ``repeats.max_pasted_share`` of the corpus.

System: ``held_corpus``'s, as the configuration's ``layout`` says
(``preprocess``, one ``BatchedSearcher``; a counting caller does not
``optimize_for``).  Answers: :mod:`portbench.reference_dna`'s exact counts.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from portbench import reference_dna
from portbench.inputs import Inputs, rng
from portbench.spec import load_kind

LETTERS = np.frombuffer(reference_dna.LETTERS, np.uint8)


class Text(NamedTuple):
    corpus: np.ndarray
    #: uint8[families, element_bytes]: each family's element.
    elements: np.ndarray
    #: each family's copy offsets, in the order pasted.
    offsets: List[np.ndarray]
    #: bytes the copies wrote.
    pasted: int


def text(config: dict, seed: int) -> Text:
    n, rep = config["corpus"]["bytes"], config["repeats"]
    corpus = LETTERS[rng(seed, 1).integers(0, 4, n, dtype=np.uint8)]
    r, e = rng(seed, 4), rep["element_bytes"]
    elements = LETTERS[r.integers(0, 4, (rep["families"], e), dtype=np.uint8)]
    copies = np.minimum(r.zipf(rep["zipf_a"], rep["families"]), rep["max_copies"])
    pasted = int(copies.sum()) * e
    if pasted > rep["max_pasted_share"] * n:
        raise ValueError(f"{config['name']}: the repeats' {pasted} bytes exceed "
                         f"{rep['max_pasted_share']:.0%} of the corpus")
    offsets = [r.integers(0, n - e + 1, c) for c in copies]
    for element, at in zip(elements, offsets):
        # The copies of one family are alike, so their order among themselves is moot.
        corpus[(at[:, None] + np.arange(e)).ravel()] = np.tile(element, at.size)
    return Text(corpus, elements, offsets, pasted)


def inputs(config: dict, seed: int) -> Inputs:
    corpus = text(config, seed).corpus
    k, count = config["needles"]["bytes"], config["needles"]["count"]
    starts = rng(seed, 3).choice(corpus.size - k + 1, count, replace=False)
    return Inputs(corpus.tobytes(), [corpus[s : s + k].tobytes() for s in starts])


build = load_kind("held_corpus").HeldCorpus


def answers(op: str, inputs: Inputs):
    if op != "count":
        raise ValueError(f"seeded_dna answers count only, not {op}")
    return reference_dna.count_all(inputs.corpus, inputs.needles)


def tiny(config: dict) -> dict:
    """64 KiB, 4 families of at most 4 copies and 32 needles."""
    return dict(config, corpus=dict(config["corpus"], bytes=65536),
                repeats=dict(config["repeats"], families=4, max_copies=4),
                needles=dict(config["needles"], count=32))
