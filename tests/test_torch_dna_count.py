"""The port's overlapping counts on the ``dna200m-count`` cell's inputs, cut
to the kind's tiny size, held on the CPU to both references the benchmark
has: CPython's ``bytes.find`` (``portbench/reference.py``) and the exact
2-bit k-mer counts of ``portbench/reference_dna.py``, which decides the
cell's ``correct`` on the card.  Also the kind's inputs themselves: the
seed alone decides them, needles are cut from the corpus, repeat families
survive as counted copies, and the pasted share stays under its limit.
Every comparison is exact (integer counts, tolerance 0)."""

import ast
import json

import numpy as np
import pytest
import torch

from portbench import reference, reference_dna, spec
from sliceslice_tpu_torch import BatchedSearcher, preprocess

CONFIG = json.loads((spec.HERE / "configs" / "dna200m-20mers.json").read_text())
KIND = spec.load_kind(CONFIG["kind"])
TINY = KIND.tiny(CONFIG)
SEEDS = [5, 2**31 + 11, 2**32 + 2**20 + 3]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_counts(corpus: bytes, needles) -> np.ndarray:
    dh = preprocess(corpus, device="cpu")
    return BatchedSearcher(needles, device="cpu").count_all(dh)


def _all_agree(corpus: bytes, needles) -> np.ndarray:
    """The three counts of ``needles``, asserted equal; returns them."""
    want = reference.count_all(corpus, needles)
    assert reference_dna.count_all(corpus, needles, device="cpu").tolist() == want.tolist()
    assert _port_counts(corpus, needles).tolist() == want.tolist()
    return want


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_both_references_on_the_tiny_cell(seed):
    inp = KIND.inputs(TINY, seed)
    assert len(inp.corpus) == 65536 and len(inp.needles) == 32
    assert {len(n) for n in inp.needles} == {20} and set(inp.corpus) <= set(b"ACGT")
    want = _all_agree(inp.corpus, inp.needles)
    assert want.min() >= 1  # every needle is cut from the corpus
    assert KIND.answers("count", inp).tolist() == want.tolist()


def test_periodic_needles_count_every_overlap():
    """Runs of ``AC`` and of ``A`` pasted into a seeded corpus: their
    needles' overlapping counts are far above ``bytes.count``'s."""
    corpus = bytearray(KIND.inputs(TINY, SEEDS[0]).corpus)
    corpus[1000:1100] = b"AC" * 50
    corpus[5000:5080] = b"A" * 80
    corpus = bytes(corpus)
    for needles, least in [([b"AC" * 10, b"CA" * 10, b"A" * 20], [41, 40, 61]),
                           ([b"A" * 32, b"AC" * 16], [49, 35])]:
        got = _all_agree(corpus, needles)
        assert all(c >= lo for c, lo in zip(got, least))
        assert all(c > corpus.count(n) for c, n in zip(got, needles))


def test_needles_at_the_corpus_ends():
    corpus = KIND.inputs(TINY, SEEDS[1]).corpus
    for needles in ([corpus[:20], corpus[-20:]], [corpus[:1], corpus[-1:]],
                    [corpus[:32], corpus[-32:]], [corpus[7:38]]):
        assert _all_agree(corpus, needles).min() >= 1


def test_a_repeat_family_counts_at_least_its_surviving_copies():
    text = KIND.text(TINY, SEEDS[2])
    e = TINY["repeats"]["element_bytes"]
    corpus = text.corpus.tobytes()
    intact = [int(sum(corpus[o : o + e] == el.tobytes() for o in at))
              for el, at in zip(text.elements, text.offsets)]
    f = int(np.argmax(intact))
    assert intact[f] >= 2
    needles = [text.elements[f][s : s + 20].tobytes() for s in (0, 140, e - 20)]
    assert all(c >= intact[f] for c in _all_agree(corpus, needles))


def test_the_reference_refuses_what_it_cannot_key():
    with pytest.raises(ValueError, match="outside ACGT"):
        reference_dna.count_all(b"ACGTNACGT", [b"ACG"], device="cpu")
    with pytest.raises(ValueError, match="outside ACGT"):
        reference_dna.count_all(b"ACGTACGT", [b"ACgT"], device="cpu")
    with pytest.raises(ValueError, match="1 to 32"):
        reference_dna.count_all(b"ACGT" * 20, [b"A" * 33], device="cpu")
    with pytest.raises(ValueError, match="unequal length"):
        reference_dna.count_all(b"ACGT" * 20, [b"ACG", b"AC"], device="cpu")
    with pytest.raises(ValueError, match="count only"):
        KIND.answers("find", KIND.inputs(TINY, 1))


def test_the_reference_keys_every_length_up_to_32():
    """One equal-length set per length k: needles cut at two offsets, and
    a periodic one that the seeded text may not hold."""
    corpus = KIND.inputs(TINY, 9).corpus
    for k, o in zip(range(1, 33), range(0, 64000, 2000)):
        needles = [corpus[o : o + k], corpus[o + 997 : o + 997 + k], (b"ACGT" * 8)[:k]]
        assert _all_agree(corpus, needles)[:2].min() >= 1
    assert reference_dna.count_all(b"", [b"A"], device="cpu").tolist() == [0]
    assert reference_dna.count_all(corpus, [], device="cpu").tolist() == []


def test_the_seed_alone_decides_the_inputs():
    a, b, c = (KIND.inputs(TINY, s) for s in (2**33 + 1, 2**33 + 1, 6))
    assert a == b
    assert a.corpus != c.corpus and a.needles != c.needles


def test_the_pasted_share_stays_under_its_limit():
    limit = CONFIG["repeats"]["max_pasted_share"]
    assert limit == 0.12
    for seed in SEEDS:
        text = KIND.text(TINY, seed)
        assert 0 < text.pasted <= limit * TINY["corpus"]["bytes"]
        assert text.pasted == sum(at.size for at in text.offsets) * TINY["repeats"]["element_bytes"]
    tight = dict(TINY, repeats=dict(TINY["repeats"], max_pasted_share=0.001))
    with pytest.raises(ValueError, match="exceed"):
        KIND.text(tight, SEEDS[0])


def test_the_reference_imports_neither_the_program_nor_jax():
    mods = set()
    for node in ast.walk(ast.parse((spec.HERE / "reference_dna.py").read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert mods <= {"__future__", "typing", "numpy", "torch"}
