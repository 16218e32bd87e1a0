"""The port's every-offset answers on the ``dna200m-locate`` cell's inputs,
cut to the kind's tiny size, held on the CPU to both references the
benchmark has: CPython's ``bytes.find`` (``portbench/reference.py``) and
the 2-bit k-mer offsets of ``portbench/reference_dna_locate.py``, which
decides the cell's ``correct`` on the card.  Runs of one letter, patterns
at the text's ends, a pattern given twice and every key length from 1 to
32 besides.  Every comparison is exact (int64 offsets, tolerance 0)."""

import ast
import json

import numpy as np
import pytest
import torch

from portbench import reference, reference_dna_locate, spec
from sliceslice_tpu_torch import BatchedSearcher, preprocess

CONFIG = json.loads((spec.HERE / "configs" / "dna200m-5mers.json").read_text())
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


def _port_positions(corpus: bytes, needles):
    dh = preprocess(corpus, device="cpu")
    return BatchedSearcher(needles, device="cpu").positions_all(dh)


def _all_agree(corpus: bytes, needles):
    """The three answers of ``needles``, asserted equal array by array
    (int64, ascending); returns ``bytes.find``'s."""
    want = reference.positions_all(corpus, needles)
    for got in (reference_dna_locate.positions_all(corpus, needles, device="cpu"),
                _port_positions(corpus, needles)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and g.tolist() == w.tolist()
    return want


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_both_references_on_the_tiny_cell(seed):
    inp = KIND.inputs(TINY, seed)
    assert len(inp.corpus) == 65536 and len(inp.needles) == 12
    assert {len(n) for n in inp.needles} == {5} and set(inp.corpus) <= set(b"ACGT")
    want = _all_agree(inp.corpus, inp.needles)
    assert min(w.size for w in want) >= 1  # every pattern is cut from the text
    assert sum(w.size for w in want) > 12 * 30  # about 64 a pattern in 64 KiB
    got = KIND.answers("positions", inp)
    assert reference.wrong_answers("positions", got, want) == 0
    assert KIND.answers("count", inp).tolist() == [w.size for w in want]


def test_the_kind_counts_answers_of_another_dtype_wrong():
    """The configuration guarantees int64 offsets: equal values in int32 (or
    a list) are wrong answers, one a pattern; a count is compared as before."""
    inp = KIND.inputs(TINY, SEEDS[2])
    want = KIND.answers("positions", inp)
    assert KIND.wrong_answers("positions", want, want) == 0
    assert KIND.wrong_answers("positions", [w.astype(np.int32) for w in want], want) == 12
    assert KIND.wrong_answers("positions", [w.tolist() for w in want], want) == 12
    assert KIND.wrong_answers("positions", want[:1] + [w.astype(np.int32) for w in want[1:]], want) == 11
    assert KIND.wrong_answers("positions", want[:11], want) == 12
    assert KIND.wrong_answers("positions", _port_positions(inp.corpus, inp.needles), want) == 0
    counts = KIND.answers("count", inp)
    assert KIND.wrong_answers("count", counts.astype(np.int32), counts) == 0
    assert KIND.wrong_answers("count", counts + np.eye(1, 12, 3, dtype=np.int64)[0], counts) == 1


def test_runs_of_one_letter_give_every_overlap():
    corpus = bytearray(KIND.inputs(TINY, SEEDS[0]).corpus)
    corpus[:64] = b"A" * 64
    corpus[1000:1100] = b"AC" * 50
    corpus[5000:5080] = b"G" * 80
    corpus = bytes(corpus)
    want = _all_agree(corpus, [b"AAAAA", b"ACACA", b"CACAC", b"GGGGG"])
    assert want[0][:60].tolist() == list(range(60))
    assert set(range(5000, 5076)) <= set(want[3].tolist())
    assert _all_agree(b"A" * 64, [b"AAAAA"])[0].tolist() == list(range(60))


def test_patterns_at_the_text_ends():
    corpus = KIND.inputs(TINY, SEEDS[1]).corpus
    want = _all_agree(corpus, [corpus[:5], corpus[-5:]])
    assert want[0][0] == 0 and want[1][-1] == len(corpus) - 5


def test_a_pattern_given_twice_gets_two_equal_arrays():
    inp = KIND.inputs(TINY, SEEDS[2])
    needles = inp.needles[:3] + [inp.needles[1]]
    got = reference_dna_locate.positions_all(inp.corpus, needles, device="cpu")
    assert np.array_equal(got[1], got[3]) and got[1].size >= 1
    port = _port_positions(inp.corpus, needles)
    assert np.array_equal(port[1], port[3]) and np.array_equal(port[3], got[3])


def test_the_reference_keys_every_length_up_to_32():
    """One equal-length set per length k: patterns cut at two offsets, and a
    periodic one that the seeded text may not hold."""
    corpus = KIND.inputs(TINY, 9).corpus
    for k, o in zip(range(1, 33), range(0, 64000, 2000)):
        needles = [corpus[o : o + k], corpus[o + 997 : o + 997 + k], (b"ACGT" * 8)[:k]]
        want = reference.positions_all(corpus, needles)
        got = reference_dna_locate.positions_all(corpus, needles, device="cpu")
        assert reference.wrong_answers("positions", got, want) == 0, k
        assert min(w.size for w in want[:2]) >= 1
    assert reference_dna_locate.positions_all(b"", [b"A"], device="cpu")[0].tolist() == []
    assert reference_dna_locate.positions_all(b"ACG", [b"ACGT"], device="cpu")[0].tolist() == []
    assert reference_dna_locate.positions_all(corpus, [], device="cpu") == []


def test_the_reference_refuses_what_it_cannot_key():
    with pytest.raises(ValueError, match="outside ACGT"):
        reference_dna_locate.positions_all(b"ACGTNACGT", [b"ACG"], device="cpu")
    with pytest.raises(ValueError, match="outside ACGT"):
        reference_dna_locate.positions_all(b"ACGTACGT", [b"ACgT"], device="cpu")
    with pytest.raises(ValueError, match="1 to 32"):
        reference_dna_locate.positions_all(b"ACGT" * 20, [b"A" * 33], device="cpu")
    with pytest.raises(ValueError, match="unequal length"):
        reference_dna_locate.positions_all(b"ACGT" * 20, [b"ACG", b"AC"], device="cpu")
    with pytest.raises(ValueError, match="positions and count only"):
        KIND.answers("find", KIND.inputs(TINY, 1))


def test_the_kind_shares_the_count_kinds_text():
    """The same seed gives the same text as ``dna200m-20mers``; the tiny cut
    keeps the configuration's 12 patterns of 5 bytes."""
    count_cfg = json.loads((spec.HERE / "configs" / "dna200m-20mers.json").read_text())
    count_kind = spec.load_kind(count_cfg["kind"])
    for key in ("corpus", "repeats"):
        assert {k: v for k, v in CONFIG[key].items() if k != "made"} == \
            {k: v for k, v in count_cfg[key].items() if k != "made"}
    seed = SEEDS[1]
    assert KIND.inputs(TINY, seed).corpus == count_kind.inputs(count_kind.tiny(count_cfg), seed).corpus
    assert TINY["needles"] == CONFIG["needles"] and CONFIG["needles"]["count"] == 12
    assert TINY["corpus"]["bytes"] == 65536 and CONFIG["corpus"]["bytes"] == 209715200


def test_the_reference_imports_neither_the_program_nor_jax():
    mods, froms = set(), set()
    for node in ast.walk(ast.parse((spec.HERE / "reference_dna_locate.py").read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0] if node.level == 0 else ".")
            if node.module and node.module.startswith("portbench"):
                froms.add(node.module)
    assert mods <= {"__future__", "typing", "numpy", "torch", "portbench"}
    assert froms == {"portbench.reference_dna"}
