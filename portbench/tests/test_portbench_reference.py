"""The plain reference against the port's CPU path, on inputs where every
answer kind is exercised: periodic and overlapping needles, absent ones,
needles at the corpus's end, and the i386 corpus."""

import numpy as np
import pytest

from portbench import control, reference, spec


@pytest.fixture(scope="module")
def case():
    r = np.random.default_rng(17)
    hay = bytearray(r.integers(97, 101, 50_000, dtype=np.uint8).tobytes())  # 4 letters: many matches
    hay[-7:] = b"zzzzzzz"
    hay = bytes(hay)
    needles = [hay[o:o + k] for o, k in [(10, 1), (99, 2), (500, 3), (7000, 4), (123, 9), (4000, 17),
                                         (30000, 33), (49_990, 10)]]
    needles += [b"aaaa", b"zz", b"zzzzzzzz", b"\x00absent", b"abcd" * 10]
    return hay, needles


def test_reference_matches_the_port_on_the_cpu(case):
    from sliceslice_tpu_torch import BatchedSearcher, preprocess

    hay, needles = case
    dh = preprocess(hay, device="cpu")
    bs = BatchedSearcher(needles, device="cpu").optimize_for(dh)
    assert reference.wrong_answers("find", bs.find_all(dh), reference.find_all(hay, needles)) == 0
    assert reference.wrong_answers("count", bs.count_all(dh), reference.count_all(hay, needles)) == 0
    want = reference.positions_all(hay, needles)
    assert reference.wrong_answers("positions", bs.positions_all(dh), want) == 0
    assert sum(p.size for p in want) > 10_000


def test_reference_matches_the_port_on_i386():
    from sliceslice_tpu_torch import BatchedSearcher, preprocess

    cfg = {"name": "i386", "corpus": {"file": "portbench/data/i386.txt", "bytes": 200_000,
           "sha256": "563e894dab529ab3f43f5986c893a084a62da3535cf2e4860c243d0e0ef1a2b4"},
           "needles": {"file": "portbench/data/words.txt", "separator": "\n", "count": 300,
                       "sha256": "24879057d36d6ab8947ac1be6507883d7663d62264987e07764c4731b5177957"}}
    inp = spec.load_kind("held_corpus").inputs(cfg, 3)
    dh = preprocess(inp.corpus, device="cpu")
    bs = BatchedSearcher(inp.needles, device="cpu")
    for op, fn in (("find", bs.find_all), ("count", bs.count_all), ("positions", bs.positions_all)):
        assert reference.wrong_answers(op, fn(dh), reference.answers(op, inp.corpus, inp.needles)) == 0


def test_wrong_answers_counts_each_differing_needle():
    want = np.array([3, -1, 7])
    assert reference.wrong_answers("find", np.array([3, -1, 7]), want) == 0
    assert reference.wrong_answers("find", np.array([3, 0, 8]), want) == 2
    assert reference.wrong_answers("find", np.array([3, -1]), want) == 3
    pw = [np.array([1, 2]), np.array([], np.int64)]
    assert reference.wrong_answers("positions", [np.array([1, 2]), np.array([5])], pw) == 1
    assert reference.wrong_answers("positions", pw[:1], pw) == 2


def test_reference_edge_cases():
    assert reference.positions(b"aaaa", b"aa").tolist() == [0, 1, 2]
    assert reference.positions(b"ab", b"").tolist() == [0, 1, 2]
    assert reference.find_all(b"abcab", [b"ab", b"x", b"cab"]).tolist() == [0, -1, 2]
    assert reference.count_all(b"aaaa", [b"aa", b"aaaaa"]).tolist() == [3, 0]


def test_control_filter_keeps_every_true_match():
    hay = np.frombuffer(b"abcab acb axb", np.uint8)
    assert control.filter_positions(hay, b"acb").tolist() == [6, 10]  # 10: "axb", unverified
    assert control.filter_positions(hay, b"b").tolist() == [1, 4, 8, 12]
    assert control.filter_positions(hay, b"x" * 20).tolist() == []
