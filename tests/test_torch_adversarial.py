"""Adversarial inputs in the port: the mirror of tests/test_adversarial.py.

The classic pathological families (periodic haystacks that make every
position a candidate, near misses, a match only at the end, runs shorter
than the needle) through the port's ``DynamicSearcher`` (a short layout and
the host rung, at every ``position``) and ``BatchedSearcher`` over the
layout, on the CPU (the kernels' plain versions), each held to the
JAX package's answer on the same input and to ``naive_find``.  Exact."""

import numpy as np
import pytest

import sliceslice_tpu as jst
from sliceslice_tpu.ops.layout import preprocess as jpreprocess
from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, naive_find, preprocess

CPU = "cpu"

CASES = [
    (b"a" * 3000, b"a" * 24),                     # period 1, matches everywhere
    (b"a" * 3000, b"a" * 23 + b"b"),              # every position a candidate, none matches
    (b"ab" * 1500, b"ab" * 10 + b"c"),            # period-2 near miss
    (b"aab" * 1000, b"aab" * 7 + b"a"),           # period 3 with self-overlap
    (b"a" * 2999 + b"b", b"a" * 20 + b"b"),       # a match only at the very end
    ((b"a" * 63 + b"b") * 40, b"a" * 40),         # runs shorter than the needle
]
IDS = ["period1", "all-candidates", "period2-near-miss", "period3-overlap", "only-at-end", "short-runs"]


def as_offset(x) -> int:
    return -1 if x is None else int(x)


@pytest.mark.parametrize("hay,nd", CASES, ids=IDS)
def test_pathological_exactness_flat(hay, nd):
    exp = naive_find(hay, nd)
    for p in (0, len(nd) // 2, len(nd) - 1):
        got = DynamicSearcher.with_position(nd, p, device=CPU).find(hay)
        assert got == exp == jst.DynamicSearcher.with_position(nd, p).find(hay), (nd[:8], p)
        dh = preprocess(hay, device=CPU)  # a short layout on the device, not the host rung
        assert DynamicSearcher.with_position(nd, p, device=CPU).find(dh) == exp


@pytest.mark.parametrize("hay,nd", CASES, ids=IDS)
def test_pathological_exactness_cols(hay, nd):
    got = BatchedSearcher([nd, nd[::-1]], device=CPU).find_all(preprocess(hay, kh=32, force_cols=True, device=CPU))
    ref = jst.BatchedSearcher([nd, nd[::-1]]).find_all(jpreprocess(hay, kh=32, force_cols=True))
    assert list(got) == list(ref) == [as_offset(naive_find(hay, nd)), as_offset(naive_find(hay, nd[::-1]))]


def test_all_positions_match_dense_overlap():
    """Every position matches: first offset 0 for every needle, and every
    position counted and listed."""
    hay = b"z" * 4000
    needles = [b"z" * k for k in (1, 4, 7, 16, 31)]
    dh = preprocess(hay, kh=32, force_cols=True, device=CPU)
    bs = BatchedSearcher(needles, device=CPU)
    got = bs.find_all(dh)
    assert (got == 0).all()
    assert (jst.BatchedSearcher(needles).find_all(jpreprocess(hay, kh=32, force_cols=True)) == got).all()
    assert list(bs.count_all(dh)) == [4000 - len(n) + 1 for n in needles]
    for n, p in zip(needles, bs.positions_all(dh)):
        assert np.array_equal(p, np.arange(4000 - len(n) + 1))
