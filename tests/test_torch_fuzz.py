"""Property-based fuzzing of the port's search paths: the mirror of
tests/test_fuzz.py's dynamic, batched and pairwise cases (its streaming
case is mirrored in test_torch_streaming.py).  Each example runs the port
on the CPU (the kernels' plain versions) and the JAX package on the same
input, and holds both to ``naive_find`` / ``bytes.find``.  Exact."""

from hypothesis import given, settings, strategies as st_

import sliceslice_tpu as jst
from sliceslice_tpu.ops.layout import preprocess as jpreprocess
from sliceslice_tpu.ops.pairwise import PairwiseSearcher as JaxPairwiseSearcher
from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, PairwiseSearcher, naive_find, preprocess

CPU = "cpu"


def _bytes(alphabet: bytes, max_size: int):
    # A small alphabet makes collisions and near matches likely.
    return st_.builds(bytes, st_.lists(st_.sampled_from(list(alphabet)), min_size=0, max_size=max_size))


bytes_small = _bytes(b"abc\x00\xff", 200)
needle_small = _bytes(b"abc\x00\xff", 40)


@settings(max_examples=60, deadline=None)
@given(hay=bytes_small, nd=needle_small)
def test_fuzz_dynamic(hay, nd):
    exp = naive_find(hay, nd)
    assert DynamicSearcher(nd, device=CPU).find(hay) == exp == jst.DynamicSearcher(nd).find(hay)


@settings(max_examples=20, deadline=None)
@given(hay=_bytes(b"ab", 3000), needles=st_.lists(_bytes(b"ab", 24), min_size=1, max_size=8))
def test_fuzz_batched_cols(hay, needles):
    dh = preprocess(hay, kh=24, force_cols=True, device=CPU) if hay else b""
    got = BatchedSearcher(needles, device=CPU).find_all(dh)
    ref = jst.BatchedSearcher(needles).find_all(jpreprocess(hay, kh=24, force_cols=True) if hay else b"")
    assert list(got) == list(ref)
    for nd, o in zip(needles, got):
        assert (None if o < 0 else int(o)) == naive_find(hay, nd), (nd, hay)


@settings(max_examples=15, deadline=None)
@given(words=st_.lists(_bytes(b"ab", 10), min_size=1, max_size=12))
def test_fuzz_pairwise(words):
    ps = PairwiseSearcher(words, block=8, device=CPU)
    got_c, got_f = ps.contains_matrix(), ps.first_matrix()
    assert (got_f == JaxPairwiseSearcher(words, block=8).first_matrix()).all()
    for i, n in enumerate(words):
        for j, h in enumerate(words):
            exp = h.find(n)
            assert got_c[i, j] == (exp >= 0), (n, h)
            assert got_f[i, j] == exp, (n, h)
