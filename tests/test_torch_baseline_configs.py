"""BASELINE.json configs 1-3 on the reference's own data files in the port:
the mirror of tests/test_baseline_configs.py.  Each case runs the port on
the CPU (the kernels' plain versions) and the JAX package on the same
inputs, and holds both to ``bytes.find`` / ``naive_find``.  Exact."""

import numpy as np

import sliceslice_tpu as jst
from sliceslice_tpu.models.pallas_searcher import searcher_for_size as jax_searcher_for_size
from sliceslice_tpu.ops.pairwise import PairwiseSearcher as JaxPairwiseSearcher
from sliceslice_tpu_torch import (
    BatchedSearcher,
    DynamicSearcher,
    PairwiseSearcher,
    naive_find,
    preprocess,
    searcher_for_size,
)

CPU = "cpu"


def test_config1_ipsum_over_words(words):
    """b"ipsum" in every dictionary word: one by one through the dispatch
    ladder, and the whole sweep through the pairwise kernel."""
    nd = b"ipsum"
    s = DynamicSearcher(nd, device=CPU)
    exp = [w.find(nd) >= 0 for w in words]
    assert [s.search_in(w) for w in words[:300]] == exp[:300]
    assert [jst.DynamicSearcher(nd).search_in(w) for w in words[:300]] == exp[:300]
    got = PairwiseSearcher([nd], device=CPU).contains_matrix(words)[0]
    assert (got == np.array(exp)).all()
    assert (JaxPairwiseSearcher([nd]).contains_matrix(words)[0] == got).all()


def test_config3_reference_random_matrix():
    """The random needle/haystack size matrix on its data files: match and
    offset per cell, then batched over the largest haystack."""
    needle_data = open("data/needle", "rb").read()
    hay_data = open("data/haystack", "rb").read()
    for ks in (1, 5, 10, 20, 50, 100, 1000):
        nd = needle_data[:ks]
        s, js = DynamicSearcher(nd, device=CPU), jst.DynamicSearcher(nd)
        for hs in (1, 5, 10, 20, 50, 100, 1000):
            if hs < ks:
                continue
            hay = hay_data[:hs]
            exp = naive_find(hay, nd)
            assert s.find(hay) == exp == js.find(hay), (ks, hs)
            assert s.find(preprocess(hay, force_cols=True, device=CPU)) == exp, (ks, hs)
    needles = [needle_data[:k] for k in (1, 5, 10, 20, 50, 100, 1000)]
    got = BatchedSearcher(needles, device=CPU).find_all(hay_data)
    assert (got == jst.BatchedSearcher(needles).find_all(hay_data)).all()
    for nd, o in zip(needles, got):
        exp = naive_find(hay_data, nd)
        assert (None if o < 0 else int(o)) == exp, len(nd)


def test_config2_specialized_rungs_on_i386(i386_small):
    """Every specialized size 2..16 against the manual's first 48 KiB, on
    the searcher class the ladder picks, the JAX package's alike."""
    dh = preprocess(i386_small, device=CPU)
    for k in range(2, 17):
        nd = i386_small[1000:1000 + k]
        exp = naive_find(i386_small, nd)
        assert searcher_for_size(k).__name__.replace("Cuda", "") == \
            jax_searcher_for_size(k).__name__.replace("Pallas", ""), k
        assert searcher_for_size(k)(nd, device=CPU).find(dh) == exp, k
        assert jax_searcher_for_size(k)(nd).find(i386_small) == exp, k
