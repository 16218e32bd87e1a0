"""The slice as a whole: the port's ``BatchedSearcher`` against the JAX
package's and against ``bytes.find`` — a stratified i386 sample beside the
JAX searcher, all 4,585 words over the full i386 corpus, ``optimize_for``
on both its paths, and tables carried across from the JAX searcher through
``sliceslice_tpu_torch.interop``.  Comparisons are exact."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
from sliceslice_tpu_torch import BatchedSearcher, SENTINEL, interop, naive_find, preprocess

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    torch's default pool (one thread per core in each) thrashes on the
    many small ops of the plain versions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle_all(hay: bytes, needles):
    return np.array(
        [-1 if (o := naive_find(hay, n)) is None else o for n in needles], dtype=np.int64
    )


def test_i386_sample_matches_jax(words, i386_small, rng):
    """The tests/test_i386.py sample, through both packages."""
    by_len = {}
    for w in words:
        by_len.setdefault(len(w), []).append(w)
    sample = [
        by_len[k][int(rng.integers(0, len(by_len[k])))] for k in sorted(by_len) for _ in range(2)
    ]
    ref = jst.BatchedSearcher(sample).find_all(jst.preprocess(i386_small, kh=24, force_cols=True))
    got = BatchedSearcher(sample, device=CPU).find_all(preprocess(i386_small, kh=24, force_cols=True, device=CPU))
    assert got.dtype == np.int64
    assert np.array_equal(got, ref)
    assert np.array_equal(got, oracle_all(i386_small, sample))


def test_all_words_full_i386(words):
    """The port alone, all 4,585 words over the 857,425-byte corpus."""
    hay = open("data/i386.txt", "rb").read()
    dh = preprocess(hay, kh=24, device=CPU)
    bs = BatchedSearcher(words, device=CPU)
    assert {g.t: g.n for g in bs.groups} == {1: 1142, 2: 2206, 3: 1144, 4: 89, 5: 3, 6: 1}
    exp = np.array([hay.find(w) for w in words])
    assert np.array_equal(bs.find_all(dh), exp)
    dev = bs.find_all_device(dh)
    assert dev.dtype == torch.int32 and dev.shape == (len(words),)


def _rows_sorted_by_first(bs, firsts) -> bool:
    """Each width group's rows ascend by first offset, absent rows last."""
    key = np.where(firsts < 0, np.iinfo(np.int64).max, firsts)
    return all((np.diff(key[g.indices]) >= 0).all() for g in bs.groups)


def test_optimize_for_device_path_exact_and_lazy_sync(rng):
    """Cold optimize_for (one measuring sweep, its firsts read back once)
    reorders the rows on the host copies and uploads them, as
    optimize_for with firsts does; a second reschedule keeps the order;
    every answer stays exact."""
    hay = bytes(rng.integers(97, 103, (200_000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in
               [(5, 4), (77, 7), (9_000, 12), (150_000, 5), (44, 16), (199_990, 9)]]
    needles += [b"NOPE!", b"zz", b"", hay[199_999:]]
    dh = preprocess(hay, force_cols=True, device=CPU)
    bs = BatchedSearcher(needles, device=CPU)
    base = bs.find_all(dh)
    assert np.array_equal(base, oracle_all(hay, needles))
    bs.optimize_for(dh)
    assert bs._epoch == 1 and _rows_sorted_by_first(bs, base)
    assert np.array_equal(bs.find_all(dh), base)
    order = [g.indices.copy() for g in bs.groups]
    bs.optimize_for(dh)
    assert bs._epoch == 2 and all(np.array_equal(g.indices, o) for g, o in zip(bs.groups, order))
    assert np.array_equal(bs.find_all(dh), base)
    for g in bs.groups:
        assert np.array_equal(g.values_dev[: g.n].numpy(), g.values_host.view(np.int32))
    bs.optimize_for(dh, firsts=base)
    assert all(np.array_equal(g.indices, o) for g, o in zip(bs.groups, order))
    assert np.array_equal(bs.find_all(dh), base)
    assert np.array_equal(bs.find_all(dh.ensure_halo(128)), base)  # new ends length key


def test_optimize_for_host_and_flat_paths(rng):
    hay = bytes(rng.integers(97, 101, (3000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in [(2000, 5), (10, 4), (2990, 8), (7, 1)]] + [b"QQQQ"]
    bs = BatchedSearcher(needles, device=CPU)
    exp = oracle_all(hay, needles)
    assert np.array_equal(bs.find_all(hay), exp)
    bs.optimize_for(hay)  # a short haystack: laid out and measured like a long one
    assert _rows_sorted_by_first(bs, exp)
    assert np.array_equal(bs.find_all(hay), exp)
    assert np.array_equal(bs.find_all(preprocess(hay, force_cols=True, device=CPU)), exp)


def test_same_schedule_as_jax_and_interop_tables(rng):
    """The JAX optimize_for and the port's order rows alike; tables carried
    across from the JAX searcher (after its reschedule) give the same
    answers in the port."""
    hay = bytes(rng.integers(97, 101, (150_000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in
               [(120_000, 5), (10, 4), (149_990, 8), (50_000, 12), (7, 1), (90_000, 2), (3, 2)]]
    needles += [b"QQQQ", b"zzzzzz"]
    jdh = jst.preprocess(hay, kh=16)
    jbs = jst.BatchedSearcher(needles)
    ref = jbs.find_all(jdh)
    jbs.optimize_for(jdh, ref)  # the JAX host path: its host copies in the new row order
    dh = interop.haystack(jdh.host_bytes, jdh.length, jdh.kh, device=CPU)
    carried = interop.batched_searcher(
        needles, [(g.values_host, g.masks_host, g.lengths, g.indices) for g in jbs.groups], device=CPU
    )
    assert np.array_equal(carried.find_all(dh), ref)
    assert np.array_equal(ref, oracle_all(hay, needles))
    assert np.array_equal(jbs.find_all(jdh), ref)

    bs = BatchedSearcher(needles, device=CPU)
    bs.optimize_for(dh)
    for g, jg in zip(bs.groups, jbs.groups):
        assert g.t == jg.t and np.array_equal(g.indices, jg.indices)
        assert np.array_equal(g.values_host, jg.values_host)
        assert g.values_dev.shape == (jg.n_pad, jg.t)
    with pytest.raises(ValueError, match="cover every needle"):
        interop.batched_searcher(needles, [(g.values_host, g.masks_host, g.lengths, g.indices)
                                           for g in jbs.groups[1:]], device=CPU)


def test_mixed_lengths_flat(rng):
    hay = bytes(rng.integers(97, 105, (2000,), dtype=np.uint8))
    needles = [b"", b"a", hay[100:101], hay[5:12], hay[1990:2000], hay[0:4],
               b"zzzz", hay[777:800], b"q" * 50, hay[3:3]]
    bs = BatchedSearcher(needles, device=CPU)
    got = bs.find_all(hay)
    assert np.array_equal(got, oracle_all(hay, needles))
    assert np.array_equal(got, jst.BatchedSearcher(needles).find_all(hay))
    assert (bs.search_all(hay) == (got >= 0)).all()


def test_mixed_lengths_cols_and_wide_buckets(rng):
    hay = bytes(rng.integers(97, 103, (30_000,), dtype=np.uint8))
    dh = preprocess(hay, kh=32, force_cols=True, device=CPU)
    needles = [hay[i : i + k] for k in (1, 2, 3, 5, 8, 13, 21, 30, 33, 64, 65, 200)
               for i in (0, 7777, 29_000 - k)]
    needles += [b"nomatch!", b"zz", hay[-6:], hay[-200:]]
    bs = BatchedSearcher(needles, device=CPU)
    assert sorted(g.t for g in bs.groups) == [1, 2, 4, 6, 8, 16, 32, 64]
    assert np.array_equal(bs.find_all(dh), oracle_all(hay, needles))


def test_group_order_and_short_haystacks(rng):
    hay = bytes(rng.integers(97, 100, (3000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in [(5, 9), (0, 1), (100, 4), (7, 17), (50, 2)]]
    assert np.array_equal(BatchedSearcher(needles, device=CPU).find_all(hay), oracle_all(hay, needles))
    short = hay[:64]
    got = BatchedSearcher([short + b"x", short, short[:5]], device=CPU).find_all(short)
    assert got[0] == -1 and got[1] == 0
    assert BatchedSearcher([], device=CPU).find_all(b"anything").shape == (0,)


def test_batched_contracts(rng):
    BatchedSearcher([b"abc", b"de"], position=1, device=CPU)
    with pytest.raises(ValueError, match="position"):
        BatchedSearcher([b"abc", b"de"], position=2, device=CPU)
    with pytest.raises(ValueError, match="position"):
        BatchedSearcher([b"abc"], position=-1, device=CPU)
    mixed = BatchedSearcher([b"a", b"x" * 2049], device=CPU)
    assert [i for i, _ in mixed._huge] == [1] and [g.n for g in mixed.groups] == [1]
    with pytest.raises(ValueError, match="position"):
        BatchedSearcher([b"x" * 2049], position=2049, device=CPU)
    meta = BatchedSearcher([b"abc"], device="meta")
    with pytest.raises(ValueError, match="lives on cpu"):
        meta.find_all(preprocess(b"abc" * 4000, device=CPU))


def test_absent_rows_report_sentinel_on_device(rng):
    hay = bytes(rng.integers(97, 99, (20_000,), dtype=np.uint8))
    dev = BatchedSearcher([b"zz", hay[:3]], device=CPU).find_all_device(preprocess(hay, device=CPU))
    assert dev.tolist() == [SENTINEL, 0]


def test_find_all_multiseg_parity():
    """tests/test_batched.py's 1.2 MB sweep (several segments of the JAX
    layout, many queue chunks of the port's): first, last and absent
    needles, beside the JAX package and ``bytes.find``."""
    rng = np.random.default_rng(48)
    hay = bytes(rng.integers(97, 101, (1_200_000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in
               [(0, 4), (600_000, 8), (1_199_990, 10), (3, 1), (900_000, 5)]]
    needles += [b"XYZ!", b"\x00\x01\x02"]
    got = BatchedSearcher(needles, device=CPU).find_all(preprocess(hay, kh=16, device=CPU))
    assert np.array_equal(got, oracle_all(hay, needles))
    assert np.array_equal(got, jst.BatchedSearcher(needles).find_all(jst.preprocess(hay, kh=16)))


def test_optimize_for_exactness():
    """``optimize_for`` permutes rows only: find, count and positions stay
    exact after it, absent and huge needles included, as the JAX package
    finds them."""
    from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

    rng = np.random.default_rng(49)
    hay = bytes(rng.integers(97, 102, (400_000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in
               [(300_000, 5), (10, 4), (399_990, 8), (100_000, 12), (7, 1)]]
    needles += [b"QQQQ", hay[200_000:202_500]]  # absent, huge
    dh = preprocess(hay, kh=16, device=CPU)
    bs = BatchedSearcher(needles, device=CPU)
    before = bs.find_all(dh)
    bs.optimize_for(dh)
    after = bs.find_all(dh)
    assert np.array_equal(before, after) and np.array_equal(after, oracle_all(hay, needles))
    assert list(bs.count_all(dh)) == [overlapping_count(hay, nd) for nd in needles]
    for nd, pos in zip(needles, bs.positions_all(dh)):
        assert np.array_equal(pos, _host_positions(hay, nd))
    assert np.array_equal(after, jst.BatchedSearcher(needles).find_all(jst.preprocess(hay, kh=16)))
