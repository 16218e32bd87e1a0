"""Huge needles (k > MAX_NEEDLE_LEN) in the port against the JAX package
and the bytes oracle — the mirror of tests/test_huge.py case by case (but
its two ``shard_map`` cases, which wait for the port's ``parallel/``), on
the same seeded inputs: the prefix filter, the host verify and the
chained-bitmap verify, through ``DynamicSearcher`` and ``BatchedSearcher``.
Then the chained bitmap itself (count, first offset and decoded offsets;
the port's bitmap is linear, the JAX one laid out by lane, so words are
never compared), the tier ``_route`` takes, and the contracts.  The port
runs its CPU path (the kernels' plain versions); the JAX package runs as
its own tests run it on the CPU.  Every comparison is exact."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu.models.huge as jhuge
import sliceslice_tpu.ops.xla_backend as jxb
import sliceslice_tpu_torch.models.huge as thuge
from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.models.huge import CHUNK, HugeNeedleSearcher
from sliceslice_tpu_torch.needle import MAX_NEEDLE_LEN, build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import chained, torch_backend
from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"
#: The dense tier's layout halo (chunk tables of 128 slots).
DENSE_KH = needed_halo_for_t(CHUNK // 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(99)
    data = bytearray(rng.integers(97, 110, (400_000,), dtype=np.uint8))
    return bytes(data)


def oracle(hay: bytes, nd: bytes):
    f = hay.find(nd)
    return (None if f < 0 else f), overlapping_count(hay, nd), _host_positions(hay, nd).tolist()


def both(nd: bytes, hay: bytes, thay=None, jhay=None, ops=("find", "count", "positions")):
    """find / count_in / positions of the port's and the JAX package's
    DynamicSearcher over ``thay`` / ``jhay`` (default: the host bytes),
    required equal to each other and to the bytes oracle."""
    thay = hay if thay is None else thay
    jhay = hay if jhay is None else jhay
    ts, js = DynamicSearcher(nd, device=CPU), jst.DynamicSearcher(nd)
    exp = dict(zip(("find", "count", "positions"), oracle(hay, nd)))
    for op in ops:
        if op == "find":
            got, ref = ts.find(thay), js.find(jhay)
        elif op == "count":
            got, ref = ts.count_in(thay), js.count_in(jhay)
        else:
            got, ref = ts.positions(thay).tolist(), js.positions(jhay).tolist()
        assert got == ref == exp[op], (op, len(nd))
    return exp


def test_boundary_2048_2049(corpus):
    """k = MAX exactly rides the kernels, k = MAX + 1 the huge path: the
    same answers on both sides of the boundary, in both packages."""
    for k in (MAX_NEEDLE_LEN, MAX_NEEDLE_LEN + 1):
        nd = corpus[123_456 : 123_456 + k]
        assert both(nd, corpus, ops=("find", "count"))["find"] == 123_456
    assert isinstance(DynamicSearcher(b"q" * (MAX_NEEDLE_LEN + 7), device=CPU).inner, HugeNeedleSearcher)
    both(b"q" * (MAX_NEEDLE_LEN + 7), corpus, ops=("find",))


def test_huge_find_count_positions(corpus):
    nd = corpus[50_000 : 53_000]
    tdh, jdh = preprocess(corpus, device=CPU), jst.preprocess(corpus)
    assert both(nd, corpus, tdh, jdh)["find"] == 50_000
    assert DynamicSearcher(nd, device=CPU).search_in(tdh)
    assert DynamicSearcher(nd, device=CPU).inner._route(tdh, corpus)[0] == "host"


def test_huge_overlapping_periodic():
    """Overlapping occurrences of a periodic huge needle count exactly."""
    nd = b"ab" * 1_600  # 3200 bytes
    hay = b"xx" + b"ab" * 1_610 + b"yy"
    exp = both(nd, hay)
    assert exp["find"] == 2 and exp["count"] == 11


def test_huge_adversarial_prefix_repeats(corpus):
    """Many candidates share the 64-byte filter prefix but differ in their
    tails: the verify rejects every false one."""
    block = corpus[1_000 : 1_064]
    decoys = b"".join(block + bytes([i]) * 3_000 for i in range(5))
    nd = block + b"\xffTRUE" + bytes(3_000)
    hay = decoys + nd + decoys
    exp = both(nd, hay)
    assert exp["find"] == len(decoys) and exp["count"] == 1


def test_huge_needle_longer_than_haystack():
    nd = b"z" * 4_000
    both(nd, b"z" * 3_999)
    assert both(nd, b"z" * 4_000)["find"] == 0
    tdh = preprocess(b"z" * 3_999 + b"y" * 9_000, device=CPU)
    assert DynamicSearcher(b"z" * 20_000, device=CPU).inner._route(tdh, None)[0] == "empty"


def test_batched_mixed_normal_and_huge(corpus):
    k = 2_500
    needles = [
        corpus[10:14],                    # kernel path
        corpus[77_000 : 77_000 + k],      # huge, present
        b"q" * k,                         # huge, absent
        b"absent!",                       # kernel path, absent
        corpus[-5:],
    ]
    bs, jbs = BatchedSearcher(needles, device=CPU), jst.BatchedSearcher(needles)
    assert [i for i, _ in bs._huge] == [i for i, _ in jbs._huge] == [1, 2]
    tdh, jdh = preprocess(corpus, device=CPU), jst.preprocess(corpus)
    exp = [corpus.find(nd) for nd in needles]
    assert bs.find_all(tdh).tolist() == jbs.find_all(jdh).tolist() == exp
    cnt = [overlapping_count(corpus, nd) for nd in needles]
    assert bs.count_all(tdh).tolist() == jbs.count_all(jdh).tolist() == cnt
    for nd, p, q in zip(needles, bs.positions_all(tdh), jbs.positions_all(jdh)):
        assert p.tolist() == q.tolist() == _host_positions(corpus, nd).tolist(), nd[:8]
    assert bs.search_all(tdh).tolist() == [e >= 0 for e in exp]
    # optimize_for measures with find_all (huge slots included) and keeps
    # every answer.
    assert bs.optimize_for(tdh).find_all(tdh).tolist() == exp


def test_batched_all_huge(corpus):
    needles = [corpus[5_000 : 5_000 + 2_100], b"w" * 2_200]
    bs = BatchedSearcher(needles, device=CPU)
    assert bs.groups == [] and len(bs._huge) == 2
    assert bs.find_all(corpus).tolist() == jst.BatchedSearcher(needles).find_all(corpus).tolist() == [5_000, -1]
    assert bs.count_all(corpus).tolist() == [1, 0]


def test_device_resident_variants_fence(corpus):
    needles = [corpus[:4], corpus[: MAX_NEEDLE_LEN + 1]]
    bs, jbs = BatchedSearcher(needles, device=CPU), jst.BatchedSearcher(needles)
    tdh, jdh = preprocess(corpus, device=CPU), jst.preprocess(corpus)
    for name in ("find_all_device", "count_all_device"):
        with pytest.raises(ValueError, match="MAX_NEEDLE_LEN") as got:
            getattr(bs, name)(tdh)
        with pytest.raises(ValueError, match="MAX_NEEDLE_LEN") as ref:
            getattr(jbs, name)(jdh)
        assert str(got.value) == str(ref.value)


def test_huge_dense_tier_period1():
    """Period-1 content: every position passes the 64-byte prefix filter,
    so the dense tier answers on the device via the chained bitmap (the
    identical chunks share one bitmap row)."""
    k = 4096
    nd = b"a" * k
    hay = b"a" * 120_000 + b"b" + b"a" * 30_000
    tdh, jdh = preprocess(hay, device=CPU), jst.preprocess(hay)
    assert DynamicSearcher(nd, device=CPU).inner._route(tdh, hay)[0] == "dense"
    assert both(nd, hay, tdh, jdh)["find"] == 0
    # when the first run of 'a' is too short, the match moves past it
    hay2 = b"a" * 3_000 + b"c" + b"a" * 50_000 + b"d" * 9_000
    tdh2, jdh2 = preprocess(hay2, device=CPU), jst.preprocess(hay2)
    assert both(nd, hay2, tdh2, jdh2, ops=("find", "count"))["find"] == 3_001


def test_huge_dense_tier_aperiodic(corpus, monkeypatch):
    """Dense tier with distinct chunks, forced by a small host budget in
    both packages: present and absent needles whose prefix occurs at
    several places."""
    monkeypatch.setattr(jhuge, "HOST_VERIFY_MAX", 2)
    monkeypatch.setattr(thuge, "HOST_VERIFY_MAX", 2)
    prefix = corpus[9_000 : 9_064]
    k = 2_600
    present = corpus[9_000 : 9_000 + k]
    absent = prefix + b"\xff" + bytes(k - 65)
    hay = corpus[:200_000]
    tdh, jdh = preprocess(hay, device=CPU), jst.preprocess(hay)
    for nd in (present, absent):
        tier = DynamicSearcher(nd, device=CPU).inner._route(tdh, hay)[0]
        assert tier == jst.DynamicSearcher(nd).inner._route(jdh, hay)[0]
        both(nd, hay, tdh, jdh)


def test_huge_dense_tier_no_host_bytes(monkeypatch):
    """Without host bytes the sparse tier is unavailable; the dense tier
    answers exactly when the layout's halo already fits the chunk tables,
    and both packages raise the same ValueError when it does not."""
    monkeypatch.setattr(jhuge, "HOST_VERIFY_MAX", 0)
    monkeypatch.setattr(thuge, "HOST_VERIFY_MAX", 0)
    nd = b"ab" * 1_500  # k = 3000
    hay = b"xy" * 40_000 + b"ab" * 1_700 + b"z" * 100
    tdh = preprocess(hay, kh=DENSE_KH, keep_host=False, device=CPU)
    jdh = jst.preprocess(hay, kh=jxb_halo(), keep_host=False)
    both(nd, hay, tdh, jdh)
    small_t, small_j = preprocess(hay, keep_host=False, device=CPU), jst.preprocess(hay, keep_host=False)
    with pytest.raises(ValueError, match="no host bytes") as got:
        DynamicSearcher(nd, device=CPU).find(small_t)
    with pytest.raises(ValueError, match="no host bytes") as ref:
        jst.DynamicSearcher(nd).find(small_j)
    assert str(got.value) == str(ref.value)


def jxb_halo() -> int:
    from sliceslice_tpu.needle import needed_halo_for_t as jhalo

    return jhalo(jhuge.CHUNK // 4)


@pytest.mark.parametrize("budget", [jhuge.HOST_VERIFY_MAX, 0])
def test_huge_dense_boundary_last_valid_position(monkeypatch, budget):
    """At the exact end bound, in the host tier (4,137 candidates) and the
    dense tier (a host budget of 0): a needle occupying the final k bytes
    matches; one byte fewer does not (end = len - k + 1)."""
    monkeypatch.setattr(jhuge, "HOST_VERIFY_MAX", budget)
    monkeypatch.setattr(thuge, "HOST_VERIFY_MAX", budget)
    k = 4_200
    nd = b"m" * k
    hay = b"q" * 100_000 + b"m" * k
    tier = DynamicSearcher(nd, device=CPU).inner._route(preprocess(hay, device=CPU), hay)[0]
    assert tier == ("host" if budget else "dense")
    exp = both(nd, hay, ops=("find", "count"))
    assert exp["find"] == len(hay) - k and exp["count"] == 1
    assert both(nd, hay[:-1], ops=("find",))["find"] is None


# -- the chained bitmap ------------------------------------------------------


def _plan(needle: bytes):
    """The JAX searcher's chunk plan of ``needle`` (tables, lengths, map,
    offsets), which the port's searcher must build alike."""
    plan = jhuge.HugeNeedleSearcher(needle)._chunk_plan()
    mine = HugeNeedleSearcher(needle, device=CPU)._chunk_plan()
    assert len(plan[0]) == len(mine[0]) and plan[1:] == mine[1:]
    for (jv, jm), (tv, tm) in zip(plan[0], mine[0]):
        assert np.array_equal(jv, tv) and np.array_equal(jm, tm)
    return plan


def _chained_both(hay: bytes, plan, offsets=None):
    """The port's chained bitmap (plain) and the JAX one over the same
    corpus: (count, first, decoded offsets), required equal."""
    tables, lens, cmap, offs = plan
    offs = offs if offsets is None else offsets
    tdh = preprocess(hay, kh=DENSE_KH, device=CPU)
    jdh = jst.preprocess(hay, kh=jxb_halo())
    count, first, words = chained.chained_match_bitmap(tdh.flat, tables, lens, cmap, offs, tdh.length)
    jc, jf, jw = jxb.chained_match_bitmap(jdh.windows(), tables, lens, cmap, offs, jdh.length, jdh.s)
    got = (int(count), int(first), torch_backend.decode_match_bitmap(words.numpy()).tolist())
    ref = (int(jc), int(jf), jxb.decode_match_bitmap(np.asarray(jw), jdh.s).tolist())
    assert got == ref
    assert count.dtype == first.dtype == words.dtype == torch.int32 and count.dim() == first.dim() == 0
    return got


def _random_hay(seed: int, n: int) -> bytes:
    return bytes(np.random.default_rng(seed).integers(98, 123, n, dtype=np.uint8))


@pytest.mark.parametrize("where", [31, 32 * 7 + 31, 32 * 40 + 5])
def test_chained_first_in_bit_31(where):
    """A match at 32w + 31 alone in its word (the word is INT_MIN as int32
    bit patterns) and one elsewhere: first, count and offsets."""
    hay = bytearray(_random_hay(5, 60_000))
    nd = _random_hay(6, 2_600)  # a shorter last chunk: 40 bytes
    hay[where : where + len(nd)] = nd
    hay[30_000 + 3 : 30_003 + len(nd)] = nd
    hay = bytes(hay)
    got = _chained_both(hay, _plan(nd))
    assert got == (2, where, [where, 30_003])


def test_chained_period1_every_position():
    """The period-1 needle: one unique chunk, every word all ones."""
    hay = b"a" * 70_000 + b"b" + b"a" * 5_000
    nd = b"a" * 4_096
    plan = _plan(nd)
    assert len(plan[0]) == 1 and len(plan[2]) == 8
    got = _chained_both(hay, plan)
    assert got[:2] == (70_000 - 4_096 + 1 + 5_000 - 4_096 + 1, 0)
    assert got[2] == _host_positions(hay, nd).tolist()


def test_chained_chunk_past_the_corpus():
    """A chunk offset beyond the corpus and its bitmap leaves the AND all
    zero; offsets off the 32-byte grid raise in both packages."""
    hay = _random_hay(7, 40_000)
    nd = hay[1_000:3_500]
    tables, lens, cmap, offs = _plan(nd)
    assert _chained_both(hay, (tables, lens, cmap, offs))[:2] == (1, 1_000)
    far = list(offs[:-1]) + [32 * 100_000]
    assert _chained_both(hay, (tables, lens, cmap, offs), far) == (0, SENTINEL, [])
    bad = list(offs[:-1]) + [offs[-1] + 4]
    tdh = preprocess(hay, kh=DENSE_KH, device=CPU)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        chained.chained_match_bitmap(tdh.flat, tables, lens, cmap, bad, tdh.length)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        jxb.chained_match_bitmap(None, tables, lens, cmap, bad, len(hay), 128)


def test_chained_budget_splits_rows(monkeypatch):
    """Unique chunks over the positions budget run in several launch
    batches with the same answers."""
    hay = _random_hay(8, 30_000)
    nd = hay[2_000:5_000]
    plan = _plan(nd)
    whole = _chained_both(hay, plan)
    monkeypatch.setattr(torch_backend, "POSITIONS_BUDGET_BYTES", 4 * 2_000)
    assert torch_backend.position_batches(len(plan[0]), 40_000, 128, 0)[0] == (0, 1)
    assert _chained_both(hay, plan) == whole == (1, 2_000, [2_000])


def test_first_set_bit():
    cases = [[0, 0, 0], [0, -2**31, 1], [0, 0, 6], [1, 0, 0], [0, 0, -1]]
    exp = [SENTINEL, 63, 65, 0, 64]
    for words, e in zip(cases, exp):
        assert int(chained.first_set_bit(torch.tensor(words, dtype=torch.int32))) == e


# -- routing and contracts ---------------------------------------------------


@pytest.mark.parametrize("budget", [0, 1, 3, 16384])
def test_route_tiers_match_jax(corpus, monkeypatch, budget):
    """The port and the JAX package take the same tier on the same inputs
    under every host budget: host bytes or none, few or many candidates,
    a corpus shorter than the needle, a flat haystack."""
    monkeypatch.setattr(jhuge, "HOST_VERIFY_MAX", budget)
    monkeypatch.setattr(thuge, "HOST_VERIFY_MAX", budget)
    hay = corpus[:60_000]
    cases = [
        (hay[1_000:4_000], hay, True),             # one candidate
        ((hay[500:564] * 40)[:2_500], hay[:500] + hay[500:564] * 40 + hay[3_060:], True),
        (b"a" * 2_100, b"a" * 9_000, True),        # every position
        (b"q" * 3_000, hay, True),                 # no candidate
        (hay[:3_000], hay[:2_900] + b"x" * 20, True),   # shorter than the needle
        (hay[100:2_200], hay, False),              # no host bytes
    ]
    for nd, h, keep in cases:
        tdh = preprocess(h, keep_host=keep, force_cols=True, device=CPU)
        jdh = jst.preprocess(h, keep_host=keep, force_cols=True)
        ts, js = HugeNeedleSearcher(nd, device=CPU), jhuge.HugeNeedleSearcher(nd)
        tl, td = ts._as_layout(tdh)
        jl, jd = js._as_layout(jdh)
        got, ref = ts._route(tl, td)[0], js._route(jl, jd)[0]
        assert got == ref, (budget, len(nd), len(h), keep)
        if got == "host":
            assert ts._route(tl, td)[1].tolist() == np.asarray(js._route(jl, jd)[1]).tolist()
    small = hay[:7_000]  # bytes at or below the flat rung's size: scanned on the host
    assert HugeNeedleSearcher(small[:2_100], device=CPU)._route(
        *HugeNeedleSearcher(small[:2_100], device=CPU)._as_layout(small))[0] == "hostscan"
    assert jhuge.HugeNeedleSearcher(small[:2_100])._route(None, small)[0] == "hostscan"


def test_flat_layouts_on_the_cpu_scan_host_bytes(corpus):
    """A flat layout off the card is scanned on the host (hostscan), as in
    the JAX package; without host bytes both raise the same error."""
    small = corpus[:6_000]
    nd = small[1_000:3_100]
    tdh, jdh = preprocess(small, device=CPU), jst.preprocess(small)
    assert not tdh.tiled and not jdh.tiled
    assert both(nd, small, tdh, jdh)["count"] == 1
    bare_t, bare_j = preprocess(small, keep_host=False, device=CPU), jst.preprocess(small, keep_host=False)
    with pytest.raises(ValueError) as got:
        DynamicSearcher(nd, device=CPU).find(bare_t)
    with pytest.raises(ValueError) as ref:
        jst.DynamicSearcher(nd).find(bare_j)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("args", [(b"x" * MAX_NEEDLE_LEN, None), (b"x" * 3_000, 3_000),
                                  (b"x" * 3_000, -1), (b"x" * 100, None)])
def test_huge_contract_errors_identical(args):
    with pytest.raises(ValueError) as got:
        HugeNeedleSearcher(*args, device=CPU)
    with pytest.raises(ValueError) as ref:
        jhuge.HugeNeedleSearcher(*args)
    assert str(got.value) == str(ref.value)
    if args[1] is not None:
        with pytest.raises(ValueError, match="position"):
            DynamicSearcher(*args, device=CPU)
        with pytest.raises(ValueError, match="position"):
            BatchedSearcher([args[0]], position=args[1], device=CPU)


def test_huge_position_and_size():
    nd = bytes(range(256)) * 12
    for p in (None, 0, 63, 64, len(nd) - 1):
        ts, js = HugeNeedleSearcher(nd, p, device=CPU), jhuge.HugeNeedleSearcher(nd, p)
        assert (ts.size, ts.position, ts.needle.position) == (js.size, js.position, js.needle.position)
        assert ts.needle.data == js.needle.data == nd[:64]
    hay = b"\x00" * 100 + nd + b"\x01" * 3_000
    for p in (0, 1_000, len(nd) - 1):
        assert DynamicSearcher.with_position(nd, p, device=CPU).find(hay[:4_000]) == 100  # host SWAR rung
        assert DynamicSearcher.with_position(nd, p, device=CPU).find(hay * 3) == 100


def test_with_candidates_entry_points(corpus):
    """find / count / positions ``_with_candidates`` (the streaming
    scanner's batched filter) answer as the plain calls do."""
    nd = corpus[20_000:22_500]
    tdh = preprocess(corpus, device=CPU)
    s = HugeNeedleSearcher(nd, device=CPU)
    ncand = s._candidate_count(tdh)
    assert ncand == 1
    assert s.find_with_candidates(tdh, ncand) == s.find(tdh) == 20_000
    assert s.count_with_candidates(tdh, ncand) == 1
    assert s.positions_with_candidates(tdh, ncand).tolist() == [20_000]
    assert s.find_with_candidates(tdh, 0) is None and s.count_with_candidates(tdh, 0) == 0
    assert s.count_with_candidates(tdh, thuge.HOST_VERIFY_MAX + 1) == 1  # dense tier
