"""The port's all-pairs word sweep against the JAX package's
``PairwiseSearcher`` and the ``bytes.find`` oracle — the mirror of
tests/test_pairwise.py — plus the pair-block wrapper's plain version
against the JAX ``_pair_block`` on identical packed words, and needle
tables carried across by ``sliceslice_tpu_torch.interop``.  Every
comparison is exact.  The CUDA pair-block kernel itself is held against the
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py, on
the hard cases of ``sliceslice_tpu_torch/scripts/pair_cases.py``, which
run here through the plain version."""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sliceslice_tpu.ops.pairwise as jpw
import sliceslice_tpu_torch.ops.pairwise as tpw
from sliceslice_tpu_torch import PairwiseSearcher, interop, pairwise_contains_all
from sliceslice_tpu_torch.ops.scan_math import table_bits
from sliceslice_tpu_torch.scripts import pair_cases

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


def oracle_matrix(needles, haystacks):
    c = np.zeros((len(needles), len(haystacks)), dtype=bool)
    f = np.full((len(needles), len(haystacks)), -1, dtype=np.int32)
    for i, n in enumerate(needles):
        for j, h in enumerate(haystacks):
            pos = h.find(n)
            c[i, j] = pos >= 0
            f[i, j] = pos
    return c, f


def random_words(rng, count, max_len=12, alpha=(97, 101)):
    out = []
    for _ in range(count):
        k = int(rng.integers(0, max_len + 1))
        out.append(bytes(rng.integers(*alpha, (k,), dtype=np.uint8)))
    return out


def test_pairwise_random_matches_jax(rng):
    ws = random_words(rng, 60)
    c_exp, f_exp = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws, device=CPU)
    got_c, got_f = ps.contains_matrix(), ps.first_matrix()
    assert got_c.dtype == np.bool_ and got_f.dtype == np.int32
    assert (got_c == c_exp).all() and (got_f == f_exp).all()
    assert (got_f == jpw.PairwiseSearcher(ws).first_matrix()).all()


def test_pairwise_distinct_haystacks_multi_block(rng):
    nd = random_words(rng, 25, max_len=6)
    hs = random_words(rng, 40, max_len=10)
    c_exp, f_exp = oracle_matrix(nd, hs)
    ps = PairwiseSearcher(nd, block=16, device=CPU)  # multi-block tiling
    assert ps._plan(hs) == jpw.PairwiseSearcher(nd, block=16)._plan(hs)[0]
    assert (ps.contains_matrix(hs) == c_exp).all()
    assert (ps.first_matrix(hs) == f_exp).all()


def test_pairwise_words_sample(words, rng):
    idx = rng.integers(0, len(words), (80,))
    ws = sorted((words[int(i)] for i in idx), key=len)
    c_exp, _ = oracle_matrix(ws, ws)
    assert (pairwise_contains_all(ws, device=CPU) == c_exp).all()
    assert (pairwise_contains_all(ws, device=CPU) == jpw.pairwise_contains_all(ws)).all()


def test_pairwise_edge_cases():
    ws = [b"", b"a", b"aa", b"ab", b"ba", b"aba", b"abcdefghijklmnop"]
    c_exp, f_exp = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws, device=CPU)
    assert (ps.contains_matrix() == c_exp).all()
    assert (ps.first_matrix() == f_exp).all()
    assert (ps.first_matrix([b"", b"x"]) == oracle_matrix(ws, [b"", b"x"])[1]).all()
    empty = PairwiseSearcher([], device=CPU)
    assert empty.first_matrix([b"ab"]).shape == (0, 1)
    assert ps.first_matrix([]).shape == (len(ws), 0)


def test_count_matches_device(rng):
    ws = random_words(rng, 40)
    c_exp, _ = oracle_matrix(ws, ws)
    ps = PairwiseSearcher(ws, block=16, device=CPU)
    got = ps.count_matches_device()
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(c_exp.sum()) == int(jpw.PairwiseSearcher(ws, block=16).count_matches_device())


def test_pairwise_matches_jax_pallas_block(rng):
    """The JAX Pallas pair-block (its TPU hot path, in the interpreter)
    against the port on the same words, with several plan blocks."""
    ws = random_words(rng, 35, max_len=14)
    hs = random_words(rng, 50, max_len=18)
    c_exp, f_exp = oracle_matrix(ws, hs)
    pallas = jpw.PairwiseSearcher(ws, block=16, use_pallas=True)
    ps = PairwiseSearcher(ws, block=16, device=CPU)
    assert (ps.first_matrix(hs) == pallas.first_matrix(hs)).all()
    assert (ps.first_matrix(hs) == f_exp).all()
    assert int(ps.count_matches_device(hs)) == int(pallas.count_matches_device(hs)) == int(c_exp.sum())


def _packed(needles, haystacks):
    """The same packed words in both packages' forms: the JAX transposed
    windows (tn, N) tables, and the port's row-major bytes and (N, tn)
    tables, with one padded needle row (len 2**30) and one padded word
    lane (len -1)."""
    ps = jpw.PairwiseSearcher(needles)
    mi = ps._bucket(jpw.max_len(haystacks))
    arr, lens = jpw.pack_words(haystacks, mi + 4 * ps.tn)
    arr = np.pad(arr, ((0, 1), (0, (-arr.shape[1]) % 4)))
    lens = np.append(lens, -1).astype(np.int32)
    a = arr.T.astype(np.uint32)
    pht = a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)
    valt = np.pad(np.asarray(ps._valt), ((0, 0), (0, 1)))
    mskt = np.pad(np.asarray(ps._mskt), ((0, 0), (0, 1)))
    ln = np.append(np.asarray(ps._ln), 1 << 30).astype(np.int32)
    port = (table_bits(valt.T, "cpu"), table_bits(mskt.T, "cpu"), torch.from_numpy(ln),
            torch.from_numpy(arr), torch.from_numpy(lens))
    return (valt, mskt, ln, pht, lens), port, ps.tn, mi


def test_pair_block_plain_matches_jax_pair_block(rng):
    needles = random_words(rng, 30, max_len=9) + [b""]
    haystacks = random_words(rng, 45, max_len=15) + [b""]
    jax_ops, port_ops, tn, mi = _packed(needles, haystacks)
    valt, mskt, ln, pht, lh = jax_ops
    _, ref = jpw._pair_block(jnp.asarray(valt), jnp.asarray(mskt), jnp.asarray(ln),
                             jnp.asarray(pht), jnp.asarray(lh), tn, mi)
    ref = np.asarray(ref)
    ref = np.where(ref >= mi, -1, ref)
    n, h = ln.shape[0], lh.shape[0]
    got = tpw.pair_block_plain(*port_ops, [(0, 0, tn, mi)], max(n, h))
    assert np.array_equal(got.numpy(), ref)
    assert (got[-1] == -1).all() and (got[:, -1] == -1).all()  # padded rows and lanes
    _, f_exp = oracle_matrix(needles, haystacks)
    assert np.array_equal(got.numpy()[:-1, :-1], f_exp)
    # A multi-block plan with a skipped block and per-block buckets, held
    # against the JAX block function block by block.
    plan = [(0, 0, 2, 8), (0, 16, tn, mi), (16, 0, 0, 0), (16, 16, tn, mi), (16, 32, 1, 4)]
    got = tpw.pair_block_plain(*port_ops, plan, 16)
    cnt = tpw.pair_block_plain(*port_ops, plan, 16, count=True)
    exp = np.full((n, h), -1, np.int32)
    for i0, j0, tn_b, mi_b in plan:
        if tn_b:
            _, f = jpw._pair_block(
                jnp.asarray(valt[:tn_b, i0 : i0 + 16]), jnp.asarray(mskt[:tn_b, i0 : i0 + 16]),
                jnp.asarray(ln[i0 : i0 + 16]), jnp.asarray(pht[: mi_b + 4 * tn_b - 3, j0 : j0 + 16]),
                jnp.asarray(lh[j0 : j0 + 16]), tn_b, mi_b)
            f = np.asarray(f)
            exp[i0 : i0 + 16, j0 : j0 + 16] = np.where(f >= mi_b, -1, f)
    assert np.array_equal(got.numpy(), exp)
    assert int(cnt) == int((exp >= 0).sum())


def test_interop_pairwise_searcher(rng):
    ws = random_words(rng, 30, max_len=10) + [b""]
    hs = random_words(rng, 20, max_len=16)
    jps = jpw.PairwiseSearcher(ws, block=16)
    ps = interop.pairwise_searcher(ws, np.asarray(jps._valt), np.asarray(jps._mskt),
                                   np.asarray(jps._ln), jps.block, device=CPU)
    assert ps.tn == jps.tn and ps._plan(hs) == jps._plan(hs)[0]
    assert (ps.first_matrix(hs) == jps.first_matrix(hs)).all()
    assert (ps.contains_matrix() == jps.contains_matrix()).all()
    assert int(ps.count_matches_device()) == int(jps.count_matches_device())
    with pytest.raises(ValueError, match="describe the N needles"):
        interop.pairwise_searcher(ws[1:], np.asarray(jps._valt), np.asarray(jps._mskt),
                                  np.asarray(jps._ln), 16, device=CPU)


def test_pair_block_cpu_plain_no_launch_and_checks():
    ps = PairwiseSearcher([b"ab", b"abc", b""], device=CPU)
    hay, lh, _, _ = ps._pack_hay(None)
    args = (ps._values, ps._masks, ps._ln, hay, lh, ps._plan(None), ps.block)
    before = tpw.pair_block.launches
    assert torch.equal(tpw.pair_block(*args), tpw.pair_block_plain(*args))
    assert tpw.pair_block.launches == before
    meta = hay.to("meta")
    with pytest.raises(ValueError, match="no pair-block kernel"):
        tpw.pair_block(ps._values.to("meta"), ps._masks.to("meta"), ps._ln.to("meta"), meta,
                       lh.to("meta"), ps._plan(None), ps.block)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpw.pair_block(*args[:3], hay[:, :-1], *args[4:])
    with pytest.raises(ValueError, match="int32"):
        tpw.pair_block(ps._values.to(torch.int64), *args[1:])
    with pytest.raises(ValueError, match="same needles"):
        tpw.pair_block(*args[:2], ps._ln[:2], *args[3:])
    with pytest.raises(ValueError, match="outside"):
        tpw.pair_block(*args[:5], [(0, 0, ps.tn, 64)], ps.block)


def test_hay_cache_is_capped_and_identity_keyed(rng):
    ps = PairwiseSearcher(random_words(rng, 10), device=CPU)
    lists = [random_words(rng, 5) for _ in range(PairwiseSearcher._HAY_CACHE_CAP + 3)]
    for hs in lists:
        ps.first_matrix(hs)
    assert len(ps._hay_cache) <= PairwiseSearcher._HAY_CACHE_CAP
    same = list(lists[-1])
    assert (ps.first_matrix(same) == ps.first_matrix(lists[-1])).all()
    assert ps._cache_get("mat", same) is not None


@pytest.mark.parametrize("name", [c.name for c in pair_cases.cases()])
def test_pair_hard_cases_match_jax_and_bytes_find(name):
    """The pair kernel's hard cases through the plain version: equal to
    ``bytes.find`` (padded rows and words never match) and to the JAX
    ``PairwiseSearcher`` on the same seeded words, both modes; the plans of
    the two packages are the same blocks."""
    case = next(c for c in pair_cases.cases() if c.name == name)
    args, exp = pair_cases.operands(case, CPU)
    got = tpw.pair_block(*args)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), exp)
    assert int(tpw.pair_block(*args, count=True)) == int((exp >= 0).sum())
    jps = jpw.PairwiseSearcher(case.needles, block=case.block)
    assert tuple(args[5]) == jps._plan(case.haystacks)[0]
    n, h = len(case.needles), exp.shape[1] - case.pad[1]
    assert np.array_equal(jps.first_matrix(case.haystacks), exp[:n, :h])
    assert int(jps.count_matches_device(case.haystacks)) == int((exp >= 0).sum())
    if name == "skipped":
        assert any(e[2] == 0 for e in args[5]) and any(e[2] > 0 for e in args[5])
    if name == "padded":
        assert (exp[n:] == -1).all() and (exp[:, h:] == -1).all()


def test_launch_plan_is_cached_per_haystack_list(rng):
    """A second sweep of one haystack list reuses its checked plan and
    device table (the plan's non-skipped blocks); a direct ``pair_block``
    call builds its own."""
    ws = sorted(random_words(rng, 40), key=len)
    hs = random_words(rng, 30, max_len=5)
    ps = PairwiseSearcher(ws, block=8, device=CPU)
    c_exp, f_exp = oracle_matrix(ws, hs)
    assert int(ps.count_matches_device(hs)) == int(c_exp.sum())
    launch = ps._cache_get("launch", hs)
    assert isinstance(launch, tpw.PairLaunch)
    plan = ps._plan(hs)
    live = [list(e) for e in plan if e[2] > 0]
    assert launch.live.tolist() == live and len(live) < len(plan)
    assert launch.table.dtype == torch.int32 and launch.table.tolist() == live
    assert all(x.is_contiguous() for x in launch.operands) and launch.block == 8
    assert int(ps.count_matches_device(hs)) == int(c_exp.sum())
    assert (ps.first_matrix(hs) == f_exp).all()
    assert ps._cache_get("launch", hs) is launch
    assert ps._launch_plan(None) is ps._launch_plan(None) is not launch
    assert tpw.pair_block.uploads == 0 and tpw.pair_block.launches == 0  # the CPU sends nothing to a card
    # Blocks the plan leaves out stay -1, as do skipped ones.
    pk, lh, _, _ = ps._pack_hay(hs)
    part = tpw.plan_launch(ps._values, ps._masks, ps._ln, pk, lh, plan[1:], 8)
    got = tpw.run_launch(part)
    assert (got[:8, :8] == -1).all() and (got.numpy()[8:] == f_exp[8:]).all()
    assert int(tpw.run_launch(part, count=True)) == int((got >= 0).sum())


def test_launch_plan_does_not_alias_a_recycled_id(rng):
    """The cache is keyed by id() but holds the list itself: an entry left
    under another list's id (a freed list's address taken by a new one) is
    not handed out."""
    ws = random_words(rng, 20)
    ps = PairwiseSearcher(ws, device=CPU)
    hs1, hs2 = random_words(rng, 15), random_words(rng, 25)
    ps.count_matches_device(hs1)
    stale = ps._hay_cache[("launch", id(hs1))]
    for kind in ("launch", "pack", "plan"):
        ps._hay_cache[(kind, id(hs2))] = ps._hay_cache[(kind, id(hs1))]
    assert ps._cache_get("launch", hs2) is None
    assert int(ps.count_matches_device(hs2)) == int(oracle_matrix(ws, hs2)[0].sum())
    assert ps._cache_get("launch", hs2) is not stale[1]
    assert ps._cache_get("launch", hs2).operands[4].shape[0] == len(hs2)


def test_launch_plans_are_evicted_at_the_cap(rng):
    ps = PairwiseSearcher(random_words(rng, 10), device=CPU)
    lists = [random_words(rng, 5) for _ in range(PairwiseSearcher._HAY_CACHE_CAP)]
    for hs in lists:
        ps.count_matches_device(hs)
    assert len(ps._hay_cache) <= PairwiseSearcher._HAY_CACHE_CAP
    assert ps._cache_get("launch", lists[0]) is None and ps._cache_get("launch", lists[-1]) is not None
    assert int(ps.count_matches_device(lists[0])) == int(oracle_matrix(ps.needles, lists[0])[0].sum())


def test_cache_does_not_pin_instances():
    # No cache outlives its searcher: instances (and their device tables)
    # must be collectable after use in a long-running serving process.
    words = [b"abc", b"abcd", b"zzz", b"bcda"]
    s = PairwiseSearcher(words, device=CPU)
    s.contains_matrix()
    int(s.count_matches_device())
    ref = weakref.ref(s)
    del s
    gc.collect()
    assert ref() is None
