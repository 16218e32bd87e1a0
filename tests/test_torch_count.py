"""Overlapping counts in the port against the JAX package and the host
oracle: the count wrapper's plain version against ``batched_count_cols``
(Pallas interpret mode on the CPU) on identical tables, and ``count_in`` /
``count_all`` through both packages as tests/test_counts.py drives the JAX
one, including tables carried across by ``sliceslice_tpu_torch.interop``.
Every comparison is exact (integer counts, tolerance 0).  The CUDA count
kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu.ops.layout as jl
import sliceslice_tpu.ops.scan_kernel as jsk
import sliceslice_tpu_torch.ops.layout as tl
import sliceslice_tpu_torch.ops.scan_kernel as tsk
from sliceslice_tpu_torch import (
    BatchedSearcher,
    CudaSearcher,
    DynamicSearcher,
    MemchrSearcher,
    TorchSearcher,
    interop,
    overlapping_count,
    preprocess,
)
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.utils import tracing

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


def oracle_count(hay: bytes, nd: bytes) -> int:
    if not nd:
        return len(hay) + 1
    return sum(1 for i in range(len(hay) - len(nd) + 1) if hay[i : i + len(nd)] == nd)


def _corpus(rng, n=24_000):
    """A small-alphabet body (so short needles recur) and a tail of unique
    non-zero bytes (so a needle ending in a zero byte never really occurs)."""
    body = rng.integers(97, 101, n - 64, dtype=np.uint8)
    tail = rng.permutation(np.arange(192, 256, dtype=np.uint8))
    return np.concatenate([body, tail]).tobytes()


def _table(hay, rng, t):
    """Width-t table of needles of widths t-1 and t (the JAX kernel's width
    contract): present, absent, at the last valid position, and the tail
    plus a zero byte (which matches in the layout's zero halo one position
    past the last valid one); then five padded rows (mask 0, end 0)."""
    needles = []
    for k in range(max(1, 4 * (t - 2) + 1), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - 64 - k))
        needles += [hay[start : start + k], bytes([191]) * k, hay[-k:], hay[len(hay) - k + 1 :] + b"\0"]
    values, masks, lengths = build_probe_table(needles, t_max=t)
    values = np.pad(values, ((0, 5), (0, 0)))
    masks = np.pad(masks, ((0, 5), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lengths + 1, 0), (0, 5)).astype(np.int32)
    return needles, values, masks, ends


@pytest.mark.parametrize("t", [1, 2, 3, 8, 16])
def test_plain_count_matches_jax(t, rng):
    hay = _corpus(rng)
    kh = needed_halo_for_t(t)
    jdh = jl.preprocess(hay, kh=kh, force_cols=True)
    tdh = tl.preprocess(hay, kh=kh, force_cols=True, device=CPU)
    needles, values, masks, ends = _table(hay, rng, t)
    n = values.shape[0]
    counts = [overlapping_count(hay, nd) for nd in needles] + [0] * (n - len(needles))
    for base, n_real in ((0, None), (4096, n - 7)):
        e = np.where(ends > 0, ends + base, 0).astype(np.int32)
        ref = np.asarray(
            jsk.batched_count_cols(
                None, values, masks, e, s=jdh.s, base=base, n_real=n_real, pw=jdh.windows()
            )
        )
        got = tsk.batched_count(tdh.flat, values, masks, e, base=base, n_real=n_real)
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert np.array_equal(got.numpy(), ref), (t, base)
        real = n if n_real is None else n_real
        assert got.numpy().tolist() == counts[:real] + [0] * (n - real)


def test_zero_tail_needles_need_exact_ends(rng):
    """A needle ending in zero bytes matches in the layout's zero halo: the
    ends must stop before it, in both packages alike."""
    hay = _corpus(rng)
    needles = [hay[-3:] + b"\0", hay[-2:] + b"\0\0", b"\0"]
    values, masks, lengths = build_probe_table(needles, t_max=1)
    jdh = jl.preprocess(hay, kh=16, force_cols=True)
    tdh = tl.preprocess(hay, kh=16, force_cols=True, device=CPU)
    right = (len(hay) - lengths + 1).astype(np.int32)
    for ends, exp in ((right, [0, 0, 0]), (right + 3, [1, 1, 3])):
        ref = np.asarray(jsk.batched_count_cols(None, values, masks, ends, s=jdh.s, pw=jdh.windows()))
        got = tsk.batched_count(tdh.flat, values, masks, ends)
        assert got.tolist() == ref.tolist() == exp


def test_count_ends_clamped_and_chunk_boundaries(rng):
    """Matches planted on both sides of clamped ends and across the plain
    version's chunk steps count exactly once, as in the JAX kernel (the
    mirror of tests/test_counts.py's clean-vs-boundary segments)."""
    hay = bytearray(rng.integers(97, 100, (80_000,), dtype=np.uint8))
    nd = b"abcab"
    for p in (3, 4094, 4096, 65_533, 65_536, 40_000, len(hay) - len(nd)):
        hay[p : p + len(nd)] = nd
    hay = bytes(hay)
    jdh = jl.preprocess(hay, force_cols=True, seg_rows=64)
    tdh = tl.preprocess(hay, force_cols=True, device=CPU)
    values, masks, lengths = build_probe_table([nd, nd, b"bca"])
    for end in (len(hay) - len(nd) + 1, jdh.seg_bytes, 65_536, 65_537, 4097, 5, 0):
        ends = np.minimum(np.maximum(len(hay) - lengths + 1, 0), end).astype(np.int32)
        ref = np.asarray(jsk.batched_count_cols(None, values, masks, ends, s=jdh.s, pw=jdh.windows()))
        got = tsk.batched_count(tdh.flat, values, masks, ends)
        exp = [sum(1 for q in range(e) if hay[q : q + len(x)] == x) for x, e in
               zip((nd, nd, b"bca"), ends)]
        assert got.tolist() == ref.tolist() == exp, end


def test_cpu_count_takes_plain_and_counts_no_launch(rng):
    hay = _corpus(rng)
    dh = tl.preprocess(hay, kh=16, force_cols=True, device=CPU)
    values, masks, lengths = build_probe_table([hay[50:53], hay[9000:9008]])
    ends = (len(hay) - lengths + 1).astype(np.int32)
    before = tracing.counters()
    got = tsk.batched_count(dh.flat, values, masks, ends)
    v, m = torch.from_numpy(values.view(np.int32)), torch.from_numpy(masks.view(np.int32))
    assert torch.equal(got, tsk.batched_count_plain(dh.flat, v, m, torch.from_numpy(ends)))
    assert tracing.counters() == before


def test_count_wrapper_checks_and_other_devices():
    hay = torch.zeros(1024, dtype=torch.uint8)
    values, masks, _ = build_probe_table([b"abc"])
    ends = np.asarray([5], np.int32)
    with pytest.raises(ValueError, match="no count kernel"):
        tsk.batched_count(torch.empty(1024, dtype=torch.uint8, device="meta"), values, masks, ends)
    with pytest.raises(ValueError, match="int32"):
        tsk.batched_count(hay, values, masks, ends, base=-1)
    with pytest.raises(ValueError, match="uint8"):
        tsk.batched_count(hay.to(torch.int32), values, masks, ends)
    with pytest.raises(ValueError, match="width"):
        tsk.batched_count(hay, np.zeros((1, 513), np.uint32), np.zeros((1, 513), np.uint32), ends)
    with pytest.raises(ValueError, match="same rows"):
        tsk.batched_count(hay, values, masks, np.asarray([5, 6], np.int32))


def test_overlapping_count_host_oracle():
    assert overlapping_count(b"aaaa", b"aa") == 3
    assert overlapping_count(b"abababa", b"aba") == 3
    assert overlapping_count(b"abc", b"") == 4
    assert overlapping_count(b"", b"x") == 0


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 12, 17, 40])
def test_count_in_matches_jax(rng, k):
    hay = bytes(rng.integers(97, 101, (40_000,), dtype=np.uint8))
    nd = bytes(hay[137 : 137 + k])
    exp = oracle_count(hay, nd)
    ref = jst.DynamicSearcher(nd).count_in(jst.preprocess(hay, force_cols=True))
    s = DynamicSearcher(nd, device=CPU)
    assert s.count_in(preprocess(hay, force_cols=True, device=CPU)) == ref == exp
    assert s.count_in(hay) == exp  # host bytes over the kernel layout
    # host-bytes path (small haystack -> host rung)
    assert s.count_in(hay[:3000]) == oracle_count(hay[:3000], nd)


def test_count_periodic_overlaps():
    hay = b"ab" * 20_000 + b"c"
    jdh = jst.preprocess(hay, force_cols=True)
    dh = preprocess(hay, force_cols=True, device=CPU)
    for nd in (b"ab", b"aba", b"abab", b"ababab", b"b", b"bc"):
        exp = oracle_count(hay, nd)
        assert DynamicSearcher(nd, device=CPU).count_in(dh) == exp, nd
    assert DynamicSearcher(b"abab", device=CPU).count_in(dh) == jst.DynamicSearcher(b"abab").count_in(jdh)
    run = b"a" * 30_000
    assert DynamicSearcher(b"aaaa", device=CPU).count_in(preprocess(run, device=CPU)) == len(run) - 3
    assert BatchedSearcher([b"a", b"aa", b"aaaa" * 3], device=CPU).count_all(run).tolist() == [
        len(run), len(run) - 1, len(run) - 11]


def test_count_trivial_and_empty():
    assert DynamicSearcher(b"", device=CPU).count_in(b"abc") == 4
    assert DynamicSearcher(b"abc", device=CPU).count_in(b"abc") == 1
    assert DynamicSearcher(b"abcd", device=CPU).count_in(b"abc") == 0
    assert DynamicSearcher(b"", device=CPU).count_in(preprocess(b"xyz", device=CPU)) == 4
    assert CudaSearcher(b"abc", device=CPU).count_in(preprocess(b"abc", device=CPU)) == 1
    assert CudaSearcher(b"abcd", device=CPU).count_in(preprocess(b"abc", keep_host=True, device=CPU)) == 0
    assert DynamicSearcher(b"", device=CPU).count_in(preprocess(b"x" * 20_000, device=CPU)) == 20_001


def test_count_searchers_agree(rng):
    """The count kernel's searchers, the host-counting TorchSearcher and a
    batch over one layout (the mirror of test_count_in_pallas_vs_batched)."""
    hay = bytes(rng.integers(97, 100, (60_000,), dtype=np.uint8))
    dh = preprocess(hay, force_cols=True, device=CPU)
    nds = [hay[11:16], hay[100:103], b"aab", hay[-40:]]
    batched = BatchedSearcher(nds, device=CPU).count_all(dh)
    for nd, c in zip(nds, batched):
        assert CudaSearcher(nd, device=CPU).count_in(dh) == TorchSearcher(nd, device=CPU).count_in(dh) == c == oracle_count(hay, nd)
    assert MemchrSearcher(b"c", device=CPU).count_in(dh) == hay.count(b"c")
    before = tracing.counters()
    assert MemchrSearcher(b"b", device=CPU).count_in(hay) == hay.count(b"b")
    assert tracing.counters() == before  # CPU: the plain version


def test_count_all_words_matches_jax(words, i386_small, rng):
    idx = rng.integers(0, len(words), (60,))
    needles = [words[int(i)] for i in idx] + [b"", b"e", i386_small[500:504], i386_small[-20:]]
    exp = np.array([oracle_count(i386_small, nd) for nd in needles], dtype=np.int64)
    ref = jst.BatchedSearcher(needles).count_all(jst.preprocess(i386_small, kh=24, force_cols=True))
    dh = preprocess(i386_small, kh=24, force_cols=True, device=CPU)
    bs = BatchedSearcher(needles, device=CPU)
    got = bs.count_all(dh)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref) and np.array_equal(got, exp)
    dev = bs.count_all_device(dh)
    assert dev.dtype == torch.int32 and dev.shape == (len(needles),)
    bs.optimize_for(dh)  # reschedules rows on the device; counts unchanged
    assert any(g._host_perm_pending is not None for g in bs.groups)
    assert np.array_equal(bs.count_all(dh), exp)
    assert np.array_equal(bs.count_all(i386_small), exp)


def test_count_all_flat_rung_and_errors(rng):
    hay = bytes(rng.integers(97, 101, (3000,), dtype=np.uint8))
    needles = [b"ab", b"", hay[5:9], b"zz"]
    exp = [oracle_count(hay, nd) for nd in needles]
    bs = BatchedSearcher(needles, device=CPU)
    assert bs.count_all(hay).tolist() == exp  # flat layout: host count
    assert bs.count_all(hay).tolist() == jst.BatchedSearcher(needles).count_all(hay).tolist()
    assert bs.count_all(preprocess(hay, force_cols=True, device=CPU)).tolist() == exp
    with pytest.raises(ValueError, match="tiled layout"):
        bs.count_all_device(hay)
    bare = preprocess(hay, keep_host=False, device=CPU)
    with pytest.raises(ValueError, match="requires host bytes"):
        bs.count_all(bare)
    with pytest.raises(ValueError, match="requires host bytes"):
        DynamicSearcher(b"ab", device=CPU).count_in(bare)
    with pytest.raises(ValueError, match="requires host bytes"):
        CudaSearcher(b"abcd", device=CPU).count_in(preprocess(b"abc", keep_host=False, device=CPU))
    assert BatchedSearcher([], device=CPU).count_all(preprocess(hay, force_cols=True, device=CPU)).shape == (0,)


def test_kernel_layout_relays_the_flat_rung_on_its_device(rng):
    """The re-lay a flat rung on the card takes before it is counted: the
    kernel layout built from the device bytes alone, cached, and counted
    with no host bytes by every searcher."""
    hay = bytes(rng.integers(97, 101, (3000,), dtype=np.uint8))
    flat = preprocess(hay, keep_host=False, device=CPU)
    assert not flat.tiled
    kl = flat.kernel_layout(40)
    assert kl.tiled and kl.kh >= 40 and kl.device == flat.device and kl.host_bytes is None
    assert torch.equal(kl.flat, preprocess(hay, kh=40, force_cols=True, device=CPU).flat)
    assert flat.kernel_layout(16) is kl and kl.kernel_layout(16) is kl
    needles = [b"ab", hay[5:9], b"zz", hay[-7:], hay[-2:] + b"\0", hay[100:140]]
    exp = [oracle_count(hay, nd) for nd in needles]
    assert BatchedSearcher(needles, device=CPU).count_all(kl).tolist() == exp
    for nd, c in zip(needles, exp):
        assert DynamicSearcher(nd, device=CPU).count_in(kl) == TorchSearcher(nd, device=CPU).count_in(kl) == c


def test_count_all_on_tables_carried_from_jax(rng):
    hay = bytes(rng.integers(97, 101, (150_000,), dtype=np.uint8))
    needles = [hay[i : i + k] for i, k in
               [(120_000, 5), (10, 4), (149_990, 8), (50_000, 12), (7, 1), (90_000, 2), (3, 2)]]
    needles += [b"QQQQ", b"zzzzzz", b"ab"]
    jdh = jst.preprocess(hay, kh=16)
    jbs = jst.BatchedSearcher(needles)
    jbs.optimize_for(jdh)
    ref = jbs.count_all(jdh)
    for g in jbs.groups:
        g.sync_host()
    dh = interop.haystack(jdh.host_bytes, jdh.length, jdh.kh, jdh.tiled, device=CPU)
    carried = interop.batched_searcher(
        needles, [(g.values_host, g.masks_host, g.lengths, g.indices) for g in jbs.groups], device=CPU
    )
    assert np.array_equal(carried.count_all(dh), ref)
    assert ref.tolist() == [oracle_count(hay, nd) for nd in needles]
