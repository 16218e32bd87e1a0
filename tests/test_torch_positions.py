"""All-occurrence positions in the port against the JAX package and the
host oracle — the mirror of tests/test_positions.py, on the same inputs:
``DynamicSearcher.positions`` / ``find_iter``, ``positions_all``, the
compact tier and the match bitmap (decoded: the port's bitmap is linear,
the JAX one laid out by lane, so offsets are compared, never words).  The
port runs its CPU path (the match-bitmap kernel's plain version); the JAX
package its plain-XLA positions path.  Every comparison is exact.  The CUDA
match-bitmap kernel itself is held against the plain version on the card
by tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu.ops.xla_backend as jxb
import sliceslice_tpu.searcher as jsearcher
import sliceslice_tpu_torch.ops.scan_kernel as tsk
from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, TorchSearcher, preprocess
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import torch_backend
from sliceslice_tpu_torch.searcher import _host_positions
from sliceslice_tpu_torch.utils import tracing
from sliceslice_tpu_torch.utils import native

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


def oracle(hay: bytes, nd: bytes) -> list:
    """Every overlapping offset, by a scan of every position."""
    if not nd:
        return list(range(len(hay) + 1))
    return [i for i in range(len(hay) - len(nd) + 1) if hay[i : i + len(nd)] == nd]


def both(hay, nd, jdh, tdh) -> list:
    """The port's and the JAX package's positions, required equal."""
    got = DynamicSearcher(nd, device=CPU).positions(tdh)
    ref = jst.DynamicSearcher(nd).positions(jdh)
    assert got.dtype == np.int64
    assert got.tolist() == ref.tolist(), nd
    return got.tolist()


def test_host_positions_oracle_shapes():
    assert _host_positions(b"aaaa", b"aa").tolist() == [0, 1, 2]
    assert _host_positions(b"abababa", b"aba").tolist() == [0, 2, 4]
    assert _host_positions(b"abc", b"").tolist() == [0, 1, 2, 3]
    assert _host_positions(b"", b"x").size == 0
    for hay, nd in ((b"aaaa", b"aa"), (b"abababa", b"aba"), (b"abc", b""), (b"", b"x")):
        assert _host_positions(hay, nd).tolist() == jsearcher._host_positions(hay, nd).tolist()


@pytest.mark.parametrize("nd", [b"a", b"ab", b"aa", b"abcde", b"0123456789abcdef!", b"zzqx"])
def test_positions_short_host_path(nd):
    hay = (b"abcde" * 400) + (b"a" * 37)  # < SHORT_HAY_BYTES
    got = DynamicSearcher(nd, device=CPU).positions(hay)
    assert got.tolist() == jst.DynamicSearcher(nd).positions(hay).tolist() == oracle(hay, nd)


@pytest.mark.parametrize("nd", [b"e", b"th", b"the", b"tion", b"register", b"interrupted"])
def test_positions_device_bitmap(i386_small, nd):
    jdh = jst.preprocess(i386_small, kh=16)
    tdh = preprocess(i386_small, kh=16, device=CPU)
    exp = oracle(i386_small, nd)
    assert both(i386_small, nd, jdh, tdh) == exp
    # count_in must agree with the number of positions
    assert DynamicSearcher(nd, device=CPU).count_in(tdh) == len(exp)


def test_positions_periodic_overlap_device(i386_small):
    hay = b"ab" * 3 + i386_small + b"a" * 64 + i386_small[: 2**12]
    jdh, tdh = jst.preprocess(hay, kh=16), preprocess(hay, kh=16, device=CPU)
    for nd in (b"aa", b"aaa", b"abab"):
        assert both(hay, nd, jdh, tdh) == oracle(hay, nd)


def test_positions_segment_boundary(i386_small):
    """The port's layout has no segments: needles straddling the offsets
    where the JAX layout's segments meet, and the last valid position,
    give the same offsets in both packages."""
    hay = i386_small * 3
    jdh = jst.preprocess(hay, kh=16, seg_rows=64)
    assert jdh.g >= 2
    tdh = preprocess(hay, kh=16, device=CPU)
    seg = jdh.seg_bytes
    for b in range(seg, len(hay), seg):
        for nd in (hay[b - 5 : b + 5], hay[b - 1 : b + 2], hay[b - 9 : b + 11]):
            assert both(hay, nd, jdh, tdh) == oracle(hay, nd)
    for k in (1, 2, 7, 13):  # the last valid position
        tail = hay[-k:]
        assert both(hay, tail, jdh, tdh) == oracle(hay, tail)


def test_positions_absent_and_empty(i386_small):
    tdh = preprocess(i386_small, kh=16, device=CPU)
    assert DynamicSearcher(b"\xff\xfe\xfd", device=CPU).positions(tdh).size == 0
    got = DynamicSearcher(b"", device=CPU).positions(tdh)
    assert got.size == len(i386_small) + 1
    assert got[0] == 0 and got[-1] == len(i386_small)
    assert got.tolist() == jst.DynamicSearcher(b"").positions(jst.preprocess(i386_small, kh=16)).tolist()


def test_find_iter_matches_positions(i386_small):
    tdh = preprocess(i386_small, kh=16, device=CPU)
    s = DynamicSearcher(b"the", device=CPU)
    assert list(s.find_iter(tdh)) == s.positions(tdh).tolist()
    assert list(s.find_iter(tdh)) == list(jst.DynamicSearcher(b"the").find_iter(jst.preprocess(i386_small, kh=16)))
    assert list(DynamicSearcher(b"", device=CPU).find_iter(b"abc")) == [0, 1, 2, 3]


def test_positions_all_batched(i386_small, words):
    nds = [w for w in words[:40] if w] + [b"", b"\xff\xfe\xfd"]
    ref = jst.BatchedSearcher(nds).positions_all(jst.preprocess(i386_small, kh=24), batch=8)
    tdh = preprocess(i386_small, kh=24, device=CPU)
    bs = BatchedSearcher(nds, device=CPU)
    res = bs.positions_all(tdh, batch=8)
    assert len(res) == len(nds)
    for nd, got, r in zip(nds, res, ref):
        assert got.dtype == np.int64
        assert got.tolist() == r.tolist() == _host_positions(i386_small, nd).tolist(), nd
    bs.optimize_for(tdh)  # reschedules rows on the device; offsets unchanged
    assert any(g._host_perm_pending is not None for g in bs.groups)
    assert [p.tolist() for p in bs.positions_all(tdh, batch=5)] == [r.tolist() for r in ref]


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_decode_match_bitmap_roundtrip(rng, decoder):
    """Random linear bitmaps -> decode -> rebuild the words, through the
    native decoder (csrc/swarscan.cpp) and the numpy fallback alike."""
    words = rng.integers(0, 2**32, (97,), dtype=np.uint32)
    words[[3, 50]] = 0
    if decoder == "native":
        if not native.available():
            pytest.skip("no C++ toolchain for the native decoder")
        pos = native.decode_bitmap(words.view(np.int32))
    else:
        pos = torch_backend.decode_match_bitmap_numpy(words.view(np.int32))
    assert pos.dtype == np.int64
    assert (np.diff(pos) > 0).all()  # strictly ascending, no dupes
    assert pos.tolist() == torch_backend.decode_match_bitmap(words).tolist()
    back = np.zeros_like(words)
    for p in pos:
        back[int(p) // 32] |= np.uint32(1) << np.uint32(int(p) % 32)
    assert (back == words).all()


def test_compact_positions_cap_edges(rng):
    """The sparse compact tier is exact at count == cap and falls back to
    the bitmap at count == cap + 1; both tiers agree with the oracle and
    with the JAX package."""
    filler = bytes(rng.integers(103, 110, (120_000,), dtype=np.uint8))
    hay = bytearray(filler)
    cap = 64
    # Plant exactly cap occurrences of one needle and cap+1 of another.
    for i in range(cap):
        p = 37 + i * 1_500
        hay[p : p + 4] = b"XYZ!"
    for i in range(cap + 1):
        p = 900 + i * 1_100
        hay[p : p + 4] = b"QRS?"
    hay = bytes(hay)
    needles = [b"XYZ!", b"QRS?", b"NOPE!", hay[5:13]]
    got = BatchedSearcher(needles, device=CPU).positions_all(preprocess(hay, force_cols=True, device=CPU), sparse_cap=cap)
    ref = jst.BatchedSearcher(needles).positions_all(jst.preprocess(hay, force_cols=True), sparse_cap=cap)
    for nd, g, r in zip(needles, got, ref):
        assert g.tolist() == r.tolist() == oracle(hay, nd), nd
    assert len(got[0]) == cap and len(got[1]) == cap + 1
    # The tier split itself: the compact offsets are complete up to cap.
    vals, msks, lens = build_probe_table(needles)
    ends = (len(hay) - lens + 1).astype(np.int32)
    dh = preprocess(hay, force_cols=True, device=CPU)
    cnt, pos = torch_backend.compact_positions_batched(dh.flat, vals, msks, ends, cap)
    assert cnt.tolist() == [cap, cap + 1, 0, len(oracle(hay, hay[5:13]))]
    assert pos[0].tolist() == oracle(hay, b"XYZ!")
    assert pos[1].tolist() == oracle(hay, b"QRS?")[:cap]
    assert (pos[2] == tsk.SENTINEL).all()


def test_compact_vs_bitmap_differential(rng):
    """Randomized differential: the compact tier agrees with the bitmap
    decode for random content, needle widths, ends clamps and caps, and
    the decoded bitmap with the JAX package's."""
    for trial in range(6):
        n_bytes = int(rng.integers(20_000, 120_000))
        lo, hi = (97, 101) if trial % 2 else (0, 256)
        hay = bytes(rng.integers(lo, hi, (n_bytes,), dtype=np.uint8))
        jdh = jst.preprocess(hay, force_cols=True)
        dh = preprocess(hay, force_cols=True, device=CPU)
        needles = []
        for _ in range(5):
            k = int(rng.integers(2, 20))
            o = int(rng.integers(0, n_bytes - k))
            needles.append(hay[o : o + k])
        needles.append(b"\xff\x00ABSENT")
        vals, msks, lens = build_probe_table(needles)
        ends = np.maximum(dh.length - lens + 1, 0)
        if trial == 3:  # caller-clamped ends (streaming window clamp)
            ends = np.minimum(ends, n_bytes // 2)
        ends = ends.astype(np.int32)
        cap = int(rng.integers(4, 600))
        cnt, pos = torch_backend.compact_positions_batched(dh.flat, vals, msks, ends, cap)
        assert cnt.dtype == torch.int32 and pos.shape == (len(needles), cap)
        words = torch_backend.match_bitmap_batched(dh.flat, vals, msks, ends).numpy()
        jwords = np.asarray(jxb.match_bitmap_batched(jdh.require_cols(), vals, msks, ends, jdh.s))
        for j in range(len(needles)):
            exp = torch_backend.decode_match_bitmap(words[j])
            assert exp.tolist() == jxb.decode_match_bitmap(jwords[j], jdh.s).tolist(), (trial, j)
            assert int(cnt[j]) == exp.size, (trial, needles[j][:8])
            take = min(cap, exp.size)
            assert pos[j, :take].tolist() == exp[:take].tolist(), (trial, needles[j][:8])


def test_positions_zero_tail_needles(rng):
    """A needle ending in zero bytes matches in the layout's zero halo past
    the corpus: the ends keep it out, in both packages and both tiers."""
    body = rng.integers(97, 101, (30_000 - 64,), dtype=np.uint8)
    hay = np.concatenate([body, rng.permutation(np.arange(192, 256, dtype=np.uint8))]).tobytes()
    needles = [hay[-3:] + b"\0", hay[-2:] + b"\0\0", b"\0", hay[-1:] + b"\0" * 7, hay[-9:]]
    jdh, tdh = jst.preprocess(hay, kh=16), preprocess(hay, kh=16, device=CPU)
    for nd in needles:
        assert both(hay, nd, jdh, tdh) == oracle(hay, nd)
    for cap in (1, 4096):
        got = BatchedSearcher(needles, device=CPU).positions_all(tdh, sparse_cap=cap)
        assert [g.tolist() for g in got] == [oracle(hay, nd) for nd in needles]
    assert [oracle(hay, nd) for nd in needles] == [[], [], [], [], [len(hay) - 9]]


@pytest.mark.parametrize("t", [1, 2, 3, 8])
def test_plain_match_bitmap_matches_jax(t, rng):
    """The bitmap wrapper's plain version against the JAX
    ``match_bitmap_batched`` on identical tables, decoded, with a base and
    rows past n_real; no launch is counted on the CPU."""
    body = rng.integers(97, 101, (24_000 - 64,), dtype=np.uint8)
    hay = np.concatenate([body, rng.permutation(np.arange(192, 256, dtype=np.uint8))]).tobytes()
    needles = []
    for k in range(max(1, 4 * (t - 1) + 1), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - 64 - k))
        needles += [hay[start : start + k], hay[-k:], hay[len(hay) - k + 1 :] + b"\0", b"a" * k]
    values, masks, lengths = build_probe_table(needles, t_max=t)
    ends = np.maximum(len(hay) - lengths + 1, 0).astype(np.int32)
    jdh = jst.preprocess(hay, kh=needed_halo_for_t(t), force_cols=True)
    tdh = preprocess(hay, kh=needed_halo_for_t(t), force_cols=True, device=CPU)
    jwords = np.asarray(jxb.match_bitmap_batched(jdh.require_cols(), values, masks, ends, jdh.s))
    n = len(needles)
    before = tracing.counters()
    for base, n_real in ((0, None), (4096, n - 3)):
        e = np.where(ends > 0, ends + base, 0).astype(np.int32)
        got = tsk.match_bitmap(tdh.flat, values, masks, e, base=base, n_real=n_real)
        assert got.dtype == torch.int32 and got.shape == (n, tsk.bitmap_words(tdh.flat.numel(), t))
        real = n if n_real is None else n_real
        for j in range(n):
            exp = jxb.decode_match_bitmap(jwords[j], jdh.s).tolist() if j < real else []
            assert torch_backend.decode_match_bitmap(got[j].numpy()).tolist() == exp, (t, base, j)
    assert tracing.counters() == before


def test_positions_searchers_and_layouts(i386_small):
    """TorchSearcher (plain bitmap on the layout's device) agrees with the
    kernel searchers; a flat layout on the CPU is scanned on the host and
    needs host bytes, as in the JAX package; the bitmap wrapper refuses
    devices it has no kernel for; a huge needle's positions over a flat
    layout come from its host bytes too."""
    tdh = preprocess(i386_small, kh=16, device=CPU)
    for nd in (b"e", b"the", i386_small[-11:], b"\xfe\xfe"):
        assert TorchSearcher(nd, device=CPU).positions(tdh).tolist() == DynamicSearcher(nd, device=CPU).positions(tdh).tolist()
    small = i386_small[:3000]
    flat = preprocess(small, device=CPU)
    assert not flat.tiled
    assert DynamicSearcher(b"the", device=CPU).positions(flat).tolist() == oracle(small, b"the")
    assert BatchedSearcher([b"the", b"e"], device=CPU).positions_all(flat)[1].tolist() == oracle(small, b"e")
    bare = preprocess(small, keep_host=False, device=CPU)
    with pytest.raises(ValueError, match="requires host bytes"):
        DynamicSearcher(b"the", device=CPU).positions(bare)
    with pytest.raises(ValueError, match="requires host bytes"):
        BatchedSearcher([b"the"], device=CPU).positions_all(bare)
    values, masks, _ = build_probe_table([b"abc"])
    with pytest.raises(ValueError, match="no match-bitmap kernel"):
        tsk.match_bitmap(torch.empty(1024, dtype=torch.uint8, device="meta"), values, masks,
                         np.asarray([5], np.int32))
    # A huge needle in a batch: the flat rung on the CPU scans host bytes.
    huge = small[100:2200]
    got = BatchedSearcher([huge, b"the"], device=CPU).positions_all(flat)
    assert [p.tolist() for p in got] == [[100], oracle(small, b"the")]
