"""The redesigned positions path against the JAX package on the CPU: the
bitmap wrapper's counted form (``match_bitmap_counted``: words, per-item
match counts and the chunk), the compaction wrapper
(``compact_positions``), the launch-batch plan of ``positions_all`` and the
two-tier protocol around them.  The port runs its plain versions here; the
JAX package its plain-XLA ``match_bitmap_batched`` and
``compact_positions_batched``.  Every comparison is exact.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu.ops.xla_backend as jxb
import sliceslice_tpu_torch.ops.scan_kernel as tsk
from sliceslice_tpu_torch import BatchedSearcher, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import torch_backend
from sliceslice_tpu_torch.searcher import _host_positions
from sliceslice_tpu_torch.utils import tracing

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(rng, n: int) -> bytes:
    """A 4-letter body (short needles recur, so some rows are dense) and a
    tail of unique bytes (a tail needle's only match is the last valid
    position)."""
    body = rng.integers(97, 101, n - 64, dtype=np.uint8)
    return np.concatenate([body, rng.permutation(np.arange(192, 256, dtype=np.uint8))]).tobytes()


def _needles(hay: bytes, rng, t: int) -> list:
    """Needles of the lengths of one width-t table: present, at the last
    valid position, ending in a zero byte (it also matches in the layout's
    zero halo past the corpus) and a dense run of one letter."""
    out = []
    for k in range(max(1, 4 * (t - 1) + 1), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - 64 - k))
        out += [hay[start : start + k], hay[-k:], hay[len(hay) - k + 1 :] + b"\0", b"a" * k]
    return out


@pytest.mark.parametrize("t", list(range(1, 9)) + [16])
def test_plain_bitmap_counted_matches_jax(t, rng):
    """Words, per-item counts and chunk of the plain bitmap against JAX's
    bitmap (decoded) and compact counts on identical tables: three items a
    row, ``base > 0``, rows past ``n_real`` and ends that cut a
    16-position group (7 positions short, or past the corpus)."""
    hay = _corpus(rng, 2 * tsk.BITMAP_CHUNK + 9_000)
    needles = _needles(hay, rng, t)
    values, masks, lengths = build_probe_table(needles, t_max=t)
    n = len(needles)
    ends = np.maximum(len(hay) - lengths + 1, 0)
    ends[1::3] = np.maximum(ends[1::3] - 7, 0)
    ends[2::5] += 5
    ends = ends.astype(np.int32)
    jdh = jst.preprocess(hay, kh=needed_halo_for_t(t), force_cols=True)
    tdh = preprocess(hay, kh=needed_halo_for_t(t), force_cols=True, device=CPU)
    cols = jdh.require_cols()
    jwords = np.asarray(jxb.match_bitmap_batched(cols, values, masks, ends, jdh.s))
    jcounts = np.asarray(jxb.compact_positions_batched(cols, values, masks, ends, jdh.s, 64)[0])
    before = tracing.counters()
    for base, n_real in ((0, None), (4096, n - 5)):
        e = np.where(ends > 0, ends + base, 0).astype(np.int32)
        words, counts, chunk = tsk.match_bitmap_counted(tdh.flat, values, masks, e, base=base, n_real=n_real)
        real = n if n_real is None else n_real
        n_chunks = -(-tsk.position_limit(tdh.flat.numel(), t) // chunk)
        assert chunk == tsk.BITMAP_CHUNK and n_chunks == 3
        assert words.shape == (n, tsk.bitmap_words(tdh.flat.numel(), t)) and words.dtype == torch.int32
        assert counts.shape == (n_chunks, n) and counts.dtype == torch.int32
        for j in range(n):
            exp = jxb.decode_match_bitmap(jwords[j], jdh.s) if j < real else np.zeros(0, np.int64)
            got = torch_backend.decode_match_bitmap(words[j].numpy())
            assert got.tolist() == exp.tolist(), (t, base, j)
            per_item = np.bincount(exp // chunk, minlength=n_chunks)
            assert counts[:, j].tolist() == per_item.tolist(), (t, base, j)
            assert int(counts[:, j].sum()) == (int(jcounts[j]) if j < real else 0), (t, base, j)
    assert tracing.counters() == before


@pytest.mark.parametrize("cap", [1, 7, 64, 4096])
def test_plain_compaction_matches_jax(cap, rng):
    """The compaction wrapper on the CPU against JAX
    ``compact_positions_batched``, counts and offsets, with caps that end
    inside a word and inside an item: a dense row (a quarter of all
    positions, its cap-th match planted in one bitmap word with the next
    one), a row planted every 18,000 bytes (its matches spread over four
    items), an absent row, a zero-tail row and an empty-end row."""
    hay = bytearray(_corpus(rng, 3 * tsk.BITMAP_CHUNK + 5_000))
    for p in range(1_000, len(hay) - 100, 18_000):
        hay[p : p + 6] = b"\xf0PLNT\xf1"
    # The dense row's cap-th match gets a neighbour in its own bitmap word:
    # a match in a word's last bit is taken out, so the next one is cap-th.
    while True:
        p = int(_host_positions(bytes(hay), b"a")[cap - 1])
        assert hay[p + 1] in b"abcd"  # not a planted needle
        if p % 32 < 31:
            hay[p + 1] = ord("a")
            break
        hay[p] = ord("b")
    hay = bytes(hay)
    needles = [b"a", b"\xf0PLNT\xf1", b"\xfe\xfd", hay[-3:] + b"\0", b"ab", b"abc"]
    values, masks, lengths = build_probe_table(needles, t_max=2)
    ends = np.maximum(len(hay) - lengths + 1, 0).astype(np.int32)
    ends[-1] = 0
    jdh = jst.preprocess(hay, kh=needed_halo_for_t(2), force_cols=True)
    tdh = preprocess(hay, kh=needed_halo_for_t(2), force_cols=True, device=CPU)
    jcnt, jpos = (np.asarray(x) for x in
                  jxb.compact_positions_batched(jdh.require_cols(), values, masks, ends, jdh.s, cap))
    words, item_counts, chunk = tsk.match_bitmap_counted(tdh.flat, values, masks, ends)
    before = tracing.counters()
    counts, offsets = tsk.compact_positions(words, item_counts, chunk, cap)
    assert tracing.counters() == before
    assert counts.dtype == offsets.dtype == torch.int32 and offsets.shape == (len(needles), cap)
    assert counts.tolist() == jcnt.tolist()
    assert offsets.tolist() == jpos.tolist()
    assert torch.equal(offsets, torch_backend.compact_positions_batched(tdh.flat, values, masks, ends, cap)[1])
    for j, nd in enumerate(needles[:-1]):
        exp = _host_positions(hay, nd)
        assert int(counts[j]) == exp.size
        take = min(cap, exp.size)
        assert offsets[j, :take].tolist() == exp[:take].tolist()
        assert (offsets[j, take:] == SENTINEL).all()
    dense = _host_positions(hay, b"a")
    planted = _host_positions(hay, b"\xf0PLNT\xf1")
    assert planted.size > 7 and len(set(planted[:8] // chunk)) > 1
    # The cap-th match of the dense row shares its word and its item with
    # the next match: the compaction stops inside both.
    assert dense[cap - 1] // 32 == dense[cap] // 32 and dense[cap - 1] // chunk == dense[cap] // chunk
    if cap == 7:  # the planted row's cap-th match lies inside its second item
        assert planted[cap - 1] // chunk == planted[cap] // chunk == 1


def test_compaction_item_counts_steer_ranks(rng):
    """The plain compaction reads only the words: counts and offsets do not
    depend on the item counts handed beside them, while the kernel takes
    its ranks from them (held equal to popcounts on the card)."""
    hay = _corpus(rng, tsk.BITMAP_CHUNK + 4_000)
    tdh = preprocess(hay, kh=16, force_cols=True, device=CPU)
    values, masks, lengths = build_probe_table([b"ab", b"ba", b"\xfe\xfe"])
    ends = (len(hay) - lengths + 1).astype(np.int32)
    words, item_counts, chunk = tsk.match_bitmap_counted(tdh.flat, values, masks, ends)
    assert torch.equal(item_counts, tsk.item_counts_of(words, chunk, item_counts.shape[0]))
    c1, o1 = tsk.compact_positions_plain(words, item_counts, chunk, 100)
    c2, o2 = tsk.compact_positions_plain(words, torch.zeros_like(item_counts), chunk, 100)
    assert torch.equal(c1, c2) and torch.equal(o1, o2)
    assert torch.equal(c1, item_counts.sum(dim=0, dtype=torch.int32))


def test_position_batches_plan(words):
    """The launch-batch plan as a pure function: i386's 4,585 words take one
    batch per width group; 40 rows over a 256 MiB corpus (40 x 32 MiB of
    bitmap) take two; ``batch`` caps the rows per batch when given; every
    plan covers its rows once, in order, one row at least per batch, and a
    batch's rows (bitmap, item counts and first ranks, count, int64 row
    base) fit the budget beside one window of packed offsets."""
    with open("data/i386.txt", "rb") as f:
        hay = f.read()
    dh = preprocess(hay, kh=24, device=CPU)
    bs = BatchedSearcher(words, device=CPU)
    plans = [torch_backend.position_batches(g.n, dh.flat.numel(), g.t) for g in bs.groups]
    assert [len(p) for p in plans] == [1] * len(bs.groups) and sum(g.n for g in bs.groups) == 4585
    assert [p[0] for p in plans] == [(0, g.n) for g in bs.groups]
    big = (256 << 20) + 64
    plan = torch_backend.position_batches(40, big, 16)
    assert len(plan) == 2
    for rows, batch in ((4585, 5), (2206, 7), (40, 8), (3, 8), (1, None), (0, None)):
        plan = torch_backend.position_batches(rows, dh.flat.numel(), 2, batch)
        assert [i for r in plan for i in range(*r)] == list(range(rows))
        assert all(0 < i1 - i0 <= (batch or rows) for i0, i1 in plan)
    assert torch_backend.position_batches(3, 1 << 34, 1) == [(0, 1), (1, 2), (2, 3)]
    per_row = 4 * (tsk.bitmap_words(big, 16) + 2 * -(-tsk.position_limit(big, 16) // tsk.BITMAP_CHUNK) + 3)
    window = 4 * torch_backend.window_entries()
    assert all((i1 - i0) * per_row + window <= torch_backend.POSITIONS_BUDGET_BYTES for i0, i1 in plan)


def test_positions_all_default_batch_matches_jax(i386_small, words):
    """``positions_all`` with the default batch (the budget: one launch
    batch per width group here) against JAX ``positions_all`` and the host
    scan, with a sparse cap that sends the common words to the dense
    tier."""
    nds = [w for w in words[:60] if w] + [b"e", b"th", b"", b"\xff\xfe\xfd", i386_small[-5:]]
    jdh = jst.preprocess(i386_small, kh=24)
    tdh = preprocess(i386_small, kh=24, device=CPU)
    bs = BatchedSearcher(nds, device=CPU)
    for cap in (torch_backend.SPARSE_POSITIONS_CAP, 16):
        ref = jst.BatchedSearcher(nds).positions_all(jdh, sparse_cap=cap)
        got = bs.positions_all(tdh, sparse_cap=cap)
        assert len(got) == len(nds)
        for nd, g, r in zip(nds, got, ref):
            assert g.dtype == np.int64
            assert g.tolist() == r.tolist() == _host_positions(i386_small, nd).tolist(), nd
    assert any(len(_host_positions(i386_small, nd)) > 16 for nd in nds)


@pytest.mark.parametrize("cap", [0, 1, 3, 4096])
def test_two_tier_positions_tiers(cap, rng):
    """The protocol over one batch on the CPU, with the plain versions and
    without: every row equal to the host scan whichever tier it takes
    (none, some or all rows over the cap), rows with no match empty."""
    hay = _corpus(rng, 30_000)
    needles = [b"ab", hay[100:108], b"\xfe\xfd", hay[-4:], b"abcd"]
    values, masks, lengths = build_probe_table(needles)
    ends = (len(hay) - lengths + 1).astype(np.int32)
    tdh = preprocess(hay, kh=16, force_cols=True, device=CPU)
    for plain in (False, True):
        got = torch_backend.two_tier_positions(tdh.flat, values, masks, ends, cap, plain=plain)
        assert [g.tolist() for g in got] == [_host_positions(hay, nd).tolist() for nd in needles]
        assert all(g.dtype == np.int64 for g in got)
    assert torch_backend.two_tier_positions(tdh.flat, values[:0], masks[:0], ends[:0], cap) == []


def test_compaction_wrapper_refuses_other_devices():
    """No compaction kernel for a tensor off the CPU and the card; a
    negative cap is refused before any device is touched."""
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    counts = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no compaction kernel"):
        tsk.compact_positions(meta, counts, tsk.BITMAP_CHUNK, 4)
    with pytest.raises(ValueError, match="negative"):
        tsk.compact_positions(torch.zeros((2, 8), dtype=torch.int32), counts, tsk.BITMAP_CHUNK, -1)
    values, masks, _ = build_probe_table([b"abc"])
    with pytest.raises(ValueError, match="no match-bitmap kernel"):
        tsk.match_bitmap_counted(torch.empty(1024, dtype=torch.uint8, device="meta"), values, masks,
                                 np.asarray([5], np.int32))


# -- the rank kernel's and the windowed compaction's plain versions ----------


def _ranked_table(rng):
    """A corpus of three bitmap items a row and a table of rows past the
    cap (a dense letter, a planted needle spread over the items), an absent
    row, a zero-tail row and an empty-end row, with ``n_real`` cutting two
    padded rows; the JAX package's compact counts and offsets at cap 4,096
    and its two-tier answers beside the port's plain bitmap."""
    hay = bytearray(_corpus(rng, 2 * tsk.BITMAP_CHUNK + 9_000))
    for p in range(700, len(hay) - 100, 9_000):
        hay[p : p + 5] = b"\xf0QRS\xf1"
    hay = bytes(hay)
    needles = [b"a", b"\xf0QRS\xf1", b"\xfe\xfd", hay[-3:] + b"\0", b"ab", b"cab", b"dd", b"b"]
    values, masks, lengths = build_probe_table(needles, t_max=2)
    values, masks = np.pad(values, ((0, 2), (0, 0))), np.pad(masks, ((0, 2), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lengths + 1, 0), (0, 2)).astype(np.int32)
    ends[4] = 0
    jdh = jst.preprocess(hay, kh=needed_halo_for_t(2), force_cols=True)
    tdh = preprocess(hay, kh=needed_halo_for_t(2), force_cols=True, device=CPU)
    n_real = len(needles)
    words, item_counts, chunk = tsk.match_bitmap_counted(tdh.flat, values, masks, ends, n_real=n_real)
    cols = jdh.require_cols()
    jxb_rows = (values[:n_real], masks[:n_real], ends[:n_real])
    jcnt, jpos = (np.asarray(x) for x in jxb.compact_positions_batched(cols, *jxb_rows, jdh.s, 4096))
    jtwo = jxb.two_tier_positions(cols, *jxb_rows, jdh.s, 16)
    return hay, needles, (tdh, values, masks, ends), (words, item_counts, chunk), (jcnt, jpos, jtwo)


@pytest.fixture(scope="module")
def ranked():
    return _ranked_table(np.random.default_rng(77))


@pytest.mark.parametrize("cap", [0, 1, 7, 4096])
def test_plain_ranks_match_jax(cap, ranked):
    """The plain rank function: each row's count (the JAX compact count;
    0 past ``n_real``), each item's first rank (the exclusive cumsum of
    the JAX bitmap's per-item matches), and the SENTINEL tail it writes
    into the capped offsets (the JAX offsets' own tail), the head left as
    it was; no launch is counted on the CPU."""
    hay, needles, _, (words, item_counts, chunk), (jcnt, jpos, _) = ranked
    n, n_real = words.shape[0], len(needles)
    before = tracing.counters()
    offsets = torch.full((n, cap), -5, dtype=torch.int32)
    counts, first = tsk.item_ranks(item_counts, offsets)
    assert tracing.counters() == before
    assert counts.dtype == first.dtype == torch.int32 and first.shape == item_counts.shape
    assert counts.tolist() == jcnt.tolist() + [0] * (n - n_real)
    assert torch.equal(tsk.item_ranks_plain(item_counts)[0], counts)
    for j in range(n):
        exp = _host_positions(hay, needles[j]) if j < n_real and j != 4 else np.zeros(0, np.int64)
        per_item = np.bincount(exp // chunk, minlength=item_counts.shape[0])
        assert first[:, j].tolist() == (np.cumsum(per_item) - per_item).tolist(), j
        take = min(cap, exp.size)
        assert (offsets[j, :take] == -5).all() and (offsets[j, take:] == SENTINEL).all(), j
        if j < n_real and cap == jpos.shape[1]:
            assert ((offsets[j] == SENTINEL).numpy() == (jpos[j] == SENTINEL)).all(), j
    assert max(jcnt) > 4096 and min(jcnt) == 0


@pytest.mark.parametrize("cap", [0, 1, 7, 4096])
def test_plain_capped_window_matches_jax(cap, ranked):
    """Capped mode of the plain windowed compaction after the plain ranks:
    the JAX ``compact_positions_batched`` offsets at every cap, rows over
    the cap cut at it, empty and padded rows all SENTINEL; the capped
    wrapper ``compact_positions`` the same."""
    _, needles, (tdh, values, masks, ends), (words, item_counts, chunk), _ = ranked
    n_real = len(needles)
    jdh = jst.preprocess(tdh.host_bytes, kh=needed_halo_for_t(2), force_cols=True)
    jcnt, jpos = (np.asarray(x) for x in jxb.compact_positions_batched(
        jdh.require_cols(), values[:n_real], masks[:n_real], ends[:n_real], jdh.s, cap))
    offsets = torch.empty((words.shape[0], cap), dtype=torch.int32)
    counts, first = tsk.item_ranks(item_counts, offsets)
    before = tracing.counters()
    assert tsk.compact_window(words, item_counts, first, chunk, offsets, cap=cap) is offsets
    assert tracing.counters() == before
    assert counts[:n_real].tolist() == jcnt.tolist()
    assert offsets[:n_real].tolist() == jpos.tolist()
    assert (offsets[n_real:] == SENTINEL).all()
    wrapped = tsk.compact_positions(words, item_counts, chunk, cap)
    assert torch.equal(wrapped[0], counts) and torch.equal(wrapped[1], offsets)


def test_plain_packed_window_matches_jax(ranked):
    """Packed mode: every row's offsets in one buffer, row after row, equal
    to the JAX two tiers' answers joined in row order; any window of it is
    the same slice of that buffer, including windows that start and end
    inside a row and inside a bitmap word."""
    _, needles, _, (words, item_counts, chunk), (jcnt, _, jtwo) = ranked
    counts, first = tsk.item_ranks(item_counts)
    cnt = counts.numpy().astype(np.int64)
    row_base = torch.from_numpy(np.cumsum(cnt) - cnt)
    total = int(cnt.sum())
    whole = torch.empty((total,), dtype=torch.int32)
    tsk.compact_window(words, item_counts, first, chunk, whole, row_base=row_base, window=(0, total))
    assert whole.tolist() == np.concatenate(jtwo).tolist()
    dense_end = int(cnt[0])
    for lo, hi in ((0, 0), (3, 3 + 31), (dense_end - 5, dense_end + 7), (total - 9, total), (0, total)):
        part = torch.full((hi - lo,), -1, dtype=torch.int32)
        tsk.compact_window(words, item_counts, first, chunk, part, row_base=row_base, window=(lo, hi))
        assert part.tolist() == whole[lo:hi].tolist(), (lo, hi)


def test_forced_rank_windows_split_rows(ranked, monkeypatch):
    """A budget of a few offsets per window: ``two_tier_positions`` packs
    the batch in many windows, one compaction call each, a dense row split
    across several, and answers as the JAX two tiers and the host scan."""
    hay, needles, (tdh, values, masks, ends), _, (jcnt, _, jtwo) = ranked
    n_real = len(needles)
    monkeypatch.setattr(torch_backend, "POSITIONS_BUDGET_BYTES", 4 * torch_backend.WINDOW_SHARE * 997)
    assert torch_backend.window_entries() == 997
    windows = []
    total = int(jcnt.sum())
    for plain, name in ((False, "compact_window"), (True, "compact_window_plain")):
        windows.clear()
        real = getattr(tsk, name)

        def compact(*args, real=real, **kw):
            windows.append(kw["window"])
            return real(*args, **kw)

        with monkeypatch.context() as m:
            m.setattr(tsk, name, compact)
            got = torch_backend.two_tier_positions(tdh.flat, values[:n_real], masks[:n_real],
                                                   ends[:n_real], 16, plain=plain)
        assert [g.tolist() for g in got] == [j.tolist() for j in jtwo]
        assert [g.tolist() for g in got[:4]] == [_host_positions(hay, nd).tolist() for nd in needles[:4]]
        assert windows == [(lo, min(lo + 997, total)) for lo in range(0, total, 997)]
        assert sum(hi <= jcnt[0] for _, hi in windows) > 3  # the dense row 0 spans several windows
        assert any(lo < jcnt[0] < hi for lo, hi in windows)  # one window holds rows 0 and 1


def test_positions_protocol_on_i386_small_and_period_one(i386_small, words):
    """``two_tier_positions`` and ``positions_all`` over i386-small and a
    period-1 corpus (every position a match of ``a``, ``aa``, ...): every
    row exact against ``_host_positions`` and the JAX two tiers and
    ``positions_all`` at caps 0 and the default."""
    period = b"a" * 70_000
    for hay, nds in ((i386_small, [w for w in words[:40] if w] + [b"e", b" ", b"\xfe\xfd"]),
                     (period, [b"a", b"aa", b"a" * 7, b"a" * 13, b"ab", b"b"])):
        jdh = jst.preprocess(hay, kh=24, force_cols=True)
        tdh = preprocess(hay, kh=24, force_cols=True, device=CPU)
        values, masks, lengths = build_probe_table(nds)
        ends = np.maximum(len(hay) - lengths + 1, 0).astype(np.int32)
        exp = [_host_positions(hay, nd).tolist() for nd in nds]
        ref = jxb.two_tier_positions(jdh.require_cols(), values, masks, ends, jdh.s, 64)
        assert [r.tolist() for r in ref] == exp
        got = torch_backend.two_tier_positions(tdh.flat, values, masks, ends, 64)
        assert [g.tolist() for g in got] == exp and all(g.dtype == np.int64 for g in got)
        for cap in (0, torch_backend.SPARSE_POSITIONS_CAP):
            jall = jst.BatchedSearcher(nds).positions_all(jdh, sparse_cap=cap)
            tall = BatchedSearcher(nds, device=CPU).positions_all(tdh, sparse_cap=cap)
            assert [g.tolist() for g in tall] == [r.tolist() for r in jall] == exp, cap
    assert len(exp[0]) == len(period) and len(exp[1]) == len(period) - 1


def test_rank_and_window_wrappers_refuse_bad_operands():
    """The rank and compaction wrappers refuse a device they have no kernel
    for, a call in neither or both modes, a negative cap, a window that is
    not a range, and an output of the wrong shape; ``two_tier_positions``
    refuses a negative cap, as the JAX package does."""
    meta = torch.empty((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no rank kernel"):
        tsk.item_ranks(meta)
    words = torch.zeros((2, 8), dtype=torch.int32)
    counts = torch.zeros((1, 2), dtype=torch.int32)
    base = torch.zeros((2,), dtype=torch.int64)
    out = torch.empty((2, 4), dtype=torch.int32)
    chunk = tsk.BITMAP_CHUNK
    with pytest.raises(ValueError, match="capped mode"):
        tsk.compact_window(words, counts, counts, chunk, out)
    with pytest.raises(ValueError, match="capped mode"):
        tsk.compact_window(words, counts, counts, chunk, out, cap=4, row_base=base)
    with pytest.raises(ValueError, match="negative"):
        tsk.compact_window(words, counts, counts, chunk, out, cap=-1)
    with pytest.raises(ValueError, match="not a range"):
        tsk.compact_window(words, counts, counts, chunk, out, row_base=base, window=(5, 2))
    with pytest.raises(ValueError, match="shape"):
        tsk.compact_window(words, counts, counts, chunk, out, cap=3)
    with pytest.raises(ValueError, match="item counts"):
        tsk.compact_window(words, counts[:, :1], counts, chunk, out, cap=4)
    with pytest.raises(ValueError, match="no compaction kernel"):
        tsk.compact_window(words.to("meta"), counts.to("meta"), counts.to("meta"), chunk, out.to("meta"), cap=4)
    values, masks, _ = build_probe_table([b"abc"])
    flat = preprocess(b"abcabc" * 1000, kh=16, force_cols=True, device=CPU).flat
    with pytest.raises(ValueError, match="negative"):
        torch_backend.two_tier_positions(flat, values, masks, np.asarray([5998], np.int32), -1)
