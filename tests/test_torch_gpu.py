"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, and the main paths (find, count,
positions, the pair sweep) against ``bytes.find``, ``overlapping_count``
and the host positions oracle.  Exact comparisons.

Every test here carries the ``gpu`` marker and skips without a CUDA card;
the card's presence is decided inside the ``cuda`` fixture, never at
import.  This file imports neither jax nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from sliceslice_tpu_torch import (
    BatchedSearcher,
    DynamicSearcher,
    PairwiseSearcher,
    StreamingScanner,
    TorchSearcher,
    overlapping_count,
    preprocess,
)
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import pairwise, scan_kernel, torch_backend
from sliceslice_tpu_torch.ops.scan_math import table_bits
from sliceslice_tpu_torch.scripts import contract_cases, kernel_probe, pair_cases
from sliceslice_tpu_torch.searcher import _host_positions
from sliceslice_tpu_torch.utils import streaming, tracing

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _n(name: str) -> int:
    """The program's counter ``name`` (``utils/tracing.py``)."""
    return tracing.counters().get(name, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _hay(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    body = rng.integers(97, 101, n - 128, dtype=np.uint8)
    return np.concatenate([body, rng.permutation(np.arange(128, 256, dtype=np.uint8))]).tobytes()


@pytest.mark.parametrize("t", list(range(1, 9)) + [16, 32, 512])
def test_find_kernel_equals_plain(cuda, t):
    rng = np.random.default_rng(t)
    hay = _hay(t, 300_000)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    needles = []
    for k in range(max(1, 4 * t - 9), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles += [hay[start : start + k], b"\x7f" * k, hay[-k:]]
    vals, msks, lens = build_probe_table(needles, t_max=t)
    vals, msks = np.pad(vals, ((0, 4), (0, 0))), np.pad(msks, ((0, 4), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 4)).astype(np.int32)
    n = vals.shape[0]
    for base, n_real in ((0, n), (1 << 20, n - 6)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        v, m = table_bits(vals, cuda), table_bits(msks, cuda)
        before = _n("launches.batched_find")
        got = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
        assert _n("launches.batched_find") == before + 1
        plain = scan_kernel.batched_find_plain(dh.flat, v, m, e, base=base, n_real=n_real)
        assert torch.equal(got, plain), (t, base)
        exp = [hay.find(nd) for nd in needles[:n_real]]
        exp = [SENTINEL if f < 0 else f + base for f in exp]
        exp += [SENTINEL] * (n - len(exp))
        assert got.cpu().tolist() == exp


def _queue_cases(hay: bytes, t: int):
    """Needles of a width-t table whose answers the work queue makes hard:
    the only match in the last chunk, an absent needle, a match ending at
    the corpus's last byte, one ending in zero bytes (it also matches in
    the zero halo, which the ends must cut), and all-zero needles."""
    k = 4 * t
    tail = hay[-k:]
    return [tail, bytes([1]) * k, hay[-k - 5 : -5], hay[len(hay) - k + 1 :] + b"\0", b"\0" * k,
            hay[: k]]


#: Compaction caps the card tests run: inside a word, inside an item, the
#: default.
CAPS = (1, 7, 64, 4096)


def _check_positions_kernels(dh, v, m, e, base=0, n_real=None):
    """The bitmap kernel (words, item counts, chunk) and the compaction
    kernel at every cap against their plain versions on one table, each
    launch counted; two bitmap launches give the same answers.  Returns the
    kernel's words and row totals."""
    before = _n("launches.match_bitmap_counted")
    words, counts, chunk = scan_kernel.match_bitmap_counted(dh.flat, v, m, e, base=base, n_real=n_real)
    assert _n("launches.match_bitmap_counted") == before + 1
    again = scan_kernel.match_bitmap_counted(dh.flat, v, m, e, base=base, n_real=n_real)
    plain = scan_kernel.match_bitmap_counted_plain(dh.flat, v, m, e, base=base, n_real=n_real)
    for other in (again, plain):
        assert torch.equal(words, other[0]) and torch.equal(counts, other[1]) and chunk == other[2]
    for cap in CAPS:
        before = _rank_launches()
        got = scan_kernel.compact_positions(words, counts, chunk, cap)
        assert _rank_launches() == (before[0] + 1, before[1] + 1)
        ref = scan_kernel.compact_positions_plain(words, counts, chunk, cap)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), cap
    _check_packed_windows(words, counts, chunk)
    return words, counts.sum(dim=0, dtype=torch.int32)


def _rank_launches():
    return _n("launches.item_ranks"), _n("launches.compact_window")


def rank_windows(total: int) -> list:
    """Windows of packed ranks to test: all of them at once, thirds, and
    the first and last 20 windows of 7 and of 1,000 (windows that cut rows
    and bitmap words)."""
    out = {(0, total)}
    for step in (7, 1000, max(total // 3, 1)):
        starts = list(range(0, total, step))
        out.update((lo, min(lo + step, total)) for lo in starts[:20] + starts[-20:])
    return sorted(out)


def _check_packed_windows(words, item_counts, chunk):
    """The rank kernel and the packed compaction against their plain
    versions, each window of ``rank_windows`` also against the same slice
    of the whole packed buffer; a window launches once, an empty one
    never."""
    before = _rank_launches()
    counts, first = scan_kernel.item_ranks(item_counts)
    assert _rank_launches() == (before[0] + 1, before[1])
    ref = scan_kernel.item_ranks_plain(item_counts)
    assert torch.equal(counts, ref[0]) and torch.equal(first, ref[1])
    cnt = counts.cpu().numpy().astype(np.int64)
    row_base = torch.from_numpy(np.cumsum(cnt) - cnt).to(words.device)
    whole = None
    for lo, hi in rank_windows(int(cnt.sum())):
        got = torch.full((hi - lo,), -1, dtype=torch.int32, device=words.device)
        n0 = _n("launches.compact_window")
        scan_kernel.compact_window(words, item_counts, first, chunk, got, row_base=row_base, window=(lo, hi))
        assert _n("launches.compact_window") == n0 + (hi > lo)
        exp = torch.full_like(got, -2)
        scan_kernel.compact_window_plain(words, item_counts, first, chunk, exp, row_base=row_base,
                                         window=(lo, hi))
        assert torch.equal(got, exp), (lo, hi)
        whole = got if lo == 0 and hi == int(cnt.sum()) else whole
    for lo, hi in rank_windows(int(cnt.sum())):
        part = torch.empty((hi - lo,), dtype=torch.int32, device=words.device)
        scan_kernel.compact_window(words, item_counts, first, chunk, part, row_base=row_base, window=(lo, hi))
        assert torch.equal(part, whole[lo:hi]), (lo, hi)


def _check_queue_kernels(cuda, hay, dh, needles, t, ends, base=0, n_real=None):
    """Find, count, bitmap and compaction kernels against their plain
    versions and the host oracles on one table; two launches give the same
    answers, and the bitmap's row totals are the counts."""
    vals, msks, lens = build_probe_table(needles, t_max=t)
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    e = torch.from_numpy(np.asarray(ends, np.int64).astype(np.int32)).to(cuda)
    got = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
    assert torch.equal(got, scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real))
    assert torch.equal(got, scan_kernel.batched_find_plain(dh.flat, v, m, e, base=base, n_real=n_real))
    cnt = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
    assert torch.equal(cnt, scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real))
    assert torch.equal(cnt, scan_kernel.batched_count_plain(dh.flat, v, m, e, base=base, n_real=n_real))
    _, totals = _check_positions_kernels(dh, v, m, e, base, n_real)
    assert torch.equal(totals, cnt)
    return got.cpu().tolist(), cnt.cpu().tolist()


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8, 16, 32, 512])
def test_queue_kernels_hard_cases(cuda, t):
    """The chunk-major queue's hard cases at every width: a match only in
    the last chunk, absent rows, one-row launches, ends inside a
    16-position group and ends at the buffer's last words (all-zero needles
    match through the zero halo up to the last position whose windows fit),
    base > 0 and n_real < n."""
    hay = _hay(50 + t, 3 * scan_kernel.COUNT_CHUNK + 1000)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    needles = _queue_cases(hay, t)
    lens = np.array([len(nd) for nd in needles])
    right = len(hay) - lens + 1
    got, cnt = _check_queue_kernels(cuda, hay, dh, needles, t, right)
    assert got == [hay.find(nd) if hay.find(nd) >= 0 else SENTINEL for nd in needles]
    assert cnt == [overlapping_count(hay, nd) for nd in needles]
    n_pos = scan_kernel.position_limit(dh.flat.numel(), t)
    for ends in (right - 7, right + 5, np.full(len(needles), n_pos - 3), np.full(len(needles), 1 << 30)):
        _check_queue_kernels(cuda, hay, dh, needles, t, ends)
    for base, n_real in ((4096, len(needles) - 2), (1 << 20, 1)):
        _check_queue_kernels(cuda, hay, dh, needles, t, np.where(right > 0, right + base, 0), base, n_real)
    for nd in needles:  # one-row launches
        f, c = _check_queue_kernels(cuda, hay, dh, [nd], t, [len(hay) - len(nd) + 1])
        assert f == [hay.find(nd) if hay.find(nd) >= 0 else SENTINEL] and c == [overlapping_count(hay, nd)]


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_register_tables_equal_shared_tables(cuda, t):
    """The registers-table instantiations (t <= 4) against the
    shared-memory one on the same rows: a width-t table padded with a
    mask-0 fifth slot describes the same needles and takes T = 0."""
    hay = _hay(60 + t, 200_000)
    dh = preprocess(hay, kh=needed_halo_for_t(5), device=cuda)
    rng = np.random.default_rng(t)
    needles = [hay[s : s + k] for k in range(4 * t - 3, 4 * t + 1)
               for s in rng.integers(0, len(hay) - k, 8)] + _queue_cases(hay, t)
    vals, msks, lens = build_probe_table(needles, t_max=t)
    ends = torch.from_numpy((len(hay) - lens + 1).astype(np.int32)).to(cuda)
    pad = ((0, 0), (0, 5 - t))
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    v5, m5 = table_bits(np.pad(vals, pad), cuda), table_bits(np.pad(msks, pad), cuda)
    assert torch.equal(scan_kernel.batched_find(dh.flat, v, m, ends), scan_kernel.batched_find(dh.flat, v5, m5, ends))
    assert torch.equal(scan_kernel.batched_count(dh.flat, v, m, ends),
                       scan_kernel.batched_count(dh.flat, v5, m5, ends))
    assert scan_kernel.batched_count(dh.flat, v, m, ends).cpu().tolist() == [overlapping_count(hay, nd) for nd in needles]


def test_one_row_spreads_over_a_large_corpus(cuda):
    """One row over 64 MiB: absent (every chunk scanned), present only in
    the last chunk, and counted; the queue gives the row many more chunks
    than the span plan's 13 blocks."""
    n = 64 << 20
    arr = np.random.default_rng(8).integers(0, 200, n, dtype=np.uint8)
    arr[n - 20 : n - 12] = np.frombuffer(b"\xf0\xf1\xf2\xf3\xf4\xf5\xf6\xf7", np.uint8)
    hay = arr.tobytes()
    dh = preprocess(arr, kh=64, device=cuda)
    assert scan_kernel.plan_queue(dh.flat.numel(), 2, 1, 1 << 20, scan_kernel.COUNT_CHUNK).n_chunks > 13
    for nd in (b"\xf0\xf1\xf2\xf3\xf4\xf5\xf6\xf7", b"\xff\xfe\xfd", b"\xf7"):
        f, c = _check_queue_kernels(cuda, hay, dh, [nd], max(1, -(-len(nd) // 4)), [n - len(nd) + 1])
        assert f == [hay.find(nd) if hay.find(nd) >= 0 else SENTINEL] and c == [overlapping_count(hay, nd)]


def test_memchr_kernel_equals_plain(cuda):
    hay = _hay(3, 5_000_000)
    dh = preprocess(hay, device=cuda)
    for byte in (97, 128, 255, 0):
        for end, base in ((len(hay), 0), (len(hay) // 2, 0), (len(hay) + 99, 99)):
            before = _n("launches.memchr_find")
            got = scan_kernel.memchr_find(dh.flat, byte, end, base)
            assert _n("launches.memchr_find") == before + 1
            plain = scan_kernel.memchr_find_plain(dh.flat, byte, end, base)
            f = hay.find(bytes([byte]), 0, end - base)
            assert int(got) == int(plain) == (SENTINEL if f < 0 else f + base)


def test_kernel_refuses_misaligned_haystack(cuda):
    flat = torch.zeros(4096 + 16, dtype=torch.uint8, device=cuda)
    vals, msks, _ = build_probe_table([b"abc"])
    with pytest.raises(ValueError, match="16-byte"):
        scan_kernel.batched_find(flat[1:4097], vals, msks, np.asarray([5], np.int32))
    with pytest.raises(ValueError, match="16-byte"):
        scan_kernel.batched_count(flat[1:4097], vals, msks, np.asarray([5], np.int32))
    with pytest.raises(ValueError, match="16-byte"):
        scan_kernel.memchr_find(flat[:4095], 97, 10)


def test_i386_sweep_on_card(cuda):
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(words, device=cuda)
    exp = np.array([hay.find(w) for w in words])
    before = _n("launches.batched_find")
    assert np.array_equal(bs.find_all(dh), exp)
    assert _n("launches.batched_find") == before + len(bs.groups)
    bs.optimize_for(dh)
    assert np.array_equal(bs.find_all(dh), exp)


def test_dynamic_arms_on_card(cuda):
    hay = _hay(5, 100_000)
    big = preprocess(hay, device=cuda)
    small = preprocess(hay[:5000], device=cuda)
    before = _n("launches.memchr_find")
    for k in (1, 2, 7, 16, 17, 40, 300):
        for nd in (hay[5000 : 5000 + k], hay[-k:], b"\x01" * k):
            for h, data in ((big, hay), (small, hay[:5000])):
                f = data.find(nd)
                assert DynamicSearcher(nd, device=cuda).find(h) == (None if f < 0 else f)
    assert _n("launches.memchr_find") > before


@pytest.mark.parametrize("t", list(range(1, 9)) + [16, 32, 512])
def test_count_kernel_equals_plain(cuda, t):
    rng = np.random.default_rng(100 + t)
    hay = _hay(t, 300_000)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    needles = []
    for k in range(max(1, 4 * t - 9), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        # present, absent, at the last position, and ending in a zero byte
        # that would match in the layout's zero halo past the last position
        needles += [hay[start : start + k], b"\x7f" * k, hay[-k:], hay[len(hay) - k + 1 :] + b"\0"]
    vals, msks, lens = build_probe_table(needles, t_max=t)
    vals, msks = np.pad(vals, ((0, 4), (0, 0))), np.pad(msks, ((0, 4), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 4)).astype(np.int32)
    n = vals.shape[0]
    exp_all = [overlapping_count(hay, nd) for nd in needles] + [0] * 4
    for base, n_real in ((0, n), (4096, n - 6)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        v, m = table_bits(vals, cuda), table_bits(msks, cuda)
        before = _n("launches.batched_count")
        got = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
        assert _n("launches.batched_count") == before + 1
        plain = scan_kernel.batched_count_plain(dh.flat, v, m, e, base=base, n_real=n_real)
        assert torch.equal(got, plain), (t, base)
        assert got.cpu().tolist() == exp_all[:n_real] + [0] * (n - n_real)


def test_i386_counts_on_card(cuda):
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    sample = words[::23]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(sample, device=cuda)
    exp = np.array([overlapping_count(hay, w) for w in sample])
    before = _n("launches.batched_count")
    assert np.array_equal(bs.count_all(dh), exp)
    assert _n("launches.batched_count") == before + len(bs.groups)
    bs.optimize_for(dh)
    assert np.array_equal(bs.count_all(dh), exp)
    for nd in (b"e", b"the", hay[-9:], b"\xfe\xfe"):
        assert DynamicSearcher(nd, device=cuda).count_in(dh) == overlapping_count(hay, nd)


def test_flat_layout_counts_on_card(cuda):
    """A flat rung on the card, kept without host bytes, is counted by the
    count kernel: re-laid on the card, never counted on the host."""
    hay = _hay(9, 3000)
    flat = preprocess(hay, keep_host=False, device=cuda)
    assert not flat.tiled
    needles = [hay[100:103], b"a", hay[-5:], hay[-2:] + b"\0", b"\x7f\x7f", hay[7:40]]
    exp = [overlapping_count(hay, nd) for nd in needles]
    bs = BatchedSearcher(needles, device=cuda)
    before = _n("launches.batched_count")
    assert bs.count_all(flat).tolist() == exp
    assert bs.count_all_device(flat).cpu().tolist() == exp
    assert _n("launches.batched_count") == before + 2 * len(bs.groups)
    for nd, c in zip(needles, exp):
        before = _n("launches.batched_count")
        assert DynamicSearcher(nd, device=cuda).count_in(flat) == c
        assert _n("launches.batched_count") == before + 1
        assert TorchSearcher(nd, device=cuda).count_in(flat) == c
        assert _n("launches.batched_count") == before + 1


def _words(rng, count, max_len, alpha=(97, 100)):
    return [bytes(rng.integers(*alpha, int(rng.integers(0, max_len + 1)), dtype=np.uint8))
            for _ in range(count)] + [b""]


@pytest.mark.parametrize("max_len,block,count", [(64, 512, 300), (14, 16, 300), (600, 64, 40)])
def test_pair_kernel_equals_plain(cuda, max_len, block, count):
    """Random word sets with the empty word: the kernel against its plain
    version in both modes and against bytes.find; 600-byte words are rows of
    more than 16 32-bit words, past the loads a thread starts together."""
    rng = np.random.default_rng(max_len)
    ws = sorted(_words(rng, count, max_len), key=len)
    hs = _words(rng, 2 * count // 3, max_len + 8)
    ps = PairwiseSearcher(ws, block=block, device=cuda)
    hay, lh, _, _ = ps._pack_hay(hs)
    args = (ps._values, ps._masks, ps._ln, hay, lh, ps._plan(hs), block)
    before = _n("launches.pair_block")
    got = pairwise.pair_block(*args)
    count = pairwise.pair_block(*args, count=True)
    assert _n("launches.pair_block") == before + 2
    assert torch.equal(got, pairwise.pair_block_plain(*args))
    assert int(count) == int(pairwise.pair_block_plain(*args, count=True)) == int((got >= 0).sum())
    exp = np.array([[h.find(n) for h in hs] for n in ws], dtype=np.int32)
    assert np.array_equal(got.cpu().numpy(), exp)


@pytest.mark.parametrize("name", [c.name for c in pair_cases.cases()])
def test_pair_kernel_hard_cases(cuda, name):
    """The pair kernel's hard cases (tiles in both directions, lengths on
    the plan's buckets, needles equal to their words, empty and 1-byte
    needles, rows and tables longer than the unrolled loads, unsorted lists,
    skipped blocks, padded rows): both modes against the plain version and
    bytes.find, two launches alike."""
    case = next(c for c in pair_cases.cases() if c.name == name)
    args, exp = pair_cases.operands(case, cuda)
    plain = pairwise.pair_block_plain(*args)
    assert np.array_equal(plain.cpu().numpy(), exp)
    before = _n("launches.pair_block")
    got, again = pairwise.pair_block(*args), pairwise.pair_block(*args)
    cnt, cnt2 = pairwise.pair_block(*args, count=True), pairwise.pair_block(*args, count=True)
    assert _n("launches.pair_block") == before + 4
    assert torch.equal(got, plain) and torch.equal(got, again)
    assert int(cnt) == int(cnt2) == int((exp >= 0).sum())


def test_pair_launch_plan_is_uploaded_once(cuda):
    """After the first sweep of a haystack list, count_matches_device is one
    launch and no plan upload; another list gets its own plan."""
    rng = np.random.default_rng(5)
    ws = sorted(pair_cases.random_words(rng, 300, 12), key=len)
    hs = pair_cases.random_words(rng, 200, 15)
    ps = PairwiseSearcher(ws, block=64, device=cuda)
    for hay, words in ((None, ws), (hs, hs)):
        exp = sum(h.find(n) >= 0 for n in ws for h in words)
        assert int(ps.count_matches_device(hay)) == exp
        launches, uploads = _n("launches.pair_block"), _n("uploads.pair_block")
        totals = [ps.count_matches_device(hay) for _ in range(32)]
        assert _n("launches.pair_block") == launches + 32
        assert _n("uploads.pair_block") == uploads
        assert {int(x) for x in totals} == {exp}
        assert np.array_equal(ps.contains_matrix(hay).sum(), exp)
        assert _n("uploads.pair_block") == uploads


def test_pair_kernel_padded_rows_never_match(cuda):
    ws = [b"", b"ab", b"b"]
    vals, msks, _ = build_probe_table(ws, t_max=2)
    vals, msks = np.pad(vals, ((0, 1), (0, 0))), np.pad(msks, ((0, 1), (0, 0)))
    ln = torch.tensor([0, 2, 1, 1 << 30], dtype=torch.int32, device=cuda)
    arr, lens = pairwise.pack_words([b"ab", b"", b"zzb"], 12)
    lh = torch.from_numpy(np.append(lens, -1).astype(np.int32)).to(cuda)
    hay = torch.from_numpy(np.pad(arr, ((0, 1), (0, 0)))).to(cuda)
    args = (table_bits(vals, cuda), table_bits(msks, cuda), ln, hay, lh, [(0, 0, 2, 4)], 8)
    got = pairwise.pair_block(*args)
    assert torch.equal(got, pairwise.pair_block_plain(*args))
    assert got.cpu().tolist() == [[0, 0, 0, -1], [0, -1, -1, -1], [1, -1, 2, -1], [-1, -1, -1, -1]]


def test_pairwise_searcher_on_card(cuda):
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    ws = sorted(words[::9], key=len)
    ps = PairwiseSearcher(ws, device=cuda)
    exp = np.array([[h.find(n) for h in ws] for n in ws], dtype=np.int32)
    assert np.array_equal(ps.first_matrix(), exp)
    assert np.array_equal(ps.contains_matrix(), exp >= 0)
    assert int(ps.count_matches_device()) == int((exp >= 0).sum())


def test_pair_kernel_refuses_bad_operands(cuda):
    ps = PairwiseSearcher([b"ab", b"abc"], device=cuda)
    hay, lh, _, _ = ps._pack_hay(None)
    with pytest.raises(ValueError, match="4-byte aligned"):
        flat = torch.zeros(hay.numel() + 4, dtype=torch.uint8, device=cuda)
        pairwise.pair_block(ps._values, ps._masks, ps._ln, flat[1 : 1 + hay.numel()].view(hay.shape),
                            lh, ps._plan(None), ps.block)
    with pytest.raises(ValueError, match="outside"):
        pairwise.pair_block(ps._values, ps._masks, ps._ln, hay, lh, [(0, 0, ps.tn + 1, 4)], ps.block)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 16])
def test_match_bitmap_kernel_equals_plain(cuda, t):
    """The bitmap and compaction kernels against their plain versions and
    the host positions: present, absent, last-position, zero-tail and dense
    needles, base > 0 and n_real < n, every cap."""
    rng = np.random.default_rng(200 + t)
    hay = _hay(t, 300_000)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    needles = []
    for k in range(max(1, 4 * t - 9), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles += [hay[start : start + k], b"\x7f" * k, hay[-k:], hay[len(hay) - k + 1 :] + b"\0"]
    needles.append(b"a" * max(1, 4 * t - 3))  # dense in the 4-letter body
    vals, msks, lens = build_probe_table(needles, t_max=t)
    vals, msks = np.pad(vals, ((0, 4), (0, 0))), np.pad(msks, ((0, 4), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 4)).astype(np.int32)
    n = vals.shape[0]
    for base, n_real in ((0, n), (4096, n - 6)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        v, m = table_bits(vals, cuda), table_bits(msks, cuda)
        got, _ = _check_positions_kernels(dh, v, m, e, base, n_real)
        assert torch.equal(got, scan_kernel.match_bitmap(dh.flat, v, m, e, base=base, n_real=n_real))
        words = got.cpu().numpy()
        for i, nd in enumerate(needles):
            exp = _host_positions(hay, nd) if i < n_real else np.zeros(0, np.int64)
            assert torch_backend.decode_match_bitmap(words[i]).tolist() == exp.tolist(), (t, i)



#: Masks of the exotic rows of ``_group_table``: mask-0, non-prefix and
#: partial slots beside full ones.
EXOTIC_MASKS = np.array([0, 0xFFFF0000, 0x00FF00FF, 0xFF, 0xFFFFFF, 0xFFFFFFFF], np.uint32)


def _group_table(hay: bytes, t: int, rows: int = 41):
    """uint32 ``(values, masks)`` and int32 ``ends`` of ``rows`` width-t rows
    whose groups of 8 hold the group walk's hard cases: one needle on two
    neighbouring rows whose ends fall just before and just after one of its
    matches (a slot-0 hit past one row's limit but inside the other's);
    1-byte ``a`` (a slot-0 hit in most 16-position groups, its later slots
    mask-0) and a dense needle; needles of every length of the width
    (partial final, and for t = 1 partial slot-0, masks) present, absent,
    at the last position and ending in a zero byte; rows of random masks
    from ``EXOTIC_MASKS`` per slot, valued from a corpus window so that
    they match; padded rows (mask 0, end 0) last."""
    rng = np.random.default_rng(900 + t)
    k = 4 * t
    p = int(rng.integers(len(hay) // 2, len(hay) - 2 * k))
    needles = [hay[p : p + k], hay[p : p + k], b"a", b"a" * max(2, k - 3)]
    for n in range(max(1, k - 3), k + 1):
        s = int(rng.integers(0, len(hay) - n))
        needles += [hay[s : s + n], b"\x7f" * n, hay[-n:], hay[len(hay) - n + 1 :] + b"\0"]
    vals, msks, lens = build_probe_table(needles, t_max=t)
    ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int64)
    ends[0], ends[1] = p, p + 1  # p is a match of rows 0 and 1; row 0 stops just before it
    n_exotic = max(0, rows - 3 - len(needles))
    xm = EXOTIC_MASKS[rng.integers(0, len(EXOTIC_MASKS), (n_exotic, t))]
    at = rng.integers(0, len(hay) - k, n_exotic)
    win = np.frombuffer(b"".join(hay[a : a + k] for a in at), np.uint32).reshape(n_exotic, t)
    vals = np.concatenate([vals, win & xm])[: rows - 3]
    msks = np.concatenate([msks, xm])[: rows - 3]
    ends = np.concatenate([ends, np.full(n_exotic, len(hay) - k + 1)])[: rows - 3]
    pad = ((0, rows - len(vals)), (0, 0))
    return np.pad(vals, pad), np.pad(msks, pad), np.pad(ends, pad[0]).astype(np.int32)


def _row_counters() -> tuple:
    """The row counters of the count and bitmap wrappers, in one tuple."""
    return tuple(_n(f"{rows}.{w}") for rows in ("tiled_rows", "single_rows", "two_slot_rows")
                 for w in ("batched_count", "match_bitmap_counted"))


def _walk_rows(t: int, grouped: tuple, single: tuple) -> tuple:
    """What ``_row_counters`` gains from the (count, bitmap) rows
    ``grouped`` launched 8 an item and ``single`` one an item, of width-t
    tables: the two-slot filter's rows are every row of a table of 5 to 8
    slots."""
    two = (0, 0)
    if scan_kernel.MAX_REG_T < t <= scan_kernel.MAX_GROUP_T:
        two = tuple(a + b for a, b in zip(grouped, single))
    return (*grouped, *single, *two)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 7, 8, 512])
def test_group_walk_equals_plain(cuda, monkeypatch, t):
    """The count and bitmap kernels' group walk against their plain
    versions on ``_group_table``'s 41 rows over 2 MiB at a chunk of 4,096
    (so that the launch groups 8 rows an item where t <= 8, and
    ``tiled_rows.<wrapper>`` counts them, with ``two_slot_rows.<wrapper>``
    where t is 5 to 8; wider tables take one row an item), at base 0 and
    base > 0 with n_real < n, a match in the buffer's last 16-position group
    among them; then one-row launches, which never group."""
    for name in ("COUNT_CHUNK", "BITMAP_CHUNK"):
        monkeypatch.setattr(scan_kernel, name, scan_kernel.WIDE_TILE)
    hay = _hay(950 + t, 2 << 20)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    vals, msks, ends = _group_table(hay, t)
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    n = vals.shape[0]
    grouped = t <= scan_kernel.MAX_GROUP_T
    for base, n_real in ((0, n), (1 << 20, n - 5)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        before = _row_counters()
        got = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
        assert torch.equal(got, scan_kernel.batched_count_plain(dh.flat, v, m, e, base=base, n_real=n_real))
        assert int(got[0]) + 1 == int(got[1]) and int(got[2]) > len(hay) // 8, got[:3]
        _check_positions_kernels(dh, v, m, e, base, n_real)
        made = tuple(a - b for a, b in zip(_row_counters(), before))
        rows = (n_real, 2 * n_real)
        assert made == _walk_rows(t, rows if grouped else (0, 0), (0, 0) if grouped else rows), (t, base)
    e = torch.from_numpy(ends).to(cuda)
    before = _row_counters()
    singles = (0, 1, 2, 5, n - 4)
    for row in singles:  # one-row launches
        args = (dh.flat, v[row : row + 1], m[row : row + 1], e[row : row + 1])
        assert torch.equal(scan_kernel.batched_count(*args), scan_kernel.batched_count_plain(*args))
        words, counts, chunk = scan_kernel.match_bitmap_counted(*args)
        plain = scan_kernel.match_bitmap_counted_plain(*args)
        assert torch.equal(words, plain[0]) and torch.equal(counts, plain[1]) and chunk == plain[2]
    made = tuple(a - b for a, b in zip(_row_counters(), before))
    assert made == _walk_rows(t, (0, 0), (len(singles), len(singles)))


def _acgt_decoys(t: int, n: int = 2 << 20):
    """A four-letter text of ``n`` bytes (i.i.d. ACGT, so a 4-byte window
    passes one slot once in 256 windows) and width-t needles for the
    two-slot filter: a needle ``d`` of 4t bytes with 5 more exact copies
    planted and 60 decoys that keep its slots 0 and 1 (its first 8 bytes)
    but change one byte of a later slot; needles of every length of the
    width cut from the text; short needles padded into the wide table, so
    that slot 0 or slot 1 is partial or mask 0 (1, 4, 5, 6, 7 and 8
    bytes); the text's last 4t bytes; an absent needle; 16 more needles of
    4t bytes cut from the text, so that 8-row groups fill the card.
    Returns the text and the needles, ``d`` first."""
    rng = np.random.default_rng(2400 + t)
    body = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    k = 4 * t
    at = rng.choice(np.arange(1, n // 256 - 2) * 256, 66, replace=False)
    d = body[at[0] : at[0] + k].copy()
    for a in at[1:6]:
        body[a : a + k] = d
    for a in at[6:]:
        body[a : a + k] = d
        i = int(rng.integers(8, k))
        body[a + i] = b"ACGT"[(b"ACGT".index(int(d[i])) + 1) % 4]
    hay = body.tobytes()
    needles = [bytes(d)]
    for size in range(k - 3, k + 1):
        s = int(rng.integers(0, n - size))
        needles.append(hay[s : s + size])
    for size in (1, 4, 5, 6, 7, 8):
        s = int(rng.integers(0, n - size))
        needles.append(hay[s : s + size])
    needles += [hay[-k:], b"ACGT" * (t - 1) + b"TTTT", b"\x7f" * k]
    needles += [hay[s : s + k] for s in rng.integers(0, n - k, 16)]
    return hay, needles


@pytest.mark.parametrize("t", [5, 6, 7, 8])
def test_two_slot_filter_on_a_four_letter_text(cuda, monkeypatch, t):
    """The two-slot filter of tables of 5 to 8 slots, grouped (8 rows an
    item at a chunk of 4,096) and one row an item: on ``_acgt_decoys``'
    text, where slot 0 passes a window in 256 and 60 planted sites pass
    slots 0 and 1 but fail a later slot, ``batched_count`` and
    ``match_bitmap_counted`` equal their plain versions and the needles'
    ``overlapping_count``, with partial and mask-0 slots 0 and 1, a match
    in the buffer's last 16-position group, base > 0 and n_real < n; each
    launch counts its rows as tiled or single, and as two-slot rows."""
    for name in ("COUNT_CHUNK", "BITMAP_CHUNK"):
        monkeypatch.setattr(scan_kernel, name, scan_kernel.WIDE_TILE)
    hay, needles = _acgt_decoys(t)
    d = 0
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    vals, msks, lens = build_probe_table(needles, t_max=t)
    vals, msks = np.pad(vals, ((0, 3), (0, 0))), np.pad(msks, ((0, 3), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 3)).astype(np.int32)
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    n = vals.shape[0]
    assert (msks[:, 0] != 0xFFFFFFFF).any() and (msks[:, 1] != 0xFFFFFFFF).any()
    assert (msks[:, 1] == 0).any()
    want = [overlapping_count(hay, nd) for nd in needles]
    assert want[d] == 6 and want[11] >= 1 and want[13] == 0
    for base, n_real in ((0, n), (1 << 20, n - 5)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        assert scan_kernel._queue_plan(scan_kernel.COUNT, dh.flat, t, n_real).group == 8
        before = _row_counters()
        got = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
        assert torch.equal(got, scan_kernel.batched_count_plain(dh.flat, v, m, e, base=base, n_real=n_real))
        live = min(n_real, len(needles))
        assert got.tolist()[:live] == want[:live] and not any(got.tolist()[live:])
        _, totals = _check_positions_kernels(dh, v, m, e, base, n_real)
        assert torch.equal(totals, got)
        made = tuple(a - b for a, b in zip(_row_counters(), before))
        assert made == _walk_rows(t, (n_real, 2 * n_real), (0, 0)), base
    e = torch.from_numpy(ends).to(cuda)
    before = _row_counters()
    singles = (d, 1, 5, 11, 13)  # d, k - 3 bytes, 1 byte, the text's end, absent
    for row in singles:
        args = (dh.flat, v[row : row + 1], m[row : row + 1], e[row : row + 1])
        got = scan_kernel.batched_count(*args)
        assert torch.equal(got, scan_kernel.batched_count_plain(*args)) and int(got[0]) == want[row]
        words, counts, chunk = scan_kernel.match_bitmap_counted(*args)
        plain = scan_kernel.match_bitmap_counted_plain(*args)
        assert torch.equal(words, plain[0]) and torch.equal(counts, plain[1]) and chunk == plain[2]
    made = tuple(a - b for a, b in zip(_row_counters(), before))
    assert made == _walk_rows(t, (0, 0), (len(singles), len(singles)))


def test_i386_count_groups_every_narrow_row(cuda):
    """All 4,585 i386 words counted in one ``count_all``: every answer
    ``overlapping_count``'s, and every row of a width group of t <= 3
    (4,492 rows) taken by a launch that groups rows; the bitmap kernel on
    each width group's table equals its plain version."""
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(words, device=cuda)
    bs.optimize_for(dh)
    tiled = _n("tiled_rows.batched_count")
    assert bs.count_all(dh).tolist() == [overlapping_count(hay, w) for w in words]
    narrow = sum(g.n for g in bs.groups if g.t <= 3)
    assert narrow == 4492 and _n("tiled_rows.batched_count") - tiled >= narrow
    for g in bs.groups:
        args = (dh.flat, g.values_dev, g.masks_dev, g.ends_dev(dh.length), 0, g.n)
        words_, counts, _ = scan_kernel.match_bitmap_counted(*args)
        plain = scan_kernel.match_bitmap_counted_plain(*args)
        assert torch.equal(words_, plain[0]) and torch.equal(counts, plain[1]), g.t


def _delta(before: dict, name: str) -> int:
    return _n(name) - before.get(name, 0)


def test_dna_guides_counted_on_card_equal_the_kmer_reference(cuda):
    """The ``dna200m-count`` cell's path at 8 MiB: 512 guides of 20 bytes
    (one width group of t = 5) counted by ``count_all`` on the card equal
    ``portbench/reference_dna.py`` on the card, from one count launch that
    groups its 512 rows 8 an item (``tiled_rows.batched_count``) behind
    the two-slot filter (``two_slot_rows.batched_count``).  An i386 sweep
    then still groups its 4,492 rows of t <= 3, walks its other 93 alone
    (``single_rows.batched_count``) and filters its 4 rows of t = 5 and 6
    on two slots."""
    import json

    from portbench import reference_dna, spec

    cfg = json.loads((spec.HERE / "configs" / "dna200m-20mers.json").read_text())
    cfg = dict(cfg, corpus=dict(cfg["corpus"], bytes=8 << 20),
               repeats=dict(cfg["repeats"], families=8, max_copies=300))
    inp = spec.load_kind(cfg["kind"]).inputs(cfg, 2**32 + 23)
    assert len(inp.needles) == 512
    dh = preprocess(inp.corpus, device=cuda)
    bs = BatchedSearcher(inp.needles, device=cuda)
    assert [g.t for g in bs.groups] == [5]
    before = tracing.counters()
    got = bs.count_all(dh)
    assert [_delta(before, c) for c in ("launches.batched_count", "single_rows.batched_count",
                                        "tiled_rows.batched_count",
                                        "two_slot_rows.batched_count")] == [1, 0, 512, 512]
    want = reference_dna.count_all(inp.corpus, inp.needles, device=cuda)
    assert got.tolist() == want.tolist() and want.min() >= 1

    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    bs = BatchedSearcher(words, device=cuda)
    dh = preprocess(hay, kh=24, device=cuda)
    before = tracing.counters()
    assert bs.count_all(dh).tolist() == [overlapping_count(hay, w) for w in words]
    assert _delta(before, "tiled_rows.batched_count") == 4492
    assert _delta(before, "single_rows.batched_count") == len(words) - 4492 == 93
    assert _delta(before, "two_slot_rows.batched_count") == 4


@pytest.mark.parametrize("chunk", [4096, 65536])
def test_rank_and_compaction_kernels_equal_plain(cuda, monkeypatch, chunk):
    """The rank kernel and both compaction modes against their plain
    versions on rows of 73 chunks (carries across a warp's 32) and of 5:
    rows past every cap, absent rows, padded rows past ``n_real``; counts,
    first ranks, the SENTINEL tail at every cap with the head left as it
    was, the capped offsets and the packed windows."""
    from sliceslice_tpu_torch.ops.scan_math import position_limit

    monkeypatch.setattr(scan_kernel, "BITMAP_CHUNK", chunk)
    hay = _hay(31, 300_000)
    dh = preprocess(hay, kh=needed_halo_for_t(2), device=cuda)
    needles = [b"a", b"ab", b"\x7f\x7f", hay[-5:], b"abcd", b"dcba", hay[1000:1003]]
    vals, msks, lens = build_probe_table(needles, t_max=2)
    vals, msks = np.pad(vals, ((0, 4), (0, 0))), np.pad(msks, ((0, 4), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 4)).astype(np.int32)
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    e = torch.from_numpy(ends).to(cuda)
    n = vals.shape[0]
    words, counts, got_chunk = scan_kernel.match_bitmap_counted(dh.flat, v, m, e, n_real=len(needles) + 1)
    assert got_chunk == chunk and counts.shape == (-(-position_limit(dh.flat.numel(), 2) // chunk), n)
    for cap in (0,) + CAPS + (16_384,):
        got_off = torch.full((n, cap), -3, dtype=torch.int32, device=cuda)
        ref_off = got_off.clone()
        before = _n("launches.item_ranks")
        got = scan_kernel.item_ranks(counts, got_off)
        assert _n("launches.item_ranks") == before + 1
        ref = scan_kernel.item_ranks_plain(counts, ref_off)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and torch.equal(got_off, ref_off), cap
        got = scan_kernel.compact_positions(words, counts, got_chunk, cap)
        ref = scan_kernel.compact_positions_plain(words, counts, got_chunk, cap)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), cap
    assert int(got[0].max()) > 16_384 and int(got[0][len(needles):].sum()) == 0
    _check_packed_windows(words, counts, got_chunk)


def test_contract_tables_on_card(cuda):
    """The mixed-width, exotic-mask and prefix-mask tables of
    ``scripts/contract_cases.py`` (the first refused by the JAX package's
    ``*_cols``): the find, count, bitmap and compaction kernels, one launch
    each, equal their plain versions and the host oracles; the exotic table
    through a 2x1 sharded sweep of cells on the card too."""
    from sliceslice_tpu_torch.parallel import make_mesh, sharded_find_cols

    wrappers = ("batched_find", "batched_count", "match_bitmap_counted", "item_ranks", "compact_window")
    for case in contract_cases.cases():
        dh, v, m, e = contract_cases.operands(case, cuda)
        before = [_n("launches." + w) for w in wrappers]
        got = contract_cases.answers(dh.flat, v, m, e)
        assert [_n("launches." + w) - b for w, b in zip(wrappers, before)] == [1, 1, 1, 1, 1], case.name
        assert contract_cases.same(got, contract_cases.answers(dh.flat, v, m, e, plain=True)), case.name
        assert contract_cases.same(got, contract_cases.oracle(case)), case.name
        if case.name == "exotic_mask":
            mesh = make_mesh((2, 1), device=cuda)
            sharded = sharded_find_cols(dh, case.values, case.masks, case.ends, mesh)
            assert sharded.tolist() == [contract_cases.EXOTIC_AT]

@pytest.mark.parametrize("t", [1, 2, 3])
def test_probe_kernel_equals_plain(cuda, t):
    """Every ablation variant against its plain version on i386 tables,
    and the answer-preserving ones against the count and find kernels."""
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    values, masks = kernel_probe.make_tables(hay, t, n=600)
    ends = kernel_probe.table_ends(masks, len(hay))
    v, m = table_bits(values, cuda), table_bits(masks, cuda)
    e = torch.from_numpy(ends).to(cuda)
    count = scan_kernel.batched_count(dh.flat, v, m, e, n_real=600)
    first = scan_kernel.batched_find(dh.flat, v, m, e, n_real=600)
    for variant in kernel_probe.VARIANTS:
        for rows in (kernel_probe.ROWS if variant == "rows" else (4,)):
            before = _n("launches.probe")
            got = kernel_probe.probe(variant, dh.flat, v, m, e, n_real=600, rows=rows)
            assert _n("launches.probe") == before + 1
            plain = kernel_probe.probe_plain(variant, dh.flat, v, m, e, n_real=600, rows=rows)
            assert torch.equal(got, plain), (variant, rows)
            if variant in kernel_probe.COUNTING:
                assert torch.equal(got, count), (variant, rows)
    assert torch.equal(kernel_probe.probe("first", dh.flat, v, m, e, n_real=600), first)
    assert torch.equal(kernel_probe.probe("nomin", dh.flat, v, m, e, n_real=600),
                       (first != SENTINEL).to(torch.int32))
    if t == 2:
        for row, nd in kernel_probe.planted(hay, masks).items():
            if row < 600:
                assert int(first[row]) == hay.find(nd)
                assert int(count[row]) == overlapping_count(hay, nd)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8])
def test_probe_variants_on_real_needles(cuda, t):
    """The counting variants on needles that do occur (the harness's own
    tables never pass slot 0): present, absent, 1-byte, last-position and
    zero-tail needles, the queue's hard cases, base > 0 and n_real < n; the
    prefilter's candidates must lose no match."""
    rng = np.random.default_rng(300 + t)
    hay = _hay(70 + t, 2 * scan_kernel.COUNT_CHUNK + 777)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=cuda)
    needles = _queue_cases(hay, t)
    for k in range(max(1, 4 * t - 7), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles += [hay[start : start + k], b"\x7f" * k, hay[-k:], hay[len(hay) - k + 1 :] + b"\0",
                    b"a" * k]
    needles += [b"a", b"\0", hay[-1:]]
    vals, msks, lens = build_probe_table(needles, t_max=t)
    vals, msks = np.pad(vals, ((0, 3), (0, 0))), np.pad(msks, ((0, 3), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lens + 1, 0), (0, 3)).astype(np.int32)
    n = vals.shape[0]
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    for base, n_real in ((0, n), (4096, n - 5)):
        e = torch.from_numpy(np.where(ends > 0, ends + base, 0).astype(np.int32)).to(cuda)
        count = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
        assert count.cpu().tolist()[: len(needles)][: n_real] == [
            overlapping_count(hay, nd) for nd in needles][: n_real]
        first = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
        for variant in kernel_probe.VARIANTS:
            got = kernel_probe.probe(variant, dh.flat, v, m, e, base=base, n_real=n_real)
            if variant in kernel_probe.COUNTING:
                assert torch.equal(got, count), (variant, t, base)
            elif variant == "first":
                assert torch.equal(got, first), (t, base)
            plain = kernel_probe.probe_plain(variant, dh.flat, v, m, e, base=base, n_real=n_real)
            assert torch.equal(got, plain), (variant, t, base)
        for rows in kernel_probe.ROWS:
            got = kernel_probe.probe("rows", dh.flat, v, m, e, base=base, n_real=n_real, rows=rows)
            assert torch.equal(got, count), (rows, t, base)


def test_probe_kernel_refuses_bad_variants(cuda):
    dh = preprocess(_hay(4, 10_000), device=cuda)
    values, masks = kernel_probe.make_tables(b"", 5, n=8)
    ends = kernel_probe.table_ends(masks, 10_000)
    with pytest.raises(ValueError, match="unknown"):
        kernel_probe.probe("regtab", dh.flat, values, masks, ends)
    with pytest.raises(ValueError, match="rows"):
        kernel_probe.probe("rows", dh.flat, values, masks, ends, rows=3)
    with pytest.raises(ValueError, match="unknown"):
        kernel_probe.probe("full", dh.flat, values, masks, ends)
    with pytest.raises(ValueError, match="unknown"):
        kernel_probe.probe("wide", dh.flat, values, masks, ends)


def _launches():
    return (_n("launches.match_bitmap_counted"), _n("launches.item_ranks"),
            _n("launches.compact_window"))


def _sweep_launches(bs, exp, before):
    """The launch counts after one ``positions_all`` of ``bs`` (one launch
    batch a width group): a bitmap and a rank launch per group, and one
    compaction launch per group that holds a match."""
    live = sum(any(exp[j] for j in g.indices.tolist()) for g in bs.groups)
    return before[0] + len(bs.groups), before[1] + len(bs.groups), before[2] + live


def test_positions_on_card(cuda, monkeypatch):
    """Positions of card layouts: i386 words before and after
    optimize_for, rows past the cap and under it, one bitmap, one rank and
    one packed compaction launch per width group (all 4,585 words, one
    launch batch and one window each), every DynamicSearcher arm, and a
    flat layout kept without host bytes, scanned by the kernels on the
    card; no bitmap is decoded on the host."""
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    sample = words[::29] + [b"e", b"", hay[-3:] + b"\0"]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(sample, device=cuda)
    exp = [_host_positions(hay, w).tolist() for w in sample]
    before = _launches()
    assert [p.tolist() for p in bs.positions_all(dh)] == exp
    assert _launches() == _sweep_launches(bs, exp, before)
    bs.optimize_for(dh)
    assert [p.tolist() for p in bs.positions_all(dh, batch=7, sparse_cap=64)] == exp
    full = BatchedSearcher(words, device=cuda)
    full_exp = [_host_positions(hay, w).tolist() for w in words]
    before = _launches()
    with monkeypatch.context() as m:
        m.setattr(torch_backend, "decode_match_bitmap", None)  # nothing is decoded on the host
        got = full.positions_all(dh)
    assert _launches() == _sweep_launches(full, full_exp, before) and len(full.groups) == 6
    assert [len(p) for p in got] == full.count_all(dh).tolist()
    assert [p.tolist() for p in got] == full_exp
    assert sum(len(p) > torch_backend.SPARSE_POSITIONS_CAP for p in got) == 32
    for nd in (b"", b"e", b"the", hay[-9:], b"Protected Mode", hay[-2:] + b"\0"):
        assert DynamicSearcher(nd, device=cuda).positions(dh).tolist() == _host_positions(hay, nd).tolist()
    small = _hay(11, 3000)
    flat = preprocess(small, keep_host=False, device=cuda)
    assert not flat.tiled
    for nd in (small[100:103], b"a", small[-5:], small[-2:] + b"\0", b"\x7f\x7f"):
        before = _launches()
        assert DynamicSearcher(nd, device=cuda).positions(flat).tolist() == _host_positions(small, nd).tolist()
        made = tuple(a - b for a, b in zip(_launches(), before))
        assert made == ((1, 1, 1) if len(_host_positions(small, nd)) else (1, 1, 0)), nd
        assert TorchSearcher(nd, device=cuda).positions(flat).tolist() == _host_positions(small, nd).tolist()
        assert tuple(a - b for a, b in zip(_launches(), before)) == made
    got = BatchedSearcher([b"a", small[7:12]], device=cuda).positions_all(flat)
    assert [p.tolist() for p in got] == [_host_positions(small, nd).tolist() for nd in (b"a", small[7:12])]


def test_forced_rank_windows_on_card(cuda, monkeypatch):
    """A budget of 1,000 packed offsets a window (and so one row a launch
    batch): ``positions_all`` over i386 compacts each row in as many
    windows as its matches need, one compaction launch each, dense rows
    split across windows; every answer exact."""
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w][::80]
    words += [b"e", b"the", hay[-7:]]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(words, device=cuda)
    exp = [_host_positions(hay, w) for w in words]
    monkeypatch.setattr(torch_backend, "POSITIONS_BUDGET_BYTES", 4 * torch_backend.WINDOW_SHARE * 1000)
    assert torch_backend.window_entries() == 1000
    before = _launches()
    got = bs.positions_all(dh)
    assert [g.tolist() for g in got] == [e.tolist() for e in exp]
    windows = sum(-(-len(e) // 1000) for e in exp)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (len(words), len(words), windows)
    assert max(len(e) for e in exp) > 10_000


def test_chunk_bitmap_t128_equals_plain(cuda):
    """The dense huge-needle tier's bitmap: one t = 128 table of chunks of
    differing lengths (mask-0 padded slots), with their own ends and with
    ends cut inside the corpus, against the plain version, the host
    positions and the compaction at every cap up to 16,384; then the
    chained bitmap of huge needles against its plain version."""
    from sliceslice_tpu_torch.models.huge import HugeNeedleSearcher
    from sliceslice_tpu_torch.ops import chained

    hay = _hay(128, 400_000)
    dh = preprocess(hay, kh=needed_halo_for_t(128), device=cuda)
    chunks = [hay[1000:1512], hay[-512:], hay[5000:5300], hay[-129:], hay[70_000:70_001],
              b"\x7f" * 512, hay[len(hay) - 39 :] + b"\0", b"a" * 7]
    vals, msks, lens = build_probe_table(chunks, t_max=128)
    v, m = table_bits(vals, cuda), table_bits(msks, cuda)
    own = np.maximum(len(hay) - lens.astype(np.int64) + 1, 0)
    for ends in (own, np.maximum(own - np.arange(len(chunks)) * 5000 - 7, 0)):
        e = torch.from_numpy(ends.astype(np.int32)).to(cuda)
        words, _ = _check_positions_kernels(dh, v, m, e)
        counts, offsets = scan_kernel.compact_positions(*scan_kernel.match_bitmap_counted(dh.flat, v, m, e), 16_384)
        ref = scan_kernel.compact_positions_plain(*scan_kernel.match_bitmap_counted_plain(dh.flat, v, m, e), 16_384)
        assert torch.equal(counts, ref[0]) and torch.equal(offsets, ref[1])
        rows = words.cpu().numpy()
        for i, nd in enumerate(chunks):
            exp = _host_positions(hay, nd)
            assert torch_backend.decode_match_bitmap(rows[i]).tolist() == exp[exp < ends[i]].tolist(), i
    for nd in (hay[3000:5600], hay[-4096:], hay[-2600:-1] + b"\0", b"a" * 2100):
        plan = HugeNeedleSearcher(nd, device=cuda)._chunk_plan()
        got = chained.chained_match_bitmap(dh.flat, *plan, dh.length)
        ref = chained.chained_match_bitmap(dh.flat, *plan, dh.length, plain=True)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        exp = _host_positions(hay, nd)
        assert int(got[0]) == len(exp) and int(got[1]) == (int(exp[0]) if len(exp) else SENTINEL)


def _tier_launches():
    return (_n("launches.batched_count"), _n("launches.match_bitmap_counted"),
            _n("launches.item_ranks"), _n("launches.compact_window"))


def test_huge_tiers_on_card(cuda, monkeypatch):
    """Huge needles on the card in each tier, exact against the host
    oracles, each call with its tier's launches: the sparse tier (prefix
    count, bitmap and compaction, host verify), the dense tier (prefix
    count, one bitmap launch of the unique chunks), a flat layout on the
    card kept without host bytes (re-laid there, dense), a batch of words
    and huge needles, and the device-resident fences."""
    import sliceslice_tpu_torch.models.huge as huge

    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    dh = preprocess(hay, device=cuda)
    present = hay[200_000:204_096]
    absent = present[:2048] + b"\xff" + present[2049:]
    period = b"a" * 300_000 + b"b" + b"a" * 90_000
    pdh = preprocess(period, device=cuda)
    cases = [(present, dh, hay, "host", (1, 1, 1, 1)), (absent, dh, hay, "host", (1, 1, 1, 1)),
             (b"a" * 4096, pdh, period, "dense", (1, 1, 0, 0)),
             (b"a" * 3000 + b"c", pdh, period, "dense", (1, 1, 0, 0))]
    for nd, layout, h, tier, launches in cases:
        ds = DynamicSearcher(nd, device=cuda)
        assert ds.inner._route(layout, h)[0] == tier
        f = h.find(nd)
        for op, want in (("find", None if f < 0 else f), ("count_in", overlapping_count(h, nd)),
                         ("positions", _host_positions(h, nd).tolist())):
            before = _tier_launches()
            got = getattr(ds, op)(layout)
            assert (got.tolist() if op == "positions" else got) == want, (len(nd), op)
            assert tuple(a - b for a, b in zip(_tier_launches(), before)) == launches, (len(nd), op)
    monkeypatch.setattr(huge, "HOST_VERIFY_MAX", 0)  # force the dense tier on aperiodic text
    assert DynamicSearcher(present, device=cuda).positions(dh).tolist() == _host_positions(hay, present).tolist()
    monkeypatch.undo()
    small = hay[10_000:16_000]
    flat = preprocess(small, keep_host=False, device=cuda)
    assert not flat.tiled
    nd = small[1_000:3_200]
    assert DynamicSearcher(nd, device=cuda).find(flat) == 1_000
    assert DynamicSearcher(nd, device=cuda).count_in(flat) == 1
    mixed = BatchedSearcher([nd, small[5:9]], device=cuda)
    assert mixed.find_all(flat).tolist() == [1_000, small.find(small[5:9])]
    assert mixed.count_all(flat).tolist() == [1, overlapping_count(small, small[5:9])]
    assert [p.tolist() for p in mixed.positions_all(flat)] == [[1_000], _host_positions(small, small[5:9]).tolist()]
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w][::40]
    needles = words + [present, absent, hay[-2100:]]
    bs = BatchedSearcher(needles, device=cuda)
    assert bs.find_all(dh).tolist() == [hay.find(nd) for nd in needles]
    assert bs.count_all(dh).tolist() == [overlapping_count(hay, nd) for nd in needles]
    assert [p.tolist() for p in bs.positions_all(dh)] == [_host_positions(hay, nd).tolist() for nd in needles]
    for name in ("find_all_device", "count_all_device"):
        with pytest.raises(ValueError, match="MAX_NEEDLE_LEN"):
            getattr(bs, name)(dh)


def _stream_case(seed: int, n: int):
    """A seeded corpus of ``n`` bytes and needles over it: planted at
    window boundaries, frequent, 1-byte, absent, a zero-tailed one."""
    data = bytearray(_hay(seed, n))
    mib = 1 << 20
    plants = [data[5 * mib - 7:5 * mib + 9], data[11 * mib - 1:11 * mib + 40]]
    return bytes(data), plants + [bytes(data[100:103]), b"a", b"\xff\xfe\xfd", bytes(data[-6:])]


def test_stream_parity_at_1mib_windows_pinned(cuda, tmp_path):
    """A 16 MiB file streamed at 1 MiB windows: find (with and without
    early stop), count and positions exact, file and chunks alike, both
    pools on their side of the copy (host pinned, device on the card)."""
    data, needles = _stream_case(21, 16 << 20)
    p = tmp_path / "s.bin"
    p.write_bytes(data)
    sc = StreamingScanner(needles, window_bytes=1 << 20, device=cuda).warmup()
    assert all(t.is_pinned() for t in sc._host_q.queue)
    assert all(t.device == cuda for t in sc._dev_pool)
    made = sc.buffer_allocations
    exp = [data.find(nd) for nd in needles]
    assert sc.find_in_file(str(p), early_stop=False).tolist() == exp
    assert sc.find_in_file(str(p), early_stop=True).tolist() == exp
    assert sc.count_in_file(str(p)).tolist() == [overlapping_count(data, nd) for nd in needles]
    chunks = [data[i:i + 999_983] for i in range(0, len(data), 999_983)]
    for got in (sc.positions_in_file(str(p)), sc.positions_in_chunks(iter(chunks))):
        assert [g.tolist() for g in got] == [_host_positions(data, nd).tolist() for nd in needles]
    assert sc.find_in_chunks(iter(chunks), early_stop=False).tolist() == exp
    assert sc.buffer_allocations == made


def test_stream_windows_outnumber_the_pool(cuda):
    """A chunk stream of 40 windows through a pool of 3 host and 2 device
    buffers, at each prefetch depth: every buffer is reused many times
    while copies and kernels are in flight, and the answers stay exact."""
    data, needles = _stream_case(22, 10 << 20)
    for prefetch in (0, 1, 4):
        sc = StreamingScanner(needles, window_bytes=1 << 18, prefetch=prefetch, device=cuda)
        exp = [data.find(nd) for nd in needles]
        assert sc.find_in_chunks(iter([data]), early_stop=False).tolist() == exp
        assert sc.stats["windows"] == 40 > 3 * (max(prefetch, 1) + 2)
        assert sc.count_in_chunks(iter([data])).tolist() == [overlapping_count(data, nd) for nd in needles]
        got = sc.positions_in_chunks(iter([data]), start_offset=2**33)
        assert [g.tolist() for g in got] == [(_host_positions(data, nd) + 2**33).tolist() for nd in needles]
        assert len(sc._dev_pool) == streaming.DEVICE_BUFFERS


def test_sharded_4x1_mesh_equals_the_single_layout(cuda):
    """A 4x1 mesh of cells on the card: find, count and positions of words
    and of needles across every shard boundary equal ``BatchedSearcher``'s
    over the same layout, through the kernels."""
    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh
    from sliceslice_tpu_torch.parallel.shard_scan import shard_bytes_for

    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w][::20]
    edge = shard_bytes_for(len(hay), 4)
    needles = words + [hay[b * edge + o:b * edge + o + 10] for b in (1, 2, 3) for o in (-9, -5, -1, 0)]
    dh = preprocess(hay, kh=32, device=cuda)
    bs = BatchedSearcher(needles, device=cuda)
    sb = ShardedBatchedSearcher(needles, make_mesh((4, 1), device=cuda))
    launches = _n("launches.batched_find")
    got = sb.find_all(dh).tolist()
    assert _n("launches.batched_find") == launches + 4 * len(sb.inner.groups)
    assert got == bs.find_all(dh).tolist() == [hay.find(nd) for nd in needles]
    assert sb.count_all(dh).tolist() == bs.count_all(dh).tolist()
    assert [p.tolist() for p in sb.positions_all(dh)] == [p.tolist() for p in bs.positions_all(dh)]


def test_two_gloo_processes_on_the_card(cuda):
    """The two-process check with its cells on the card: gloo across two
    processes, each holding its half of an 8 MiB corpus as two cells."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "sliceslice_tpu_torch.scripts.multihost_check", "--device", "cuda",
         "--bytes", str(8 << 20), "--timeout", "150"],
        capture_output=True, text=True, timeout=180, cwd=os.path.dirname(DATA))
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert "2-process sharded scan parity ok" in out.stdout


def test_full_conformance_on_the_card(cuda):
    """All 4,585 words over i386 and all 21,022,225 ordered pairs of the
    length-sorted words, first offsets against bytes.find (the JAX suite's
    two full sweeps, tests/test_i386.py)."""
    from sliceslice_tpu_torch.scripts import conformance

    got = conformance.run_conformance(full=True, device=cuda)
    assert got["long_words"] == 4585 and got["short_total_checked"] == 4585 ** 2
    assert got["long_mismatches"] == 0 and got["short_mismatches"] == 0


def test_fuzz_campaign_on_the_card(cuda, capsys):
    from sliceslice_tpu_torch.scripts import fuzz_campaign

    assert fuzz_campaign.main(["2"]) == 0
    assert "MISMATCH" not in capsys.readouterr().out
