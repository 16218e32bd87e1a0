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
    TorchSearcher,
    overlapping_count,
    preprocess,
)
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import pairwise, scan_kernel, torch_backend
from sliceslice_tpu_torch.ops.scan_math import table_bits
from sliceslice_tpu_torch.scripts import kernel_probe, pair_cases
from sliceslice_tpu_torch.searcher import _host_positions

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


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
        before = scan_kernel.batched_find.launches
        got = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
        assert scan_kernel.batched_find.launches == before + 1
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
    before = scan_kernel.match_bitmap_counted.launches
    words, counts, chunk = scan_kernel.match_bitmap_counted(dh.flat, v, m, e, base=base, n_real=n_real)
    assert scan_kernel.match_bitmap_counted.launches == before + 1
    again = scan_kernel.match_bitmap_counted(dh.flat, v, m, e, base=base, n_real=n_real)
    plain = scan_kernel.match_bitmap_counted_plain(dh.flat, v, m, e, base=base, n_real=n_real)
    for other in (again, plain):
        assert torch.equal(words, other[0]) and torch.equal(counts, other[1]) and chunk == other[2]
    for cap in CAPS:
        before = scan_kernel.compact_positions.launches
        got = scan_kernel.compact_positions(words, counts, chunk, cap)
        assert scan_kernel.compact_positions.launches == before + 1
        ref = scan_kernel.compact_positions_plain(words, counts, chunk, cap)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), cap
    return words, counts.sum(dim=0, dtype=torch.int32)


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
            before = scan_kernel.memchr_find.launches
            got = scan_kernel.memchr_find(dh.flat, byte, end, base)
            assert scan_kernel.memchr_find.launches == before + 1
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
    before = scan_kernel.batched_find.launches
    assert np.array_equal(bs.find_all(dh), exp)
    assert scan_kernel.batched_find.launches == before + len(bs.groups)
    bs.optimize_for(dh)
    assert np.array_equal(bs.find_all(dh), exp)


def test_dynamic_arms_on_card(cuda):
    hay = _hay(5, 100_000)
    big = preprocess(hay, device=cuda)
    small = preprocess(hay[:5000], device=cuda)
    before = scan_kernel.memchr_find.launches
    for k in (1, 2, 7, 16, 17, 40, 300):
        for nd in (hay[5000 : 5000 + k], hay[-k:], b"\x01" * k):
            for h, data in ((big, hay), (small, hay[:5000])):
                f = data.find(nd)
                assert DynamicSearcher(nd, device=cuda).find(h) == (None if f < 0 else f)
    assert scan_kernel.memchr_find.launches > before


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
        before = scan_kernel.batched_count.launches
        got = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real)
        assert scan_kernel.batched_count.launches == before + 1
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
    before = scan_kernel.batched_count.launches
    assert np.array_equal(bs.count_all(dh), exp)
    assert scan_kernel.batched_count.launches == before + len(bs.groups)
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
    before = scan_kernel.batched_count.launches
    assert bs.count_all(flat).tolist() == exp
    assert bs.count_all_device(flat).cpu().tolist() == exp
    assert scan_kernel.batched_count.launches == before + 2 * len(bs.groups)
    for nd, c in zip(needles, exp):
        before = scan_kernel.batched_count.launches
        assert DynamicSearcher(nd, device=cuda).count_in(flat) == c
        assert scan_kernel.batched_count.launches == before + 1
        assert TorchSearcher(nd, device=cuda).count_in(flat) == c
        assert scan_kernel.batched_count.launches == before + 1


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
    before = pairwise.pair_block.launches
    got = pairwise.pair_block(*args)
    count = pairwise.pair_block(*args, count=True)
    assert pairwise.pair_block.launches == before + 2
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
    before = pairwise.pair_block.launches
    got, again = pairwise.pair_block(*args), pairwise.pair_block(*args)
    cnt, cnt2 = pairwise.pair_block(*args, count=True), pairwise.pair_block(*args, count=True)
    assert pairwise.pair_block.launches == before + 4
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
        launches, uploads = pairwise.pair_block.launches, pairwise.pair_block.uploads
        totals = [ps.count_matches_device(hay) for _ in range(32)]
        assert pairwise.pair_block.launches == launches + 32
        assert pairwise.pair_block.uploads == uploads
        assert {int(x) for x in totals} == {exp}
        assert np.array_equal(ps.contains_matrix(hay).sum(), exp)
        assert pairwise.pair_block.uploads == uploads


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
            before = kernel_probe.probe.launches
            got = kernel_probe.probe(variant, dh.flat, v, m, e, n_real=600, rows=rows)
            assert kernel_probe.probe.launches == before + 1
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
    return scan_kernel.match_bitmap_counted.launches, scan_kernel.compact_positions.launches


def test_positions_on_card(cuda):
    """Positions of card layouts: i386 words before and after
    optimize_for, both tiers, one bitmap and one compaction launch per
    width group (all 4,585 words, one launch batch each), every
    DynamicSearcher arm, and a flat layout kept without host bytes,
    scanned by the kernels on the card."""
    hay = open(os.path.join(DATA, "i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(DATA, "words.txt"), "rb").read().split(b"\n") if w]
    sample = words[::29] + [b"e", b"", hay[-3:] + b"\0"]
    dh = preprocess(hay, kh=24, device=cuda)
    bs = BatchedSearcher(sample, device=cuda)
    exp = [_host_positions(hay, w).tolist() for w in sample]
    b0, c0 = _launches()
    assert [p.tolist() for p in bs.positions_all(dh)] == exp
    assert _launches() == (b0 + len(bs.groups), c0 + len(bs.groups))
    bs.optimize_for(dh)
    assert [p.tolist() for p in bs.positions_all(dh, batch=7, sparse_cap=64)] == exp
    full = BatchedSearcher(words, device=cuda)
    b0, c0 = _launches()
    got = full.positions_all(dh)
    assert _launches() == (b0 + len(full.groups), c0 + len(full.groups)) and len(full.groups) == 6
    assert [len(p) for p in got] == full.count_all(dh).tolist()
    for nd in (b"", b"e", b"the", hay[-9:], b"Protected Mode", hay[-2:] + b"\0"):
        assert DynamicSearcher(nd, device=cuda).positions(dh).tolist() == _host_positions(hay, nd).tolist()
    small = _hay(11, 3000)
    flat = preprocess(small, keep_host=False, device=cuda)
    assert not flat.tiled
    for nd in (small[100:103], b"a", small[-5:], small[-2:] + b"\0", b"\x7f\x7f"):
        b0, c0 = _launches()
        assert DynamicSearcher(nd, device=cuda).positions(flat).tolist() == _host_positions(small, nd).tolist()
        assert _launches() == (b0 + 1, c0 + 1)
        assert TorchSearcher(nd, device=cuda).positions(flat).tolist() == _host_positions(small, nd).tolist()
        assert _launches() == (b0 + 1, c0 + 1)
    got = BatchedSearcher([b"a", small[7:12]], device=cuda).positions_all(flat)
    assert [p.tolist() for p in got] == [_host_positions(small, nd).tolist() for nd in (b"a", small[7:12])]


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
    return (scan_kernel.batched_count.launches, scan_kernel.match_bitmap_counted.launches,
            scan_kernel.compact_positions.launches)


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
    cases = [(present, dh, hay, "host", (1, 1, 1)), (absent, dh, hay, "host", (1, 1, 1)),
             (b"a" * 4096, pdh, period, "dense", (1, 1, 0)), (b"a" * 3000 + b"c", pdh, period, "dense", (1, 1, 0))]
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
