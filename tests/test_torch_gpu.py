"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, and the main paths (find, count,
the pair sweep) against ``bytes.find`` and ``overlapping_count``.  Exact
comparisons.

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
from sliceslice_tpu_torch.ops import pairwise, scan_kernel
from sliceslice_tpu_torch.ops.scan_math import table_bits

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
    version in both modes and against bytes.find; 600-byte words do not fit
    a tile's shared memory and are read in place."""
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
