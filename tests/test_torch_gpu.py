"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors, and the main path against
``bytes.find``.  Exact comparisons.

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

from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops import scan_kernel
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
