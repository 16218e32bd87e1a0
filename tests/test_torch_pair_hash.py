"""The pair hash of the count and bitmap kernels' hashed filter
(``csrc/queue.cuh`` ``pair_hash``, ``kPairHashK``; mirrored by
``ops/scan_math.py`` ``pair_hash``, ``PAIR_HASH_K``), on the CPU.

At 8 rows an item, a table of 5 to 8 slots whose slots 0 and 1 are whole
filters each position by one compare of the hash of its two windows with
the row's hash.  The filter stays exact because equal window pairs hash
equal (every match passes) and a pass is only a request for the exact
walk (a collision costs work, not an answer); on a four-letter text the
hash is one-to-one, so it passes exactly what the pair test passes.  The
kernel itself is held to the plain versions on planted collisions by
tests/test_torch_gpu.py and chip_smoke.py."""

import itertools

import numpy as np
import pytest
import torch

from sliceslice_tpu_torch import preprocess
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops.scan_math import (PAIR_HASH_K, match_spans, pair_hash,
                                                position_limit, table_bits)
from sliceslice_tpu_torch.scripts import kernel_probe as kp

CPU = "cpu"
M32 = 0xFFFFFFFF


def _words(data: bytes) -> np.ndarray:
    """uint32 little-endian 4-byte windows at every offset of ``data``."""
    a = np.frombuffer(data, np.uint8).astype(np.uint32)
    return a[:-3] | a[1:-2] << 8 | a[2:-1] << 16 | a[3:] << 24


def test_pair_hash_is_one_to_one_on_four_letter_window_pairs():
    """All 65,536 pairs of 4-byte windows over A, C, G and T hash apart."""
    w = np.array([int.from_bytes(bytes(c), "little") for c in itertools.product(b"ACGT", repeat=4)],
                 np.uint32)
    h = pair_hash(w[:, None], w[None, :])
    assert h.shape == (256, 256) and h.dtype == np.uint32
    assert len(np.unique(h)) == 65536


@pytest.mark.parametrize("form", ["int", "numpy", "torch"])
def test_pair_hash_forms_agree(rng, form):
    """The mirror's int, numpy and tensor forms give ``(a + K b) mod
    2**32``, edge words included; the tensor form as int32 bit patterns."""
    a = np.concatenate([rng.integers(0, 1 << 32, 500, dtype=np.uint64), [0, M32, 1, M32]])
    b = np.concatenate([rng.integers(0, 1 << 32, 500, dtype=np.uint64), [M32, M32, 0, 0]])
    want = [(int(x) + PAIR_HASH_K * int(y)) & M32 for x, y in zip(a, b)]
    if form == "int":
        got = [pair_hash(int(x), int(y)) for x, y in zip(a, b)]
    elif form == "numpy":
        got = pair_hash(a.astype(np.uint32).view(np.int32), b.astype(np.uint32)).tolist()
    else:
        ta, tb = (torch.from_numpy(x.astype(np.uint32).view(np.int32)) for x in (a, b))
        h = pair_hash(ta, tb)
        assert h.dtype == torch.int32
        got = h.numpy().view(np.uint32).tolist()
    assert got == want


def _collision(v0: int, v1: int) -> tuple:
    """A window pair other than ``(v0, v1)`` with the same pair hash."""
    return (v0 - PAIR_HASH_K) & M32, (v1 + 1) & M32


def test_a_built_collision_hashes_equal_and_fails_the_pair_test(rng):
    """``(v0 - K, v1 + 1)`` hashes as ``(v0, v1)`` does and fails the pair
    test, for seeded, four-letter and edge windows."""
    acgt = _words(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)].tobytes())
    pairs = [(int(x), int(y)) for x, y in rng.integers(0, 1 << 32, (200, 2), dtype=np.uint64)]
    pairs += [(int(acgt[i]), int(acgt[i + 4])) for i in range(0, 3000, 15)]
    pairs += [(0, 0), (M32, M32), (PAIR_HASH_K, M32), (0, M32)]
    for v0, v1 in pairs:
        a, b = _collision(v0, v1)
        assert pair_hash(a, b) == pair_hash(v0, v1) and a != v0


def _planted(rng, n: int = 1 << 16, k: int = 20):
    """A four-letter text of ``n`` bytes, 12 needles of ``k`` bytes cut from
    it, and, for each of the first 4, one planted copy whose first 8 bytes
    are replaced by a colliding window pair: it passes the hash and fails
    the pair test.  Returns the text and the needles."""
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    at = rng.choice(np.arange(1, n // 1024 - 1) * 1024, 16, replace=False)
    needles = [text[a : a + k].tobytes() for a in at[:12]]
    for nd, a in zip(needles[:4], at[12:]):
        v0, v1 = (int.from_bytes(nd[i : i + 4], "little") for i in (0, 4))
        c0, c1 = _collision(v0, v1)
        text[a : a + k] = np.frombuffer(c0.to_bytes(4, "little") + c1.to_bytes(4, "little") + nd[8:],
                                        np.uint8)
    return text.tobytes(), needles


def test_hash_spans_pass_planted_collisions_and_every_match(rng):
    """``kernel_probe.hash_spans`` (the hashed filter's plain column) passes
    every span the pair test passes and, on the planted text, the colliding
    copies' spans too; ``walk_shares`` reads one more step per collision in
    its hashed column than in its two-slot column."""
    hay, needles = _planted(rng)
    t = 5
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=CPU)
    values, masks, lens = build_probe_table(needles, t_max=t)
    limits = torch.from_numpy(np.clip(len(hay) - lens + 1, 0, position_limit(dh.flat.numel(), t)))
    v, m = table_bits(values, CPU), table_bits(masks, CPU)
    pair = match_spans(dh.flat, v[:, :2], m[:, :2], limits, kp.WARP_SPAN)
    hashed = kp.hash_spans(dh.flat, v, limits, kp.WARP_SPAN)
    assert (hashed >= pair).all() and (pair >= 1).all()
    assert (hashed - pair).tolist() == [1] * 4 + [0] * 8
    [(_, rows, _, _, two, hashed_steps)] = kp.walk_shares(hay, needles, CPU)
    assert rows == 12 and hashed_steps == two + 4


@pytest.mark.parametrize("seed", [0, 1, 2**33 + 7])
def test_every_exact_match_passes_the_hash(seed):
    """Every site of every needle of 17-32 bytes in a seeded text (cut
    from it, so each has one, and 8 of them from a repeated stretch) has
    the needle's pair hash at its slot-0 and slot-1 windows."""
    rng = np.random.default_rng(seed)
    hay = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1 << 15)].tobytes()
    hay = hay[:20_000] + hay[100:300] * 4 + hay[20_000:]  # repeats, so some needles recur
    w = _words(hay)
    seen = 0
    starts = np.concatenate([rng.integers(0, len(hay) - 32, 56), 20_000 + rng.integers(0, 150, 8)])
    for a in starts:
        nd = hay[a : a + int(rng.integers(17, 33))]
        want = pair_hash(int.from_bytes(nd[:4], "little"), int.from_bytes(nd[4:8], "little"))
        p = hay.find(nd)
        while p >= 0:
            assert pair_hash(int(w[p]), int(w[p + 4])) == want
            seen += 1
            p = hay.find(nd, p + 1)
    assert seen >= 64 + 8  # the last 8 needles lie in the repeat: two sites at least
