"""The port's native host helper (its own ``csrc/host/`` sources, built
into its own ``csrc/build/``): the mirror of tests/test_native.py.  SWAR,
Two-Way, the batch and all-pairs entries and the bitmap decoder, each held
to the Python oracle and to the JAX package's helper on the same inputs.
Exact."""

import numpy as np
import pytest

from sliceslice_tpu.ops.xla_backend import decode_match_bitmap_numpy as jax_decode_numpy
from sliceslice_tpu.utils import native as jnative
from sliceslice_tpu_torch import naive_find
from sliceslice_tpu_torch.ops.torch_backend import decode_match_bitmap_numpy
from sliceslice_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")


def test_swar_basic():
    hay = b"the quick brown fox jumps over the lazy dog"
    for nd, exp in ((b"quick", 4), (b"dog", hay.find(b"dog")), (b"zebra", None), (b"t", 0), (b"", 0),
                    (hay, 0)):
        assert native.swar_find(hay, nd) == exp == jnative.swar_find(hay, nd)
    assert native.swar_find(b"ab", b"abc") is None


def test_swar_positions_equivalent():
    hay = b"aaabaaabaaab" * 5
    nd = b"abaa"
    for p in range(len(nd)):
        assert native.swar_find(hay, nd, position=p) == naive_find(hay, nd) == jnative.swar_find(hay, nd, p)


def test_swar_differential(rng):
    hay = bytes(rng.integers(97, 102, (5000,), dtype=np.uint8))
    for k in [1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 40]:
        for _ in range(20):
            start = int(rng.integers(0, 5000 - k))
            nd = hay[start:start + k]
            assert native.swar_find(hay, nd) == naive_find(hay, nd)
        nd = bytes(rng.integers(0, 256, (k,), dtype=np.uint8))
        assert native.swar_find(hay, nd) == naive_find(hay, nd) == jnative.swar_find(hay, nd)


def test_swar_boundaries(rng):
    hay = bytes(rng.integers(97, 100, (257,), dtype=np.uint8))
    for k in [2, 3, 8, 9]:
        for nd in (hay[-k:], hay[-k:-1] + b"\xff"):
            assert native.swar_find(hay, nd) == naive_find(hay, nd) == jnative.swar_find(hay, nd)


def test_swar_batch(rng):
    hay = bytes(rng.integers(97, 103, (3000,), dtype=np.uint8))
    needles = [hay[i:i + k] for i, k in [(0, 3), (100, 8), (2990, 10)]] + [b"zzz", b"", hay[-1:]]
    got = native.swar_find_batch(hay, needles)
    assert (got == jnative.swar_find_batch(hay, needles)).all()
    for nd, o in zip(needles, got):
        assert (None if o < 0 else int(o)) == naive_find(hay, nd), nd


def test_swar_pairwise_matches_oracle(rng):
    words = [bytes(rng.integers(97, 100, (int(rng.integers(0, 8)),), dtype=np.uint8)) for _ in range(40)]
    got = native.swar_pairwise(words)
    assert (got == jnative.swar_pairwise(words)).all()
    for i, n in enumerate(words):
        for j, h in enumerate(words):
            assert got[i, j] == (h.find(n) >= 0), (n, h)


def test_decode_bitmap_differential(rng):
    """The linear decode (bit b of word w is offset 32w + b) equals the
    port's numpy decode and the JAX decoders on the same words laid out as
    one segment of one lane."""
    for q in (1, 16, 3 * 16 * 128):
        w = (rng.random(q) < 0.07).astype(np.uint32) * rng.integers(1, 2**32, q, dtype=np.uint32)
        a = native.decode_bitmap(w)
        assert np.array_equal(a, decode_match_bitmap_numpy(w))
        assert np.array_equal(a, jax_decode_numpy(w.reshape(1, q, 1), 32 * q))
        assert np.array_equal(a, jnative.decode_bitmap(w.reshape(1, q, 1), 32 * q))
        assert np.array_equal(native.decode_bitmap(w.view(np.int32)), a)
    assert native.decode_bitmap(np.zeros(512, np.uint32)).size == 0


def test_twoway_differential(rng):
    """Two-Way == bytes.find on periodic needles, critical-factorization
    edge cases, small alphabets and boundaries, and == the JAX helper."""
    hay = bytes(rng.integers(97, 100, (60_000,), dtype=np.uint8))
    cases = [b"a", b"ab", b"ba", b"aaaa", b"abab", b"aabaab", b"abaab", b"aabaa", b"abcabcab", b"zzzz",
             hay[:7], hay[100:123], hay[-9:], hay[30_000:30_040], b"aaaaaaaab", b"baaaaaaaa"]
    for nd in cases:
        got = native.twoway_find(hay, nd)
        assert (got if got is not None else -1) == hay.find(nd), nd
        assert got == jnative.twoway_find(hay, nd)
    assert native.twoway_find(hay, b"") == 0
    assert native.twoway_find(b"ab", b"abc") is None
    tiny = bytes(rng.integers(97, 99, (4_000,), dtype=np.uint8))
    for _ in range(400):
        k = int(rng.integers(1, 40))
        if rng.random() < 0.5:
            i = int(rng.integers(0, len(tiny) - k))
            nd = tiny[i:i + k]
        else:
            nd = bytes(rng.integers(97, 99, (k,), dtype=np.uint8))
        got = native.twoway_find(tiny, nd)
        assert (got if got is not None else -1) == tiny.find(nd), nd
    got = native.twoway_find_batch(hay, cases)
    assert list(got) == [hay.find(nd) for nd in cases] == list(jnative.twoway_find_batch(hay, cases))
