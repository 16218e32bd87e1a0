"""Per-backend property suites for the port's single-needle searchers —
the mirror of tests/test_searchers.py (six properties, every case at every
``position``, against the ``bytes.find`` oracle) plus the contract errors
of tests/test_contracts.py and a differential check against the JAX
package's searchers on the same inputs.  Exact comparisons throughout."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
from sliceslice_tpu_torch import (
    CudaSearcher,
    DynamicSearcher,
    EmptyNeedleSearcher,
    MemchrSearcher,
    NaiveSearcher,
    TorchSearcher,
    naive_find,
)
from sliceslice_tpu_torch.models.cuda_searcher import SPECIALIZED, searcher_for_size
from sliceslice_tpu_torch.models.huge import HugeNeedleSearcher
from sliceslice_tpu_torch.ops.layout import preprocess

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"

BACKENDS = [DynamicSearcher, CudaSearcher, TorchSearcher, NaiveSearcher]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    torch's default pool (one thread per core in each) thrashes on the
    many small ops of the plain versions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check(cls, needle: bytes, hay: bytes):
    """find/search_in parity with the oracle at every position."""
    expected = naive_find(hay, needle)
    positions = range(len(needle)) if len(needle) else [None]
    for p in positions:
        s = cls(needle, device=CPU) if p is None else cls.with_position(needle, p, device=CPU)
        assert s.find(hay) == expected, (cls.__name__, needle, hay, p)
        assert s.search_in(hay) == (expected is not None)


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_same(cls):
    for nd in [b"x", b"ab", b"abcd", b"abcdefg", b"foo bar baz qux quux!"]:
        check(cls, nd, nd)


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_different(cls):
    for nd in [b"x", b"ab", b"abcd", b"needle"]:
        check(cls, nd, b"yyyyyyyyyyyyyyyyyyyyyyyyyyyy")


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_prefix(cls):
    for nd in [b"p", b"pre", b"prefix!"]:
        check(cls, nd, nd + b" trailing content here")


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_suffix(cls):
    for nd in [b"s", b"suf", b"suffix!"]:
        check(cls, nd, b"leading content here " + nd)


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_multiple(cls):
    for nd in [b"ab", b"aba"]:
        check(cls, nd, b"ab aba abab ababa " * 3)


@pytest.mark.parametrize("cls", BACKENDS)
def test_search_middle(cls):
    for nd in [b"m", b"mid", b"middle needle"]:
        check(cls, nd, b"some text before " + nd + b" and after")


@pytest.mark.parametrize("cls", BACKENDS)
def test_shorter_and_equal_haystack(cls):
    check(cls, b"abcdef", b"abc")
    check(cls, b"abcdef", b"abcdef")
    check(cls, b"abcdef", b"abcdeX")


@pytest.mark.parametrize("cls", BACKENDS)
def test_kernel_layout_every_position(cls, rng):
    """The six properties' shapes on the kernel layout (past the flat rung
    and the host rung), every position."""
    filler = bytes(rng.integers(97, 100, (9000,), dtype=np.uint8))
    dh_cases = [
        (b"p", b"p" + filler),
        (b"suf!", filler + b"suf!"),
        (b"middle-needle", filler[:4500] + b"middle-needle" + filler[4500:]),
        (b"zz", filler),
    ]
    for nd, hay in dh_cases:
        dh = preprocess(hay, kh=16, device=CPU)
        assert dh.tiled
        exp = naive_find(hay, nd)
        for p in range(len(nd)):
            assert cls.with_position(nd, p, device=CPU).find(dh) == exp, (cls.__name__, nd, p)
            assert cls.with_position(nd, p, device=CPU).find(hay) == exp


def test_memchr_backend(rng):
    check(MemchrSearcher, b"q", b"the quick brown fox")
    check(MemchrSearcher, b"z", b"the quick brown fox")
    check(MemchrSearcher, b"\x00", b"ab\x00cd")
    assert MemchrSearcher(b"x", device=CPU).find(b"") is None
    hay = bytes(rng.integers(97, 105, (20_000,), dtype=np.uint8)) + b"\x01"
    dh = preprocess(hay, device=CPU)
    for b in (b"a", b"h", b"\x01", b"\x00", b"z"):
        assert MemchrSearcher(b, device=CPU).find(dh) == naive_find(hay, b)


@pytest.mark.parametrize("cls", [DynamicSearcher, CudaSearcher, TorchSearcher])
def test_random_differential_flat(cls, rng):
    hay = bytes(rng.integers(97, 105, (1500,), dtype=np.uint8))
    for k in [1, 2, 3, 4, 5, 7, 8, 11, 16, 17, 24, 40]:
        for _ in range(3):
            start = int(rng.integers(0, 1500 - k))
            nd = hay[start : start + k]
            assert cls(nd, device=CPU).find(hay) == naive_find(hay, nd)
        nd = bytes(rng.integers(0, 256, (k,), dtype=np.uint8))
        assert cls(nd, device=CPU).find(hay) == naive_find(hay, nd)


@pytest.mark.parametrize("cls", [DynamicSearcher, CudaSearcher, TorchSearcher])
def test_random_differential_cols_vs_jax(cls, rng):
    """Kernel-layout path (force_cols), boundary positions included, held
    against ``bytes.find`` and the JAX package's XlaSearcher on the same
    haystack and needles."""
    hay = bytes(rng.integers(97, 103, (9000,), dtype=np.uint8))
    dh = preprocess(hay, kh=24, force_cols=True, device=CPU)
    jdh = jst.preprocess(hay, kh=24, force_cols=True)
    for k in [1, 2, 4, 5, 8, 13, 16, 24]:
        needles = [hay[s : s + k] for s in (0, 1, 127, 128, 4499, 9000 - k)]
        needles.append(bytes(rng.integers(0, 256, (k,), dtype=np.uint8)))
        for nd in needles:
            got = cls(nd, device=CPU).find(dh)
            assert got == naive_find(hay, nd), (k, nd)
            assert got == jst.XlaSearcher(nd).find(jdh), (k, nd)


def test_specialized_family_dispatch():
    for k in range(2, 17):
        cls = searcher_for_size(k)
        assert cls.__name__ == f"Searcher{k}"
        nd = bytes(range(65, 65 + k))
        hay = b"\xff" * 37 + nd + b"\xee" * 9
        assert cls(nd, device=CPU).find(hay) == 37
        big = b"\xff" * 9000 + nd + b"\xee" * 9
        assert cls(nd, device=CPU).find(big) == 9000
    assert searcher_for_size(17) is CudaSearcher
    assert searcher_for_size(1) is CudaSearcher


def test_long_needles(rng):
    hay = bytes(rng.integers(0, 256, (60_000,), dtype=np.uint8))
    for k in [33, 64, 65, 100, 500, 1000, 2048]:
        start = int(rng.integers(0, 60_000 - k))
        nd = hay[start : start + k]
        assert CudaSearcher(nd, device=CPU).find(hay) == naive_find(hay, nd), k
        mutated = bytearray(nd)
        mutated[k // 2] ^= 1
        assert CudaSearcher(bytes(mutated), device=CPU).find(hay) == naive_find(hay, bytes(mutated)), k


def test_layout_halo_widened_for_long_needle(rng):
    """A needle wider than the layout's halo rebuilds a wider layout from
    the host bytes, as the JAX package does."""
    hay = bytes(rng.integers(97, 99, (30_000,), dtype=np.uint8))
    dh = preprocess(hay, kh=8, device=CPU)
    nd = hay[-200:]
    assert DynamicSearcher(nd, device=CPU).find(dh) == naive_find(hay, nd)
    assert dh._rehalo is not None and dh._rehalo.kh >= 199


# -- contract errors (the mirror of tests/test_contracts.py) ------------------


@pytest.mark.parametrize("cls", [CudaSearcher, TorchSearcher, MemchrSearcher, NaiveSearcher])
def test_empty_needle_rejected(cls):
    with pytest.raises(ValueError):
        cls(b"", device=CPU)


@pytest.mark.parametrize("cls", [CudaSearcher, TorchSearcher, DynamicSearcher])
def test_invalid_position_rejected(cls):
    with pytest.raises(ValueError):
        cls.with_position(b"abc", 3, device=CPU)
    with pytest.raises(ValueError):
        cls.with_position(b"abc", -1, device=CPU)
    cls.with_position(b"abc", 2, device=CPU)


def test_dynamic_empty_needle_always_true():
    d = DynamicSearcher(b"", device=CPU)
    assert isinstance(d.inner, EmptyNeedleSearcher)
    assert d.search_in(b"") is True
    assert d.search_in(b"anything") is True
    assert d.find(b"xyz") == 0
    assert d.find(preprocess(b"x" * 10_000, device=CPU)) == 0
    with pytest.raises(ValueError):
        DynamicSearcher.with_position(b"", 1, device=CPU)


def test_dynamic_dispatch_arms():
    assert isinstance(DynamicSearcher(b"x", device=CPU).inner, MemchrSearcher)
    for k in range(2, 17):
        assert type(DynamicSearcher(b"a" * k, device=CPU).inner).__name__ == f"Searcher{k}"
    assert type(DynamicSearcher(b"a" * 17, device=CPU).inner) is CudaSearcher
    assert type(DynamicSearcher(b"a" * 2048, device=CPU).inner) is CudaSearcher
    huge = DynamicSearcher(b"a" * 2049, device=CPU).inner
    assert type(huge) is HugeNeedleSearcher and huge.size == 2049 and huge.needle.size == 64


def test_specialized_size_mismatch():
    with pytest.raises(ValueError):
        SPECIALIZED[4](b"abc", device=CPU)
    with pytest.raises(ValueError):
        SPECIALIZED[2](b"abc", device=CPU)


def test_memchr_requires_single_byte():
    with pytest.raises(ValueError):
        MemchrSearcher(b"ab", device=CPU)


def test_haystack_type_contract():
    s = DynamicSearcher(b"ab", device=CPU)
    assert s.find("xxab") == 2
    assert s.find(np.frombuffer(b"abyy", np.uint8)) == 0
    with pytest.raises(TypeError):
        s.find(np.zeros(4, np.int32))
    assert s.find(bytearray(b"zzzab")) == 3
    assert s.find(memoryview(b"ab")) == 0
    big = CudaSearcher(b"ab", device=CPU)
    assert big.find("x" * 9000 + "ab") == 9000
    with pytest.raises(TypeError):
        big.find(np.zeros(9000, np.int32))


def test_inlined_alias():
    s = DynamicSearcher(b"ab", device=CPU)
    assert s.inlined_search_in(b"xxab") is True
    assert CudaSearcher(b"ab", device=CPU).inlined_search_in(b"zz") is False


def test_short_device_haystack_without_host_bytes():
    dh = preprocess(b"abc", keep_host=False, device=CPU)
    with pytest.raises(ValueError, match="host bytes"):
        CudaSearcher(b"abcdef", device=CPU).find(dh)
    assert CudaSearcher(b"bc", device=CPU).find(dh) == 1


def test_host_rung_uses_position(rng):
    """Haystacks up to HOST_HAY_BYTES given as bytes take the host SWAR rung
    (or the oracle without a toolchain); every position answers alike."""
    from sliceslice_tpu_torch.models.dynamic import HOST_HAY_BYTES

    hay = bytes(rng.integers(97, 100, (HOST_HAY_BYTES,), dtype=np.uint8))
    nd = hay[3000:3010]
    for p in range(len(nd)):
        assert DynamicSearcher(nd, p, device=CPU).find(hay) == naive_find(hay, nd)


def test_host_oracles_match_jax(rng):
    """``overlapping_count`` and ``_host_positions`` are the JAX package's
    host oracles, unchanged."""
    from sliceslice_tpu import searcher as js

    from sliceslice_tpu_torch import overlapping_count
    from sliceslice_tpu_torch.searcher import _host_positions

    hay = bytes(rng.integers(97, 99, (3000,), dtype=np.uint8))
    for nd in (b"", b"a", b"ab", b"aba", b"abab", hay[100:108], b"zz"):
        assert overlapping_count(hay, nd) == js.overlapping_count(hay, nd)
        assert np.array_equal(_host_positions(hay, nd), js._host_positions(hay, nd))
    assert overlapping_count(b"ababa", b"aba") == 2  # overlapping, unlike bytes.count
