"""The port's flat device layout: padding and halo, the flat rung, the
int32 position bound and the same errors as the JAX package's layout."""

import numpy as np
import pytest
import torch

import sliceslice_tpu.ops.layout as jl
import sliceslice_tpu_torch.ops.layout as tl
from sliceslice_tpu_torch import interop
from sliceslice_tpu_torch.needle import needed_halo_for_t
from sliceslice_tpu_torch.ops.scan_math import position_limit


@pytest.mark.parametrize("force_cols", [False, True])
@pytest.mark.parametrize("length", [0, 1, 127, 128, 4096, 8192, 8193, 10_000, 50_000])
def test_padding_and_halo(length, force_cols, rng):
    data = bytes(rng.integers(0, 256, (length,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=40, force_cols=force_cols)
    ref = jl.preprocess(data, kh=40, force_cols=force_cols)
    assert dh.tiled == ref.tiled and dh.kh == ref.kh == 64 and dh.length == length
    flat = dh.flat.numpy()
    assert flat.dtype == np.uint8 and flat.size == tl.padded_total(length, 40, force_cols)
    assert flat.tobytes()[:length] == data and not flat[length:].any()
    assert flat.size % 128 == 0 and dh.device == torch.device("cpu")
    if dh.tiled:
        # The halo covers every probe table the layout's kh admits.
        assert flat.size - length >= dh.kh
        t = max(t for t in range(1, 513) if needed_halo_for_t(t) <= dh.kh)
        assert position_limit(flat.size, t) >= length
    else:
        # The flat rung matches the JAX flat layout's buffer.
        assert flat.size == np.asarray(ref.flat).size


def test_flat_rung_boundary():
    assert not tl.preprocess(b"a" * tl.SHORT_HAY_BYTES).tiled
    assert tl.preprocess(b"a" * (tl.SHORT_HAY_BYTES + 1)).tiled
    assert tl.preprocess(b"a" * 10, force_cols=True).tiled
    assert tl.SHORT_HAY_BYTES == jl.SHORT_HAY_BYTES == 8192


def test_position_bound_refused():
    """A layout whose positions would leave int32 is refused before any
    copy (a zero-stride array stands in for a >2 GiB corpus)."""
    assert tl.MAX_DEVICE_POSITIONS == jl.MAX_DEVICE_POSITIONS
    huge = np.broadcast_to(np.zeros(1, np.uint8), (tl.MAX_DEVICE_POSITIONS - 64,))
    with pytest.raises(ValueError, match="int32 position range"):
        tl.preprocess(huge)
    ok = tl.padded_total(tl.MAX_DEVICE_POSITIONS - 4096, 64)
    assert ok <= tl.MAX_DEVICE_POSITIONS


@pytest.mark.parametrize("mod", [jl, tl], ids=["jax", "torch"])
def test_input_errors_identical(mod):
    with pytest.raises(TypeError):
        mod.preprocess(np.zeros(16, np.int32))
    with pytest.raises(ValueError):
        mod.preprocess(np.zeros(16, np.uint8), length=17)
    with pytest.raises(ValueError):
        mod.preprocess(b"abc", length=2)


def test_prepadded_ndarray_length(rng):
    buf = np.zeros(20_000, np.uint8)
    buf[:9000] = rng.integers(1, 256, 9000, dtype=np.uint8)
    dh = tl.preprocess(buf, length=9000, kh=16)
    assert dh.length == 9000 and dh.tiled
    assert dh.host_bytes == buf[:9000].tobytes()
    assert dh.flat.numpy()[:9000].tobytes() == dh.host_bytes
    assert tl.preprocess(buf, keep_host=False).host_bytes is None


def test_ensure_halo_rebuild_and_cache(rng):
    data = bytes(rng.integers(0, 256, (20_000,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=8, force_cols=True)
    assert dh.kh == 32  # rounded up, as in the JAX package
    dh2 = dh.ensure_halo(64)
    assert dh2.kh >= 64 and dh2.length == dh.length and dh2.tiled
    assert dh.ensure_halo(64) is dh2 and dh.ensure_halo(40) is dh2
    assert dh.ensure_halo(16) is dh
    assert dh.ensure_kh(125) is dh.ensure_halo(tl.round_up(127, 32))
    assert dh2.flat.numpy().tobytes()[:20_000] == data
    no_host = tl.preprocess(data, kh=8, keep_host=False, force_cols=True)
    with pytest.raises(ValueError, match="no host bytes"):
        no_host.ensure_halo(64)
    flat = tl.preprocess(data[:300])
    assert flat.ensure_halo(512) is flat  # the flat rung needs no halo


def test_supports_needle_len(rng):
    data = bytes(rng.integers(0, 256, (20_000,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=32, force_cols=True)
    ref = jl.preprocess(data, kh=32, force_cols=True)
    for k in (1, 4, 32, 33, 64, 65):
        assert dh.supports_needle_len(k) == ref.supports_needle_len(k)


@pytest.mark.parametrize("length", [300, 20_000])
def test_interop_haystack_from_jax_state(length, rng):
    data = bytes(rng.integers(0, 256, (length,), dtype=np.uint8))
    ref = jl.preprocess(data, kh=48, force_cols=length > 1000)
    dh = interop.haystack(ref.host_bytes, ref.length, ref.kh, ref.tiled)
    assert (dh.length, dh.kh, dh.tiled) == (ref.length, ref.kh, ref.tiled)
    assert dh.host_bytes == data
    assert dh.flat.numpy().tobytes()[:length] == data
