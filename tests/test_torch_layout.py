"""The port's flat device layout: padding and halo, one layout at every
length (no flat rung), the int32 position bound and the same errors as
the JAX package's layout."""

import numpy as np
import pytest
import torch

import sliceslice_tpu.ops.layout as jl
import sliceslice_tpu_torch.ops.layout as tl
from sliceslice_tpu_torch import interop
from sliceslice_tpu_torch.needle import needed_halo_for_t
from sliceslice_tpu_torch.ops.scan_math import position_limit

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


@pytest.mark.parametrize("force_cols", [False, True])
@pytest.mark.parametrize("length", [0, 1, 127, 128, 4096, 8192, 8193, 10_000, 50_000])
def test_padding_and_halo(length, force_cols, rng):
    data = bytes(rng.integers(0, 256, (length,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=40, force_cols=force_cols, device=CPU)
    ref = jl.preprocess(data, kh=40, force_cols=force_cols)
    assert dh.kh == ref.kh == 64 and dh.length == ref.length == length
    flat = dh.flat.numpy()
    # Both arms take the kernel layout: round_up(length + kh, 128) + 128.
    assert flat.dtype == np.uint8 and flat.size == tl.padded_total(length, 40)
    assert flat.size == tl.round_up(length + 64, 128) + 128
    assert flat.tobytes()[:length] == data and not flat[length:].any()
    assert flat.size % 128 == 0 and dh.device == torch.device("cpu")
    # The halo covers every probe table the layout's kh admits.
    assert flat.size - length >= dh.kh
    t = max(t for t in range(1, 513) if needed_halo_for_t(t) <= dh.kh)
    assert position_limit(flat.size, t) >= length


def test_flat_rung_boundary():
    """Where the JAX package's flat rung ends, the port's layout does not
    change: 8,192 and 8,193 bytes, with and without ``force_cols``, take the
    same layout, and ``SHORT_HAY_BYTES`` is only the host rung's threshold."""
    assert tl.SHORT_HAY_BYTES == jl.SHORT_HAY_BYTES == 8192
    for length in (tl.SHORT_HAY_BYTES, tl.SHORT_HAY_BYTES + 1, 10):
        data = b"a" * length
        plain = tl.preprocess(data, device=CPU)
        forced = tl.preprocess(data, force_cols=True, device=CPU)
        assert plain.kh == forced.kh and torch.equal(plain.flat, forced.flat)
        assert plain.flat.numel() == tl.padded_total(length, plain.kh)


def test_position_bound_refused():
    """A layout whose positions would leave int32 is refused before any
    copy (a zero-stride array stands in for a >2 GiB corpus)."""
    assert tl.MAX_DEVICE_POSITIONS == jl.MAX_DEVICE_POSITIONS
    huge = np.broadcast_to(np.zeros(1, np.uint8), (tl.MAX_DEVICE_POSITIONS - 64,))
    with pytest.raises(ValueError, match="int32 position range"):
        tl.preprocess(huge, device=CPU)
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
    dh = tl.preprocess(buf, length=9000, kh=16, device=CPU)
    assert dh.length == 9000 and dh.flat.numel() == tl.padded_total(9000, 16)
    assert dh.host_bytes == buf[:9000].tobytes()
    assert dh.flat.numpy()[:9000].tobytes() == dh.host_bytes
    assert tl.preprocess(buf, keep_host=False, device=CPU).host_bytes is None


def test_ensure_halo_rebuild_and_cache(rng):
    data = bytes(rng.integers(0, 256, (20_000,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=8, force_cols=True, device=CPU)
    assert dh.kh == 32  # rounded up, as in the JAX package
    dh2 = dh.ensure_halo(64)
    assert dh2.kh >= 64 and dh2.length == dh.length and dh2.host_bytes == data
    assert dh.ensure_halo(64) is dh2 and dh.ensure_halo(40) is dh2
    assert dh.ensure_halo(16) is dh
    assert dh.ensure_kh(125) is dh.ensure_halo(tl.round_up(127, 32))
    assert torch.equal(dh2.flat, tl.preprocess(data, kh=64, device=CPU).flat)
    # The re-lay copies the device bytes: no host bytes are needed.
    no_host = tl.preprocess(data, kh=8, keep_host=False, force_cols=True, device=CPU)
    wide = no_host.ensure_halo(64)
    assert wide.host_bytes is None and torch.equal(wide.flat, dh2.flat)
    short = tl.preprocess(data[:300], keep_host=False, device=CPU)
    relaid = short.ensure_halo(512)
    assert relaid.kh == 512 and relaid.flat.numel() == tl.padded_total(300, 512)
    assert relaid.flat.numpy().tobytes()[:300] == data[:300] and not relaid.flat[300:].any()


def test_supports_needle_len(rng):
    data = bytes(rng.integers(0, 256, (20_000,), dtype=np.uint8))
    dh = tl.preprocess(data, kh=32, force_cols=True, device=CPU)
    ref = jl.preprocess(data, kh=32, force_cols=True)
    for k in (1, 4, 32, 33, 64, 65):
        assert dh.supports_needle_len(k) == ref.supports_needle_len(k)


@pytest.mark.parametrize("length", [300, 20_000])
def test_interop_haystack_from_jax_state(length, rng):
    data = bytes(rng.integers(0, 256, (length,), dtype=np.uint8))
    ref = jl.preprocess(data, kh=48, force_cols=length > 1000)
    dh = interop.haystack(ref.host_bytes, ref.length, ref.kh, device=CPU)
    assert (dh.length, dh.kh) == (ref.length, ref.kh)
    assert dh.host_bytes == data
    assert dh.flat.numpy().tobytes()[:length] == data
