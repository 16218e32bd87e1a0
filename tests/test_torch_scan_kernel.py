"""The find and memchr wrappers' plain versions against the JAX package's
``batched_find_cols`` / ``memchr_find_cols`` (Pallas interpret mode on the
CPU), on the same seeded inputs.  Comparisons are exact (integer offsets,
tolerance 0).  The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import sliceslice_tpu.ops.layout as jl
import sliceslice_tpu.ops.scan_kernel as jsk
import sliceslice_tpu_torch.ops.layout as tl
import sliceslice_tpu_torch.ops.scan_kernel as tsk
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    torch's default pool (one thread per core in each) thrashes on the
    many small ops of the plain versions."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(rng, n=20_000):
    """A small-alphabet body (so short needles recur) and a tail of unique
    bytes (so a tail needle's first match is the last valid position)."""
    body = rng.integers(97, 101, n - 64, dtype=np.uint8)
    tail = rng.permutation(np.arange(192, 256, dtype=np.uint8))
    return np.concatenate([body, tail]).tobytes()


def _table(hay, rng, t):
    """Width-t table of needles of widths t-1 and t (the JAX kernel's width
    contract), present, absent and at the last valid position, plus five
    padded rows (mask 0, end 0)."""
    needles = []
    for k in range(max(1, 4 * (t - 2) + 1), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - 64 - k))
        needles += [hay[start : start + k], bytes([191]) * k, hay[-k:]]
    values, masks, lengths = build_probe_table(needles, t_max=t)
    values = np.pad(values, ((0, 5), (0, 0)))
    masks = np.pad(masks, ((0, 5), (0, 0)))
    ends = np.pad(np.maximum(len(hay) - lengths + 1, 0), (0, 5)).astype(np.int32)
    return needles, values, masks, ends


@pytest.mark.parametrize("t", list(range(1, 9)) + [16])
def test_plain_find_matches_jax(t, rng):
    hay = _corpus(rng)
    kh = needed_halo_for_t(t)
    jdh = jl.preprocess(hay, kh=kh, force_cols=True)
    tdh = tl.preprocess(hay, kh=kh, force_cols=True)
    needles, values, masks, ends = _table(hay, rng, t)
    n = values.shape[0]
    for base, n_real in ((0, None), (5000, n - 7)):
        e = np.where(ends > 0, ends + base, 0).astype(np.int32)
        ref = np.asarray(
            jsk.batched_find_cols(
                None, values, masks, e, s=jdh.s, base=base, n_real=n_real, pw=jdh.windows()
            )
        )
        got = tsk.batched_find(tdh.flat, values, masks, e, base=base, n_real=n_real)
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert np.array_equal(got.numpy(), ref), (t, base)
        real = n if n_real is None else n_real
        exp = [hay.find(nd) for nd in needles[:real]]
        exp = [SENTINEL if f < 0 else f + base for f in exp]
        exp += [SENTINEL] * (n - len(exp))
        assert got.numpy().tolist() == exp


def test_plain_memchr_matches_jax(rng):
    hay = _corpus(rng)
    jdh = jl.preprocess(hay, kh=16, force_cols=True)
    tdh = tl.preprocess(hay, kh=16, force_cols=True)
    for byte in (97, 100, 192, 255, 0, 150):
        for end, base in ((len(hay), 0), (len(hay) // 3, 0), (len(hay) + 777, 777), (0, 0)):
            ref = int(jsk.memchr_find_cols(jdh.cols, byte, end, s=jdh.s, base=base))
            got = tsk.memchr_find(tdh.flat, byte, end, base)
            assert got.dtype == torch.int32 and got.dim() == 0
            assert int(got) == ref, (byte, end, base)
            f = hay.find(bytes([byte]), 0, max(end - base, 0))
            assert int(got) == (SENTINEL if f < 0 else f + base)


def test_host_tables_remasked_like_jax(rng):
    """Host tables are re-masked by the wrapper, as the JAX wrapper does:
    value bits outside a mask do not hide a match."""
    hay = _corpus(rng)
    nd = hay[1000:1006]
    values, masks, lengths = build_probe_table([nd])
    dirty = values | ~masks  # junk bits outside every mask
    ends = np.asarray([len(hay) - 6 + 1], np.int32)
    tdh = tl.preprocess(hay, kh=16, force_cols=True)
    jdh = jl.preprocess(hay, kh=16, force_cols=True)
    got = int(tsk.batched_find(tdh.flat, dirty, masks, ends)[0])
    ref = int(np.asarray(jsk.batched_find_cols(None, dirty, masks, ends, s=jdh.s, pw=jdh.windows()))[0])
    assert got == ref == hay.find(nd)


def test_cpu_takes_plain_and_counts_no_launch(rng):
    hay = _corpus(rng)
    dh = tl.preprocess(hay, kh=16, force_cols=True)
    values, masks, lengths = build_probe_table([hay[50:53], hay[9000:9008]])
    ends = (len(hay) - lengths + 1).astype(np.int32)
    before = (tsk.batched_find.launches, tsk.memchr_find.launches)
    got = tsk.batched_find(dh.flat, values, masks, ends)
    v, m = torch.from_numpy(values.view(np.int32)), torch.from_numpy(masks.view(np.int32))
    plain = tsk.batched_find_plain(dh.flat, v, m, torch.from_numpy(ends))
    assert torch.equal(got, plain)
    assert int(tsk.memchr_find(dh.flat, 98, len(hay))) == hay.find(b"b")
    assert (tsk.batched_find.launches, tsk.memchr_find.launches) == before


def test_other_devices_raise_instead_of_falling_back(rng):
    """A tensor neither on the CPU nor on a CUDA card has no kernel: the
    wrapper raises rather than moving it to the CPU."""
    meta = torch.empty(1024, dtype=torch.uint8, device="meta")
    values, masks, _ = build_probe_table([b"abc"])
    with pytest.raises(ValueError, match="no find kernel"):
        tsk.batched_find(meta, values, masks, np.asarray([5], np.int32))
    with pytest.raises(ValueError, match="no memchr kernel"):
        tsk.memchr_find(meta, 97, 100)


def test_wrapper_input_checks():
    hay = torch.zeros(1024, dtype=torch.uint8)
    values, masks, _ = build_probe_table([b"abc"])
    ends = np.asarray([5], np.int32)
    with pytest.raises(ValueError, match="int32"):
        tsk.batched_find(hay, values, masks, ends, base=SENTINEL)
    with pytest.raises(ValueError, match="int32"):
        tsk.memchr_find(hay, 97, 10, base=-1)
    with pytest.raises(ValueError, match="uint8"):
        tsk.batched_find(hay.to(torch.int32), values, masks, ends)
    with pytest.raises(ValueError, match="width"):
        tsk.batched_find(hay, np.zeros((1, 513), np.uint32), np.zeros((1, 513), np.uint32), ends)
    with pytest.raises(ValueError, match="same rows"):
        tsk.batched_find(hay, values, masks, np.asarray([5, 6], np.int32))


@pytest.mark.parametrize("n,t", [(1, 1), (7, 2), (8, 3), (300, 1), (2206, 2), (89, 4), (5, 16), (40, 512)])
def test_plan_block_matches_jax(n, t):
    assert tsk.plan_block(n, t) == jsk.plan_block(n, t)


@pytest.mark.parametrize("n_pos,rows", [(1, 1), (5000, 1), (857_424, 2206), (857_424, 1), (1 << 28, 1), (1 << 28, 40)])
def test_plan_spans_cover_positions(n_pos, rows):
    span, n_spans = tsk.plan_spans(n_pos, rows, tsk.FIND_TILE, 132)
    assert span % tsk.FIND_TILE == 0
    assert (n_spans - 1) * span < n_pos <= n_spans * span
    assert n_spans == 1 or span >= tsk.MIN_SPAN
    assert n_spans <= 65535  # the grid's y limit
