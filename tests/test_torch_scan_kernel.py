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
from sliceslice_tpu_torch.utils import tracing

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


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
    tdh = tl.preprocess(hay, kh=kh, force_cols=True, device=CPU)
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
    tdh = tl.preprocess(hay, kh=16, force_cols=True, device=CPU)
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
    tdh = tl.preprocess(hay, kh=16, force_cols=True, device=CPU)
    jdh = jl.preprocess(hay, kh=16, force_cols=True)
    got = int(tsk.batched_find(tdh.flat, dirty, masks, ends)[0])
    ref = int(np.asarray(jsk.batched_find_cols(None, dirty, masks, ends, s=jdh.s, pw=jdh.windows()))[0])
    assert got == ref == hay.find(nd)


def test_cpu_takes_plain_and_counts_no_launch(rng):
    hay = _corpus(rng)
    dh = tl.preprocess(hay, kh=16, force_cols=True, device=CPU)
    values, masks, lengths = build_probe_table([hay[50:53], hay[9000:9008]])
    ends = (len(hay) - lengths + 1).astype(np.int32)
    before = tracing.counters()
    got = tsk.batched_find(dh.flat, values, masks, ends)
    v, m = torch.from_numpy(values.view(np.int32)), torch.from_numpy(masks.view(np.int32))
    plain = tsk.batched_find_plain(dh.flat, v, m, torch.from_numpy(ends))
    assert torch.equal(got, plain)
    assert int(tsk.memchr_find(dh.flat, 98, len(hay))) == hay.find(b"b")
    assert tracing.counters() == before


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


def _queue_items(plan, rows, limits):
    """(row, start, stop) of every live item in the order the kernels' queue
    hands them out (csrc/scan_common.cuh next_item): item i is chunk
    i // rows of row i % rows, cut at the row's limit; dead items skipped."""
    for i in range(plan.n_items):
        c, row = divmod(i, rows)
        start = c * plan.chunk
        if start < limits[row]:
            yield row, start, min(start + plan.chunk, limits[row])


@pytest.mark.parametrize("chunk", ["FIND_CHUNK", "COUNT_CHUNK"])
@pytest.mark.parametrize("nbytes,t,rows", [(857_600, 2, 2206), (857_600, 1, 1), (20_000, 5, 7),
                                           (4096 + 128, 4, 3), (1 << 28, 2, 1), (1 << 20, 512, 40)])
def test_plan_queue_covers_each_row_once_in_chunk_major_order(nbytes, t, rows, chunk):
    rng = np.random.default_rng(rows)
    chunk = getattr(tsk, chunk)
    plan = tsk.plan_queue(nbytes, t, rows, 1056, chunk)
    assert plan.chunk % tsk.WIDE_TILE == 0 and plan.chunk == chunk
    # the kernel's position limit is position_limit, and its words hold it
    assert plan.n_pos == tsk.position_limit(nbytes, t) == 4 * (plan.n_words - t)
    assert plan.n_items == rows * plan.n_chunks and (plan.n_chunks - 1) * plan.chunk < plan.n_pos
    assert 1 <= plan.grid <= min(plan.n_items, 1056)
    # row limits min(ends - base, n_pos): some past the buffer, some empty
    ends = rng.integers(0, plan.n_pos + 5000, rows)
    ends[: min(rows, 2)] = (0, 1 << 30)[: min(rows, 2)]
    limits = np.minimum(ends, plan.n_pos)
    items = list(_queue_items(plan, rows, limits))
    chunks = [start // plan.chunk for _, start, _ in items]
    assert chunks == sorted(chunks)  # chunk c of every row before chunk c + 1 of any
    covered = np.zeros(rows, np.int64)
    for row, start, stop in items:  # per row, consecutive and disjoint
        assert start == covered[row] and start < stop
        covered[row] = stop
    assert np.array_equal(covered, limits)


def test_plan_queue_spreads_one_row_and_stays_in_int32():
    """One row gets many chunks where the span plan gave it 13 blocks over
    i386; item counts that would leave int32 double the chunk."""
    spans = tsk.plan_spans(tsk.position_limit(857_600, 2), 1, tsk.FIND_TILE, 132)[1]
    assert tsk.plan_queue(857_600, 2, 1, 1056, tsk.FIND_CHUNK).n_chunks > 13 == spans
    assert tsk.plan_queue(256 << 20, 2, 1, 1056, tsk.COUNT_CHUNK).n_chunks > 13
    wide = tsk.plan_queue((1 << 31) - 256, 1, 1 << 20, 1056, tsk.COUNT_CHUNK)
    assert wide.chunk > tsk.COUNT_CHUNK and wide.n_items + 1056 < 2**31
    assert tsk.plan_queue(1 << 20, 2, 3, 1056, 5000).chunk == 2 * tsk.WIDE_TILE
    assert tsk.plan_queue(16, 4, 5, 1056, tsk.FIND_CHUNK).n_items == 0


def _resident(group):
    """Resident blocks of a card of 132 SMs that holds 8 blocks of the
    one-row kernel and 3 of the grouped one per SM."""
    return 132 * (8 if group == 1 else 3)


@pytest.mark.parametrize("nbytes,t,rows,group", [
    (857_600, 1, 1142, 8), (857_600, 2, 2206, 8), (857_600, 3, 1144, 8),  # i386's widths
    (857_600, 4, 89, 1), (857_600, 5, 3, 1), (857_600, 6, 1, 1),
    (857_600, 2, 1, 1), (256 << 20, 2, 1, 1), (256 << 20, 2, 7, 1),  # fewer rows than a group
    (256 << 20, 2, 8, 8), (1 << 20, 3, 41, 1), (64 << 20, 3, 41, 8),  # a stream window's 41
    (857_600, 5, 4000, 1), (256 << 20, 512, 40, 1),  # wider than registers hold
    (857_600, 2, 0, 1), (16, 4, 5, 1),  # nothing to scan
])
def test_plan_grouped_takes_rows_per_item_from_the_launch_shape(nbytes, t, rows, group):
    """8 rows an item where the launch still leaves ITEMS_PER_BLOCK items
    per resident block of the grouped kernel; one row an item for a launch
    of fewer rows than a group, for too few items and for tables wider
    than MAX_REG_T.  The chunk and its count do not depend on the group."""
    plan = tsk.plan_grouped(nbytes, t, rows, tsk.COUNT_CHUNK, _resident)
    one = tsk.plan_queue(nbytes, t, rows, _resident(1), tsk.COUNT_CHUNK)
    assert plan.group == group
    assert (plan.chunk, plan.n_chunks) == (one.chunk, one.n_chunks)
    assert plan.n_items == -(-rows // group) * plan.n_chunks
    assert plan.grid == max(1, min(_resident(group), plan.n_items))
    if group == 1:
        assert plan == one
    else:
        assert plan.n_items >= tsk.ITEMS_PER_BLOCK * _resident(group)


def _group_items(plan, rows, limits):
    """(c, row0, [(row, start, stop), ...]) of every live item in the order
    the count and bitmap kernels' queue hands them out (csrc/queue.cuh
    next_group): item i is chunk i // groups of the rows group * (i %
    groups) .., each cut at its row's limit; rows past ``rows`` and rows
    whose limit lies at or before the chunk's start scan nothing, and an
    item in which no row scans anything is skipped."""
    groups = -(-rows // plan.group)
    for i in range(plan.n_items):
        c, g = divmod(i, groups)
        row0, start = g * plan.group, c * plan.chunk
        spans = [(r, start, min(start + plan.chunk, limits[r]))
                 for r in range(row0, min(row0 + plan.group, rows)) if limits[r] > start]
        if spans:
            yield c, row0, spans


@pytest.mark.parametrize("group", [1, tsk.GROUP_ROWS])
@pytest.mark.parametrize("nbytes,t,rows", [(857_600, 2, 2206), (857_600, 1, 1142), (300_000, 3, 41),
                                           (20_000, 4, 13), (4096 + 128, 4, 9), (1 << 20, 1, 8)])
def test_group_queue_covers_each_row_once_in_chunk_major_order(nbytes, t, rows, group):
    """Every (row, position) below the row's limit lies in exactly one item
    of the group queue, for row counts that are not a multiple of the group
    and with padded rows (limit 0) and rows past the buffer among them;
    chunk c of every group comes before chunk c + 1 of any group."""
    rng = np.random.default_rng(rows + group)
    plan = tsk.plan_queue(nbytes, t, rows, 396, tsk.COUNT_CHUNK, group)
    ends = rng.integers(0, plan.n_pos + 5000, rows)
    ends[::5] = 0  # padded rows
    ends[1::7] = 1 << 30
    limits = np.minimum(ends, plan.n_pos)
    items = list(_group_items(plan, rows, limits))
    chunks = [c for c, _, _ in items]
    assert chunks == sorted(chunks)
    covered = np.zeros(rows, np.int64)
    for c, row0, spans in items:
        assert row0 % group == 0 and all(row0 <= r < row0 + group for r, _, _ in spans)
        for row, start, stop in spans:  # per row, consecutive and disjoint
            assert start == covered[row] == c * plan.chunk and start < stop
            covered[row] = stop
    assert np.array_equal(covered, limits)


@pytest.mark.parametrize("group", [1, tsk.GROUP_ROWS])
def test_group_items_count_into_the_plain_item_counts_layout(group):
    """The bitmap kernel adds row ``r``'s matches of an item of chunk ``c``
    at ``c * rows + r`` of its item counts: over a random bitmap this
    gives ``item_counts_of``'s int32[n_chunks, N], the plain version's, for
    every group."""
    rng = np.random.default_rng(group)
    nbytes, t, rows = 300_000, 2, 21
    plan = tsk.plan_queue(nbytes, t, rows, 396, tsk.WIDE_TILE * 4, group)
    limits = np.minimum(rng.integers(0, plan.n_pos + 100, rows), plan.n_pos)
    limits[3] = 0
    n_words = tsk.bitmap_words(nbytes, t)
    bits = rng.random((rows, 32 * n_words)) < 0.01
    bits &= np.arange(32 * n_words)[None, :] < limits[:, None]
    packed = np.packbits(bits, axis=1, bitorder="little").view("<u4").view(np.int32)
    words = torch.from_numpy(packed.copy())
    flat = np.zeros(plan.n_chunks * rows, np.int64)
    for c, _, spans in _group_items(plan, rows, limits):
        for row, start, stop in spans:
            flat[c * rows + row] += bits[row, start:stop].sum()
    exp = tsk.item_counts_of(words, plan.chunk, plan.n_chunks)
    assert exp.shape == (plan.n_chunks, rows)
    assert np.array_equal(flat.reshape(plan.n_chunks, rows), exp.numpy())
