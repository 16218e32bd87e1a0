"""The port's sharded scanner (``sliceslice_tpu_torch.parallel``) against
the JAX package and the host oracles — the mirror of tests/test_sharded.py
case by case, with the port's meshes made of cells on the CPU and the JAX
package's of tests/conftest.py's 8 virtual CPU devices.  For a few cases
of each function both packages run on the same seeded inputs and must
agree, values and return types; the rest are held against ``bytes.find``,
``overlapping_count``, the host positions scan and the port's own
single-layout ``BatchedSearcher``.  Then the port's own contracts: its
``ValueError``s, the mesh's placement, the shard views.  Every comparison
is exact."""

import gc

import numpy as np
import pytest
import torch

import sliceslice_tpu.parallel as jpar
from sliceslice_tpu.ops.layout import preprocess as jax_preprocess
from sliceslice_tpu_torch import BatchedSearcher, naive_find, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import MAX_NEEDLE_LEN, build_probe_table
from sliceslice_tpu_torch.ops import layout as layout_mod
from sliceslice_tpu_torch.ops import scan_kernel, torch_backend
from sliceslice_tpu_torch.parallel import (
    ShardedBatchedSearcher,
    corpus_sharding,
    make_mesh,
    sharded_count_cols,
    sharded_find_cols,
    sharded_positions,
    table_sharding,
)
from sliceslice_tpu_torch.parallel import distributed, shard_scan
from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(rng=np.random.default_rng(7)):
    return bytes(rng.integers(97, 103, (900_000,), dtype=np.uint8))


@pytest.fixture(scope="module")
def dh(corpus):
    return preprocess(corpus, kh=16, device=CPU)


@pytest.fixture(scope="module")
def jdh(corpus):
    return jax_preprocess(corpus, kh=16)


def mesh(shape):
    return make_mesh(shape, device=CPU)


def _tables(needles, hay_len):
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(hay_len - lengths.astype(np.int64) + 1, 0)
    return values, masks, ends


def _firsts(got) -> list:
    """Device int32 results as Python ints, -1 absent."""
    return [-1 if int(o) >= SENTINEL else int(o) for o in np.asarray(got)]


def shard_edge(corpus, n_data: int, b: int) -> int:
    """The port's ``b``-th shard boundary of the corpus cut ``n_data`` ways."""
    return b * shard_scan.shard_bytes_for(len(corpus), n_data)


def test_devices_available():
    m = mesh((8, 1))
    assert len(m.local_cells()) == 8 and {str(d) for _, _, d in m.local_cells()} == {"cpu"}
    assert m.shape == {"data": 8, "needle": 1} and m.devices.shape == (8, 1)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_find_matches_oracle(corpus, dh, jdh, shape):
    rng = np.random.default_rng(11)
    needles = [
        corpus[i : i + k]
        for k in (2, 4, 7, 12)
        for i in map(int, rng.integers(0, len(corpus) - k, (3,)))
    ] + [b"ZZZZ", corpus[-9:]]
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_find_cols(dh, values, masks, ends, mesh(shape))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert _firsts(got) == [-1 if naive_find(corpus, nd) is None else naive_find(corpus, nd) for nd in needles]
    if shape in ((8, 1), (2, 4)):  # the JAX package on the same tables
        ref = jpar.sharded_find_cols(jdh, values, masks, ends, jpar.make_mesh(shape))
        assert np.asarray(ref).dtype == np.int32 and np.array_equal(got.numpy(), np.asarray(ref))


def test_shard_boundary_exactly_once(corpus, dh):
    """Needles across each of the port's shard boundaries are found with
    their global offsets and counted once."""
    needles = [corpus[shard_edge(corpus, 8, b) - 6 : shard_edge(corpus, 8, b) + 6] for b in range(1, 8)]
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_find_cols(dh, values, masks, ends, mesh((8, 1)))
    assert _firsts(got) == [corpus.find(nd) for nd in needles]
    cnt = sharded_count_cols(dh, values, masks, ends, mesh((8, 1)))
    assert cnt.tolist() == [overlapping_count(corpus, nd) for nd in needles]


def test_sharded_batched_searcher(corpus, dh):
    needles = [corpus[10:15], b"absent!", corpus[500_000:500_020], b"a"]
    sb = ShardedBatchedSearcher(needles, mesh((4, 2)))
    exp = BatchedSearcher(needles, device=CPU).find_all(dh)
    got = sb.find_all(dh)
    assert got.dtype == np.int64 and (got == exp).all()
    # The int64 host combine through the searcher.
    sb64 = ShardedBatchedSearcher(needles, mesh((4, 2)))
    sb64.force_int64 = True
    got64 = sb64.find_all(dh)
    assert got64.dtype == np.int64 and (got64 == exp).all()
    assert (sb64.count_all(dh) == BatchedSearcher(needles, device=CPU).count_all(dh)).all()


def test_pad_segments_mesh_bigger_than_corpus():
    """Shards past the corpus (a 700-byte corpus over 8 shards of 128
    bytes) hold nothing and fabricate no match; the JAX package's case
    (600,000 bytes) agrees with it."""
    rng = np.random.default_rng(3)
    for data in (bytes(rng.integers(97, 100, (700,), dtype=np.uint8)),
                 bytes(rng.integers(97, 100, (600_000,), dtype=np.uint8))):
        dh = preprocess(data, kh=16, device=CPU)
        needles = [data[:4], b"\x00\x00\x00", data[-5:]]
        values, masks, ends = _tables(needles, dh.length)
        place = shard_scan.place_corpus(dh, mesh((8, 1)))
        assert (len(place.shards) < 8) == (len(data) == 700)
        got = sharded_find_cols(dh, values, masks, ends, mesh((8, 1)))
        assert _firsts(got) == [data.find(nd) for nd in needles]
    ref = jpar.sharded_find_cols(jax_preprocess(data, kh=16), values, masks, ends, jpar.make_mesh((8, 1)))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_make_global_corpus_single_process():
    """One process's shard rows placed on its cells: a global shape of
    (data rows, row bytes), one buffer per (row, device)."""
    m = distributed.global_mesh(cells_per_process=8, device=CPU)
    shards = distributed.make_global_corpus(np.zeros((8, 256), np.uint8), m)
    assert shards.shape == (8, 256)
    assert sorted(shards.buffers) == [(d, torch.device("cpu")) for d in range(8)]
    assert all(b.shape == (256,) and b.dtype == torch.uint8 for b in shards.buffers.values())
    with pytest.raises(ValueError, match="7 shard rows for the 8 data rows"):
        distributed.make_global_corpus(np.zeros((7, 256), np.uint8), m)


def test_initialize_noop():
    distributed.initialize(num_processes=1)  # must be a no-op, and touch no card
    assert not torch.distributed.is_initialized()
    jpar.distributed.initialize(num_processes=1)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_find_int64_pair_path(corpus, dh, jdh, shape):
    """The int64 host combine (``force_int64``) gives the int32 path's
    exact offsets as a host int64 ndarray, shard straddles and absences
    included."""
    rng = np.random.default_rng(23)
    needles = (
        [corpus[i : i + k] for k in (3, 8, 13) for i in map(int, rng.integers(0, len(corpus) - k, (2,)))]
        + [corpus[shard_edge(corpus, shape[0], b) - 5 : shard_edge(corpus, shape[0], b) + 5]
           for b in range(1, min(shape[0], 4))]
        + [b"ZZZZ", corpus[-7:]]
    )
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_find_cols(dh, values, masks, ends, mesh(shape), force_int64=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    assert list(got) == [corpus.find(nd) for nd in needles]
    if shape == (4, 2):
        ref = jpar.sharded_find_cols(jdh, values, masks, ends, jpar.make_mesh(shape), force_int64=True)
        assert isinstance(ref, np.ndarray) and ref.dtype == np.int64 and np.array_equal(got, ref)


def test_sharded_count_int64_pair_path(corpus, dh, jdh):
    needles = [corpus[10:14], b"aab", b"absent!", b"a"]
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_count_cols(dh, values, masks, ends, mesh((8, 1)), force_int64=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    assert list(got) == [overlapping_count(corpus, nd) for nd in needles]
    ref = jpar.sharded_count_cols(jdh, values, masks, ends, jpar.make_mesh((8, 1)), force_int64=True)
    assert isinstance(ref, np.ndarray) and ref.dtype == np.int64 and np.array_equal(got, ref)
    # And the int32 device path: a tensor of the same counts.
    got32 = sharded_count_cols(dh, values, masks, ends, mesh((8, 1)))
    assert got32.dtype == torch.int32 and got32.tolist() == list(got)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_positions_matches_oracle(corpus, dh, jdh, shape):
    """Sharded positions through the searcher: int64 global offsets,
    exactly once at the shard boundaries."""
    edge = shard_edge(corpus, shape[0], 1)
    needles = [corpus[100:104], b"aab", b"absent!", corpus[edge - 3 : edge + 3], corpus[-6:]]
    got = ShardedBatchedSearcher(needles, mesh(shape)).positions_all(dh)
    for nd, g in zip(needles, got):
        assert g.dtype == np.int64 and np.array_equal(g, _host_positions(corpus, nd)), nd
    if shape == (2, 4):
        ref = jpar.ShardedBatchedSearcher(needles, jpar.make_mesh(shape)).positions_all(jdh)
        assert all(r.dtype == np.int64 and np.array_equal(g, r) for g, r in zip(got, ref))


def test_sharded_positions_function_level(corpus, dh, jdh):
    needles = [corpus[5:9], corpus[77:81], b"zzzz"]
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_positions(dh, values, masks, ends, mesh((8, 1)))
    ref = jpar.sharded_positions(jdh, values, masks, ends, jpar.make_mesh((8, 1)))
    for nd, g, r in zip(needles, got, ref):
        assert np.array_equal(g, _host_positions(corpus, nd)) and np.array_equal(g, r), nd


def test_int64_combine_math():
    """The combine is exact past int32: cells whose shard bases lie at
    multi-GiB offsets (shards of 512 MiB) fold their local offsets into
    the global minimum and sum in int64, through the port's own combine."""
    sb = 1 << 29
    hay = torch.zeros(1024, dtype=torch.uint8)
    hay[5:8] = torch.tensor([1, 2, 3], dtype=torch.uint8)
    hay[700:703] = torch.tensor([1, 2, 3], dtype=torch.uint8)
    place = shard_scan.Placement(length=101 * sb, kh=32, shard_bytes=sb, n_data=101,
                                 shards={(9, torch.device("cpu")): hay, (100, torch.device("cpu")): hay})
    vals, msks, _ = build_probe_table([b"\x01\x02\x03", b"\x09\x09"])
    v, m = shard_scan._tables(vals, msks, torch.device("cpu"))
    ends = torch.tensor([1000, 1000], dtype=torch.int32)
    cells = [shard_scan.Cell(d, torch.device("cpu"), d * sb, v, m, ends, 0, 2) for d in (100, 9)]
    assert not place.fits32
    acc = shard_scan.new_acc(2, "find", torch.device("cpu"))
    shard_scan.combine_cells(acc, 0, place, cells, "find")
    out = shard_scan.finish(acc, "find", place.fits32)
    assert out.dtype == np.int64 and out.tolist() == [9 * sb + 5, -1]  # ~4.5 GiB, exact
    acc = shard_scan.new_acc(2, "count", torch.device("cpu"))
    shard_scan.combine_cells(acc, 0, place, cells, "count")
    assert shard_scan.finish(acc, "count", False).tolist() == [4, 0]


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_count_matches_oracle(corpus, dh, jdh, shape):
    edge = shard_edge(corpus, shape[0], 1)
    needles = [corpus[10:14], b"aab", b"absent!", corpus[edge - 3 : edge + 3], b"a"]
    got = ShardedBatchedSearcher(needles, mesh(shape)).count_all(dh)
    assert got.dtype == np.int64 and list(got) == [overlapping_count(corpus, nd) for nd in needles]
    if shape == (8, 1):
        ref = jpar.ShardedBatchedSearcher(needles, jpar.make_mesh(shape)).count_all(jdh)
        assert ref.dtype == np.int64 and np.array_equal(got, ref)


def test_sharded_searcher_consumes_global_corpus(corpus):
    """A (single-process) GlobalCorpus is searched as it is: its shards
    built from host bytes, no relayout; a halo too small for the needle set
    raises."""
    m = distributed.global_mesh(cells_per_process=8, device=CPU)
    gc_ = distributed.assemble_global_corpus(corpus, b"", len(corpus), 32, m)
    edge = gc_.shard_bytes
    needles = [corpus[100:108], corpus[edge - 3 : edge + 5], b"nope!", b"a"]
    sb = ShardedBatchedSearcher(needles, m)
    assert list(sb.find_all(gc_)) == [corpus.find(nd) for nd in needles]
    assert list(sb.count_all(gc_)) == [overlapping_count(corpus, nd) for nd in needles]
    for nd, p in zip(needles, sb.positions_all(gc_)):
        assert np.array_equal(p, _host_positions(corpus, nd)), nd
    sb_wide = ShardedBatchedSearcher([corpus[:120]], m)
    with pytest.raises(ValueError, match="halo"):
        sb_wide.find_all(gc_)


def test_sharded_long_needle_block_cap(corpus):
    """Needles of 900 and 901 bytes (t = 225, 226) over two shards."""
    dh = preprocess(corpus, kh=1024, device=CPU)
    needles = [corpus[1000 : 1000 + 900], corpus[5000 : 5000 + 901]]
    values, masks, ends = _tables(needles, dh.length)
    got = sharded_find_cols(dh, values, masks, ends, make_mesh((2, 1), devices=[CPU, CPU]))
    assert got.tolist() == [1000, 5000]


def test_sharded_cache_invalidates_on_optimize(corpus, dh):
    """optimize_for permutes the inner groups' rows (on the device, or on
    the host from given offsets); the placed cells follow the epoch."""
    needles = [corpus[10:15], b"absent!", corpus[700_000:700_012], b"a"]
    sb = ShardedBatchedSearcher(needles, mesh((4, 2)))
    before = sb.find_all(dh)
    epoch = sb.inner._epoch
    sb.inner.optimize_for(dh)
    assert sb.inner._epoch == epoch + 1
    assert (sb.find_all(dh) == before).all()
    sb.optimize_for(dh)  # the measuring sweep runs on the mesh
    assert (sb.find_all(dh) == before).all()
    assert list(sb.count_all(dh)) == [overlapping_count(corpus, nd) for nd in needles]


def test_placed_corpus_cache_alternate_drop_purge(corpus):
    """Two corpora alternating through one searcher keep both entries; a
    dropped corpus leaves a dead weak reference, purged at the next insert;
    answers stay exact throughout."""
    needles = [corpus[10:15], b"absent!", b"a", corpus[444_444:444_452]]
    sb = ShardedBatchedSearcher(needles, mesh((4, 2)))
    bs = BatchedSearcher(needles, device=CPU)
    dh_a = preprocess(corpus, kh=16, device=CPU)
    dh_b = preprocess(corpus[::-1], kh=16, device=CPU)
    exp_a, exp_b = bs.find_all(dh_a), bs.find_all(dh_b)
    for _ in range(3):
        assert (sb.find_all(dh_a) == exp_a).all()
        assert (sb.find_all(dh_b) == exp_b).all()
    assert len(sb._placed_corpus) == 2
    del dh_b
    gc.collect()
    dh_c = preprocess(corpus[:300_000], kh=16, device=CPU)
    assert (sb.find_all(dh_c) == bs.find_all(dh_c)).all()
    alive = [k for k, v in sb._placed_corpus.items() if v[0]() is not None]
    assert len(alive) == len(sb._placed_corpus) == 2  # a + c, b purged
    assert (sb.find_all(dh_a) == exp_a).all()


def test_sharded_huge_dense_local_layout_cached(monkeypatch):
    """A repeated dense-tier huge-needle query over one GlobalCorpus lays
    out this process's range once (period-1 content: every position passes
    the prefix filter)."""
    k = MAX_NEEDLE_LEN + 2
    nd = b"a" * k
    hay = b"a" * 60_000 + b"b" + b"a" * 9_000
    m = distributed.global_mesh(cells_per_process=8, device=CPU)
    gc_ = distributed.assemble_global_corpus(hay, b"", len(hay), 64, m)
    sb = ShardedBatchedSearcher([nd], m)
    calls = []
    real = layout_mod.preprocess

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layout_mod, "preprocess", counting)
    exp = overlapping_count(hay, nd)
    assert int(sb.count_all(gc_)[0]) == exp
    first = len(calls)
    assert first >= 1  # the dense tier laid out the local range once
    assert int(sb.count_all(gc_)[0]) == exp
    assert int(sb.find_all(gc_)[0]) == hay.find(nd)
    assert np.array_equal(sb.positions_all(gc_)[0], _host_positions(hay, nd))
    assert len(calls) == first, "a repeated dense query re-laid the corpus"


def test_sharded_positions_two_tier_cap_split(corpus, monkeypatch):
    """At sparse_cap=8 a needle dense in one shard (the JAX package reads
    that cell's bitmap back) is compacted whole on the device like every
    other cell, with no host decode; both packages exact."""
    hay = bytearray(corpus[:200_000])
    for i in range(40):  # a dense cluster early, in shard 0
        hay[100 + i * 37 : 104 + i * 37] = b"ZZZQ"
    hay = bytes(hay)
    dh = preprocess(hay, force_cols=True, device=CPU)
    needles = [b"ZZZQ", hay[150_000:150_009], b"NOPE!", hay[0:2]]
    values, masks, ends = _tables(needles, dh.length)
    decoded, counts = [], []
    real_decode, real_ranks = torch_backend.decode_match_bitmap, scan_kernel.item_ranks
    monkeypatch.setattr(torch_backend, "decode_match_bitmap", lambda w: decoded.append(1) or real_decode(w))

    def ranks(item_counts, offsets=None):
        out = real_ranks(item_counts, offsets)
        counts.extend(out[0].tolist())
        return out

    monkeypatch.setattr(scan_kernel, "item_ranks", ranks)
    got = sharded_positions(dh, values, masks, ends, mesh((4, 2)), sparse_cap=8)
    assert max(counts) > 8, "no cell held more matches than the cap"
    assert not decoded, "a cell's bitmap was decoded on the host"
    ref = jpar.sharded_positions(jax_preprocess(hay, force_cols=True, seg_rows=64), values, masks, ends,
                                 jpar.make_mesh((4, 2)), sparse_cap=8)
    for nd, g, r in zip(needles, got, ref):
        assert np.array_equal(g, _host_positions(hay, nd)) and np.array_equal(g, r), nd


# -- the port's own contracts ----------------------------------------------


def test_mesh_places_cells_round_robin_and_checks_cover():
    m = make_mesh((3, 2), devices=[CPU, CPU, CPU], device=CPU)
    assert m.local_rows == [0, 1, 2] and m.home == torch.device("cpu")
    assert corpus_sharding(m)[1] == [(0, torch.device("cpu"), 0), (1, torch.device("cpu"), 0)]
    assert [d for d, _, _ in table_sharding(m)[1]] == [0, 1, 2]
    for shape, devices in (((3, 1), [CPU, CPU]), ((1, 1), [CPU, CPU])):
        with pytest.raises(ValueError, match="does not cover"):
            make_mesh(shape, devices=devices)
    with pytest.raises(ValueError, match="empty axis"):
        make_mesh((0, 2), device=CPU)
    assert make_mesh(device=CPU).shape == {"data": 1, "needle": 1}  # one cell per visible device


def test_shards_of_a_layout_are_views_with_the_next_bytes_as_halo(corpus, dh):
    place = shard_scan.place_corpus(dh, mesh((4, 1)))
    sb = place.shard_bytes
    assert sb % 128 == 0 and 4 * sb >= len(corpus) > 3 * sb
    for d in range(4):
        shard = place.shards[(d, torch.device("cpu"))]
        assert shard.data_ptr() == dh.flat.data_ptr() + d * sb  # a view, no copy
        assert bytes(shard[: sb + 16].numpy()) == (corpus + bytes(dh.flat.numel()))[d * sb : (d + 1) * sb + 16]


def test_the_jax_value_errors(corpus, dh):
    """A table wider than the halo, a huge needle without host bytes or a
    local range, a shard past int32, a corpus of another mesh."""
    values, masks, ends = _tables([corpus[:40]], dh.length)
    with pytest.raises(ValueError, match="halo bytes"):
        sharded_find_cols(dh, values, masks, ends, mesh((2, 1)))
    with pytest.raises(ValueError, match="halo bytes"):
        sharded_positions(dh, values, masks, ends, mesh((2, 1)))
    huge = corpus[:MAX_NEEDLE_LEN + 10]
    bare = preprocess(corpus, kh=64, keep_host=False, device=CPU)
    with pytest.raises(ValueError, match="requires host bytes"):
        ShardedBatchedSearcher([huge], mesh((2, 1))).find_all(bare)
    m = distributed.global_mesh(cells_per_process=2, device=CPU)
    blind = distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m, keep_local=False)
    with pytest.raises(ValueError, match="keep_local=True"):
        ShardedBatchedSearcher([huge], m).count_all(blind)
    with pytest.raises(ValueError, match="int32 device-offset range"):
        distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m, shard_bytes=2**31)
    with pytest.raises(ValueError, match="another mesh"):
        ShardedBatchedSearcher([b"ab"], mesh((4, 1))).find_all(blind)
    with pytest.raises(ValueError, match="not 2 shards"):
        distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m, shard_bytes=128)


def test_a_candidate_outside_the_own_range_raises(corpus):
    """A huge needle's candidate is verified by the process holding its
    first byte; one that lies outside this process's range means the mesh
    and the corpus's ranges disagree, and raises rather than miss a
    match."""
    m = distributed.global_mesh(cells_per_process=2, device=CPU)
    gc_ = distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m)
    huge = corpus[1000:1000 + MAX_NEEDLE_LEN + 10]
    sb = ShardedBatchedSearcher([huge], m)
    assert sb.find_all(gc_).tolist() == [1000]
    gc_.local_base = 5000  # as if this process held bytes from 5,000 on
    with pytest.raises(RuntimeError, match="outside this process's range"):
        sb.find_all(gc_)


def test_sharded_huge_needles():
    """tests/test_huge.py's huge needles over a 4x2 mesh of cells: the
    prefix filter per cell, candidates verified against the host bytes,
    one needle across the port's first shard boundary and a decoy sharing
    a real 64-byte prefix; find, count and positions (gathered too) exact,
    find as the JAX package's single layout gives it."""
    import sliceslice_tpu as jst

    corpus = bytes(np.random.default_rng(99).integers(97, 110, (400_000,), dtype=np.uint8))
    edge = shard_edge(corpus, 4, 1)
    k = MAX_NEEDLE_LEN + 700
    needles = [
        corpus[10:14],
        corpus[77_000 : 77_000 + k],
        corpus[edge - 900 : edge - 900 + k],
        b"q" * k,
        corpus[1_000:1_064] + b"\xffX" + bytes(2_500),
        corpus[-5:],
    ]
    sb = ShardedBatchedSearcher(needles, mesh((4, 2)))
    dh = preprocess(corpus, device=CPU)
    got = sb.find_all(dh)
    assert list(got) == [corpus.find(nd) for nd in needles]
    assert list(sb.count_all(dh)) == [overlapping_count(corpus, nd) for nd in needles]
    pos = sb.positions_all(dh)
    for nd, p in zip(needles, pos):
        assert np.array_equal(p, _host_positions(corpus, nd)), nd[:20]
    for p, q in zip(pos, sb.positions_all(dh, gather=True)):
        assert np.array_equal(p, q)
    assert np.array_equal(got, jst.BatchedSearcher(needles).find_all(jst.preprocess(corpus)))


def test_sharded_huge_global_corpus_requires_local_bytes():
    """A ``GlobalCorpus`` assembled without its local bytes cannot verify a
    huge needle's candidates and raises; with them, find, count and
    gathered positions are exact, as in the JAX package."""
    import sliceslice_tpu as jst

    corpus = bytes(np.random.default_rng(99).integers(97, 110, (400_000,), dtype=np.uint8))
    nd = corpus[5_000 : 5_000 + MAX_NEEDLE_LEN + 100]
    m = distributed.global_mesh(2, cells_per_process=8, device=CPU)
    assert m.shape == {"data": 4, "needle": 2}
    sb = ShardedBatchedSearcher([nd], m)
    blind = distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m, keep_local=False)
    with pytest.raises(ValueError, match="keep_local"):
        sb.find_all(blind)
    gc_ = distributed.assemble_global_corpus(corpus, b"", len(corpus), 64, m)
    assert list(sb.find_all(gc_)) == [5_000] == [jst.DynamicSearcher(nd).find(corpus)]
    assert list(sb.count_all(gc_)) == [overlapping_count(corpus, nd)]
    assert np.array_equal(sb.positions_all(gc_, gather=True)[0], _host_positions(corpus, nd))
