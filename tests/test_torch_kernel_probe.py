"""The port's ablation harness (``sliceslice_tpu_torch/scripts/kernel_probe.py``)
against the JAX package's (``scripts/kernel_probe.py``), on the CPU.

* ``make_tables`` builds the JAX script's tables byte for byte (captured
  from its ``main`` by replacing ``build``);
* each variant's plain version equals its "must equal" column on small
  corpora;
* the port's plain ``first`` / ``nomin`` / count family against the JAX
  ``build`` in TPU interpret mode (``full``, ``nomin``, ``premask``,
  ``dedup``) on a one-segment layout, decoded to first offsets.

The JAX script is imported by path and its ``pl.pallas_call`` wrapped with
``monkeypatch``; the script itself is never edited.  Exact comparisons.
The CUDA kernel is held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import importlib.util
import os
import struct
import sys

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu_torch.ops.scan_kernel as tsk
from sliceslice_tpu_torch import overlapping_count, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
from sliceslice_tpu_torch.ops.scan_math import pair_hash
from sliceslice_tpu_torch.scripts import kernel_probe as kp
from sliceslice_tpu_torch.utils import tracing

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX harness as a module, imported by path (never edited)."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_probe", os.path.join(REPO, "scripts", "kernel_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(jax_probe, monkeypatch):
    """``build`` with every ``pl.pallas_call`` in TPU interpret mode, its
    cache cleared before and after so no compiled call leaks out."""
    from jax.experimental.pallas import tpu as pltpu

    orig = jax_probe.pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=pltpu.InterpretParams(), **k))
    jax_probe.build.cache_clear()
    yield jax_probe.build
    jax_probe.build.cache_clear()


@pytest.fixture(scope="module")
def i386():
    with open(os.path.join(REPO, "data", "i386.txt"), "rb") as f:
        return f.read()


class _Captured(Exception):
    pass


@pytest.mark.parametrize("t", [1, 2, 3])
def test_make_tables_match_the_jax_harness(jax_probe, monkeypatch, i386, t):
    seen = {}

    def build(*args, **kwargs):
        def call(vals, msks, *rest):
            seen["values"], seen["masks"] = np.asarray(vals), np.asarray(msks)
            raise _Captured

        return call

    monkeypatch.setattr(jax_probe, "build", build)
    monkeypatch.setattr(sys, "argv", ["kernel_probe.py", f"t={t}", "U=16", "full"])
    monkeypatch.chdir(REPO)
    with pytest.raises(_Captured):
        jax_probe.main()
    values, masks = kp.make_tables(i386, t)
    assert values.dtype == masks.dtype == np.uint32
    assert values.tobytes() == seen["values"].tobytes()
    assert masks.tobytes() == seen["masks"].tobytes()
    if t == 2:
        plants = kp.planted(i386, masks)
        assert sorted(plants) == [0, 201, 255, 4000]
        for row, nd in plants.items():
            assert len(nd) == kp.needle_lengths(masks)[row]
            assert i386.find(nd) >= 0


def _corpus(rng, n=30_000):
    """A small-alphabet body with runs of 0xFF bytes (windows that are all
    ones, for noprobe) and a tail of unique bytes."""
    body = rng.integers(97, 101, n - 64, dtype=np.uint8)
    for p in (0, 999, 4096, 17_001):
        body[p : p + 7] = 0xFF
    return np.concatenate([body, rng.permutation(np.arange(192, 256, dtype=np.uint8))]).tobytes()


def _plant(hay, values, masks, rows_offsets):
    """Rows of the table holding the corpus bytes at an offset: needles
    of the length each row's table describes."""
    k = kp.needle_lengths(masks)
    t = masks.shape[1]
    for row, off in rows_offsets:
        nd = hay[off : off + int(k[row])].ljust(4 * t, b"\0")
        values[row] = np.frombuffer(nd, "<u4") & masks[row]
    return {row: hay[off : off + int(k[row])] for row, off in rows_offsets}


def _walk_steps(hay: bytes, values, masks, limits, slots: int, hashed: bool = False) -> list:
    """Per row, the spans of kp.WARP_SPAN positions holding a position
    below its limit whose first ``slots`` probe windows match, read from
    the bytes (walk_shares' column); with ``hashed``, for a row whose slots
    0 and 1 are whole, whose pair hash equals the row's instead."""
    t = values.shape[1]
    s = min(slots, t)
    win = np.frombuffer(hay + b"\0" * 8, np.uint8)
    out = []
    for v, m, lim in zip(values, masks, limits):
        p = np.arange(int(lim))
        ok = np.ones(len(p), bool)
        w = []
        for i in range(s):
            q = p + 4 * i
            w.append(win[q].astype(np.uint32) | win[q + 1].astype(np.uint32) << 8
                     | win[q + 2].astype(np.uint32) << 16 | win[q + 3].astype(np.uint32) << 24)
            ok &= (w[i] & m[i]) == v[i]
        if hashed and s == 2 and m[0] == m[1] == 0xFFFFFFFF:
            ok = pair_hash(w[0], w[1]) == pair_hash(int(v[0]), int(v[1]))
        out.append(len(np.unique(p[ok] // kp.WARP_SPAN)))
    return out


@pytest.mark.parametrize("t", [1, 2, 3, 5])
def test_plain_variants_equal_their_columns(rng, t):
    hay = _corpus(rng)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=CPU)
    values, masks = kp.make_tables(hay, t, n=40)
    plants = _plant(hay, values, masks, [(1, 3), (6, 1000), (9, 29_000), (14, 17_000), (23, len(hay) - 4 * t)])
    ends = kp.table_ends(masks, len(hay))
    count = tsk.batched_count(dh.flat, values, masks, ends, n_real=37)
    first = tsk.batched_find(dh.flat, values, masks, ends, n_real=37)
    for row, nd in plants.items():
        assert int(first[row]) == hay.find(nd) and int(count[row]) == overlapping_count(hay, nd)
    bound = tsk.position_limit(dh.flat.numel(), t)
    lim = np.minimum(ends.astype(np.int64), bound)
    before = tracing.counters()
    for variant in kp.VARIANTS:
        for rows in (kp.ROWS if variant == "rows" else (4,)):
            got = kp.probe(variant, dh.flat, values, masks, ends, n_real=37, rows=rows)
            assert got.dtype == torch.int32 and got.shape == (kp.NBLK,)
            assert torch.equal(got, kp.probe_plain(variant, dh.flat, values, masks, ends, n_real=37, rows=rows))
            if variant in kp.COUNTING:
                assert torch.equal(got, count), variant
            elif variant == "first":
                assert torch.equal(got, first)
            elif variant == "nomin":
                assert got.tolist() == [int(f != SENTINEL) for f in first.tolist()]
            elif variant == "noprobe":
                ones = [q for q in range(len(hay) - 3) if hay[q : q + 4] == b"\xff" * 4]
                exp = [sum(q < e for q in ones) for e in lim[:37]] + [0] * (kp.NBLK - 37)
                assert got.tolist() == exp and max(exp) == 16
            else:  # empty: XOR of the word indices below each limit
                exp = []
                for e in lim[:37]:
                    x = 0
                    for j in range((int(e) + 3) // 4):
                        x ^= j
                    exp.append(x)
                assert got.tolist() == exp + [0] * (kp.NBLK - 37)
    assert tracing.counters() == before  # the CPU takes the plain versions


def test_probe_refuses_what_it_has_no_kernel_for(rng):
    hay = _corpus(rng)
    dh = preprocess(hay, kh=32, device=CPU)
    values, masks = kp.make_tables(hay, 2, n=8)
    ends = kp.table_ends(masks, len(hay))
    with pytest.raises(ValueError, match="unknown probe variant"):
        kp.probe("full", dh.flat, values, masks, ends)
    with pytest.raises(ValueError, match="rows per block"):
        kp.probe("rows", dh.flat, values, masks, ends, rows=3)
    with pytest.raises(ValueError, match="no probe kernel"):
        kp.probe("count", torch.empty(1024, dtype=torch.uint8, device="meta"), values, masks, ends)


@pytest.mark.parametrize("variant", ["prefilter", "smemtab", "span", "word", "nomask"])
@pytest.mark.parametrize("t", [1, 2, 4, 6])
def test_queue_variants_equal_batched_count(rng, variant, t):
    """The variants the queue loop added, and ``nomask``, on needles that do occur (real
    tables, not the harness's never-matching ones): 1-byte needles, needles
    of every length of the width, one ending in a zero byte, absent ones;
    base > 0 and n_real < n."""
    from sliceslice_tpu_torch.needle import build_probe_table

    hay = _corpus(rng)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=CPU)
    needles = [b"a", b"\xff", hay[-1:]]
    for k in range(max(1, 4 * t - 4), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles += [hay[start : start + k], b"\x7f" * k, hay[-k:], hay[len(hay) - k + 1 :] + b"\0"]
    vals, msks, lens = build_probe_table(needles, t_max=t)
    ends = np.maximum(len(hay) - lens + 1, 0).astype(np.int32)
    for base, n_real in ((0, None), (512, len(needles) - 3)):
        e = np.where(ends > 0, ends + base, 0).astype(np.int32)
        got = kp.probe(variant, dh.flat, vals, msks, e, base=base, n_real=n_real)
        assert torch.equal(got, tsk.batched_count(dh.flat, vals, msks, e, base=base, n_real=n_real))
        live = len(needles) if n_real is None else n_real
        assert got.tolist()[:live] == [overlapping_count(hay, nd) for nd in needles[:live]]
        assert not any(got.tolist()[live:])


def test_variant_lists_are_consistent():
    assert len(set(kp.VARIANTS)) == len(kp.VARIANTS) == 12 and not {"wide", "regtab"} & set(kp.VARIANTS)
    assert set(kp.COUNTING) | {"first", "nomin", "noprobe", "empty"} == set(kp.VARIANTS)
    assert set(kp.SPAN_PLAN) <= set(kp.COUNTING)
    for bad in ("wide", "regtab", "full", ""):
        with pytest.raises(ValueError, match="unknown probe variant"):
            kp._check(bad, 4)
    for rows in (0, 3, 16):
        with pytest.raises(ValueError, match="rows per block"):
            kp._check("rows", rows)
    for variant in kp.VARIANTS:
        kp._check(variant, 4)


def _decode_first(out: np.ndarray, s: int) -> list:
    """First offset per row of the JAX harness's (rows, 128) per-lane
    values on a one-segment layout: min over lanes of lane * s + value."""
    lanes = np.arange(out.shape[1], dtype=np.int64) * s
    hit = out < SENTINEL
    best = np.where(hit, lanes[None, :] + out, np.iinfo(np.int64).max).min(axis=1)
    return [int(b) if h else -1 for b, h in zip(best, hit.any(axis=1))]


def _dedup_operands(values: np.ndarray, umax: int):
    """The JAX script's per-block unique slot-0 tables (its ``main``)."""
    nblocks = values.shape[0] // kp.NBLK
    uvals = np.zeros((nblocks, umax), np.uint32)
    cls = np.zeros(values.shape[0], np.int32)
    for b in range(nblocks):
        u, inv = np.unique(values[b * kp.NBLK : (b + 1) * kp.NBLK, 0], return_inverse=True)
        uvals[b, : len(u)] = u
        cls[b * kp.NBLK : (b + 1) * kp.NBLK] = inv
    return uvals, cls.reshape(-1, 1)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_plain_variants_match_the_jax_build(interpret, i386, t):
    """On a one-segment layout (40,000 bytes, kh=24: g=1, s=512) the JAX
    ``full`` output decodes to first offsets and ``nomin`` flags the rows
    found: the port's plain ``first``, ``nomin`` and count family give the
    same rows, with planted needles at their ``bytes.find`` offsets."""
    import jax.numpy as jnp

    hay = i386[:40_000]
    jdh = jst.preprocess(hay, kh=24)
    pw = jdh.windows()
    g, h = pw.shape[0], pw.shape[1] + 3
    assert g == 1
    values, masks = kp.make_tables(hay, t, n=kp.NBLK)
    plants = _plant(hay, values, masks, [(0, 1000), (100, 5000), (201, 20_000), (255, 39_990 - 4 * t)])
    vj, mj = jnp.asarray(values), jnp.asarray(masks)
    out = {v: np.asarray(interpret(g, h, jdh.s, t, kp.NBLK, v)(vj, mj, pw)) for v in ("full", "nomin")}
    if t == 2:
        umax = 16
        uvals, cls = _dedup_operands(values, umax)
        out["premask"] = np.asarray(interpret(g, h, jdh.s, t, kp.NBLK, "premask")(vj, mj, pw))
        out["dedup"] = np.asarray(interpret(g, h, jdh.s, t, kp.NBLK, "dedup", 4, umax)(
            vj, mj, jnp.asarray(uvals), jnp.asarray(cls), pw))
    ref = _decode_first(out["full"], jdh.s)
    for row, nd in plants.items():
        assert ref[row] == hay.find(nd) >= 0
    assert sum(r >= 0 for r in ref) == len(plants)
    for v in ("premask", "dedup"):
        if v in out:
            assert _decode_first(out[v], jdh.s) == ref, v

    dh = preprocess(hay, kh=needed_halo_for_t(t), device=CPU)
    ends = kp.table_ends(masks, len(hay))
    first = kp.probe_plain("first", dh.flat, values, masks, ends)
    assert [f if f < SENTINEL else -1 for f in first.tolist()] == ref
    nomin = kp.probe_plain("nomin", dh.flat, values, masks, ends)
    assert nomin.tolist() == (out["nomin"] < SENTINEL).any(axis=1).astype(int).tolist()
    for variant in kp.COUNTING:
        counts = kp.probe_plain(variant, dh.flat, values, masks, ends)
        assert [int(c > 0) for c in counts.tolist()] == nomin.tolist(), variant
        for row, nd in plants.items():
            assert int(counts[row]) == overlapping_count(hay, nd), (variant, row)


def test_main_runs_on_the_cpu(capsys):
    assert kp.main(["t=2", "n=8", "k=1", "device=cpu", "count", "empty", "span"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("CPU, plain versions")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == ["count", "empty", "span"]
    assert all("ms/sweep" in ln and "ns/(row, 1024 pos)" in ln for ln in lines[1:])
    assert kp.main(["t=5", "n=8", "k=1", "device=cpu", "all"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == list(kp.VARIANTS)
    with pytest.raises(ValueError, match="unknown probe variant"):
        kp.main(["t=5", "device=cpu", "regtab"])


def test_walk_shares_on_a_four_letter_text():
    """walk_shares groups needles by width as BatchedSearcher does, and its
    steps and filter passes are the bytes' own: on 64 KiB of ACGT with
    20-byte guides cut from it, two slots pass fewer steps than one, and
    every guide passes at its own site; the pair hash passes what two slots
    do, since it is one-to-one on a four-letter text's window pairs."""
    rng = np.random.default_rng(24)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1 << 16)].tobytes()
    guides = [dna[a : a + 20] for a in rng.choice(len(dna) - 20, 24, replace=False)]
    needles = guides + [b"AC", b"ACGTA", dna[:9]]
    rows = kp.walk_shares(dna, needles, CPU)
    assert [r[:2] for r in rows] == [(1, 1), (2, 1), (3, 1), (5, 24)]
    for t, n, steps, w1, w2, wh in rows:
        group = [nd for nd in needles if -(-len(nd) // 4) == t]
        values, masks, lens = build_probe_table(group, t_max=t)
        ends = np.maximum(len(dna) - lens + 1, 0)
        assert steps == sum(-(-int(e) // kp.WARP_SPAN) for e in ends)
        assert [w1, w2] == [sum(_walk_steps(dna, values, masks, ends, s)) for s in (1, 2)]
        assert wh == sum(_walk_steps(dna, values, masks, ends, 2, hashed=True))
        assert n <= w2 <= w1 <= steps and (w2 < w1 if t > 1 else w2 == w1)
        assert wh == w2  # so at least w2, which every hashed filter passes
    t5 = rows[-1]
    assert t5[3] > 0.5 * t5[2] > 10 * t5[4] and t5[5] == t5[4]


def test_table_helpers():
    masks = np.array([[0xFFFFFFFF, 0xFF], [0xFFFFFFFF, 0xFFFF], [0xFFFFFFFF, 0xFFFFFF],
                      [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    assert kp.needle_lengths(masks).tolist() == [5, 6, 7, 8]
    assert kp.table_ends(masks, 7).tolist() == [3, 2, 1, 0]
    assert kp.table_ends(masks, 3).tolist() == [0, 0, 0, 0]
    v, m = kp.make_tables(b"", 2, n=300)
    assert v.shape == m.shape == (512, 2) and not kp.planted(b"", m)
    assert set(np.unique(v[:, 0]).tolist()) <= set(range(1, 7))
    assert struct.pack("<I", int(m[3, 1])) == b"\xff" * 4
