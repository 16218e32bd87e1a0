"""The probe-table contracts, the oracle and the state sizes of the port,
against the JAX package and the host oracles — the mirror of
tests/test_contracts.py's caller-built tables (an exotic final mask, a
mixed-width table, a sharded mixed-width table with a padding row) and of
its state-size pin, plus ``naive_windows_find``.

One deliberate deviation is pinned here: the JAX ``*_cols`` entry points
refuse a mixed-width table (their TPU kernels compare non-final slots
unmasked), while the port's kernels apply every slot's mask and answer it
exactly.  Every comparison is exact."""

import numpy as np
import pytest
import torch

import sliceslice_tpu as jst
import sliceslice_tpu.ops.layout as jl
import sliceslice_tpu.ops.scan_kernel as jsk
import sliceslice_tpu.parallel as jpar
from sliceslice_tpu.models import naive_find as jax_naive_find
from sliceslice_tpu.models import naive_windows_find as jax_naive_windows_find
from sliceslice_tpu_torch import BatchedSearcher, models, naive_find, preprocess
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.models import naive_windows_find
from sliceslice_tpu_torch.needle import build_probe_table, num_probes
from sliceslice_tpu_torch.ops import scan_kernel
from sliceslice_tpu_torch.ops.layout import ALIGN, round_up
from sliceslice_tpu_torch.parallel import make_mesh, sharded_find_cols
from sliceslice_tpu_torch.scripts import contract_cases

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"
CASES = {c.name: c for c in contract_cases.cases()}


def test_width_gap_table_exact_where_jax_raises():
    """The JAX test's mixed-width table: its ``batched_find_cols`` and
    ``batched_count_cols`` raise, run as tests/test_contracts.py runs them;
    the port's find, count and bitmap -> compaction give ``bytes.find``'s,
    ``overlapping_count``'s and the host scan's answers."""
    case = CASES["mixed_width"]
    jdh = jl.preprocess(case.hay, kh=16, force_cols=True)
    for fn in (jsk.batched_find_cols, jsk.batched_count_cols):
        with pytest.raises(ValueError, match="width contract"):
            fn(None, case.values, case.masks, case.ends, s=jdh.s, pw=jdh.windows())
    assert case.masks[0].tolist() == [0xFFFFFFFF, 0, 0, 0]  # slots 1..3 of row 0: mask 0
    flat = preprocess(case.hay, kh=16, force_cols=True, device=CPU).flat
    assert scan_kernel.batched_find(flat, case.values, case.masks, case.ends).tolist() == [4, 20012]
    assert scan_kernel.batched_count(flat, case.values, case.masks, case.ends).tolist() == [2, 1]
    dh, v, m, e = contract_cases.operands(case, CPU)
    got = contract_cases.answers(dh.flat, v, m, e)
    exp = contract_cases.oracle(case)
    assert exp[0] == [4, 20012] and exp[1] == [2, 1]
    assert [p.tolist() for p in exp[2]] == [[4, 20022], [20012]]
    assert contract_cases.same(got, exp)


def test_exotic_final_mask_exact():
    """A caller-built row whose final mask is 0xFFFF0000 (it matches
    ``b"QRST??WX"``): the port's find gives 123,456 on the single layout
    and through ``sharded_find_cols`` on a 2x1 mesh of CPU cells, as the
    JAX package gives; the prefix-mask table gives the JAX answer too."""
    case = CASES["exotic_mask"]
    dh, v, m, e = contract_cases.operands(case, CPU)
    got = contract_cases.answers(dh.flat, v, m, e)
    assert contract_cases.same(got, contract_cases.oracle(case))
    assert got[0] == [contract_cases.EXOTIC_AT] and got[1] == [1]
    mesh = make_mesh((2, 1), device=CPU)
    assert sharded_find_cols(dh, case.values, case.masks, case.ends, mesh).tolist() == [123_456]
    jdh = jl.preprocess(case.hay, kh=16)
    ref = jsk.batched_find_cols(None, case.values, case.masks, case.ends, s=jdh.s, pen_full=True,
                                pw=jdh.windows())
    assert np.asarray(ref).tolist() == [123_456]

    prefix = CASES["prefix_mask"]
    pdh, pv, pm, pe = contract_cases.operands(prefix, CPU)
    ref = jsk.batched_find_cols(None, prefix.values, prefix.masks, prefix.ends, s=jdh.s,
                                pen_full=True, pw=jdh.windows())
    assert scan_kernel.batched_find(pdh.flat, pv, pm, pe).tolist() == np.asarray(ref).tolist() == [123_456]
    assert contract_cases.same(contract_cases.answers(pdh.flat, pv, pm, pe),
                               contract_cases.oracle(prefix))


def test_sharded_width_gap_regroups_exactly():
    """At 4x1 cells, a table of mixed widths plus an explicit padding row
    (mask 0, end 0) gives ``[50, 60000, SENTINEL, SENTINEL]``: the JAX
    package's answer on 4 virtual devices, ``bytes.find``'s and the port's
    single layout's."""
    rng = np.random.default_rng(3)
    hay = bytes(rng.integers(97, 102, (120_000,), dtype=np.uint8))
    needles = [hay[50:54], hay[60_000:60_016], b"nope"]
    values, masks, lengths = build_probe_table(needles)
    values = np.pad(values, ((0, 1), (0, 0)))
    masks = np.pad(masks, ((0, 1), (0, 0)))
    ends = np.append(np.maximum(len(hay) - lengths + 1, 0).astype(np.int64), 0)
    dh = preprocess(hay, kh=16, device=CPU)
    got = sharded_find_cols(dh, values, masks, ends, make_mesh((4, 1), device=CPU))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert got.tolist() == [50, 60_000, SENTINEL, SENTINEL]
    exp = [hay.find(nd) for nd in needles]
    assert [-1 if o >= SENTINEL else o for o in got.tolist()[:3]] == exp
    single = scan_kernel.batched_find(dh.flat, values, masks, ends.astype(np.int32))
    assert torch.equal(got, single)
    import jax

    jmesh = jpar.make_mesh((4, 1), jax.devices()[:4])
    ref = jpar.sharded_find_cols(jl.preprocess(hay, kh=16), values, masks, ends, jmesh)
    assert np.asarray(ref).tolist() == got.tolist()


def test_state_size_pinning():
    """The port's device state: each width group's tables are int32, 8
    bytes per (needle, probe slot) plus block padding, in the JAX package's
    group shapes; a layout is one flat uint8 tensor of the corpus, its
    rounded halo and one aligned block of slack, at every length."""
    needles = [b"ab", b"abcde", b"abcdefghij", b"x" * 33]
    bs = BatchedSearcher(needles, device=CPU)
    jbs = jst.BatchedSearcher(needles)
    assert [(g.t, g.n_pad) for g in bs.groups] == [(g.t, g.n_pad) for g in jbs.groups]
    for grp in bs.groups:
        for table in (grp.values_dev, grp.masks_dev):
            assert table.dtype == torch.int32 and table.element_size() == 4
            assert table.numel() * table.element_size() == grp.n_pad * grp.t * 4
    for nd in needles:
        assert num_probes(len(nd)) * 8 == 2 * 4 * -(-len(nd) // 4)

    data = bytes(np.random.default_rng(1).integers(97, 105, (200_000,), dtype=np.uint8))
    dh = preprocess(data, kh=32, device=CPU)
    assert dh.flat.dtype == torch.uint8 and dh.flat.dim() == 1
    assert dh.flat.numel() == round_up(200_000 + 32, ALIGN) + ALIGN == 200_192
    assert dh.flat.numel() / len(data) < 1.001  # ~1 byte per corpus byte (JAX: ~5)
    assert preprocess(data, kh=100, device=CPU).flat.numel() == round_up(200_000 + 128, ALIGN) + ALIGN
    assert preprocess(data[:300], device=CPU).flat.numel() == round_up(300 + 64, ALIGN) + ALIGN == 512
    tensors = [f for f in vars(dh).values() if isinstance(f, torch.Tensor)]
    assert len(tensors) == 1  # the layout holds no other device state


def test_naive_windows_find_matches_jax():
    """The literal windows() oracle on a few hundred seeded small cases:
    equal to the JAX package's, to both packages' ``naive_find`` and to
    ``bytes.find``; an empty needle finds 0, a needle longer than the
    haystack and an absent one ``None``; a match at the last window."""
    assert "naive_windows_find" in models.__all__
    rng = np.random.default_rng(41)
    cases = [(b"", b""), (b"abc", b""), (b"ab", b"abc"), (b"abcab", b"cab"), (b"aaab", b"ab"),
             (b"", b"a"), (b"xyz", b"xyz")]
    for _ in range(400):
        hay = bytes(rng.integers(97, 100, (int(rng.integers(0, 24)),), dtype=np.uint8))
        kind = int(rng.integers(0, 4))
        if kind == 0 and hay:
            i = int(rng.integers(0, len(hay)))
            nd = hay[i : i + int(rng.integers(1, 6))]
        elif kind == 1:
            nd = hay[len(hay) - int(rng.integers(0, len(hay) + 1)):]  # a suffix: the last window
        elif kind == 2:
            nd = hay + bytes(rng.integers(97, 100, (int(rng.integers(1, 4)),), dtype=np.uint8))
        else:
            nd = bytes(rng.integers(97, 100, (int(rng.integers(0, 5)),), dtype=np.uint8))
        cases.append((hay, nd))
    kinds = set()
    for hay, nd in cases:
        got = naive_windows_find(hay, nd)
        exp = None if hay.find(nd) < 0 else hay.find(nd)
        assert got == exp == jax_naive_windows_find(hay, nd) == naive_find(hay, nd) == jax_naive_find(hay, nd), (hay, nd)
        kinds.add("empty" if not nd else "longer" if len(nd) > len(hay)
                  else "last" if got is not None and got == len(hay) - len(nd) else "other")
    assert kinds == {"empty", "longer", "last", "other"}
