"""The port's spans and counters (``sliceslice_tpu_torch/utils/tracing.py``)
on the CPU: under a CPU ``torch.profiler`` each of ``find_all``,
``count_all`` and ``positions_all`` is a root span with its stage spans
nested inside it on one thread; with no profiler a span is the shared null
context and opens no profiler range; the counters move only for work on a
card; and the record of what the spans measured under a profiler
(``tracing.traced``) sums calls, seconds and self seconds."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sliceslice_tpu_torch import BatchedSearcher, preprocess
from sliceslice_tpu_torch.ops import transfer
from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count
from sliceslice_tpu_torch.utils import tracing

CPU = "cpu"

#: Per call: its root span and the spans that must lie inside it.
SPANS = {
    "find_all": ("sliceslice.find_all", {"sliceslice.scatter", "sliceslice.huge"}),
    "count_all": ("sliceslice.count_all", {"sliceslice.scatter", "sliceslice.huge"}),
    "positions_all": ("sliceslice.positions_all",
                      {"sliceslice.positions.batch", "sliceslice.positions.bases",
                       "sliceslice.positions.widen", "sliceslice.positions.split",
                       "sliceslice.positions.place", "sliceslice.huge"}),
}


@pytest.fixture(scope="module")
def held(i386_small, words):
    """A layout on the CPU and a searcher of 48 words and one
    huge needle (past ``MAX_NEEDLE_LEN``), with the host oracles."""
    needles = words[:48] + [i386_small[1000:3100]]
    dh = preprocess(i386_small, force_cols=True, device=CPU)
    bs = BatchedSearcher(needles, device=CPU)
    assert bs._huge
    exp = {"find_all": np.array([i386_small.find(n) for n in needles]),
           "count_all": np.array([overlapping_count(i386_small, n) for n in needles]),
           "positions_all": [_host_positions(i386_small, n) for n in needles]}
    return dh, bs, exp


def _same(call, got, exp) -> bool:
    if call == "positions_all":
        return len(got) == len(exp) and all(np.array_equal(g, e) for g, e in zip(got, exp))
    return np.array_equal(got, exp)


@pytest.mark.parametrize("call", sorted(SPANS))
def test_each_call_is_a_root_span_with_its_stages_inside(held, call):
    dh, bs, exp = held
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = getattr(bs, call)(dh)
    assert _same(call, got, exp[call])
    root_name, inner = SPANS[call]
    events = [e for e in prof.events() if e.name.startswith("sliceslice.")]
    roots = [e for e in events if e.name == root_name]
    assert len(roots) == 1
    root = roots[0]
    assert {e.name for e in events} == {root_name} | inner
    for e in events:
        assert e.thread == root.thread
        assert root.time_range.start <= e.time_range.start <= e.time_range.end <= root.time_range.end
        # Operator-scope ranges: the profiler gives them no device-side copy.
        assert not e.is_user_annotation
    # The row slices, the bases and the widening lie inside a batch of the protocol.
    batches = [e.time_range for e in events if e.name == "sliceslice.positions.batch"]
    for e in events:
        if e.name in ("sliceslice.positions.bases", "sliceslice.positions.widen",
                      "sliceslice.positions.split"):
            assert any(b.start <= e.time_range.start and e.time_range.end <= b.end for b in batches)


@pytest.mark.parametrize("call", sorted(SPANS))
def test_no_profiler_no_range_and_no_counter_moves_on_the_cpu(held, call, monkeypatch):
    dh, bs, exp = held

    def refuse(name):
        raise AssertionError(f"a profiler range was opened for {name} with no profiler running")

    monkeypatch.setattr(tracing, "_profiler_range", refuse)
    assert tracing.span("sliceslice.x") is tracing.span("sliceslice.y")
    assert isinstance(tracing.span("sliceslice.x"), contextlib.nullcontext)
    before, traced = tracing.counters(), tracing.traced()
    assert _same(call, getattr(bs, call)(dh), exp[call])
    # Launches, readbacks and uploads count only work on a card.
    assert tracing.counters() == before and tracing.traced() == traced


@pytest.mark.parametrize("copy", ["to_host", "to_device"])
def test_copies_on_the_cpu_are_not_counted(copy):
    before = tracing.counters()
    x = np.arange(5, dtype=np.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if copy == "to_host":
            got = transfer.to_host(torch.from_numpy(x))
        else:
            got = transfer.to_device(x, torch.device(CPU)).numpy()
    assert np.array_equal(got, x)
    assert tracing.counters() == before
    assert not [e for e in prof.events() if e.name.startswith("sliceslice.")]


def test_counters_copy_and_traced_self_time(monkeypatch):
    monkeypatch.setattr(tracing, "_counts", {})
    monkeypatch.setattr(tracing, "_traced_counts", {})
    monkeypatch.setattr(tracing, "_traced_spans", {})
    tracing.count("launches.k")
    snap = tracing.counters()
    tracing.count("launches.k", 2)
    tracing.count("readback_bytes", 40)
    assert snap == {"launches.k": 1}
    assert tracing.counters() == {"launches.k": 3, "readback_bytes": 40}
    assert tracing.traced() == {"spans": {}, "counters": {}}  # no span was open
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("sliceslice.outer"):
            with tracing.span("sliceslice.inner"):
                tracing.count("launches.k")
                torch.ones(1000).sum()
            with tracing.span("sliceslice.inner"):
                pass
            tracing.count("readbacks")
    rec = tracing.traced()
    assert rec["counters"] == {"launches.k": 1, "readbacks": 1}
    (oc, o_s, o_self), (ic, i_s, i_self) = rec["spans"]["sliceslice.outer"], rec["spans"]["sliceslice.inner"]
    assert (oc, ic) == (1, 2) and i_s == i_self
    assert o_self == pytest.approx(o_s - i_s, abs=1e-9) and 0 < o_self < o_s
    assert tracing.counters()["launches.k"] == 4
