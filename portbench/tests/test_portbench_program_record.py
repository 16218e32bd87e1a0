"""The readers of the program's own record (``portbench/program_record.py``
and the ``program_span`` / ``program_counter`` metrics) on the CPU: the
arithmetic on a synthetic record, None wherever there is nothing to read,
and the program's spans in ``trace.summarize`` as host events only."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import harness, program_record, spec, trace
from sliceslice_tpu_torch.utils import tracing

from .conftest import run_tiny

PROGRAM = [m for m in spec.load_benchmark()["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
#: 4 profiled positions requests: 72 launches, 48 readbacks; seconds.
RECORD = {
    "spans": {"sliceslice.positions_all": (4, 0.020, 0.004),
              "sliceslice.launch.match_bitmap_counted": (24, 0.0012, 0.0012),
              "sliceslice.launch.item_ranks": (24, 0.0006, 0.0006),
              "sliceslice.launch.compact_window": (24, 0.0006, 0.0006),
              "sliceslice.readback": (48, 0.008, 0.008),
              "sliceslice.upload": (24, 0.0004, 0.0004),
              "sliceslice.positions.split": (24, 0.003, 0.003)},
    "counters": {"launches.match_bitmap_counted": 24, "launches.item_ranks": 24,
                 "launches.compact_window": 24, "readbacks": 48, "readback_bytes": 1 << 20},
}
WANT = {"launches_per_query": 18.0, "launch_host_us": 2400 / 72, "readbacks_per_query": 12.0,
        "readback_ms": 2.0, "protocol_host_ms": (0.020 - 0.0024 - 0.008 - 0.0004) / 4 * 1e3}


def _run(op="positions", traced=True):
    return types.SimpleNamespace(op=op, trace=object() if traced else None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_on_a_synthetic_record(name, monkeypatch):
    monkeypatch.setattr(tracing, "traced", lambda: RECORD)
    read = harness.load_reader(name)
    assert read(_run()) == pytest.approx(WANT[name])
    assert read(_run(traced=False)) is None
    assert read(_run(op="find")) is None  # no find_all root span in this record
    monkeypatch.setattr(tracing, "traced", lambda: dict(RECORD, counters={"readbacks": 48}))
    assert read(_run()) is None  # no launch: the plain versions


def test_readers_read_nothing_from_a_program_without_the_record(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sliceslice_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["sliceslice_tpu_torch.utils"], "tracing")
    assert program_record.record(_run()) is None
    for m in PROGRAM:
        assert harness.load_reader(m["name"])(_run()) is None


def _event(name, start, end, device=DeviceType.CPU, thread=1):
    return types.SimpleNamespace(name=name, device_type=device, thread=thread,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_program_spans_are_host_events_that_label_idle_gaps():
    """A request 0-100 us, two kernels (10-20, 60-70): the program's span
    over 25-55 labels that gap and adds no device event or busy time."""
    base = [_event(trace.REQUEST, 0, 100), _event("kernel_a", 10, 20, DeviceType.CUDA),
            _event("kernel_b", 60, 70, DeviceType.CUDA)]
    plain = trace.summarize(base)
    spanned = trace.summarize(base + [_event("sliceslice.positions.split", 25, 55)])
    assert (spanned.device_events, spanned.busy_s, spanned.window_s) == \
        (plain.device_events, plain.busy_s, plain.window_s) == (2, 20e-6, 100e-6)
    assert dict(plain.idle_gaps) == pytest.approx({trace.IN_REQUEST: 80e-6})
    assert dict(spanned.idle_gaps) == pytest.approx({trace.IN_REQUEST: 40e-6,
                                                     "sliceslice.positions.split": 40e-6})


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_traced_tiny_run_reports_program_metrics_only_above_zero(name):
    result, _ = run_tiny(name, trace=True)
    for m in PROGRAM:
        v = result["metrics"].get(m["name"], {}).get("value")
        assert v is None or v > 0, (m["name"], v)
