"""The port's utility layer: the mirror of tests/test_utils.py's first
three cases (its fourth, offsets past 2^32 in a stream, is mirrored in
test_torch_streaming.py): the measurement harness, mmap ingest and trace
capture, beside the JAX package's on the same inputs."""

import json
import os

import numpy as np
import torch

from sliceslice_tpu.utils import load_haystack as jax_load_haystack
from sliceslice_tpu.utils import map_file as jax_map_file
from sliceslice_tpu.utils import measure as jax_measure
from sliceslice_tpu_torch.utils import Measurement, load_haystack, map_file, measure
from sliceslice_tpu_torch.utils.profiling import per_call_ms, trace

CPU = "cpu"


def test_measure_and_summary():
    calls = []
    m = measure(lambda: calls.append(1), name="x", warmup=2, samples=5, bytes_processed=1000)
    assert len(calls) == 7
    assert m.low <= m.estimate <= m.high
    assert m.gbps() is not None and "GB/s" in m.summary() and m.clock == "host clock"
    assert Measurement("y", [1.0]).gbps() is None
    ref = jax_measure(lambda: None, name="x", warmup=2, samples=5, bytes_processed=1000)
    assert len(ref.samples_s) == len(m.samples_s) == 5
    assert Measurement("z", [2.0, 1.0, 3.0], 6).gbps("low") == 6 / 1.0 / 1e9
    lo, med, hi = per_call_ms(lambda: calls.append(2), 4, CPU, samples=3)
    assert calls.count(2) == 4 * (1 + 3) and 0 <= lo <= med <= hi


def test_map_file_and_load(tmp_path):
    p = tmp_path / "c.bin"
    p.write_bytes(b"hello corpus " * 1000)
    arr = map_file(str(p))
    assert arr.dtype == np.uint8 and bytes(arr[:5]) == b"hello"
    assert np.array_equal(arr, jax_map_file(str(p)))
    dh = load_haystack(str(p), device=CPU)
    assert dh.length == jax_load_haystack(str(p)).length == 13_000
    assert bytes(dh.flat[:13_000].numpy()) == p.read_bytes() and not dh.flat[13_000:].any()
    empty = tmp_path / "e.bin"
    empty.write_bytes(b"")
    assert map_file(str(empty)).size == 0 == jax_map_file(str(empty)).size


def test_trace_capture(tmp_path):
    logdir = trace(lambda: torch.arange(8) * 2, logdir=str(tmp_path / "tr"))
    assert logdir == str(tmp_path / "tr")
    found = [f for _root, _dirs, files in os.walk(logdir) for f in files]
    assert found == ["trace.json"]
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mul" in str(e.get("name", "")) for e in events)
