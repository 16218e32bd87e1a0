"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, as each
configuration's kind cuts it (``tiny`` in ``kinds/<kind>.py``)."""

import time

import pytest

from portbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def tiny(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.config = spec.load_kind(cell.config["kind"], cell.kinds).tiny(cell.config)
    cell.traffic = dict(cell.traffic, warmup_requests=1, trace_requests=2)
    return cell


def run_tiny(name: str, seed: int = 2**31 + 11, trace: bool = False, build=None, seconds: float = 0.2):
    kw = {} if build is None else {"build": build}
    return harness.run_cell(tiny(name), seed, seconds, trace, "cpu", time.perf_counter(), **kw)


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
