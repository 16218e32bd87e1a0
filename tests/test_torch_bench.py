"""The port's bench entry and its >4 GiB stream check on the CPU (the
kernels' plain versions).  ``python -m sliceslice_tpu_torch.bench --device
cpu`` is the labelled reduced slice: it prints the card line first, the
detail object next to last and, last, exactly the JAX bench's four keys; a
parity failure prints ``FAILED_CONFORMANCE`` and exits 1.  The bigscan
plants cross 2^31 and 2^32.  Nothing here writes into the repository."""

import json
import os
import pathlib

import pytest
import torch

from sliceslice_tpu_torch import BatchedSearcher, bench
from sliceslice_tpu_torch.scripts import bigscan_check, stream_bench
from test_torch_harness import REPO, tree_state

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree_before():
    return tree_state()


def test_tree_snapshot_taken_first(tree_before):
    assert tree_before[1]


def test_bench_cpu_reduced_slice(capsys, tmp_path):
    detail_path = tmp_path / "detail.json"
    assert bench.main(["--device", CPU, "--detail", str(detail_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu (no card)"
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "GB/s" and last["value"] > 0 and "REDUCED" in last["metric"]
    assert abs(last["vs_baseline"] - last["value"] / bench.REFERENCE_GBPS) < 1e-3
    detail = json.loads(lines[-2])
    assert detail == json.loads(detail_path.read_text())
    assert detail["conformance"]["long_mismatches"] == detail["conformance"]["short_mismatches"] == 0
    assert detail["sweeps"] == 4 and len(detail["random_matrix"]) == 28
    assert set(detail["kernels_ms"]) >= {"groups", "find", "count", "sweeps"}
    assert all(r["ok"] for r in stream_bench.rows(detail["streaming"]))
    assert os.path.isfile(os.path.join(detail["trace_logdir"], "trace.json"))
    assert not pathlib.Path(detail["trace_logdir"]).resolve().is_relative_to(REPO)


def test_bench_parity_failure(monkeypatch, capsys):
    right = BatchedSearcher.find_all
    monkeypatch.setattr(BatchedSearcher, "find_all", lambda self, hay: right(self, hay) - 1)
    assert bench.main(["--device", CPU]) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"metric": "FAILED_CONFORMANCE", "value": 0.0, "unit": "GB/s", "vs_baseline": 0.0}


def test_bigscan_check_small(capsys):
    """Plants past 2^31 and 2^32 drop out below them; the ones that fit
    and the absent needle are exact."""
    assert bigscan_check.main(["0.004", "--window", str(1 << 20), "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "ALPHA-NEEDLE-01!" in out and "ABSENT-NEEDLE-Z!" in out


def test_bigscan_plants_cross_the_int32_and_uint32_limits():
    total = int(4.5 * 2**30)
    plants = bigscan_check.make_plants(total)
    needles, first = bigscan_check.expected(plants)
    assert needles[-1] == bigscan_check.ABSENT and first[-1] == -1
    assert any(o < 2**31 < o + len(n) for o, n in plants)
    assert max(first) > 2**32
    assert first[needles.index(b"DELTA-NEEDLE-05!")] == 2**31 + 9_999_999
    chunk = next(bigscan_check.chunks(4096, bigscan_check.make_plants(4096), chunk=2048))
    assert len(chunk) == 2048


def test_repository_unchanged(tree_before):
    assert tree_state() == tree_before
