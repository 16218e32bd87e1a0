"""The port's timing scripts (``breakeven``, ``oneshot_decompose``,
``perf_long``, ``scale_check``, ``stream_bench``) on the CPU (the kernels'
plain versions) at small sizes: each runs, checks its answers, prints its
keys, and writes nothing into the repository."""

import json
import pathlib

import pytest
import torch

from sliceslice_tpu_torch.scripts import breakeven, oneshot_decompose, perf_long, scale_check, stream_bench
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


def json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_tree_snapshot_taken_first(tree_before):
    assert tree_before[1]


def test_breakeven(capsys):
    assert breakeven.main(["--device", CPU, "--words", "64", "--bytes", "65536", "--sweeps", "2"]) == 0
    rows = json_lines(capsys.readouterr().out)
    assert [r["protocol"].split(":")[0].split(",")[0] for r in rows] == ["cold", "cold", "piggyback"]
    for r in rows:
        assert set(r) == {"protocol", "t_base_ms", "c_opt_ms", "t_opt_ms", "gain_ms", "n_star"}
        assert r["n_star"] == "never" if r["gain_ms"] <= 0 else r["n_star"] == r["c_opt_ms"] / r["gain_ms"]


def test_oneshot_decompose(capsys):
    assert oneshot_decompose.main(["--device", CPU, "--words", "64", "--bytes", "65536", "--samples", "2",
                                   "--sweeps", "2"]) == 0
    (d,) = json_lines(capsys.readouterr().out)
    assert d["parity"] is True
    assert set(d) == {"parity", "compute_ms", "round_trip_ms", "dispatch_ms", "readback_remap_ms", "oneshot_ms",
                      "model_ms", "residual_ms"}


def test_perf_long(capsys):
    assert perf_long.main(["2", "--device", CPU, "--words", "64", "--bytes", "65536"]) == 0
    rows = json_lines(capsys.readouterr().out)
    assert [r["regime"] for r in rows] == ["real", "floor", "fullscan"]
    for r in rows:
        assert r["parity"] and r["needles"] == 64 and r["bound_ms"] > 0 and r["bound_by"] in ("operations", "bytes")
    # A fullscan sweep tests every position; a floor sweep stops in the first chunk.
    assert rows[2]["bound_ms"] > rows[1]["bound_ms"]


def test_scale_check(capsys):
    assert scale_check.main(["8192", "mb=0.25", "k=1", "samples=1", "--device", CPU]) == 0
    (row,) = json_lines(capsys.readouterr().out)
    assert row["parity"] and row["needles"] == 502 and row["bytes"] == 1 << 18 and row["chunk"] == 8192


def test_scale_check_case_is_the_jax_scripts():
    """Seed 42: the corpus and the 502 needles of scripts/scale_check.py."""
    import numpy as np

    hay, needles = scale_check.make_case(1)
    rng = np.random.default_rng(42)
    assert hay == rng.integers(97, 123, (1 << 20,), dtype=np.uint8).tobytes()
    starts, lens = rng.integers(0, len(hay) - 24, (502,)), rng.integers(8, 25, (502,))
    assert needles == [hay[int(i):int(i) + int(k)] for i, k in zip(starts, lens)]


def test_stream_bench(capsys):
    assert stream_bench.main([str(3 << 19), "--fast", "--window", str(1 << 19), "--device", CPU]) == 0
    (res,) = json_lines(capsys.readouterr().out)
    rows = stream_bench.rows(res)
    assert [r["mode"] for r in rows] == ["find", "count", "find", "positions"]
    for r in rows:
        assert r["ok"] and r["GBps"] > 0 and {"dispatch_s", "read_s", "window_p50_ms"} <= set(r["stats"])
    assert not pathlib.Path(stream_bench.corpus_path(1 << 16)).resolve().is_relative_to(REPO)


def test_repository_unchanged(tree_before):
    assert tree_state() == tree_before
