"""Every cell of BENCHMARK.json driven end to end on the CPU at a tiny size:
the result line's keys, its metrics, and ``correct``."""

import json

import pytest

from portbench import spec

from .conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(cell_name, trace):
    result, lines = run_tiny(cell_name, trace=trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[: len(KEYS)] == KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert json.loads(json.dumps(result)) == result
    cell = spec.cell(cell_name)
    if trace:
        # No device on the CPU: every device-trace metric reads nothing.
        allowed = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
        assert set(result["metrics"]) <= allowed
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert lines[-2:] == [f"{k} {c['value']} limit {c['rule']} {c['limit']}"
                          for k, c in result["checks"].items()]


CONFIGS = [c["file"] for c in spec.load_benchmark()["configs"]]


def _inputs(file: str, *seeds: int):
    from portbench import inputs

    cfg = json.loads((spec.ROOT / file).read_text())
    return cfg, [inputs.make(cfg, s) for s in seeds]


@pytest.mark.parametrize("file", CONFIGS)
def test_same_seed_same_inputs_other_seed_other_order(file):
    """Every kind: the seed alone decides the inputs."""
    _, (a, b, c) = _inputs(file, 2**33 + 1, 2**33 + 1, 5)
    assert a == b and a != c


@pytest.mark.parametrize("file", [f for f in CONFIGS
                                  if json.loads((spec.ROOT / f).read_text())["kind"] == "held_corpus"])
def test_held_corpus_keeps_its_corpus_and_permutes_its_needles(file):
    cfg, (a, c) = _inputs(file, 2**33 + 1, 5)
    assert a.corpus == c.corpus and len(a.corpus) == cfg["corpus"]["bytes"]
    assert a.needles != c.needles and sorted(a.needles) == sorted(c.needles)
    assert len(a.needles) == cfg["needles"]["count"]


def test_the_data_files_are_checked():
    from portbench import inputs

    cfg = json.loads((spec.HERE / "configs" / "i386-dictionary.json").read_text())
    cfg["corpus"]["sha256"] = "0" * 64
    with pytest.raises(ValueError, match="sha256"):
        inputs.make(cfg, 1)
