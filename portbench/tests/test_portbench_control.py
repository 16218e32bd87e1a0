"""``correct`` has to come out false when the timed path is wrong: with the
control (the reference with its verification left out) in the program's
place, and with the program's own answer altered where it is produced.
The other faults of the contract's list (a state left unchanged, half a
batch left out, the exchange between chips left out) belong to training
and to sharded cells, which this benchmark does not have."""

import pytest
import torch

from portbench import control

from .conftest import CELLS, run_tiny


def test_control_is_not_correct(cell_name):
    result, _ = run_tiny(cell_name, build=control.build)
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0
    assert result["failed"] >= 1


def _alter_first_row(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[0] += 1
    return out


def _plant_altered_answer(op: str, monkeypatch) -> None:
    from sliceslice_tpu_torch.ops import scan_kernel, torch_backend

    if op == "positions":
        real = torch_backend.two_tier_positions

        def altered(*a, **k):
            res = list(real(*a, **k))
            res[0] = res[0] + 1
            return res

        monkeypatch.setattr(torch_backend, "two_tier_positions", altered)
        return
    name = "batched_find" if op == "find" else "batched_count"
    real = getattr(scan_kernel, name)
    monkeypatch.setattr(scan_kernel, name, lambda *a, **k: _alter_first_row(real(*a, **k)))


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    from portbench import spec

    sound, _ = run_tiny(name, seed=5)
    assert sound["correct"] is True
    _plant_altered_answer(spec.cell(name).traffic["op"], monkeypatch)
    broken, _ = run_tiny(name, seed=5)
    assert broken["correct"] is False
    assert broken["checks"]["wrong_answers"]["value"] >= 1


def test_control_command_reports_every_seed_not_correct(capsys):
    import json

    assert control.main(["--workload", "i386-find", "--seeds", "4,2147483659"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [4, 2147483659]
    assert all(x["control_correct"] is False and x["checks"]["wrong_answers"]["value"] > 100
               for x in lines)
