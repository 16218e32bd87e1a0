"""The benchmark's command on the card: every cell once, briefly, untraced
and traced, with ``correct`` true.  Marked ``gpu``; each test skips on a
machine without a CUDA card, decided inside the test.

    python3 -m pytest -m gpu portbench/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                          str(2**32 + 77), "--seconds", "1", "--trace", str(trace)], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    layer = {m["name"] for m in spec.cell(name).per_layer}
    want = layer if trace else {m["name"] for m in spec.cell(name).end_to_end}
    assert set(result["metrics"]) <= want and result["metrics"]
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
