"""Two real processes run the port's sharded scan on ``torch.distributed``
(gloo, on the CPU) — the mirror of tests/test_multihost.py: each process
lays out only its own half of the corpus plus a peek, and find, count,
positions (gathered) and a huge needle across the process boundary must
be exact (``sliceslice_tpu_torch/scripts/multihost_check.py``)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_sharded_scan():
    out = subprocess.run(
        [sys.executable, "-m", "sliceslice_tpu_torch.scripts.multihost_check", "--device", "cpu",
         "--timeout", "150"],
        capture_output=True, text=True, timeout=180, cwd=REPO,
    )
    tail = "\n".join((out.stdout + out.stderr).splitlines()[-12:])
    assert out.returncode == 0, tail
    assert "2-process sharded scan parity ok" in out.stdout, tail
    # Both workers' parity lines: all three operations and the huge
    # needle's cross-process straddle ran, not just find and count.
    assert out.stdout.count("positions(+gather)/huge") == 2, tail
