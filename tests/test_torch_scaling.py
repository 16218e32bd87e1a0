"""The port's scaling harness (``sliceslice_tpu_torch.parallel.scaling``)
against the JAX package's — the mirror of tests/test_scaling.py: the cost
model's functions equal the JAX package's on explicit arguments (the
port's defaults are this card's, not the TPU's), and ``measure_scaling``
re-checks its answers at every cell count on the CPU."""

import numpy as np
import pytest
import torch

from sliceslice_tpu.parallel import scaling as jscaling
from sliceslice_tpu_torch import preprocess
from sliceslice_tpu_torch.parallel import format_report, measure_scaling
from sliceslice_tpu_torch.parallel import scaling

#: The CPU tests run the kernels' plain versions.
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_granularity_efficiency_model():
    """The skew term: exact at divisibility, >= 90% when a shard holds >= 9
    units, in (0, 1]; the full prediction equals the JAX package's on the
    same arguments and degrades as shards shrink."""
    g_eff, p_eff = scaling.granularity_efficiency, scaling.predicted_efficiency
    assert g_eff(64, 8) == 1.0 and g_eff(9, 1) == 1.0
    for n in (2, 3, 8, 17, 64):
        assert g_eff(9 * n, n) >= 0.9 and g_eff(9 * n + 1, n) >= 0.9
    assert g_eff(9, 8) == 9 / 16
    for g, n in [(100, n) for n in range(1, 33)] + [(9, 8), (257, 8)]:
        assert 0 < g_eff(g, n) <= 1 and g_eff(g, n) == jscaling.granularity_efficiency(g, n)
    for kw in ({"scan_gbps": 666.0, "allreduce_bytes": 2 * 4 * 4096, "ici_gbps": 50.0},
               {"scan_gbps": scaling.SCAN_GBPS, "allreduce_bytes": 8 * 4096, "ici_gbps": scaling.NVLINK_GBPS}):
        for b in (32 * 2**20, 64 * 2**10):
            assert p_eff(256, 8, b, **kw) == jscaling.predicted_efficiency(256, 8, b, **kw)
    big = p_eff(g=256, n=8, bytes_per_shard=32 * 2**20)
    tiny = p_eff(g=256, n=8, bytes_per_shard=64 * 2**10)
    assert big > 0.98 and tiny < big
    # The defaults are the card's and NVIDIA's, never the TPU's.
    assert (scaling.SCAN_GBPS, scaling.NVLINK_GBPS) != (666.0, 50.0)
    with pytest.raises(ValueError):
        g_eff(0, 4)


def test_measure_scaling_exactness(rng):
    corpus = bytes(rng.integers(97, 103, (700_000,), dtype=np.uint8))
    dh = preprocess(corpus, kh=16, device=CPU)
    needles = [corpus[i : i + k] for i, k in [(5, 4), (650_000, 8), (0, 2)]] + [b"QZX"]
    res = measure_scaling(dh, needles, device_counts=[1, 2, 8], samples=1)
    assert [r["devices"] for r in res] == [1, 2, 8]
    assert res[0]["efficiency"] == 1.0
    report = format_report(res)
    assert "devices" in report and "| 8 |" in report
    assert report.splitlines()[:2] == jscaling.format_report(res).splitlines()[:2]
    assert [r["devices"] for r in measure_scaling(dh, needles, samples=1)] == [1]  # one visible CPU
