"""Scaling harness: bytes/s against the number of mesh cells.

Counterpart of ``sliceslice_tpu/parallel/scaling.py``.  Every measurement
re-checks its answers against the first cell count's.  Several cells on
one card share its SMs and its memory, so on one card the table measures
what the mesh costs (a launch per cell and width group, the combine),
not scaling; across cards it measures scaling.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..needle import build_probe_table
from ..ops.layout import DeviceHaystack
from .mesh import make_mesh, visible_devices
from .shard_scan import sharded_find_cols

#: Default scan rate, GB/s: the count kernel's one-row rate over the
#: 256 MiB corpus (an absent needle: every position tested), 0.1137 ms a
#: launch, from chip_smoke.py's ``[sharded_times]`` line on an NVIDIA H100
#: 80GB HBM3 at 700.00 W.
SCAN_GBPS = 2360.9
#: Default link rate, GB/s: NVIDIA's published NVLink 4 figure for the
#: H100 SXM, 900 GB/s in both directions, so 450 each way.  A data-sheet
#: figure, not a measurement (one card cannot measure a link); the name
#: ``ici_gbps`` is kept for the JAX signature.
NVLINK_GBPS = 450.0


def granularity_efficiency(g: int, n: int) -> float:
    """Upper bound on scaling efficiency from whole-unit sharding alone: a
    shard receives ``ceil(g/n)`` of ``g`` units, so the slowest shard sets
    the step time.  At least 90% whenever g >= 9n."""
    if g <= 0 or n <= 0:
        raise ValueError("g and n must be positive")
    return g / (n * -(-g // n))


def predicted_efficiency(
    g: int,
    n: int,
    bytes_per_shard: int,
    scan_gbps: float = SCAN_GBPS,
    allreduce_bytes: int = 8 * 4096,
    ici_gbps: float = NVLINK_GBPS,
) -> float:
    """Cost-model efficiency bound: the granularity skew times the share
    of a step that is scanning, against the collective per query batch.
    Defaults: this card's count rate (:data:`SCAN_GBPS`), NVIDIA's NVLink
    figure (:data:`NVLINK_GBPS`), and the find combine's traffic, one
    int64 MIN per needle for 4,096 needles."""
    scan_s = bytes_per_shard / (scan_gbps * 1e9)
    comm_s = allreduce_bytes / (ici_gbps * 1e9)
    return granularity_efficiency(g, n) * scan_s / (scan_s + comm_s)


def measure_scaling(
    dh: DeviceHaystack,
    needles: Sequence[bytes],
    device_counts: Optional[Sequence[int]] = None,
    samples: int = 3,
) -> List[dict]:
    """Per cell count ``n`` (an ``n x 1`` mesh, cells round-robin on the
    visible devices of ``dh``'s type, so several per device once ``n``
    passes them): the median sweep seconds, bytes/s, and efficiency
    against linear from the first count.  Default counts: 1, 2, 4, ... up
    to the visible devices."""
    devices = visible_devices(dh.device)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(devices)]
    values, masks, lengths = build_probe_table(needles)
    ends = np.maximum(np.int64(dh.length) - lengths.astype(np.int64) + 1, 0)
    total_bytes = dh.length * len(needles)

    def run(mesh):
        r = sharded_find_cols(dh, values, masks, ends, mesh)
        if isinstance(r, torch.Tensor):
            r = r.cpu().numpy()  # the readback synchronises
        return np.asarray(r)

    results = []
    reference_out = None
    base_rate = base_n = None
    for n in device_counts:
        mesh = make_mesh((n, 1), devices=devices[:n])
        out = run(mesh)
        if reference_out is None:
            reference_out = out
        elif not (out == reference_out).all():
            raise RuntimeError(f"divergence at n={n}")
        ts = []
        for _ in range(samples):
            t0 = time.perf_counter()
            run(mesh)
            ts.append(time.perf_counter() - t0)
        sec = sorted(ts)[len(ts) // 2]
        rate = total_bytes / sec
        if base_rate is None:
            base_rate, base_n = rate, n
        results.append({"devices": n, "seconds": sec, "bytes_per_s": rate,
                        # Against linear from the first measured point.
                        "efficiency": rate / (base_rate * n / base_n)})
    return results


def format_report(results: List[dict]) -> str:
    lines = ["| devices | sweep s | GB/s | efficiency vs linear |",
             "|---------|---------|------|----------------------|"]
    for r in results:
        lines.append(
            f"| {r['devices']} | {r['seconds']:.4f} | "
            f"{r['bytes_per_s'] / 1e9:.2f} | {r['efficiency'] * 100:.1f}% |"
        )
    return "\n".join(lines)
