"""Criterion-analogue measurement harness (reference: criterion benches,
bench/benches/i386.rs): warmup, repeated samples, low/estimate/high from
the sample distribution, plus achieved bandwidth against the HBM roofline.

On a CUDA device each sample is timed with CUDA events around the call
(``fn`` need not synchronise); elsewhere with the host clock (``fn`` must
block until its work is done).  Every device number should be reported
beside :func:`card`'s name and power limit.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, Optional

import torch

#: HBM bandwidth roofline, bytes/s: NVIDIA's data sheet for the H100 SXM
#: (80 GB HBM3), which assumes the card's full 700 W power limit.  A card
#: set below that limit runs slower under load: report :func:`card` beside
#: any share of this roofline.
HBM_ROOFLINE = {"h100": 3.35e12}


def card(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``)."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


@dataclasses.dataclass
class Measurement:
    name: str
    samples_s: list
    bytes_processed: Optional[int] = None
    #: where the samples were timed: a CUDA device name, or "host clock".
    clock: str = "host clock"

    @property
    def low(self) -> float:
        return min(self.samples_s)

    @property
    def estimate(self) -> float:
        s = sorted(self.samples_s)
        return s[len(s) // 2]

    @property
    def high(self) -> float:
        return max(self.samples_s)

    def gbps(self, which: str = "estimate") -> Optional[float]:
        if self.bytes_processed is None:
            return None
        return self.bytes_processed / getattr(self, which) / 1e9

    def summary(self) -> str:
        ms = [f"{x * 1e3:.4f}" for x in (self.low, self.estimate, self.high)]
        line = f"{self.name}: [{ms[0]} {ms[1]} {ms[2]}] ms ({self.clock})"
        if self.bytes_processed is not None:
            line += f"  ({self.gbps():.1f} GB/s effective)"
        return line


def measure(
    fn: Callable[[], object],
    name: str = "bench",
    warmup: int = 1,
    samples: int = 5,
    bytes_processed: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Measurement:
    """Run ``fn`` ``warmup`` times, then time ``samples`` calls: with CUDA
    events when ``device`` is a CUDA device, else with the host clock."""
    for _ in range(warmup):
        fn()
    out = []
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            for _ in range(samples):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                stop.synchronize()
                out.append(start.elapsed_time(stop) / 1e3)
            clock = torch.cuda.get_device_name()
        return Measurement(name, out, bytes_processed, clock)
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return Measurement(name, out, bytes_processed)
