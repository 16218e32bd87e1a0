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
import os
import subprocess
import tempfile
import time
from typing import Callable, Optional

import torch

#: HBM bandwidth roofline, bytes/s: NVIDIA's data sheet for the H100 SXM
#: (80 GB HBM3), which assumes the card's full 700 W power limit.  A card
#: set below that limit runs slower under load: report :func:`card` beside
#: any share of this roofline.
HBM_ROOFLINE = {"h100": 3.35e12}
#: Peak 32-bit integer operations per second of one H100 SXM: 132 SMs x 64
#: INT32 lanes x 1.98 GHz (NVIDIA's data sheet and Hopper white paper).
INT32_PEAK = {"h100": 132 * 64 * 1.98e9}


def bound_ms(ops: float, nbytes: float, card: str = "h100") -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` 32-bit integer operations and ``nbytes`` bytes moved, the
    larger of the two times, and which of them sets it."""
    t_ops, t_bytes = ops / INT32_PEAK[card], nbytes / HBM_ROOFLINE[card]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def per_call_ms(fn: Callable[[], object], reps: int, device, samples: int = 5, warmup: int = 1) -> list:
    """[low, median, high] ms per call of ``fn`` when ``reps`` calls are
    issued back to back and timed as one sample (:func:`measure`: CUDA
    events on a CUDA ``device``, one synchronisation a sample)."""
    m = measure(lambda: [fn() for _ in range(reps)], warmup=warmup, samples=samples, device=device)
    return [x * 1e3 / reps for x in (m.low, m.estimate, m.high)]


def sync(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device (the
    CPU's torch ops have finished when they return)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device) -> str:
    """:func:`card` of a CUDA ``device``, or ``"cpu (no card)"``: the line
    the harness scripts print first."""
    d = torch.device(device)
    if d.type != "cuda":
        return "cpu (no card)"
    return card(torch.cuda.current_device() if d.index is None else d.index)


def trace(fn: Callable[[], object], logdir: Optional[str] = None) -> str:
    """Capture a torch.profiler trace of one call of ``fn`` (the card's
    kernels and copies too when a CUDA device is present) and export it as
    a Chrome trace, ``trace.json``, into ``logdir`` (default: a directory
    under the system's temporary directory, never the repository).  Returns
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "sliceslice_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return logdir
