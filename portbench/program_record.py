"""What the program recorded about itself in a traced run, per request:
the sums its spans and counters keep while a profiler collects
(``sliceslice_tpu_torch.utils.tracing.traced``).

The profiled requests are the traced window's and the one request that
set-up runs under the profiler to load it; the root span of the cell's
call (``sliceslice.find_all``, ``count_all``, ``positions_all``) counts
them.  The spans are the program's own, measured on the host between the
same points as the ranges it puts in the profiler's trace.  There is
nothing to read in an untraced run, from a program without the record,
or in a run whose profiled requests launched no kernel (the plain
versions on the CPU): :func:`record` is then None, and so is every reader
built on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: The program's root span of each traffic operation's request.
ROOT = {"find": "sliceslice.find_all", "count": "sliceslice.count_all",
        "positions": "sliceslice.positions_all"}
LAUNCH = "sliceslice.launch."
#: The spans of the card's work and the copies: what the protocol's own
#: host work excludes.
DEVICE_SIDE = (LAUNCH, "sliceslice.readback", "sliceslice.upload")


@dataclasses.dataclass
class Record:
    requests: int
    #: span name -> (calls, seconds, self seconds).
    spans: dict
    #: counter name -> the bumps made inside profiled spans.
    counters: dict

    def calls(self, prefix: str) -> int:
        return sum(c for name, (c, _, _) in self.spans.items() if name.startswith(prefix))

    def seconds(self, prefix: str) -> float:
        return sum(s for name, (_, s, _) in self.spans.items() if name.startswith(prefix))

    def count(self, prefix: str) -> int:
        return sum(n for name, n in self.counters.items() if name.startswith(prefix))

    def per_request(self, x: float) -> Optional[float]:
        """``x`` over the profiled requests; None where ``x`` is 0."""
        return x / self.requests if x > 0 else None


def record(run) -> Optional[Record]:
    if run.trace is None:
        return None
    try:
        from sliceslice_tpu_torch.utils import tracing
    except ImportError:
        return None
    got = tracing.traced()
    rec = Record(got["spans"].get(ROOT[run.op], (0, 0.0, 0.0))[0], got["spans"], got["counters"])
    if not rec.requests or not rec.count("launches."):
        return None
    return rec


def launch_host_us(run) -> Optional[float]:
    """Microseconds per ``sliceslice.launch.<kernel>`` span."""
    rec = record(run)
    if rec is None or not rec.calls(LAUNCH):
        return None
    return rec.seconds(LAUNCH) / rec.calls(LAUNCH) * 1e6
