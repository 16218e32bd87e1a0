"""The program's spans and counters: what a trace, or a reader of the
program's own numbers, sees inside a request.

``span(name)`` marks a stretch of the host's work.  While a torch profiler
collects (``torch.profiler.profile``, :func:`.profiling.trace`) it is a
profiler range on the profiler's timeline, beside the device's kernels and
copies and on one clock with them; otherwise it is one shared
``nullcontext``, and costs one check.  There is no switch: spans are on
exactly while someone profiles.  The range is an operator-scope one, not a
user annotation, so the profiler gives it no device-side copy and the
device's activity reads as it would without it.  Calls on one thread are
synchronous, so a span's parent is the span that encloses it on its
thread, and a request is whatever its caller wraps around the call (a
benchmark's mark, say).  While a profiler collects, each span also sums
its calls, seconds and self seconds (its seconds less those of the spans
directly inside it), and each counter bump made inside a span is summed
apart: :func:`traced` returns both.

``count(name, n)`` adds to one of the program's counters, always;
:func:`counters` returns a copy, which a caller subtracts from a later one.
Names: ``launches.<kernel>`` (a kernel launched), ``tiled_rows.<wrapper>``
(the rows of a count or bitmap launch whose items are groups of rows that
share each corpus tile), ``single_rows.<wrapper>`` (the rows of one whose
items are one row each), ``two_slot_rows.<wrapper>`` (the rows of one whose
table, of 5 to 8 slots, is filtered on slots 0 and 1 before the exact
walk), ``hashed_rows.<wrapper>`` (those of them whose launch groups 8 rows
an item, where the filter compares a hash of the two slots' windows),
``uploads.pair_block``
(a pair plan sent to a card), ``readbacks`` / ``readback_bytes`` and
``uploads`` / ``upload_bytes`` (the copies of :mod:`..ops.transfer`),
``packed_offsets`` (the offsets the positions protocol packed and read
back), ``direct_offsets`` (those of them a readback wrote straight into
the caller's int64 answers).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

#: Whether a torch profiler is collecting (one C call).
enabled = torch._C._autograd._profiler_enabled
#: The profiler range a span opens (looked up here, so a test can swap it).
_profiler_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counts: dict = {}
_traced_counts: dict = {}
#: span name -> [calls, ns, self ns], while a profiler collected.
_traced_spans: dict = {}
_open = threading.local()  # .stack: this thread's spans open under a profiler
_depth = 0  # spans open under a profiler, on every thread


class _Span:
    __slots__ = ("name", "range", "t0", "inner")

    def __init__(self, name: str):
        self.name, self.range, self.inner = name, _profiler_range(name), 0

    def __enter__(self):
        global _depth
        self.range.__enter__()
        if not hasattr(_open, "stack"):
            _open.stack = []
        _open.stack.append(self)
        with _lock:
            _depth += 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _depth
        ns = time.perf_counter_ns() - self.t0
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].inner += ns
        with _lock:
            _depth -= 1
            rec = _traced_spans.setdefault(self.name, [0, 0, 0])
            rec[0], rec[1], rec[2] = rec[0] + 1, rec[1] + ns, rec[2] + ns - self.inner
        return self.range.__exit__(*exc)


def span(name: str):
    """A context manager: a profiler range named ``name`` while a torch
    profiler collects, else a shared ``nullcontext``."""
    return _Span(name) if enabled() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
        if _depth:
            _traced_counts[name] = _traced_counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter, by name."""
    with _lock:
        return dict(_counts)


def traced() -> dict:
    """What the spans recorded while a profiler collected: ``{"spans":
    {name: (calls, seconds, self_seconds)}, "counters": {name: n}}``, the
    counters summing only the bumps made inside such a span."""
    with _lock:
        spans = {k: (c, ns / 1e9, own / 1e9) for k, (c, ns, own) in _traced_spans.items()}
        return {"spans": spans, "counters": dict(_traced_counts)}
