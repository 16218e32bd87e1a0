"""Milliseconds per positions request of the host's widening of the packed
offsets, in the traced requests: the program's
``sliceslice.positions.widen`` spans, each the copy of one window's int32
offsets, already read back, into the int64 answers.  It reads nothing
from a program without the span."""

from portbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or run.op != "positions":
        return None
    return rec.per_request(rec.seconds("sliceslice.positions.widen") * 1e3)
