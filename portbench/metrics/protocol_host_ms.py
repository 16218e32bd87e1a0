"""Milliseconds per positions request of the protocol's own host work, in
the traced requests: the program's ``sliceslice.positions_all`` span less
the spans of its kernel wrappers, readbacks and uploads inside it (the
bases, the row slices, the placing in input order, and the Python
between)."""

from portbench.program_record import DEVICE_SIDE, ROOT, record


def read(run):
    rec = record(run)
    if rec is None or run.op != "positions":
        return None
    own = rec.seconds(ROOT["positions"]) - sum(rec.seconds(p) for p in DEVICE_SIDE)
    return rec.per_request(own * 1e3)
