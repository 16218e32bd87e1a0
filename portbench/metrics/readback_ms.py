"""Milliseconds per dictionary request in the program's
``sliceslice.readback`` spans, in the traced requests: the host's wait for
the work queued before each copy to the host, and the copy."""

from portbench.program_record import record


def read(run):
    rec = record(run)
    return None if rec is None else rec.per_request(rec.seconds("sliceslice.readback") * 1e3)
