"""Kernel launches per dictionary request, in the traced requests: the
program's ``launches.<kernel>`` counters (one a kernel launched)."""

from portbench.program_record import record


def read(run):
    rec = record(run)
    return None if rec is None else rec.per_request(rec.count("launches."))
