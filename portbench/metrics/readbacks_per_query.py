"""Copies from the card to the host per dictionary request, in the traced
requests: the program's ``readbacks`` counter (two per launch batch of the
positions protocol, and the sweep's own)."""

from portbench.program_record import record


def read(run):
    rec = record(run)
    return None if rec is None else rec.per_request(rec.counters.get("readbacks", 0))
