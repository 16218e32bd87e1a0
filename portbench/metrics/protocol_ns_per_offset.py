"""Nanoseconds of the positions protocol's own host work per offset it
packed, in the traced requests: ``protocol_host_ms`` per request over the
program's ``packed_offsets`` counter per request.  The host's cost per
offset, comparable between many sparse rows and a few dense ones.  It
reads nothing where no offset was packed, and so nothing from a program
without the counter."""

from portbench.harness import load_reader
from portbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or run.op != "positions":
        return None
    offsets = rec.count("packed_offsets")
    host_ms = load_reader("protocol_host_ms")(run)
    if not offsets or host_ms is None:
        return None
    return host_ms * 1e6 / (offsets / rec.requests)
