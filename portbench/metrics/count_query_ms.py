"""``query_ms`` of the count cell.  Apart from ``query_ms`` because that
cell, held by its kernel, runs far steadier than the cells the host holds,
and so takes a far tighter bound."""

from portbench.metrics_common import ms_per_request


def read(run):
    return ms_per_request(run)
