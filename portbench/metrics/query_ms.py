"""Milliseconds per dictionary request: the window's seconds over the
requests completed in it, answers on the host (host clock)."""

from portbench.metrics_common import ms_per_request


def read(run):
    return ms_per_request(run)
