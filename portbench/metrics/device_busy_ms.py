"""Milliseconds per dictionary request in which the device ran anything
(overlaps merged), in the traced requests.  The host's share of a request
is ``query_ms`` less this."""

from portbench.metrics_common import device_busy_ms


def read(run):
    return device_busy_ms(run)
