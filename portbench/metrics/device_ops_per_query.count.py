"""``device_ops_per_query`` in the count cell, which reports
``count_query_ms``."""

from portbench.metrics_common import device_ops_per_request


def read(run):
    return device_ops_per_request(run)
