"""``device_busy_ms`` in the count cell, which reports ``count_query_ms``."""

from portbench.metrics_common import device_busy_ms


def read(run):
    return device_busy_ms(run)
