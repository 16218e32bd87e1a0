"""``device_idle_pct.query`` in the count cell, which reports
``count_query_ms``."""

from portbench.metrics_common import device_idle_pct


def read(run):
    return device_idle_pct(run)
