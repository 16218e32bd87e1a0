"""Share of the traced dictionary requests' span in which the device ran
nothing."""

from portbench.metrics_common import device_idle_pct


def read(run):
    return device_idle_pct(run)
