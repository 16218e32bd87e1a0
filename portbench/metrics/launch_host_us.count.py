"""``launch_host_us`` in the count cell, which reports ``count_query_ms``."""

from portbench.program_record import launch_host_us


def read(run):
    return launch_host_us(run)
