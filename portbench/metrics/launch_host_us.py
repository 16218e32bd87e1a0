"""Microseconds of the host's time per kernel wrapper call on the card, in
the traced requests: the program's ``sliceslice.launch.<kernel>`` spans,
from the wrapper's entry to its kernel's return (operand checks, output
buffers, the queue plan, the launch), summed over their calls."""

from portbench.program_record import launch_host_us


def read(run):
    return launch_host_us(run)
