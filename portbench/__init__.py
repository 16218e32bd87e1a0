"""portbench — the benchmark of ``sliceslice_tpu_torch`` on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python3 -m portbench.run --workload i386-find --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<name>.json``, ``traffic/<name>.json`` and ``metrics/<name>.py``.
The yardstick is this folder's own: the input generator (``inputs``), the
plain reference (``reference``), the comparison (``harness``), the trace
reading (``trace``) and the roofline arithmetic (``roofline``).  From the
program it takes only the entry points that the cells drive, their counters
and the kernels' names.
"""
