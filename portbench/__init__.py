"""portbench — the benchmark of ``sliceslice_tpu_torch`` on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python3 -m portbench.run --workload i386-find --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` or a
configuration file gives it: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py`` and ``kinds/<kind>.py``, the
kind a configuration file names (its inputs from the seed, the system
under test built from them, its cut for the CPU tests, and optionally its
own reference).  So a new configuration adds files and entries alone: its
``configs/`` file, a ``kinds/`` module where no kind it can use exists, its
``traffic/`` files and ``metrics/`` readers, an entry in ``configs`` and one
in ``workloads`` for each cell, and each cell's name in the ``workloads``
of the metrics it reports.  The yardstick is this folder's own: the
input generator (``inputs`` and ``kinds/``), the plain reference
(``reference``), the comparison (``harness``), the trace reading
(``trace``) and the roofline arithmetic (``roofline``).  From the program
it takes only the entry points that the cells drive, their counters and
the kernels' names.
"""
