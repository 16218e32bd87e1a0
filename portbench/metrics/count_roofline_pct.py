"""The count kernel's share of its roofline: the least time one card needs
for a request's overlapping counts (``portbench.roofline.count_s``: every
position of every needle) over the device time per request of the kernels
named below."""

from portbench import roofline

KERNEL = r"\bcount_kernel\b"


def read(run):
    tr = run.trace
    if tr is None or run.op != "count":
        return None
    t = tr.kernel_s(KERNEL) / tr.requests
    if t <= 0:
        return None
    lengths = [len(n) for n in run.inputs.needles]
    return 100.0 * roofline.count_s(len(run.inputs.corpus), lengths) / t
