"""The match-bitmap kernel's share of its roofline: the least time one card
needs to test every position of every needle and write one bit for each
(``portbench.roofline.bitmap_s``) over the device time per positions
request of the kernels named below."""

from portbench import roofline

KERNEL = r"\bmatch_bitmap_kernel\b"


def read(run):
    tr = run.trace
    if tr is None or run.op != "positions":
        return None
    t = tr.kernel_s(KERNEL) / tr.requests
    if t <= 0:
        return None
    lengths = [len(n) for n in run.inputs.needles]
    return 100.0 * roofline.bitmap_s(len(run.inputs.corpus), lengths) / t
