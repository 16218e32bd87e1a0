"""The find kernel's share of its roofline: the least time one card needs
for a request's first offsets (``portbench.roofline.find_s``: each
needle's positions up to its first match, by the reference's answers)
over the device time per request of the kernels named below."""

from portbench import roofline

KERNEL = r"\bbatched_find_kernel\b"


def read(run):
    tr = run.trace
    if tr is None or run.op != "find":
        return None
    t = tr.kernel_s(KERNEL) / tr.requests
    if t <= 0:
        return None
    lengths = [len(n) for n in run.inputs.needles]
    return 100.0 * roofline.find_s(len(run.inputs.corpus), lengths, run.want) / t
