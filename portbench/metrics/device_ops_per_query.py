"""Device operations (kernels, copies, fills) per dictionary request in the
traced requests: what the host dispatches for one request."""

from portbench.metrics_common import device_ops_per_request


def read(run):
    return device_ops_per_request(run)
