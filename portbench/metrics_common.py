"""What several metric readers (``metrics/*.py``) read: per request of the
window, or per request of the traced slice and of its span."""


def ms_per_request(run):
    if not run.requests:
        return None
    return run.window_s / run.requests * 1e3


def device_ops_per_request(run):
    tr = run.trace
    if tr is None or not tr.device_events:
        return None
    return tr.device_events / tr.requests


def device_busy_ms(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return tr.busy_s / tr.requests * 1e3


def device_idle_pct(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
