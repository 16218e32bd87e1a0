"""One run of one cell: inputs from the seed and the system built by the
configuration's kind (``kinds/<kind>.py``) and warmed up (set-up), a
closed loop of requests for the window, then the comparison with the
plain reference (or the kind's own) and the metrics.

The window: one caller sends the traffic's request, waits for its answers
on the host, and sends the next, until ``seconds`` have passed; the
request that crosses the end is the window's last.  Every request's
answers are compared or not by a draw from the seed (one in the traffic's
``sample_one_in``), and the last always: those answers are kept and held
to the reference once the window has closed, the device's peak memory
read and the program's state freed.  With ``trace`` the profiler covers
the window's first ``trace_requests`` requests.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

from . import inputs as inputs_mod
from . import reference
from .spec import HERE, Cell, load_file, load_kind
from .trace import Trace, Tracer


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    op: str
    inputs: inputs_mod.Inputs
    setup_s: float
    window_s: float
    requests: int
    #: the reference's answers.
    want: object
    trace: Optional[Trace] = None


def load_reader(name: str) -> Callable[[Run], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    return load_file(HERE / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_")).read


def _window(sut, traffic: dict, seconds: float, tracer: Optional[Tracer], keep: Callable[[], bool]):
    """(seconds, requests, kept): the closed loop, and the (index, answers)
    of the requests kept for the comparison."""
    n_trace = int(traffic["trace_requests"]) if tracer is not None else 0
    kept = []
    if n_trace:
        tracer.start()
    start = time.perf_counter()
    i = 0
    while True:
        if i < n_trace:
            with tracer.mark():
                ans = sut.request()
        else:
            ans = sut.request()
        t1 = time.perf_counter()
        i += 1
        if i == n_trace:
            tracer.stop()
        last = t1 - start >= seconds
        if keep() or last:
            kept.append((i - 1, ans))
        if last:
            break
    if tracer is not None:
        tracer.stop()
    return t1 - start, i, kept


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             build: Optional[Callable] = None):
    """Run ``cell`` once; returns (result, lines): the result's JSON object
    and the lines that give set-up's stages and the numbers compared with
    their limits, the last lines of standard error.  ``build`` stands in
    for the kind's own (``build(config, op, inputs, device)``)."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    if traffic.get("loop") != "closed" or int(traffic.get("clients", 0)) != 1:
        raise ValueError(f"{traffic['name']}: only a closed loop with one client is generated")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stages = [("start", time.perf_counter() - t0)]
    kind = load_kind(cfg["kind"], cell.kinds)
    op = traffic["op"]
    inp = kind.inputs(cfg, seed)
    stages.append(("inputs", time.perf_counter() - t0))
    sut = (build or kind.build)(cfg, op, inp, dev)
    stages.append(("system", time.perf_counter() - t0))
    for _ in range(int(traffic["warmup_requests"])):
        sut.request()
    tracer = None
    if trace:
        tracer = Tracer(dev)  # its first start, which loads the tracing library, is set-up
        tracer.start()
        sut.request()
        tracer.stop()
        tracer = Tracer(dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    stages.append(("warm-up", setup_s))

    draw = inputs_mod.rng(seed, 2)
    one_in = float(traffic["sample_one_in"])
    window_s, requests, kept = _window(sut, traffic, seconds, tracer,
                                       lambda: draw.random() * one_in < 1.0)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = tracer.summary() if tracer is not None else None
    sut.close()
    del sut
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if hasattr(kind, "answers"):
        want = kind.answers(op, inp)
    else:
        want = reference.answers(op, inp.corpus, inp.needles)
    wrong_answers = getattr(kind, "wrong_answers", reference.wrong_answers)
    wrong = [wrong_answers(op, got, want) for _, got in kept]
    run = Run(op, inp, setup_s, window_s, requests, want, tr)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"])(run)
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing in {cell.name}")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks = {
        "wrong_answers": {"value": sum(wrong), "limit": 0, "rule": "at most"},
        "checked_requests": {"value": len(kept), "limit": 1, "rule": "at least"},
    }
    correct = sum(wrong) <= 0 and len(kept) >= 1
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": requests,
              "failed": sum(1 for w in wrong if w), "metrics": metrics, "device": device_info}
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    lines = ["set-up s: " + ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b) in
                                     zip([("", 0.0)] + stages, stages))]
    lines.append(f"checked {len(kept)} of {requests} requests ({len(kept) * len(inp.needles)} answers)")
    lines += [f"{k} {c['value']} limit {c['rule']} {c['limit']}" for k, c in checks.items()]
    return result, lines
