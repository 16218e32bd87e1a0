"""A cell of ``BENCHMARK.json`` with its configuration, its traffic mix and
the metrics it reports, each read from the file its name points to, and
the loader of the Python files found by name (``kinds/``, ``metrics/``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Optional

#: The folder of the benchmark and the checkout that holds it.
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: The configuration kinds: ``kinds/<kind>.py`` for a configuration's ``kind``.
KINDS = HERE / "kinds"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the ``end_to_end`` and ``per_layer`` entries this cell reports.
    end_to_end: list
    per_layer: list
    #: the folder its configuration's kind is found in.
    kinds: pathlib.Path = KINDS


def load_file(path: pathlib.Path, module: str):
    """The Python file ``path`` run as a module named ``module``."""
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, folder: pathlib.Path = KINDS):
    """``<folder>/<kind>.py``: a configuration kind.  It provides
    ``inputs(config, seed)``, ``build(config, op, inputs, device)`` (the
    system under test, with ``request()`` and ``close()``) and
    ``tiny(config)`` (a copy cut to what the CPU tests run), and may provide
    ``answers(op, inputs)`` and ``wrong_answers(op, got, want)`` in place of
    ``reference``'s."""
    path = pathlib.Path(folder) / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown configuration kind {kind!r}: there is no {path}")
    return load_file(path, "portbench_kind_" + kind.replace(".", "_"))


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    names = ", ".join(e["name"] for e in entries)
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json (have: {names})")


def reports(metric: dict, cell: str, e2e_names: Optional[set] = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or without that key every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str) -> Cell:
    bench = load_benchmark()
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    with open(ROOT / c["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)
