"""Finds every part of a cell by its name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; ``posebench/workloads/<cell>.json`` holds a cell's traffic mix
and the limits of its output check, ``posebench/configs/<config>.json``
its configuration, ``posebench/traffic/<kind>.py`` the driver of its kind
of traffic and ``posebench/metrics/<metric>.py`` the reader of a
per-layer metric (``read(run) -> float | None``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return _load(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return _load(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(kind: str):
    return importlib.import_module(f"posebench.traffic.{kind}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (metric names hold dots, so it is
    loaded by path)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"posebench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_entry(bench: dict, cell: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"BENCHMARK.json names no cell {cell!r}")


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones."""
    return [m for m in bench["per_layer" if traced else "end_to_end"] if applies(m, cell)]
