"""Finds a cell's files by the names ``BENCHMARK.json`` gives them.

``root`` is the checkout: ``root/BENCHMARK.json``, and under
``root/portbench/`` the ``configs/``, ``workloads/`` and
``layer_metrics/`` files.  A cell, a configuration or a per-layer metric
is added by adding its file and its entry; nothing here names one, and
nothing in ``portbench/testing.py`` either: the CPU tests shrink a cell
by its driver's ``shrink_for_cpu_tests``, then by its configuration's
optional ``"cpu_test"`` object, which no run reads.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent


class Cell(NamedTuple):
    name: str
    chips: int
    driver: str  # module of portbench.traffic
    config: dict  # configs/<config>.json
    traffic: dict  # the workload file's traffic parameters
    limits: dict  # the correctness check's limits, by compared number
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # its per-layer metrics


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    work = json.loads((Path(root) / "portbench" / "workloads" / f"{name}.json").read_text())
    if work["config"] != entry["config"]:
        raise ValueError(f"workloads/{name}.json names config {work['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    config = json.loads((Path(root) / conf["file"]).read_text())
    return Cell(name, entry["chips"], work["driver"], config, work["traffic"], work["limits"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """``read(trace) -> float | None`` of ``layer_metrics/<metric>.py``."""
    path = Path(root) / "portbench" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
