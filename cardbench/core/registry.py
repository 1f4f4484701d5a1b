"""Finds what ``BENCHMARK.json`` names: a cell's configuration, its traffic
mix and the generator kind the mix names, its task, and the readers of its
per-layer metrics. Each is a file of its own under ``cardbench/``, found by
name, so that a new cell, mix or metric is a new file and no edit."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_file(path: Path, module_name: str) -> ModuleType:
    """The module of a file that need not be importable by name (metric
    readers are named like ``mfu.serve.py``)."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> dict:
    for entry in spec["workloads"]:
        if entry["name"] == workload:
            return entry
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def traffic_kind(kind: str) -> ModuleType:
    return load_file(BENCH_DIR / "traffic" / "kinds" / f"{kind}.py", f"cardbench_traffic_{kind}")


def task(name: str) -> ModuleType:
    return load_file(BENCH_DIR / "tasks" / f"{name}.py", f"cardbench_task_{name}")


def head(name: str) -> dict:
    """A head's frozen tables: the plan, the static tables and the label table."""
    folder = BENCH_DIR / "heads" / name
    document = json.loads((folder / "flagship_plan.json").read_text())
    with np.load(folder / "flagship_static.npz") as arrays:
        static = {key: arrays[key] for key in arrays.files}
    with np.load(folder / "labels.npz") as arrays:
        labels = {key: arrays[key] for key in arrays.files}
    return {
        "plan": document["plan"],
        "static": static,
        "label_table": labels["label_table"],
        "inventories": labels["inventories"],
        "heads": [str(name) for name in labels["heads"]],
    }


def end_to_end(spec: dict, workload: str, names: List[str]) -> List[dict]:
    """The end-to-end metrics that the cell reports, among those its task
    measures: a metric with a ``workloads`` list in those cells, else every
    metric the task measures."""
    chosen = []
    for entry in spec["end_to_end"]:
        listed = entry.get("workloads")
        if (listed is None and entry["name"] in names) or (listed is not None and workload in listed):
            chosen.append(entry)
    return chosen


def per_layer(spec: dict, workload: str) -> Dict[str, ModuleType]:
    """The readers of the cell's per-layer metrics: those that list the cell,
    and those without a list whose end-to-end metric the cell reports."""
    reported = {
        entry["name"] for entry in spec["end_to_end"] if workload in entry.get("workloads", (workload,))
    }
    readers = {}
    for entry in spec["per_layer"]:
        listed = entry.get("workloads")
        if (workload in listed) if listed is not None else (entry["moves"] in reported):
            readers[entry["name"]] = load_file(
                BENCH_DIR / "metrics" / f"{entry['name']}.py", "cardbench_metric_" + entry["name"].replace(".", "_")
            )
    return readers
