"""Finds what ``BENCHMARK.json`` names: a cell's configuration, the encoder
the configuration names (its reference and its port-facing file), its
traffic mix and the generator kind the mix names, its task, the readers of
its per-layer metrics, and every kernel's file under ``work/``. Each is a
file of its own under ``cardbench/``, found by name, so that a new cell,
mix or metric is a new file and no edit, and a new architecture or kernel
is new files."""

from __future__ import annotations

import importlib
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
    """The configuration's file; raises unless it names an encoder whose two
    files exist: its plain reference ``reference/encoders/<encoder>.py`` and
    what the harness knows of it in the port, ``encoders/<encoder>.py``."""
    for entry in spec["configs"]:
        if entry["name"] == name:
            value = json.loads((root / entry["file"]).read_text())
            if "encoder" not in value:
                raise KeyError(f"the configuration {name!r} names no encoder")
            named = value["encoder"]
            for path in (BENCH_DIR / "reference" / "encoders" / f"{named}.py", BENCH_DIR / "encoders" / f"{named}.py"):
                if not path.is_file():
                    raise FileNotFoundError(f"the configuration {name!r} names the encoder {named!r}: no {path}")
            return value
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def encoder(name: str) -> ModuleType:
    """What the harness knows of encoder ``name`` in the port
    (``encoders/<name>.py``): its architecture object, frame lengths,
    FLOPs, the launches a request or microbatch makes and the widths of the
    tests' tiny cells."""
    return importlib.import_module(f"cardbench.encoders.{name}")


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


def kernels() -> List[ModuleType]:
    """Every kernel's file ``work/<kernel>.py`` (the modules of the package
    ``cardbench.work``), by ``KERNEL``, its name in the launch counts. Each
    holds ``COUNTER``, the (module, attribute) of the port's counted launch
    wrapper, and may hold ``TWINS``, the port's plain twins that may not run
    in the window, ``KERNEL_NAMES``, its names in a device trace, and its
    work function. Files without ``KERNEL`` (``model_flops.py``) are not
    kernels."""
    from cardbench import work

    found = []
    for folder in work.__path__:
        for path in sorted(Path(folder).glob("*.py")):
            if not path.name.startswith("_"):
                module = importlib.import_module(f"cardbench.work.{path.stem}")
                if hasattr(module, "KERNEL"):
                    found.append(module)
    return sorted(found, key=lambda module: module.KERNEL)
