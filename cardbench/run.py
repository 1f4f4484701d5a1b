"""The benchmark of the PyTorch and CUDA port (``allophant_tpu_torch``).

    python3 cardbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` on the card it is started on: builds the
cell's model with weights drawn from the seed, warms up the traffic's
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference in ``cardbench/reference/``, and prints one JSON
line last: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics read from a profiled stretch after the window (``--trace 1``).
Earlier lines name the card and the kernel launches; the numbers compared,
each beside its limit, end standard error and the result's line. Exits
non-zero, with no result, without a CUDA card, when JAX or the JAX package
was loaded, or when the run fails."""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "cardbench" / ".cache"
#: Top-level modules that may not be loaded in the process that prints the result.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "allophant_tpu")


def _set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, each compared
    whole (``allophant_tpu_torch`` is not ``allophant_tpu``)."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def _number(value: float):
    return value if math.isfinite(value) else ("inf" if value > 0 else "-inf" if value < 0 else "nan")


def result_line(spec: dict, cell: dict, trace: bool, result, device_kind: str) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device`` (and ``breakdown`` when traced), then the numbers compared
    under ``checks``, last."""
    from cardbench.core import registry

    metrics = {}
    if trace:
        units = {entry["name"]: entry["unit"] for entry in spec["per_layer"]}
        for name, reader in registry.per_layer(spec, cell["name"]).items():
            value = reader.read(result.readings)
            if value is not None and math.isfinite(value):
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for entry in registry.end_to_end(spec, cell["name"], list(result.end_to_end)):
            value = result.end_to_end.get(entry["name"])
            if value is not None and math.isfinite(value):
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    correct = result.failed == 0 and all(check.passed for check in result.checks.values())
    device = {"platform": "gpu", "kind": device_kind, "count": int(cell["chips"]), "memory_peak_bytes": result.memory_peak_bytes}
    if trace and result.busy_s is not None:
        device["busy_s"] = result.busy_s
        device["window_s"] = result.window_s
    line = {"correct": correct, "attempted": result.attempted, "failed": result.failed, "metrics": metrics, "device": device}
    if trace and result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {name: {"value": _number(check.value), "limit": check.limit} for name, check in result.checks.items()}
    return line


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", **overrides):
    """The result line of one run. ``overrides`` replace the cell's
    ``config``, ``traffic``, ``head`` or ``limits`` and add ``faults`` (for
    the tests, which run a tiny model on the CPU)."""
    from cardbench.core import card, registry
    from cardbench.core.context import make_context

    cell = registry.cell(spec, workload)
    if device == "cuda":
        card.require_cards(int(cell["chips"]))
        print(f"cardbench card: {card.describe()}", flush=True)
    started = overrides.pop("started", STARTED)
    context = make_context(spec, workload, seed, seconds, trace, device, started, **overrides)
    result = registry.task(context.traffic["task"]).run(context)
    import torch

    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    line = result_line(spec, cell, trace, result, kind)
    for name, check in line["checks"].items():
        print(f"cardbench check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr, flush=True)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    from cardbench.core import card, registry

    try:
        line = run_cell(registry.benchmark(ROOT), args.workload, args.seed, args.seconds, bool(args.trace))
    except card.NoCard as error:
        print(f"cardbench: {error}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"cardbench: forbidden modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
