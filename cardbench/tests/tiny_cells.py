"""Tiny versions of the benchmark's cells for the CPU tests: the cells'
configurations at their encoder's tiny widths (``TINY`` of
``encoders/<encoder>.py``: width 32 and depth 2 for wav2vec2), traffic of
0.2-0.7 s utterances, and the float32 preset, at which the port's plain
twins and the reference agree to rounding."""

from __future__ import annotations

import copy
import time

from cardbench.core import registry

SPEC = registry.benchmark()

#: A cell that ``BENCHMARK.json`` does not hold yet (PERF.md, Open questions),
#: whose path the harness keeps, with the limits the tiny runs hold it to.
FURTHER = {
    "xlsr300m-beam4-cv": (
        {"name": "xlsr300m-beam4-cv", "config": "xlsr300m-allophant", "traffic": "cv-beam4", "chips": 1},
        {"beam_gap_nats": 1.5, "beam_shortfall_nats": 1.0},
    ),
}


def config(name: str, precision: str = "float32") -> dict:
    value = copy.deepcopy(registry.config(SPEC, name))
    value["architecture"].update(copy.deepcopy(registry.encoder(value["encoder"]).TINY))
    value["precision"] = precision
    if precision == "float32":
        value["precision_parts"] = {"encoder": "float32", "head": "float32", "float32_matmul": "highest", "master_weights": "float32"}
    return value


def traffic(name: str) -> dict:
    value = copy.deepcopy(registry.traffic(name))
    value["duration_s"].update(median=0.4, min=0.2, max=0.7)
    value["cycle_utterances"] = 16
    value["batch_samples"] = 40_000
    value["trace_requests"] = 2
    if value["task"] == "train":
        value.update(microbatches=2, length_multiple=3_200)
        value["check"]["steps"] = 2
    return value


def run(workload: str, seed: int = 2**33 + 5, seconds: float = 1.0, trace: bool = False, faults=None, precision: str = "float32"):
    """The result line of a tiny run of ``workload`` on the CPU (the cell's
    own limits)."""
    from cardbench import run as runner

    spec, extra = SPEC, {}
    if workload in FURTHER:
        entry, limits = FURTHER[workload]
        spec, extra = {**SPEC, "workloads": SPEC["workloads"] + [entry]}, {"limits": limits}
    cell = registry.cell(spec, workload)
    return runner.run_cell(
        spec, workload, seed, seconds, trace, device="cpu", config=config(cell["config"], precision),
        traffic=traffic(cell["traffic"]), faults=faults or {}, started=time.perf_counter(), **extra,
    )
