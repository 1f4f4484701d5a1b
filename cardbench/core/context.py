"""What a task gets from the harness, and what it gives back."""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

from cardbench.core import registry
from cardbench.core.registry import BENCH_DIR

TRACE_DIR = BENCH_DIR / ".cache" / "trace"


@dataclass
class Check:
    """One number compared: it passes while ``value <= limit``."""

    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    head: dict
    limits: Dict[str, float]
    device: str = "cuda"
    started: float = 0.0  # perf_counter() at process start
    #: Test hooks that break the timed path: "served" (host outputs -> host
    #: outputs) and "step" ((step, model, optimizer) -> step).
    faults: Dict[str, Callable] = field(default_factory=dict)

    def log(self, message: str) -> None:
        print(f"cardbench {self.workload}: {message}", file=sys.stderr, flush=True)

    def trace_path(self) -> Path:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        return TRACE_DIR / f"{self.workload}.json"


@dataclass
class Result:
    end_to_end: Dict[str, float]
    readings: dict
    attempted: int
    failed: int
    checks: Dict[str, Check]
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def make_context(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str, started: float, **overrides) -> Context:
    """The context of one run of ``workload``: its configuration, traffic,
    head and limits by the names ``BENCHMARK.json`` gives them, each
    replaceable through ``overrides`` (the tests' tiny cells), and the
    tests' ``faults``."""
    cell = registry.cell(spec, workload)
    config = overrides.get("config") or registry.config(spec, cell["config"])
    traffic = overrides.get("traffic") or registry.traffic(cell["traffic"])
    head = overrides.get("head") or registry.head(config["head"])
    limits = overrides.get("limits") or json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())
    return Context(
        workload, seed, seconds, trace, cell, config, traffic, head, limits,
        device=device, started=started, faults=overrides.get("faults", {}),
    )
