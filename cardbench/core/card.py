"""The card a run measures, and what the port's timed path launched on it.

The port's kernel wrappers count their launches (``.launches``); a run reads
the counters around its window and holds them to what the cell's shapes
ask for. ``TwinsForbidden`` replaces the plain twins of the kernels with
functions that raise while the window runs, so that a twin that ran on the
card fails the run. Each kernel's counter and twins are in its own
``work/<kernel>.py`` (``registry.kernels``)."""

from __future__ import annotations

import importlib
import subprocess
from typing import Dict

import torch

from cardbench.core import registry


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs only on a CUDA card")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} CUDA devices, {torch.cuda.device_count()} are visible")


def describe() -> str:
    """The card's name, the device count and the power limit, on one line."""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as error:
        limit = [f"nvidia-smi: {error}"]
    return f"{torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} device(s); nvidia-smi: {' | '.join(limit)}"


def counters() -> Dict[str, int]:
    """Each kernel's launches so far, by its ``KERNEL`` name."""
    values = {}
    for kernel in registry.kernels():
        module, attribute = kernel.COUNTER
        values[kernel.KERNEL] = int(getattr(importlib.import_module(module), attribute).launches)
    return values


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    now = counters()
    return {name: now[name] - before[name] for name in now}


def launch_gap(launches: Dict[str, int], expected: Dict[str, int]) -> int:
    """How far the counted launches lie from what the cell's shapes ask
    for, over every kernel: one that ``expected`` does not name is expected
    0 times."""
    return sum(abs(launches.get(name, 0) - expected.get(name, 0)) for name in {*launches, *expected})


class TwinFault(RuntimeError):
    pass


class TwinsForbidden:
    def __enter__(self):
        self.saved = []
        for kernel in registry.kernels():
            for module_name, attribute in getattr(kernel, "TWINS", ()):
                module = importlib.import_module(module_name)
                self.saved.append((module, attribute, getattr(module, attribute)))
                setattr(module, attribute, self._forbidden(attribute))
        return self

    @staticmethod
    def _forbidden(name: str):
        def raise_on_call(*_args, **_kwargs):
            raise TwinFault(f"the plain twin {name} ran on the card's timed path")

        return raise_on_call

    def __exit__(self, *_exc):
        for module, attribute, function in self.saved:
            setattr(module, attribute, function)
        return False
