"""The card a run measures, and what the port's timed path launched on it.

The port's kernel wrappers count their launches (``.launches``); a run reads
the counters around its window and holds them to what the cell's shapes
ask for. ``TwinsForbidden`` replaces the plain twins of the kernels with
functions that raise while the window runs, so that a twin that ran on the
card fails the run."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict

import torch

#: (module, attribute) of each counted launch wrapper, by kernel.
COUNTERS = {
    "K1": ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_attention"),
    "K2": ("allophant_tpu_torch.ops.frame_encoder", "fused_frame_conv"),
    "K3": ("allophant_tpu_torch.ops.beam_kernel", "beam_search_cuda"),
    "K4": ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_attention_backward"),
    "K5": ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_dropout_attention"),
    "backtrace": ("allophant_tpu_torch.ops.beam_kernel", "backtrace_cuda"),
}

#: The port's plain twins of the kernels on the timed paths.
TWINS = (
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot"),
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot_dropout"),
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot_backward"),
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_dropout_mask_bits"),
    ("allophant_tpu_torch.ops.frame_encoder", "reference_frame_conv"),
    ("allophant_tpu_torch.ops.decode", "beam_search_padded"),
    ("allophant_tpu_torch.ops.decode", "backtrace_beams_device"),
)


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
    values = {}
    for name, (module, attribute) in COUNTERS.items():
        values[name] = int(getattr(getattr(sys.modules[module], attribute), "launches"))
    return values


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    now = counters()
    return {name: now[name] - before[name] for name in now}


class TwinFault(RuntimeError):
    pass


class TwinsForbidden:
    def __enter__(self):
        import importlib

        self.saved = []
        for module_name, attribute in TWINS:
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
