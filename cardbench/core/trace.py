"""The benchmark's own spans, and the reading of a ``torch.profiler`` trace.

Spans are ``record_function`` ranges that the benchmark opens around its
calls into the program, and around the forward of the program's modules
through forward hooks (``ModuleSpans``): nothing is added inside the
program. A profiled stretch is exported as a Chrome trace, from which
``Trace`` reads the device operations (kernels, copies, fills), the
host-side launch of each kernel (by correlation id) and the ranges, all on
the profiler's one clock."""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from cardbench.core import registry

#: Kernel-name fragments -> group, first match wins (the port's profiling
#: tools' grouping, with the training groups).
GROUPS = (
    ("attention_backward", "attention backward (K4)"),
    ("attention_dropout", "attention dropout (K5)"),
    ("beam_search", "beam search (K3)"),
    ("beam_backtrace_kernel", "beam backtrace"),
    ("oneshot_attention", "attention (K1)"),
    ("frame_encoder", "frame encoder (K2)"),
    ("ctc", "CTC loss"),
    ("multi_tensor_apply", "optimizer and clipping (foreach)"),
    ("adam", "optimizer and clipping (foreach)"),
    ("bernoulli", "dropout masks"),
    ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("memcpy", "host and device copies"),
    ("memset", "fills"),
    ("copy", "dtype casts and copies"),
    ("layer_norm", "layer norm"),
    ("softmax", "softmax"),
    ("reduce", "reductions"),
    ("index", "gathers and scatters"),
    ("elementwise", "elementwise arithmetic"),
)

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def group_of(name: str) -> str:
    lowered = name.lower()
    for fragment, group in GROUPS:
        if fragment in lowered:
            return group
    return "other"


class ModuleSpans:
    """Forward hooks that open a ``record_function`` range named ``label``
    around every forward of ``module``."""

    def __init__(self, module: torch.nn.Module, label: str):
        self._open: List = []
        self._handles = [
            module.register_forward_pre_hook(self._enter),
            module.register_forward_hook(self._exit),
        ]
        self.label = label

    def _enter(self, _module, _inputs):
        span = torch.autograd.profiler.record_function(self.label)
        span.__enter__()
        self._open.append(span)

    def _exit(self, _module, _inputs, _output):
        self._open.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for handle in self._handles:
            handle.remove()


@dataclass
class DeviceOp:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float
    launch: Optional[float]  # host time of the launching call, if known


@dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[float, float]]]
    host_events: List[Tuple[float, float, str]] = field(default_factory=list)  # (start, end, name), sorted

    @classmethod
    def read(cls, path: Path, range_prefix: str = "cardbench.") -> "Trace":
        document = json.loads(Path(path).read_text())
        events = document["traceEvents"] if isinstance(document, dict) else document
        launches: Dict[int, float] = {}
        ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        host_events = []
        device_events = []
        for event in events:
            if event.get("ph") != "X":
                continue
            category = event.get("cat", "")
            start, duration = float(event["ts"]), float(event.get("dur", 0.0))
            if category in _DEVICE_CATEGORIES:
                device_events.append(event)
            elif category in _HOST_CATEGORIES:
                correlation = event.get("args", {}).get("correlation")
                if category in ("cuda_runtime", "cuda_driver") and correlation is not None:
                    launches[int(correlation)] = start
                if category == "user_annotation" and event["name"].startswith(range_prefix):
                    ranges[event["name"]].append((start, start + duration))
                host_events.append((start, start + duration, event["name"]))
        ops = []
        for event in device_events:
            start = float(event["ts"])
            correlation = event.get("args", {}).get("correlation")
            launch = launches.get(int(correlation)) if correlation is not None else None
            name = event["name"] if event.get("cat") == "kernel" else event.get("cat", "")
            ops.append(DeviceOp(name, start, start + float(event.get("dur", 0.0)), launch))
        ops.sort(key=lambda op: op.start)
        host_events.sort()
        return cls(ops, {name: sorted(values) for name, values in ranges.items()}, host_events)

    # -- sums ----------------------------------------------------------------

    def window(self, name: str) -> Tuple[float, float]:
        (start, end), = self.ranges[name]
        return start, end

    def busy_us(self, start: float, end: float) -> float:
        """Length of the union of device operations inside [start, end]."""
        total, reach = 0.0, start
        for op in self.ops:
            low, high = max(op.start, reach), min(op.end, end)
            if high > low:
                total += high - low
                reach = high
        return total

    def gaps(self, start: float, end: float) -> List[Tuple[float, float]]:
        """The idle intervals of [start, end]: no device operation running."""
        out, reach = [], start
        for op in self.ops:
            if op.end <= reach:
                continue
            if op.start >= end:
                break
            if op.start > reach:
                out.append((reach, op.start))
            reach = max(reach, op.end)
        if reach < end:
            out.append((reach, end))
        return out

    def launched_in(self, spans: Iterable[Tuple[float, float]]) -> List[DeviceOp]:
        """Device operations whose launch lies inside any of ``spans``."""
        spans = sorted(spans)
        starts = [span[0] for span in spans]
        out = []
        for op in self.ops:
            if op.launch is None:
                continue
            index = bisect.bisect_right(starts, op.launch) - 1
            if index >= 0 and op.launch <= spans[index][1]:
                out.append(op)
        return out

    def device_us(self, ops: Iterable[DeviceOp], names: Sequence[str] = ()) -> float:
        return sum(op.end - op.start for op in ops if not names or any(fragment in op.name for fragment in names))

    def host_labels(self, times: Sequence[float]) -> List[str]:
        """For each of the ascending ``times``, the innermost host event open
        then: the latest-starting one that contains it."""
        heap: List[Tuple[float, float, str]] = []
        labels, index, events = [], 0, self.host_events
        for time in times:
            while index < len(events) and events[index][0] <= time:
                start, end, name = events[index]
                heapq.heappush(heap, (-start, end, name))
                index += 1
            while heap and heap[0][1] < time:
                heapq.heappop(heap)
            labels.append(heap[0][2] if heap else "no host event")
        return labels

    def breakdown(self, start: float, end: float, top: int = 10) -> dict:
        """The device's time by kernel group, and its idle time by what the
        host was doing when each gap began, in seconds, largest first."""
        by_group: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            low, high = max(op.start, start), min(op.end, end)
            if high > low:
                by_group[group_of(op.name)] += (high - low) * 1e-6
        by_label: Dict[str, float] = defaultdict(float)
        gaps = self.gaps(start, end)
        for (low, high), label in zip(gaps, self.host_labels([low for low, _high in gaps])):
            by_label[label] += (high - low) * 1e-6
        ordered = lambda values: [[name, seconds] for name, seconds in sorted(values.items(), key=lambda item: -item[1])[:top]]  # noqa: E731
        return {"device_ops": ordered(by_group), "idle_gaps": ordered(by_label)}


def kernel_seconds(trace: Trace) -> Dict[str, float]:
    """Device seconds of each kernel whose ``work/`` file names it in a trace
    (``KERNEL_NAMES``), by its ``KERNEL`` name; 0 for one that did not run."""
    return {
        kernel.KERNEL: trace.device_us(trace.ops, kernel.KERNEL_NAMES) * 1e-6
        for kernel in registry.kernels() if hasattr(kernel, "KERNEL_NAMES")
    }


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the ``(start, end)`` intervals ``spans``."""
    total, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start >= reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def device_profiler():
    """A profiler of the device alone (CUDA activity, no host events): it
    records every kernel, copy and fill, and reads them in memory, so a
    whole window can run under it with no trace written."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _is_device_operation(event) -> bool:
    """A kernel, copy or fill among a profiler's events (by the event's
    activity type where this PyTorch gives it, else by its device)."""
    if hasattr(event, "activity_type"):
        return event.activity_type() in _DEVICE_CATEGORIES
    return str(event.device_type()).endswith("CUDA") and not event.is_user_annotation()


def profiled_device_seconds(profiler, wall_s: float) -> Tuple[float, int]:
    """(seconds in which a device operation ran, the operations) over what
    ``profiler`` recorded. Raises where the recorded operations cover less
    than 90% of ``wall_s``, the wall time profiled: the profiler stops
    recording when its buffers fill, and a trace cut short would read too
    little device time."""
    spans = [
        (event.start_ns(), event.start_ns() + event.duration_ns())
        for event in profiler.profiler.kineto_results.events()
        if _is_device_operation(event)
    ]
    if not spans:
        raise RuntimeError("the device profiler recorded no device operation")
    covered = (max(end for _start, end in spans) - min(start for start, _end in spans)) * 1e-9
    if covered < 0.9 * wall_s:
        raise RuntimeError(f"the device profiler recorded {covered:.3f} s of a {wall_s:.3f} s window: its trace was cut short")
    return union_length(spans) * 1e-9, len(spans)
