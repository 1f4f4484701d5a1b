"""The program's own spans and counters in a profiled stretch, and the
card's synchronisations in an update.

``allophant_tpu_torch/tracing.py`` opens ``record_function`` ranges inside
the port (``allophant.estimator.*`` around a request's inputs, forward and
decode; ``allophant.train.*`` around an update's forward, loss, backward,
optimizer and metrics read) and counts ``decode_calls``, ``ctc_calls`` and
``host_reads``, while a ``tracing.recording()`` is open. ``serve`` and
``train`` run one more stretch under a recording and ``torch.profiler``,
after a task's traced stretch: ``trace_requests`` more requests through the
task's closed loop, or the traced update's group once more. ``train`` then
runs the group once again under ``torch.cuda.set_sync_debug_mode("warn")``,
whose warnings count the host's waits for the card, by the line that made
each. ``summarise`` reads the stretch's Chrome trace with
``Trace.read(path, range_prefix="allophant.")``; ``metrics`` gives the
per-layer readings of ``METRICS`` from the result."""

from __future__ import annotations

import contextlib
import math
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from cardbench.core.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
#: The port's ``tracing.PREFIX``.
PREFIX = "allophant."
#: The benchmark's range around the program's stretch.
WINDOW = "cardbench.program"
#: Idle under no program span: the benchmark's own work and its waits.
CLIENT = "client"

#: metric -> (unit, what it reads, span or counter). ``idle``: the share of
#: the stretch's wall in which the device idled in gaps that began with the
#: span the innermost open program range (a share: the idle milliseconds
#: swing with the host's pace, PERF.md §6); ``device``: milliseconds a request
#: or update in which an operation launched inside the span ran (their union:
#: operations on cuDNN's side streams overlap the main stream's and count
#: once); ``counter``: the program's counter a request or update; ``syncs``:
#: the synchronising calls of the update run under sync-debug mode.
METRICS: Dict[str, Tuple[str, str, str]] = {
    "inputs_idle.serve": ("%", "idle", "estimator.inputs"),
    "forward_idle.serve": ("%", "idle", "estimator.forward"),
    "decode_idle.serve": ("%", "idle", "estimator.decode"),
    "decode_calls.serve": ("calls/request", "counter", "decode_calls"),
    "forward_ms.train": ("ms/update", "device", "train.forward"),
    "loss_ms.train": ("ms/update", "device", "train.loss"),
    "backward_ms.train": ("ms/update", "device", "train.backward"),
    "optimizer_ms.train": ("ms/update", "device", "train.optimizer"),
    "forward_idle.train": ("%", "idle", "train.forward"),
    "backward_idle.train": ("%", "idle", "train.backward"),
    "host_syncs.train": ("syncs/update", "syncs", ""),
}


def summarise(trace: Trace, start: float, end: float) -> Dict[str, Dict[str, float]]:
    """For each program span (prefix dropped) and ``client``: the count, the
    host µs, the device µs in which an operation launched inside it ran, and the
    device-idle µs of the gaps in [start, end] that began with it the
    innermost open program range, on any thread (``client``: under none)."""
    out: Dict[str, Dict[str, float]] = {CLIENT: {"count": 0, "host_us": 0.0, "device_us": 0.0, "idle_us": 0.0}}
    opened: List[Tuple[float, float, str]] = []
    for name, spans in trace.ranges.items():
        short = name[len(PREFIX) :]
        opened.extend((low, high, short) for low, high in spans)
        out[short] = {
            "count": len(spans),
            "host_us": sum(high - low for low, high in spans),
            "device_us": Trace(trace.launched_in(spans), {}).busy_us(-math.inf, math.inf),
            "idle_us": 0.0,
        }
    gaps = trace.gaps(start, end)
    innermost = Trace([], {}, sorted(opened)).host_labels([low for low, _high in gaps])
    for (low, high), label in zip(gaps, innermost):
        out[label if label in out else CLIENT]["idle_us"] += high - low
    return out


def _profiled(context, body: Callable[[], None], task: str, units: int) -> dict:
    """Runs ``body`` under a recording and the profiler, inside ``WINDOW``,
    and reads the stretch: its wall and busy seconds, each span's summary,
    the counters, the ``task`` and its ``units`` (requests or updates)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from allophant_tpu_torch import tracing

    on_card = context.device == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tracing.recording() as counts, profile(activities=activities) as profiler:
        with record_function(WINDOW):
            if on_card:
                torch.cuda.synchronize()
            body()
            if on_card:
                torch.cuda.synchronize()
    path = context.trace_path()
    path = path.with_name(f"{path.stem}.program{path.suffix}")
    profiler.export_chrome_trace(str(path))
    trace = Trace.read(path, range_prefix=PREFIX)
    Path(path).unlink()
    start, end = next((low, high) for low, high, name in trace.host_events if name == WINDOW)
    return {
        "task": task,
        "units": units,
        "wall_s": (end - start) * 1e-6,
        "busy_s": trace.busy_us(start, end) * 1e-6,
        "spans": summarise(trace, start, end),
        "counters": dict(counts),
    }


def calling_line(frames, fallback: str) -> Optional[str]:
    """Where a synchronising call was made: the innermost of ``frames``
    (outermost first, as ``traceback.extract_stack`` gives them) that lies in
    the repo, as ``path:line`` from its root; ``fallback`` where none does;
    None where that frame is this module's (sync-debug mode's own switch)."""
    for frame in reversed(frames):
        path = Path(frame.filename).resolve()
        if path.is_relative_to(ROOT):
            return None if path == Path(__file__).resolve() else f"{path.relative_to(ROOT)}:{frame.lineno}"
    return fallback


@contextlib.contextmanager
def synchronising_lines() -> Iterator[Counter]:
    """Counts, for the block, each warning of a synchronising call (as
    ``torch.cuda.set_sync_debug_mode("warn")`` gives them) by the line of the
    repo that made it (``calling_line``); other warnings are dropped."""
    lines: Counter = Counter()

    def seen(message, _category, filename, lineno, _file=None, _line=None):
        if "synchronizing" in str(message):
            # The stack from the warning's caller out, without this function.
            where = calling_line(traceback.extract_stack(sys._getframe(1)), f"{filename}:{lineno}")
            if where is not None:
                lines[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        yield lines


def synchronising_calls(context, body: Callable[[], None]) -> Optional[Dict[str, int]]:
    """The calls of ``body`` that make the host wait for the card, by the
    line of the repo that made them, as the CUDA runtime reports them under
    sync-debug mode; None off the card."""
    if context.device != "cuda":
        return None
    with synchronising_lines() as lines:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(lines.most_common())


def serve(context, server, stream, closed_loop) -> dict:
    """``trace_requests`` more requests of ``stream`` through the serving
    task's ``closed_loop`` and ``server``, each copied back as in the window."""
    count = int(context.traffic["trace_requests"])
    launched = []

    class Counted:
        def launch(self, request):
            launched.append(request.index)
            return server.launch(request)

        fetch = staticmethod(server.fetch)

    def body():
        closed_loop(Counted(), stream, lambda: len(launched) >= count, lambda *_done: None, context.traffic["loop"]["ahead"])

    return _profiled(context, body, "serve", count)


def train(context, trainer, group, index: int) -> dict:
    """One update of ``group`` (stacked, copied and stepped by the training
    task's ``trainer``) at update ``index``; then one more at ``index + 1``
    under sync-debug mode (``syncs``)."""
    out = _profiled(context, lambda: trainer.update(group, index), "train", 1)
    out["syncs"] = synchronising_calls(context, lambda: trainer.update(group, index + 1))
    return out


def read(name: str, readings: dict) -> Optional[float]:
    """The reading of metric ``name`` from ``readings["program"]``; None
    where no stretch ran or the span did not run, and for a device number or
    the synchronisations where the stretch ran no device operation (on the
    CPU)."""
    program = readings.get("program")
    if not program:
        return None
    _unit, kind, key = METRICS[name]
    if kind == "syncs":
        syncs = program.get("syncs")
        return None if syncs is None else float(sum(syncs.values()))
    if kind == "counter":
        return program["counters"].get(key, 0) / program["units"]
    span = program["spans"].get(key)
    if span is None or not program["busy_s"]:
        return None
    if kind == "idle":
        return 1e-4 * span["idle_us"] / program["wall_s"]
    return 1e-3 * span["device_us"] / program["units"]


def metrics(readings: dict) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each finite reading of the stretch's
    task (the metrics named ``*.serve`` or ``*.train``), as a result line
    holds them."""
    program = readings.get("program")
    if not program:
        return {}
    out = {}
    for name in (name for name in METRICS if name.endswith("." + program["task"])):
        value = read(name, readings)
        if value is not None and math.isfinite(value):
            out[name] = {"value": value, "unit": METRICS[name][0]}
    return out
