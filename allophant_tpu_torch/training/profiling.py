"""Trace parsing for per-op device-time attribution (counterpart of
``allophant_tpu/training/profiling.py``).

``torch.profiler`` writes a chrome trace (``export_chrome_trace``, or the
``tensorboard_trace_handler`` of ``training/run.py:StepProfiler``, which
writes ``*.pt.trace.json``); :func:`report_device_ops` sums the device
timeline's events by name over the newest trace under a directory, divides by
the number of profiled steps and prints the top entries. The device timeline
is the trace's CUDA kernel events (category "kernel"); ``category="cpu_op"``
reads the host's operator timeline instead, which is all a trace taken on the
CPU holds."""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, Tuple

TRACE_PATTERNS = ("*.json", "*.json.gz")


def _newest_trace(trace_dir: str):
    paths = [
        path
        for pattern in TRACE_PATTERNS
        for path in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    ]
    return max(paths, key=os.path.getmtime) if paths else None


def device_op_times(trace_path: str, category: str = "kernel") -> Tuple[Dict[str, float], Dict[str, int]]:
    """Microseconds and occurrences of each event name of ``category`` in a
    chrome trace (complete events, ``"ph": "X"``)."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt", encoding="utf-8") as handle:
        trace = json.load(handle)
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for event in trace.get("traceEvents", []):
        if event.get("ph") == "X" and event.get("cat") == category:
            totals[event["name"]] += float(event.get("dur", 0.0))
            counts[event["name"]] += 1
    return dict(totals), dict(counts)


def report_device_ops(trace_dir: str, steps: int, top: int = 40, category: str = "kernel") -> Dict[str, float]:
    """Prints per-op time of the newest trace under ``trace_dir``, each op's
    events summed over the trace and divided by ``steps``; returns the
    milliseconds per step by op name (empty when there is no trace or no
    event of ``category``)."""
    path = _newest_trace(trace_dir)
    if path is None:
        print("no trace written")
        return {}
    totals, counts = device_op_times(path, category)
    grand = sum(totals.values())
    if not grand:
        print(f"no {category} events found in trace")
        return {}
    print(f"{category} total: {grand / 1e3 / steps:.3f} ms/step over {steps} steps")
    for name, micros in sorted(totals.items(), key=lambda item: -item[1])[:top]:
        print(f"{micros / 1e3 / steps:9.3f} ms/step {100 * micros / grand:5.1f}% x{counts[name] // steps:<4d} {name[:110]}")
    return {name: micros / 1e3 / steps for name, micros in totals.items()}
