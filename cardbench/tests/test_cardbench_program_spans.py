"""The program's stretch (``core/program_spans.py``): device idle goes to the
innermost open program span when its gap begins, and the spans' idle adds up
to the stretch's wall less its busy time; a span's device time counts
overlapping operations once; a synchronising call's warning is put on the
repo's line that made it; tiny traced runs on the CPU, with the stretch after each task's
traced one, report the program's counters beside every metric they reported
before, with the spans each request and update opens."""

import json
import math
import traceback
import warnings
from pathlib import Path

import pytest

import tiny_cells
from cardbench.core import program_spans, registry
from cardbench.core.trace import Trace


def _event(category, name, start, duration, correlation=None):
    event = {"ph": "X", "cat": category, "name": name, "ts": start, "dur": duration}
    if correlation is not None:
        event["args"] = {"correlation": correlation}
    return event


def test_idle_goes_to_the_innermost_open_span_and_adds_up(tmp_path):
    events = [
        _event("user_annotation", program_spans.WINDOW, 0, 100),
        _event("user_annotation", "allophant.train.step", 10, 80),
        _event("user_annotation", "allophant.train.forward", 12, 28),
        _event("user_annotation", "allophant.train.backward", 45, 35),
        _event("user_annotation", "cardbench.update", 5, 90),
    ]
    # The backward's two kernels overlap by 5 µs: its device time is 25, not 30.
    for correlation, (launch, start, end) in enumerate([(15, 20, 30), (50, 55, 75), (52, 70, 80), (85, 86, 88)]):
        events.append(_event("cuda_runtime", "cudaLaunchKernel", launch, 1, correlation))
        events.append(_event("kernel", f"kernel{correlation}", start, end - start, correlation))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace.read(path, range_prefix=program_spans.PREFIX)
    spans = program_spans.summarise(trace, 0.0, 100.0)
    assert {name: span["idle_us"] for name, span in spans.items()} == {
        "client": 20.0, "train.step": 12.0, "train.forward": 25.0, "train.backward": 6.0
    }
    assert {name: span["device_us"] for name, span in spans.items()} == {
        "client": 0.0, "train.step": 37.0, "train.forward": 10.0, "train.backward": 25.0
    }
    assert sum(span["idle_us"] for span in spans.values()) == 100.0 - trace.busy_us(0.0, 100.0)
    readings = {"program": {
        "task": "train", "units": 1, "wall_s": 100e-6, "busy_s": 37e-6, "spans": spans, "counters": {},
        "syncs": {"a.py:3": 4, "b.py:9": 1},
    }}
    assert program_spans.metrics(readings) == {
        "forward_ms.train": {"value": 0.01, "unit": "ms/update"},
        "backward_ms.train": {"value": 0.025, "unit": "ms/update"},
        "forward_idle.train": {"value": 25.0, "unit": "%"},
        "backward_idle.train": {"value": 6.0, "unit": "%"},
        "host_syncs.train": {"value": 5.0, "unit": "syncs/update"},
    }


def _warn_as_the_runtime_does():
    warnings.warn("called a synchronizing CUDA operation", UserWarning)


def test_a_synchronising_call_is_put_on_the_repo_line_that_made_it():
    with program_spans.synchronising_lines() as lines:
        _warn_as_the_runtime_does()
        warnings.warn("some other warning")
    line = _warn_as_the_runtime_does.__code__.co_firstlineno + 1
    assert lines == {f"cardbench/tests/{Path(__file__).name}:{line}": 1}
    here = traceback.extract_stack()
    outside = traceback.FrameSummary("/elsewhere/torch/functional.py", 3107, "ctc_loss")
    assert program_spans.calling_line([*here, outside], "x:1") == f"cardbench/tests/{Path(__file__).name}:{here[-1].lineno}"
    # Sync-debug mode's own switch, made from the module itself, is not the program's.
    tool = traceback.FrameSummary(program_spans.__file__, 1, "synchronising_calls")
    assert program_spans.calling_line([*here, tool, outside], "x:1") is None
    assert program_spans.calling_line([outside], "x:1") == "x:1"


#: workload -> (requests or updates of the stretch, the program's counters a
#: unit in the tiny cell, spans and their counts a unit)
TINY = {
    # tiny_cells' ``trace_requests``; 37 classifiers and the phone layer
    # decoded greedily, the heads of each class count in one call: the 36
    # four-class heads, then phoneme and phone (40 classes).
    "xlsr300m-greedy-cv": (
        2,
        {"decode_calls": 2, "decode_heads": 38},
        {"estimator.request": 1, "estimator.inputs": 1, "estimator.forward": 1, "estimator.decode": 1},
    ),
    # Two microbatches, a CTC call each for the 4- and the 40-class heads;
    # one read of the metrics.
    "xlsr1b-train-cv": (
        1,
        {"ctc_calls": 4, "host_reads": 1},
        {"train.step": 1, "train.forward": 2, "train.loss": 2, "train.backward": 2, "train.optimizer": 1, "train.metrics": 1},
    ),
}


@pytest.fixture
def program_stretch(monkeypatch):
    """The program's stretch run after each task's traced stretch, as the
    tasks' ``run`` would call it; yields what it read."""
    serve, train = registry.task("serve"), registry.task("train")
    traced_stretch, traced_update = serve._traced_stretch, train._traced_update
    found = {}

    def stretch(context, server, stream, model, layers):
        out = traced_stretch(context, server, stream, model, layers)
        found["program"] = program_spans.serve(context, server, stream, serve._closed_loop)
        return out

    def update(context, trainer, group, index, layers):
        out = traced_update(context, trainer, group, index, layers)
        found["program"] = program_spans.train(context, trainer, group, index + 1)
        return out

    monkeypatch.setattr(serve, "_traced_stretch", stretch)
    monkeypatch.setattr(train, "_traced_update", update)
    return found


@pytest.mark.parametrize("workload", list(TINY))
def test_tiny_traced_runs_read_the_program_stretch(workload, program_stretch):
    line = tiny_cells.run(workload, trace=True)
    assert line["correct"], line["checks"]
    units, counters, spans = TINY[workload]
    stretch = program_stretch["program"]
    assert stretch["units"] == units
    assert {name: stretch["counters"][name] / units for name in counters} == counters
    assert {name: stretch["spans"][name]["count"] / units for name in spans} == spans
    # No device operation on the CPU: the device-trace readings and the
    # synchronisations stay out.
    assert stretch["busy_s"] == 0.0 and stretch.get("syncs") is None
    readings = program_spans.metrics(program_stretch)
    assert set(readings) == {
        name for name, (_unit, kind, _key) in program_spans.METRICS.items()
        if name.endswith("." + stretch["task"]) and kind == "counter"
    }
    idle_s = sum(span["idle_us"] for span in stretch["spans"].values()) * 1e-6
    assert math.isclose(idle_s, stretch["wall_s"] - stretch["busy_s"], rel_tol=1e-9)
