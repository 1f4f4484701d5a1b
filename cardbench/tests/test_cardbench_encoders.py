"""A configuration names its encoder, and everything the harness knows of one
encoder or one kernel is in files of its own: the weights and FLOPs that the
wav2vec2 files give are the ones the harness gave before they were split
out; a second encoder is new files only; an architecture key that either
side of an encoder lacks stops a run before it starts; a new kernel's
``work/`` file is counted, barred and timed with no edit elsewhere."""

import hashlib
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

import tiny_cells
from cardbench import work
from cardbench.core import card, port, registry, weights
from cardbench.core.trace import DeviceOp, Trace, kernel_seconds
from cardbench.reference.model import ReferenceAllophant
from cardbench.work import model_flops

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = registry.benchmark()
HEAD = registry.head("allophant-demo")

#: (parameters, sha256 of the JSON list of [name, shape] in order) of each
#: configuration's weights, as the harness drew them before the encoders had
#: files of their own.
SHAPES = {
    "xlsr300m-allophant": (400, "3d33366f1afd1c51aecf726e27e7bfab2d41735f7a521c91c60d53181cbea528"),
    "xlsr1b-allophant": (688, "50473bb8372e4c74b28adcb8c4b8e24ba90d24ebe5e12b454fb5a46be07a5fea"),
}
#: sha256 of the names and float32 bytes of the tiny 300M configuration's
#: weights drawn on the CPU from seed 2**33 + 5, then.
TINY_DRAW = "892f11f69caf52a1995847ecdb6c8d7676887e9550ee1aafec2f928eb3233b27"

#: Real lengths in samples, and the operations by type of the bf16 encoder
#: and the f32 head over them, then: (serving, training).
LENGTHS = [16000, 16399, 47123, 72000, 160000, 400, 399, 1000000]
FLOPS = {
    "xlsr300m-allophant": (
        {"float32": 9470599168.0, "bfloat16": 3936915030016.0},
        {"float32": 23036739584.0, "bfloat16": 11006770413568.0},
    ),
    "xlsr1b-allophant": (
        {"float32": 11113963520.0, "bfloat16": 10718200332288.0},
        {"float32": 27966832640.0, "bfloat16": 31349553102848.0},
    ),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_weights_are_the_ones_drawn_before(name):
    shapes = port.reference_shapes(registry.config(SPEC, name), HEAD)
    text = json.dumps([[parameter, list(shape)] for parameter, shape in shapes])
    assert (len(shapes), hashlib.sha256(text.encode()).hexdigest()) == SHAPES[name]


def test_the_tiny_draw_is_the_one_drawn_before():
    drawn = weights.draw(port.reference_shapes(tiny_cells.config("xlsr300m-allophant"), HEAD), 2**33 + 5, "cpu", HEAD["static"])
    digest = hashlib.sha256()
    for name, value in drawn.items():
        digest.update(name.encode())
        digest.update(value.numpy().tobytes())
    assert digest.hexdigest() == TINY_DRAW


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("name", sorted(FLOPS))
def test_the_flops_are_the_ones_counted_before(name, training):
    config = registry.config(SPEC, name)
    flops = model_flops.total_flops(config, HEAD["plan"], LENGTHS, "bfloat16", "float32", training)
    assert flops == FLOPS[name][training]


#: The script a checkout runs: the tiny greedy and training cells under
#: wav2vec2 and under its copy, with the modules that served them. Each
#: serving window launches six requests, not what a second allows, so that
#: both judge the same sample; one thread, since the gradient of the
#: attribute embeddings (a scatter-add over threads) differs in its last bits
#: from one multithreaded run to the next.
_SCRIPT = """
import json, sys
sys.path[:0] = [{copy!r}, {tests!r}, {root!r}]
import torch
torch.set_num_threads(1)
import tiny_cells
from cardbench.core import registry

serve = registry.task("serve")
timed_loop = serve._closed_loop


def six_requests(server, stream, _stop, on_done, ahead=1):
    launched = []

    class Counted:
        def launch(self, request):
            launched.append(request.index)
            return server.launch(request)

        fetch = staticmethod(server.fetch)

    return timed_loop(Counted(), stream, lambda: len(launched) >= 6, on_done, ahead)


serve._closed_loop = six_requests
out = {{}}
for workload in ("xlsr300m-greedy-cv", "copy-greedy-cv", "xlsr1b-train-cv", "copy-train-cv"):
    line = tiny_cells.run(workload)
    out[workload] = {{"correct": line["correct"], "checks": line["checks"]}}
out["modules"] = sorted(name for name in sys.modules if "wav2vec2copy" in name)
print(json.dumps(out))
"""


def test_a_new_architecture_is_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "cardbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = copy / "cardbench"
    shutil.copy(bench / "reference" / "encoders" / "wav2vec2.py", bench / "reference" / "encoders" / "wav2vec2copy.py")
    shutil.copy(bench / "encoders" / "wav2vec2.py", bench / "encoders" / "wav2vec2copy.py")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, workload in (("xlsr300m-greedy-cv", "copy-greedy-cv"), ("xlsr1b-train-cv", "copy-train-cv")):
        entry = registry.cell(spec, cell)
        config = json.loads((ROOT / next(c["file"] for c in spec["configs"] if c["name"] == entry["config"])).read_text())
        name = "copy-" + entry["config"]
        (bench / "configs" / f"{name}.json").write_text(json.dumps({**config, "name": name, "encoder": "wav2vec2copy"}))
        spec["configs"].append({**next(c for c in spec["configs"] if c["name"] == entry["config"]),
                                "name": name, "file": f"cardbench/configs/{name}.json"})
        spec["workloads"].append({**entry, "name": workload, "config": name})
        shutil.copy(bench / "limits" / f"{cell}.json", bench / "limits" / f"{workload}.json")
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    script = _SCRIPT.format(copy=str(copy), tests=str(bench / "tests"), root=str(ROOT))
    output = subprocess.run(
        [sys.executable, "-c", script], cwd=copy, capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=600,
    )
    assert output.returncode == 0, output.stderr[-4000:]
    found = json.loads(output.stdout.strip().splitlines()[-1])
    assert found.pop("modules") == ["cardbench.encoders.wav2vec2copy", "cardbench.reference.encoders.wav2vec2copy"]
    for ours, theirs in (("copy-greedy-cv", "xlsr300m-greedy-cv"), ("copy-train-cv", "xlsr1b-train-cv")):
        assert found[ours]["correct"] and found[theirs]["correct"], found
        assert found[ours]["checks"] == found[theirs]["checks"], (ours, found)


def _tiny_config(**extra):
    config = tiny_cells.config("xlsr300m-allophant")
    config["architecture"].update(extra)
    return config


@pytest.mark.parametrize("extra", [{"relative_position_buckets": 320}, {"conv_bias": False}], ids=["unknown", "not_implemented"])
def test_a_key_the_reference_lacks_raises(extra):
    with pytest.raises((KeyError, ValueError), match="reference encoder 'wav2vec2'"):
        ReferenceAllophant(_tiny_config(**extra), HEAD, device="meta")


def test_a_key_the_port_lacks_raises():
    encoder = registry.encoder("wav2vec2")
    encoder.port_architecture(_tiny_config()["architecture"])
    with pytest.raises(KeyError, match="relative_position_buckets"):
        encoder.port_architecture(_tiny_config(relative_position_buckets=320)["architecture"])


# ``use_attention_mask`` is the port's and not the reference's; the other is neither's.
@pytest.mark.parametrize("extra", [{"use_attention_mask": True}, {"relative_position_buckets": 320}], ids=["port_only", "neither"])
def test_a_run_with_an_unknown_key_does_not_start(extra, monkeypatch):
    from cardbench import run as runner

    serve = registry.task("serve")
    monkeypatch.setattr(serve, "_closed_loop", lambda *_args, **_kwargs: pytest.fail("the window ran"))
    with pytest.raises(KeyError):
        runner.run_cell(
            SPEC, "xlsr300m-greedy-cv", 7, 1.0, False, device="cpu", config=_tiny_config(**extra),
            traffic=tiny_cells.traffic("cv-greedy"), started=time.perf_counter(),
        )


@pytest.mark.parametrize("encoder", [None, "nonesuch"], ids=["none", "no_files"])
def test_a_configuration_must_name_an_encoder_with_files(tmp_path, encoder):
    config = {"name": "x"} if encoder is None else {"name": "x", "encoder": encoder}
    (tmp_path / "x.json").write_text(json.dumps(config))
    spec = {"configs": [{"name": "x", "file": "x.json"}]}
    with pytest.raises(KeyError if encoder is None else FileNotFoundError):
        registry.config(spec, "x", root=tmp_path)


def test_a_new_kernel_is_a_work_file(tmp_path, monkeypatch):
    ops = types.ModuleType("cardbench_probe_ops")

    def launch():
        launch.launches += 1

    launch.launches = 5
    ops.launch = launch
    ops.plain = lambda: "plain"
    monkeypatch.setitem(sys.modules, "cardbench_probe_ops", ops)
    (tmp_path / "probe.py").write_text(
        'KERNEL = "K9"\n'
        'COUNTER = ("cardbench_probe_ops", "launch")\n'
        'TWINS = (("cardbench_probe_ops", "plain"),)\n'
        'KERNEL_NAMES = ("probe_kernel",)\n'
    )
    monkeypatch.setattr(work, "__path__", [*work.__path__, str(tmp_path)])
    try:
        before = card.counters()
        assert before["K9"] == 5 and {"K1", "K2", "K3", "K4", "K5", "backtrace"} < set(before)
        ops.launch()
        assert card.counted_since(before)["K9"] == 1
        assert card.launch_gap(card.counted_since(before), {}) == 1
        with card.TwinsForbidden():
            with pytest.raises(card.TwinFault, match="plain"):
                ops.plain()
        assert ops.plain() == "plain"
        trace = Trace([DeviceOp("probe_kernel<64>", 0.0, 250.0, None), DeviceOp("other", 250.0, 300.0, None)], {})
        assert kernel_seconds(trace)["K9"] == pytest.approx(250e-6)
    finally:
        sys.modules.pop("cardbench.work.probe", None)


def test_the_launch_check_holds_every_counted_kernel():
    """A kernel that the cell's shapes do not ask for is expected 0 times,
    and one they ask for that no file counts is missed in full."""
    assert card.launch_gap({"K1": 48, "K2": 2, "K3": 0, "K4": 0}, {"K1": 48, "K2": 2}) == 0
    assert card.launch_gap({"K1": 48, "K2": 2, "K4": 3}, {"K1": 48, "K2": 2}) == 3
    assert card.launch_gap({"K1": 47, "K2": 2}, {"K1": 48, "K2": 2, "K9": 5}) == 6
