"""The w2v-BERT 2.0 cell's files: its tiny cell judged `correct` at float32,
its FLOPs and K7's work counted by hand, and what the files do on a program
from before K7 came to the port: the kernel's file names no kernel and its
roofline reads nothing."""

import importlib.util

import pytest

import tiny_cells
from cardbench.core import registry
from cardbench.work import k7

SPEC = registry.benchmark()
ARCH = registry.config(SPEC, "w2vbert2-allophant")["architecture"]


def test_the_tiny_cell_is_correct_at_float32():
    line = tiny_cells.run("w2vbert2-greedy-cv")
    assert line["correct"], line["checks"]
    assert line["checks"]["greedy_gap_nats"]["value"] < 1e-3


def test_the_flops_of_one_utterance():
    """4.5 s: 448 filterbank frames, 224 encoder frames (frames of 400 samples every 160, pairs stacked)."""
    frames, flops = registry.encoder("w2v_bert").encoder_flops(ARCH, 72_000, "bfloat16", False)
    assert frames == 224
    per_layer = 224 * (33_554_432 + 8_388_608 + 6_291_456 + 63_488 + 4 * 224 * 1024 + 2 * 73 * 1024)
    assert flops["bfloat16"] == 2 * 224 * 160 * 1024 + 24 * per_layer
    assert flops["float32"] == 448 * (2.5 * 512 * 9 + 2 * 257 * 80)


def test_k7_work_by_hand():
    bytes_moved, operations = k7.launch_work(10, 2, 8, 73, [10, 4, 0, 12], 2)
    # The fourth row's 12 frames are cut to the launch's 10.
    assert bytes_moved == 4 * 24 * 16 * 2 + 4 * 10 * 4 + 73 * 8 * 2
    assert operations == 4 * 16 * (100 + 16 + 100) + 2 * 73 * 16 * 24


def test_without_k7_in_the_program_the_files_read_nothing(monkeypatch):
    assert k7.KERNEL == "K7"
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec", lambda name, *args: None if name.endswith("relkey_attention") else real(name, *args)
    )
    spec = importlib.util.spec_from_file_location("cardbench_k7_without_the_port", k7.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert not hasattr(fresh, "KERNEL") and callable(fresh.launch_work)
    reader = registry.per_layer(SPEC, "w2vbert2-greedy-cv")["k7_roofline.serve"]
    assert reader.read({"trace": {"kernel_s": {"K1": 0.01}}, "config": {"architecture": ARCH}}) is None


@pytest.mark.parametrize("workload", ["w2vbert2-greedy-cv", "xlsr300m-beam4-cv"])
def test_the_new_cells_report_their_serving_metrics(workload):
    names = set(registry.per_layer(SPEC, workload))
    assert {"mfu.serve", "device_idle.serve", "encoder_ms_per_audio_s.serve"} < names
    assert ("k7_roofline.serve" in names) == (workload == "w2vbert2-greedy-cv")
    assert ("k3_roofline.serve" in names) == (workload == "xlsr300m-beam4-cv")
