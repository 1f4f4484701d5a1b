"""The port's ``train`` subcommand (allophant_tpu_torch/cli/run.py) against
the JAX CLI's on the Common Voice corpus ``tests/fixtures.py:build_cv_corpus``
writes, at float32 with dropout 0 and SGD with momentum (Adam's sign on a
zero-gradient leaf differs between frameworks): the JAX fixtures' mini
transformer on 40 log-mel filterbanks, both CLIs from the same initial
weights (JAX's, carried into the port), 2 epochs with ``-d``: the
statistics and every saved checkpoint's parameters agree; one epoch on raw
samples agrees within the limit JAX's own float32 error sets. Then preemption:
SIGTERM to a port ``train`` subprocess (with batch-building worker
processes) after its first statistics line exits 0 with ``interrupted.ckpt``,
and ``--restore`` resumes from it to parameters equal to an uninterrupted
run's."""

import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from allophant_tpu.cli import run as jax_cli
from allophant_tpu.training import checkpoint as jax_checkpoint
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.cli import run as cli
from allophant_tpu_torch.training import checkpoint as checkpoint_module
from allophant_tpu_torch.training.checkpoint import load_checkpoint, save_orbax
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.weights import load_jax_variables

from fixtures import build_cv_corpus, mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = Path(__file__).resolve().parent.parent
# Losses: f32 in two frameworks, 1e-5 relative; parameters after 8 updates:
# within 1e-5 of each leaf's largest value, and a leaf that stays zero in
# exact arithmetic (the key projection's bias, whose gradient is zero) within
# 1e-6 of the largest value of all leaves.
LOSS_RTOL, PARAMETER_SHARE, ZERO_FLOOR = 1e-5, 1e-5, 1e-6
# On raw samples (a frame a sample, T of 1,600-2,400) JAX's float32 run lies
# 1.873e-5 of a leaf's largest value from its float64 run after one epoch,
# the port's 3.1e-7, and the two float64 runs agree within 9.3e-8: JAX's CTC
# recursion runs in float32 (tools/torch_train_drift.py). The limit is JAX's
# distance and the port's, with a quarter of margin.
RAW_PARAMETER_SHARE = 2.5e-5
STATISTICS_LINE = re.compile(r"epoch \d+ step \d+:")


def _config(epochs: int) -> dict:
    """The mini transformer (linear frontend, d_model 32, 2 heads, 2 layers)
    on 40 log-mel filterbanks: the JAX fixtures' tone-corpus frontend, at
    which both frameworks' CTC gradients are exact to f32."""
    config = mini_config_dict()
    config["nn"].update(
        batch_size=2, maximum_iterations=epochs, mixed_precision=False,
        optimizer={"algorithm": "sgd", "learning_rate": 0.01, "momentum": 0.9},
    )
    config["data"]["languages"] = ["es", "it"]
    config["preprocessing"] = {
        "feature_type": "FILTERBANKS", "window": {"frame_duration": 25, "frame_stride": 10}, "resample": 16000, "num_filters": 40,
    }
    return config


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train-cli")
    build_cv_corpus(str(root / "cv"), (("train", 4), ("dev", 2), ("test", 1)))
    (root / "table.csv").write_text(mini_allophoible_csv(), encoding="utf-8")
    return root


def _arguments(workdir, save_path, epochs, *extra):
    return [
        "train", str(workdir / "cv"), "-j", json.dumps(_config(epochs)), "-a", str(workdir / "table.csv"),
        "-s", str(save_path), "-d", "--cpu", *extra,
    ]


def train_both(jax_arguments, port_arguments):
    """Runs the JAX CLI with ``jax_arguments`` and then the port CLI with
    ``port_arguments``, the port from JAX's initial weights."""
    initial = {}
    original = JaxEstimator.from_config.__func__

    def capture(cls, *args, **kwargs):
        estimator = original(cls, *args, **kwargs)
        initial["variables"] = jax.tree_util.tree_map(np.asarray, estimator.variables)
        return estimator

    port_original = Estimator.from_config.__func__

    def carried(cls, *args, **kwargs):
        estimator = port_original(cls, *args, **kwargs)
        load_jax_variables(estimator.model, initial["variables"])
        return estimator

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(JaxEstimator, "from_config", classmethod(capture))
        jax_cli.main([*jax_arguments, "--no-progress"])
        patch.setattr(Estimator, "from_config", classmethod(carried))
        cli.main([*port_arguments, "--no-progress"])


def assert_parameters_match(port_path, jax_path, share=PARAMETER_SHARE):
    """Every saved parameter within ``share`` of its leaf's largest value
    (ZERO_FLOOR of the largest of all leaves)."""
    ours = dict(jax.tree_util.tree_flatten_with_path(load_checkpoint(str(port_path)).variables["params"])[0])
    theirs = dict(jax.tree_util.tree_flatten_with_path(jax_checkpoint.load_checkpoint(str(jax_path)).variables["params"])[0])
    assert ours.keys() == theirs.keys()
    largest = max(np.abs(np.asarray(value)).max() for value in theirs.values())
    for key, value in theirs.items():
        value = np.asarray(value)
        atol = max(share * np.abs(value).max(), ZERO_FLOOR * largest)
        np.testing.assert_allclose(ours[key], value, atol=atol, rtol=0, err_msg=jax.tree_util.keystr(key))


@pytest.fixture(scope="module")
def runs(workdir):
    """The JAX CLI's and the port CLI's checkpoint directories, both trained
    from JAX's initial weights."""
    train_both(_arguments(workdir, workdir / "jax", 2), _arguments(workdir, workdir / "port", 2))
    return workdir / "jax", workdir / "port"


def test_checkpoint_files_and_positions_match_jax(runs):
    jax_directory, port_directory = runs
    names = sorted(os.listdir(jax_directory))
    assert names == sorted(os.listdir(port_directory)) == ["best.ckpt", "epoch-1.ckpt", "epoch-2.ckpt"]
    for name in names:
        ours, theirs = load_checkpoint(str(port_directory / name)), jax_checkpoint.load_checkpoint(str(jax_directory / name))
        assert ours.epoch.to_dict() == theirs.epoch.to_dict(), name
        assert ours.optimizer_state and ours.phonetic_indexer_state.to_dict() == theirs.phonetic_indexer_state.to_dict()


def test_statistics_match_jax(runs):
    jax_directory, port_directory = runs
    ours = load_checkpoint(str(port_directory / "epoch-2.ckpt")).history
    theirs = jax_checkpoint.load_checkpoint(str(jax_directory / "epoch-2.ckpt")).history
    assert len(ours) == len(theirs) == 2
    for entry, expected in zip(ours, theirs):
        assert (entry["epoch"], entry["global_step"], entry["batch_count"]) == (expected["epoch"], expected["global_step"], expected["batch_count"])
        for key in ("train_loss", "validation_loss"):
            np.testing.assert_allclose(entry[key], expected[key], rtol=LOSS_RTOL, err_msg=key)
        for losses in ("classifier_losses", "validation_classifier_losses"):
            assert entry[losses].keys() == expected[losses].keys()
            for name, value in expected[losses].items():
                np.testing.assert_allclose(entry[losses][name], value, rtol=LOSS_RTOL, err_msg=f"{losses} {name}")


@pytest.mark.parametrize("name", ["epoch-1.ckpt", "epoch-2.ckpt", "best.ckpt"])
def test_saved_parameters_match_jax(runs, name):
    jax_directory, port_directory = runs
    assert_parameters_match(port_directory / name, jax_directory / name)


def test_raw_sample_training_matches_jax(workdir):
    """The same run on raw 16 kHz samples, one frame a sample, for one epoch:
    the saved parameters within RAW_PARAMETER_SHARE, the limit JAX's own
    float32 distance from float64 sets."""
    config = _config(1)
    config["preprocessing"] = {"feature_type": "RAW", "resample": 16000}
    arguments = ["train", str(workdir / "cv"), "-j", json.dumps(config), "-a", str(workdir / "table.csv"), "-d", "--cpu"]
    train_both([*arguments, "-s", str(workdir / "raw-jax")], [*arguments, "-s", str(workdir / "raw-port")])
    assert_parameters_match(workdir / "raw-port" / "epoch-1.ckpt", workdir / "raw-jax" / "epoch-1.ckpt", RAW_PARAMETER_SHARE)


def test_sigterm_writes_the_interrupted_checkpoint_and_restore_resumes_it(workdir, tmp_path, caplog):
    epochs = 3
    interrupted_directory = tmp_path / "interrupted"
    process = subprocess.Popen(
        [sys.executable, "-m", "allophant_tpu_torch.cli.run", *_arguments(workdir, interrupted_directory, epochs, "-w", "2")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT),
        # One thread a process: the test suite runs beside other workers.
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    lines = []
    try:
        for line in process.stdout:
            lines.append(line)
            if len([entry for entry in lines if STATISTICS_LINE.match(entry)]) == 1 and STATISTICS_LINE.match(line):
                process.send_signal(signal.SIGTERM)
        code = process.wait(timeout=120)
    finally:
        if process.poll() is None:
            process.kill()
    assert code == 0, "".join(lines)
    assert any(line.startswith("Training interrupted; state saved to") for line in lines)
    interrupted_path = interrupted_directory / "interrupted.ckpt"
    interrupted = load_checkpoint(str(interrupted_path))
    assert interrupted.optimizer_state and 0 < interrupted.epoch.step
    assert interrupted.epoch.epoch < epochs

    with caplog.at_level("INFO", logger="allophant_tpu_torch"):
        cli.main([*_arguments(workdir, interrupted_directory, epochs), "--restore", "--no-progress"])
    assert f"Restoring from {interrupted_path}" in caplog.text
    uninterrupted_directory = tmp_path / "uninterrupted"
    cli.main([*_arguments(workdir, uninterrupted_directory, epochs), "--no-progress"])
    resumed = load_checkpoint(str(interrupted_directory / f"epoch-{epochs}.ckpt"))
    expected = load_checkpoint(str(uninterrupted_directory / f"epoch-{epochs}.ckpt"))
    assert resumed.epoch.to_dict() == expected.epoch.to_dict()
    ours = dict(jax.tree_util.tree_flatten_with_path(resumed.variables["params"])[0])
    for key, value in jax.tree_util.tree_flatten_with_path(expected.variables["params"])[0]:
        np.testing.assert_array_equal(ours[key], value, err_msg=jax.tree_util.keystr(key))


def test_restore_prefers_the_newer_of_interrupted_and_best(tmp_path):
    best, interrupted = tmp_path / "best.ckpt", tmp_path / "interrupted.ckpt"
    assert cli._interrupted_checkpoint_path(str(tmp_path)) == str(interrupted)
    assert cli._interrupted_checkpoint_path(str(tmp_path / "model.ckpt")) == str(tmp_path / "model.ckpt.interrupted")
    assert cli._prefer_interrupted_checkpoint(str(best), str(tmp_path)) == str(best)
    interrupted.write_bytes(b"")
    assert cli._prefer_interrupted_checkpoint(str(best), str(tmp_path)) == str(interrupted)
    best.write_bytes(b"")
    os.utime(interrupted, (1_000, 1_000))
    os.utime(best, (2_000, 2_000))
    assert cli._prefer_interrupted_checkpoint(str(best), str(tmp_path)) == str(best)
    os.utime(interrupted, (3_000, 3_000))
    assert cli._prefer_interrupted_checkpoint(str(best), str(tmp_path)) == str(interrupted)


class _Restored(Exception):
    pass


def test_training_into_an_orbax_directory_restores_the_newer_weights(workdir, runs, tmp_path, caplog):
    """``train --restore -s DIR`` where DIR is an Orbax checkpoint (the port
    run's epoch-1 checkpoint, saved as one): without ``-d`` it is refused
    before the corpus is read, since the best model would replace the
    directory; with it the run resumes from the Orbax weights and writes
    epoch 2 and best.ckpt beside them, equal to the uninterrupted run's; the
    next ``--restore`` takes that best.ckpt, not the Orbax weights."""
    _jax_directory, port_directory = runs
    directory = tmp_path / "orbax"
    save_orbax(load_checkpoint(str(port_directory / "epoch-1.ckpt")), str(directory))
    arguments = [*_arguments(workdir, directory, 2), "--restore", "--no-progress"]
    with pytest.raises(ValueError, match="Orbax checkpoint directory: train into it with --save-all"):
        cli.main([argument for argument in arguments if argument != "-d"])
    with caplog.at_level("INFO", logger="allophant_tpu_torch"):
        cli.main(arguments)
    assert f"Restoring from {directory}" in caplog.messages
    assert {"best.ckpt", "epoch-2.ckpt"} <= set(os.listdir(directory))
    expected = load_checkpoint(str(port_directory / "epoch-2.ckpt"))
    for name in ("epoch-2.ckpt", "best.ckpt"):
        resumed = load_checkpoint(str(directory / name))
        assert resumed.epoch.to_dict() == expected.epoch.to_dict(), name
        ours = dict(jax.tree_util.tree_flatten_with_path(resumed.variables["params"])[0])
        for key, value in jax.tree_util.tree_flatten_with_path(expected.variables["params"])[0]:
            np.testing.assert_array_equal(ours[key], value, err_msg=f"{name} {jax.tree_util.keystr(key)}")

    restored = []

    def record(path):
        restored.append((path, load_checkpoint(path)))
        raise _Restored

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(checkpoint_module, "load_checkpoint", record)
        with pytest.raises(_Restored):
            cli.main(arguments)
    ((path, checkpoint),) = restored
    assert path == str(directory / "best.ckpt")
    assert checkpoint.epoch.to_dict() == expected.epoch.to_dict()


def test_train_runs_on_the_card_unless_asked_for_the_cpu(workdir, tmp_path, monkeypatch):
    arguments = [argument for argument in _arguments(workdir, tmp_path / "x", 1) if argument != "--cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        cli.main([*arguments, "--no-progress"])


def test_precomputed_features_are_not_ported(workdir, tmp_path):
    """Precomputed features are ported (tests/test_torch_cli_data.py trains
    from them); ``-f`` with a directory that holds no store raises before
    any step, as the JAX CLI does."""
    for main in (cli.main, jax_cli.main):
        with pytest.raises(FileNotFoundError, match="meta.json"):
            main([*_arguments(workdir, tmp_path / "x", 1), "--no-progress", "-f", str(tmp_path)])
