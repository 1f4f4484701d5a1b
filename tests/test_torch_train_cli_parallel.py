"""The port's ``train`` over two ranks on the CPU (``--cpu`` under
``torchrun``'s environment variables: gloo, one process a rank) against one
process, on the Common Voice corpus of ``tests/fixtures.py:build_cv_corpus``:
the JAX fixtures' mini transformer on 40 filterbanks, float32, dropout 0,
SGD with momentum. Each rank loads only its rows of every batch
(``process_shard``); a batch whose rows do not divide gets a zero-weight
filler row. The two-rank run's statistics and saved parameters equal the
one-process run's, with utterance batches and with frame-budget batches of
odd row counts. Then preemption: SIGTERM to rank 1 alone stops both ranks
after the same step, rank 0 writes ``interrupted.ckpt`` once, and
``--restore`` on two ranks resumes it to the uninterrupted two-rank run's
parameters. Last, the launch that spawns one rank a device
(``train_on_devices``, which a plain ``train`` runs over several visible
GPUs) over two CPU devices: SIGTERM to the launching process reaches both
ranks, which stop after the same step."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from allophant_tpu.training import checkpoint as jax_checkpoint
from allophant_tpu_torch.training.checkpoint import load_checkpoint

from fixtures import build_cv_corpus, mini_allophoible_csv, mini_config_dict
from torch_parity import shared_across_workers

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = Path(__file__).resolve().parent.parent
# Losses: f32 sums over the ranks' rows in another order, 1e-5 relative;
# parameters within 1e-5 of each leaf's largest value, or 1e-6 of the
# largest of all leaves for a leaf that stays zero in exact arithmetic.
LOSS_RTOL, PARAMETER_SHARE, ZERO_FLOOR = 1e-5, 1e-5, 1e-6
STATISTICS_LINE = re.compile(r"epoch \d+ step \d+:")
EPOCHS = 3
# Frame budget: 6,400 samples a batch over clips of 1,600-2,080 samples
# gives batches of 3 rows and others (checked below).
FRAME_BUDGET = 6_400


def _config(frames: bool) -> dict:
    config = mini_config_dict()
    config["nn"].update(
        batch_size=FRAME_BUDGET if frames else 4, maximum_iterations=EPOCHS, mixed_precision=False,
        optimizer={"algorithm": "sgd", "learning_rate": 0.01, "momentum": 0.9},
    )
    if frames:
        config["nn"]["batching_mode"] = "frames"
    config["data"]["languages"] = ["es", "it"]
    config["preprocessing"] = {
        "feature_type": "FILTERBANKS", "window": {"frame_duration": 25, "frame_stride": 10}, "resample": 16000, "num_filters": 40,
    }
    return config


def _corpus(root):
    build_cv_corpus(str(root / "cv"), (("train", 4), ("dev", 2), ("test", 1)))
    (root / "table.csv").write_text(mini_allophoible_csv(), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("train-cli-parallel"))


def _arguments(workdir, save_path, frames, *extra, progress=False):
    """The command line; with ``progress`` the statistics lines are printed."""
    return [
        "train", str(workdir / "cv"), "-j", json.dumps(_config(frames)), "-a", str(workdir / "table.csv"),
        "-s", str(save_path), "-d", "--cpu", *([] if progress else ["--no-progress"]), *extra,
    ]


def _read_until_statistics(process, on_statistics, timeout=180):
    """``process``'s output lines up to its first statistics line, after
    which ``on_statistics()`` runs; the process is killed if that line is
    not out within ``timeout`` seconds."""
    timer = threading.Timer(timeout, process.kill)
    timer.start()
    lines = []
    try:
        for line in process.stdout:
            lines.append(line)
            if STATISTICS_LINE.match(line):
                on_statistics()
                break
    finally:
        timer.cancel()
    return lines


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _start(arguments, environment):
    return subprocess.Popen(
        [sys.executable, "-m", "allophant_tpu_torch.cli.run", *arguments],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", **environment},
    )


def _start_ranks(arguments, world_size: int = 2):
    """``world_size`` ``train`` processes under torchrun's variables."""
    port = _free_port()
    return [
        _start(
            arguments,
            {
                "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world_size),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            },
        )
        for rank in range(world_size)
    ]


def _finish(processes, timeout=180):
    outputs = []
    try:
        for process in processes:
            output, _ = process.communicate(timeout=timeout)
            outputs.append(output)
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
    for process, output in zip(processes, outputs):
        assert process.returncode == 0, output
    return outputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{frames: (one process's directory, two ranks' directory)}: both
    batching modes, all six processes started at once, once in the session
    (``shared_across_workers``), on their own copy of the corpus."""
    return shared_across_workers(tmp_path_factory, "train-cli-parallel-runs", lambda directory: _runs(_corpus(directory)))


def _runs(workdir):
    started = []
    for frames in (False, True):
        started += _start_ranks(_arguments(workdir, workdir / f"ranks-{frames}", frames))
        started.append(_start(_arguments(workdir, workdir / f"one-{frames}", frames), {}))
    _finish(started)
    return {frames: (workdir / f"one-{frames}", workdir / f"ranks-{frames}") for frames in (False, True)}


def _params(path):
    return dict(jax.tree_util.tree_flatten_with_path(load_checkpoint(str(path)).variables["params"])[0])


def test_frame_budget_batches_do_not_divide_over_two_ranks(runs):
    """The frame-budget run's batches, as its Batcher draws them (seed 7 +
    epoch over the clips' sample counts), include odd row counts."""
    from allophant_tpu_torch.data.batching import MaxFrameBatchSampler, RandomSampler
    from allophant_tpu_torch.training.run import FRAME_LENGTH_MULTIPLE

    lengths = np.array([1600, 1760, 1920, 2080] * 2)
    rows = []
    for epoch in range(EPOCHS):
        sampler = RandomSampler(len(lengths), np.random.default_rng(7 + epoch))
        rows.extend(len(batch) for batch in MaxFrameBatchSampler(sampler, FRAME_BUDGET, lengths, FRAME_LENGTH_MULTIPLE))
    one, _ranks = runs[True]
    history = load_checkpoint(str(one / f"epoch-{EPOCHS}.ckpt")).history
    assert sum(entry["batch_count"] for entry in history) == len(rows)
    assert any(count % 2 for count in rows), rows


@pytest.mark.parametrize("frames", [False, True], ids=["utterances", "frames"])
def test_two_ranks_equal_one_process(runs, frames):
    one, ranks = runs[frames]
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(ranks))
    assert "best.ckpt" in names and f"epoch-{EPOCHS}.ckpt" in names
    ours = load_checkpoint(str(ranks / f"epoch-{EPOCHS}.ckpt"))
    expected = load_checkpoint(str(one / f"epoch-{EPOCHS}.ckpt"))
    assert ours.epoch.to_dict() == expected.epoch.to_dict()
    assert len(ours.history) == len(expected.history) == EPOCHS
    for entry, reference in zip(ours.history, expected.history):
        assert (entry["global_step"], entry["batch_count"], entry["utterance_count"]) == (
            reference["global_step"], reference["batch_count"], reference["utterance_count"]
        )
        for key in ("train_loss", "validation_loss"):
            np.testing.assert_allclose(entry[key], reference[key], rtol=LOSS_RTOL, err_msg=key)
        for name, value in reference["validation_classifier_losses"].items():
            np.testing.assert_allclose(entry["validation_classifier_losses"][name], value, rtol=LOSS_RTOL, err_msg=name)
    # Rank 0's checkpoint is the full one-device checkpoint, which JAX reads.
    theirs = jax_checkpoint.load_checkpoint(str(ranks / f"epoch-{EPOCHS}.ckpt"))
    for key, value in jax.tree_util.tree_flatten_with_path(theirs.variables["params"])[0]:
        np.testing.assert_array_equal(_params(ranks / f"epoch-{EPOCHS}.ckpt")[key], value)
    for name in names:
        got, want = _params(ranks / name), _params(one / name)
        assert got.keys() == want.keys()
        largest = max(np.abs(np.asarray(value)).max() for value in want.values())
        for key, value in want.items():
            value = np.asarray(value)
            atol = max(PARAMETER_SHARE * np.abs(value).max(), ZERO_FLOOR * largest)
            np.testing.assert_allclose(got[key], value, atol=atol, rtol=0, err_msg=f"{name} {jax.tree_util.keystr(key)}")


def test_sigterm_to_one_rank_stops_both_and_restore_resumes(runs, workdir, tmp_path):
    directory = tmp_path / "interrupted"
    processes = _start_ranks(_arguments(workdir, directory, False, progress=True))
    try:
        lines = _read_until_statistics(processes[0], lambda: processes[1].send_signal(signal.SIGTERM))
        rest, _ = processes[0].communicate(timeout=180)
        lines.append(rest)
        other, _ = processes[1].communicate(timeout=180)
    finally:
        for process in processes:
            if process.poll() is None:
                process.kill()
    output = "".join(lines)
    assert processes[0].returncode == processes[1].returncode == 0, output + other
    assert output.count("Training interrupted; state saved to") == 1
    assert "Training interrupted" not in other and not STATISTICS_LINE.search(other)
    assert sorted(os.listdir(directory)) == ["best.ckpt", "epoch-1.ckpt", "interrupted.ckpt"]
    interrupted = load_checkpoint(str(directory / "interrupted.ckpt"))
    assert interrupted.optimizer_state and interrupted.epoch.epoch == 1 and 0 < interrupted.epoch.step

    _finish(_start_ranks(_arguments(workdir, directory, False, "--restore")))
    resumed = load_checkpoint(str(directory / f"epoch-{EPOCHS}.ckpt"))
    _one, uninterrupted = runs[False]
    expected = load_checkpoint(str(uninterrupted / f"epoch-{EPOCHS}.ckpt"))
    assert resumed.epoch.to_dict() == expected.epoch.to_dict()
    got = _params(directory / f"epoch-{EPOCHS}.ckpt")
    for key, value in _params(uninterrupted / f"epoch-{EPOCHS}.ckpt").items():
        np.testing.assert_array_equal(got[key], value, err_msg=jax.tree_util.keystr(key))


def test_sigterm_to_the_launcher_stops_every_spawned_rank(workdir, tmp_path):
    directory = tmp_path / "spawned"
    script = "import sys; from allophant_tpu_torch.cli.run import train_on_devices; train_on_devices(sys.argv[1:], ['cpu', 'cpu'])"
    launcher = subprocess.Popen(
        [sys.executable, "-c", script, *_arguments(workdir, directory, False, progress=True)],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    try:
        lines = _read_until_statistics(launcher, lambda: launcher.send_signal(signal.SIGTERM))
        rest, _ = launcher.communicate(timeout=180)
        lines.append(rest)
    finally:
        if launcher.poll() is None:
            # A second SIGTERM, forwarded, ends the ranks the hard way.
            launcher.send_signal(signal.SIGTERM)
            launcher.send_signal(signal.SIGTERM)
            launcher.kill()
    output = "".join(lines)
    # The ranks stop together (a rank that ran on would wait for the other in
    # its next all-reduce, and the launcher would not end well).
    assert launcher.returncode == 0, output
    assert output.count("Received SIGTERM") == 2, output
    assert output.count("Training interrupted; state saved to") == 1
    assert sorted(os.listdir(directory)) == ["best.ckpt", "epoch-1.ckpt", "interrupted.ckpt"]
    interrupted = load_checkpoint(str(directory / "interrupted.ckpt"))
    assert interrupted.optimizer_state and interrupted.epoch.epoch == 1 and 0 < interrupted.epoch.step
