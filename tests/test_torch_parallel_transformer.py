"""Tensor parallelism of the port's transformer acoustic model and of the
projection head's attention classifiers (``models/transformer.py``,
``models/projection.py``, ``parallel/sharding.py``), on the CPU: the mini
transformer of tests/test_torch_transformer.py (d_model 32, 2 heads, FFN 64,
2 layers, 40 filterbanks) with an attention classifier of 2 heads on its
composed phoneme head, float32.

One spawned group of 2 gloo ranks (``python -m allophant_tpu_torch.parallel.dryrun
--checks``, a FileStore rendezvous) takes a tp = 2 step of it, once with
dropout off and once with every dropout on (the transformer's attention,
residual and FFN dropout, the heads' tap and the head attention's output
dropout). Each is held to one device's step of the same weights and seed
within the tensor-parallel steps' limits (tests/test_torch_parallel.py):
metrics 1e-5 relative, gradients and Adam moments within 1e-5 of each leaf's
largest, or 1e-6 of the largest of all leaves for a leaf that is zero in
exact arithmetic (the head attention's key bias: softmax ignores a per-row
shift). The ranks' shards, loaded from the one-device state and gathered
back, equal it bit for bit (``shard_state`` / ``gather_state``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from allophant_tpu_torch.parallel import dryrun, sharding

from torch_parity import MINI_TRANSFORMER_FEATURES as FEATURES
from torch_parity import mini_transformer_inputs, shared_across_workers

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = Path(__file__).resolve().parent.parent
METRIC_RTOL, LEAF_SHARE, ZERO_FLOOR = 1e-5, 1e-5, 1e-6


def mini_transformer(mesh=None, dropout: float = 0.0):
    """(nn config, float32 model) of ``mini_transformer_inputs`` on the CPU."""
    return dryrun.config_model("cpu", mesh, mini_transformer_inputs(dropout))


def _microbatches(model) -> dict:
    """Two microbatches of 3 rows of up to 24 frames, 4 labels a head."""
    rng = np.random.default_rng(5)
    arrays = {
        "audio": rng.standard_normal((2, 3, 24, FEATURES)).astype(np.float32),
        "lengths": np.array([[24, 13, 9], [20, 24, 6]], dtype=np.int32),
        "language_ids": np.array([[0, 1, 0], [1, 1, 0]], dtype=np.int32),
    }
    for node in model.plan.nodes:
        arrays[f"labels_{node.name}"] = rng.integers(1, node.output_size, (2, 3, 4)).astype(np.int32)
        arrays[f"label_lengths_{node.name}"] = np.array([[4, 3, 2], [4, 4, 1]], dtype=np.int32)
    return arrays


def _results(workdir):
    """Each dropout's (tp = 2 result, one-device result)."""
    _config, model = mini_transformer()
    state = {name: value.detach().numpy() for name, value in model.state_dict().items()}
    microbatches = _microbatches(model)
    jobs = [
        {
            "name": f"dropout_{rate}", "kind": "config_step", "data_parallel": 1, "model_parallel": 2,
            "model": mini_transformer_inputs(rate), "microbatches": microbatches, "state": state,
            "dropout_seed": 3 if rate else None,
        }
        for rate in (0.0, 0.1)
    ]
    inputs, outputs = str(workdir / "inputs.pt"), str(workdir / "outputs.pt")
    torch.save({"state": None, "jobs": jobs}, inputs)
    # The group is spawned from a process of its own: the test process starts
    # no process pool and no child that could read its standard input.
    result = subprocess.run(
        [sys.executable, "-m", "allophant_tpu_torch.parallel.dryrun", "--checks", inputs, outputs, "2"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, cwd=str(ROOT), timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert result.returncode == 0, result.stdout[-4000:] + result.stderr[-4000:]
    sharded = torch.load(outputs, weights_only=False)
    single = {
        job["name"]: dryrun.config_step(None, "cpu", job["model"], microbatches, state, job["dropout_seed"]) for job in jobs
    }
    return {name: (sharded[name], single[name]) for name in sharded}, state


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return shared_across_workers(tmp_path_factory, "port-parallel-transformer", _results)


def test_mini_transformer_shards_every_tp_leaf():
    """The model under test holds every kind of leaf the new rules shard."""
    _config, model = mini_transformer()
    sharded = {name for name, _ in model.named_parameters() if sharding.param_spec(name).sharded}
    parents = {name.split(".")[-2] for name in sharded}
    assert parents == {"qkv_proj", "out_proj", "linear1", "linear2", "input_projection", "q_proj", "k_proj", "v_proj"}
    assert any(name.startswith("projection.classifiers.phoneme.") for name in sharded)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tp2_step_matches_one_device(results, rate):
    """The tp = 2 step's metrics, gradients and Adam moments equal the
    one-device step's, at dropout 0 and with every dropout on (the ranks
    draw one device's masks: the attention kernels key theirs by the global
    head, the FFN's is cut from the whole)."""
    ((metrics, tensors), (expected_metrics, expected)) = results[0][f"dropout_{rate}"]
    for key, value in expected_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=METRIC_RTOL, err_msg=key)
    for kind in ("grads", "exp_avg", "exp_avg_sq"):
        assert set(tensors[kind]) == set(expected[kind])
        floor = ZERO_FLOOR * max(np.abs(value).max() for value in expected[kind].values())
        for name, value in expected[kind].items():
            atol = max(LEAF_SHARE * np.abs(value).max(), floor)
            np.testing.assert_allclose(tensors[kind][name], value, rtol=0, atol=atol, err_msg=f"{kind} {name}")


def test_shards_gather_back_to_the_one_device_state(results):
    """``shard_state`` cut each rank's leaves from the one-device state and
    ``gather_state`` put them back together bit for bit, the fused QKV's and
    the head attention's included."""
    per_dropout, state = results
    ((_metrics, tensors), _single) = per_dropout["dropout_0.0"]
    assert set(tensors["initial"]) <= set(state)
    for name, value in tensors["initial"].items():
        np.testing.assert_array_equal(value, state[name], err_msg=name)


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_shard_state_cuts_the_new_leaves_as_jax_does(model_parallel):
    """Without processes: every sharded leaf of the mini model is cut into
    ``model_parallel`` pieces that lay side by side (each of the fused QKV's
    three blocks by heads) give back the whole."""
    _config, model = mini_transformer()
    state = {name: value.detach() for name, value in model.named_parameters()}
    shards = [sharding.shard_state(state, rank, model_parallel) for rank in range(model_parallel)]
    for name, whole in state.items():
        spec = sharding.param_spec(name)
        pieces = [shard[name] for shard in shards]
        if not spec.sharded:
            assert all(torch.equal(piece, whole) for piece in pieces), name
            continue
        blocks = [piece.reshape(*piece.shape[: spec.dim], spec.parts, -1, *piece.shape[spec.dim + 1 :]) for piece in pieces]
        joined = torch.cat(blocks, dim=spec.dim + 1).reshape(whole.shape)
        assert torch.equal(joined, whole), name
