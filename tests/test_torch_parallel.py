"""The port's multi-device layer (``allophant_tpu_torch/parallel/``) against the
JAX package's (``allophant_tpu/parallel/``, ``tests/test_parallel.py``), on the
CPU: the sharding rules on the port's names, the mesh's shape and layout,
``process_local_slice``; then one spawned group of 8 gloo processes
(``python -m allophant_tpu_torch.parallel.dryrun --checks``, a FileStore
rendezvous) runs every multi-process check once:

- float32 steps of the tiny dry-run flagship (width 64, 2 layers of 2 heads,
  FFN 128) from JAX's initial weights, dropout off, at dp = 2, dp = 4 and
  dp 4 x tp 2, each held to JAX's step on its virtual 8-device CPU mesh:
  metrics at 1e-5 (grad_norm 3e-5), gradients and Adam moments within 1e-3
  (second moment 2e-3) of each leaf's largest;
- the dry run as ``__graft_entry__`` configures it (tap dropout 0.2 on),
  against JAX's golden bands;
- the loop's dropout generators across data and model ranks, a tp = 2 step
  with dropout on against the one-device step; remat under tensor
  parallelism;
- ``Estimator.use_data_parallel``'s predictions against one process.

JAX's own dp 4 x tp 2 step doubles one gradient, the positional conv's
kernel, against its one-device and dp-only steps (its SPMD partitioning of
the grouped convolution's weight gradient); the port's steps equal the
one-device step there. The dp 4 x tp 2 test holds every other leaf to JAX's
mesh step and pins that factor of 2."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec

from allophant_tpu.demo import build_flagship as jax_build_flagship
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.parallel import mesh as jax_mesh
from allophant_tpu.parallel.sharding import param_spec as jax_param_spec
from allophant_tpu.parallel.sharding import tree_param_shardings
from allophant_tpu.training import train_step as jax_train_step
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.parallel import dryrun, mesh, sharding
from allophant_tpu_torch.weights import jax_params_from_state, state_dict_from_jax
from torch_parity import mini_transformer_inputs, numpy_tree, shared_across_workers

ROOT = Path(__file__).resolve().parent.parent
WORLD = 8
METRIC_RTOL, GRAD_NORM_RTOL = 1e-5, 3e-5
GRAD_SHARE, SECOND_MOMENT_SHARE, ZERO_FLOOR = 1e-3, 2e-3, 1e-6
LOG_PROB_ATOL = 1e-5
POSITIONAL_CONV = "['acoustic_model']['encoder']['pos_conv_embed']['conv']['kernel']"
# The remat check's encoder: the dry run's, with its dropout sites on.
DROPOUT_ARCHITECTURE = dataclasses.replace(
    dryrun.TINY_ARCHITECTURE, hidden_dropout=0.1, activation_dropout=0.1, attention_dropout=0.1
)


def _flatten(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leaves_close(got, expected, share, label, skip=()):
    """Per leaf of two flat dicts: within ``share`` of the leaf's largest
    magnitude, or ZERO_FLOOR of the largest of all leaves."""
    assert set(got) == set(expected), label
    floor = ZERO_FLOOR * max(np.abs(value).max() for value in expected.values())
    for key, value in expected.items():
        if key in skip:
            continue
        atol = max(share * np.abs(value).max(), floor)
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=f"{label} {key}")


@pytest.fixture(scope="module")
def jax_flagship():
    """(config, built, numpy variables) of JAX's dry-run flagship, with the
    dry run's initial weights (``PRNGKey(0)``)."""
    tiny = JaxArchitecture(**dataclasses.asdict(dryrun.TINY_ARCHITECTURE))
    config, _indexer, built = jax_build_flagship(wav2vec2_architecture=tiny)
    variables = numpy_tree(built.init(jax.random.PRNGKey(0), sample_batch_size=1, sample_length=640))
    return config, built, variables


def _microbatches(data_parallel: int):
    _config, template = dryrun.tiny_flagship("cpu")
    return dryrun.dryrun_microbatches(template, data_parallel)


@pytest.fixture(scope="module")
def jax_steps(jax_flagship, tmp_path_factory):
    """``_jax_step`` of each mesh shape and tap dropout, computed once in the
    session (``shared_across_workers``)."""

    def step(data_parallel: int, model_parallel: int, tap_dropout: float = 0.0):
        key = (data_parallel, model_parallel, tap_dropout)
        return shared_across_workers(
            tmp_path_factory, "jax-step-{}-{}-{}".format(*key), lambda _directory: _jax_step(jax_flagship, *key)
        )

    return step


def _jax_step(jax_flagship, data_parallel: int, model_parallel: int, tap_dropout: float = 0.0):
    """JAX's train step on a data x model mesh of its virtual CPU devices (the
    dry run's shardings): (metrics, clipped gradients, Adam mu, Adam nu) as
    flat numpy dicts."""
    config, built, variables = jax_flagship
    model = built.model.clone(plan=dataclasses.replace(built.model.plan, acoustic_model_dropout=tap_dropout))
    optimizer = jax_train_step.create_optimizer(config.nn, built.d_model)
    loss_plan = jax_train_step.build_loss_plan(config.nn, has_allophone=True)
    step = jax_train_step.make_train_step(model, optimizer, loss_plan, jax_train_step.build_freeze_plan(config.nn.acoustic_model))
    params = variables["params"]
    other = {key: value for key, value in variables.items() if key != "params"}
    grid = jax_mesh.create_mesh(jax.devices()[: data_parallel * model_parallel], data_parallel, model_parallel)
    with jax.set_mesh(grid):
        shardings = tree_param_shardings(params, grid)
        placed = jax.tree_util.tree_map(jax.device_put, params, shardings)
        batch = {
            key: jax.device_put(value, NamedSharding(grid, PartitionSpec(None, jax_mesh.DATA_AXIS)))
            for key, value in _microbatches(data_parallel).items()
        }
        _params, opt_state, metrics = jax.jit(step, in_shardings=(shardings, None, None, None, None))(
            placed, optimizer.init(placed), other, batch, jax.random.key(1, impl="rbg")
        )
    (adam,) = [
        state for state in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda node: isinstance(node, optax.ScaleByAdamState))
        if isinstance(state, optax.ScaleByAdamState)
    ]
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    return {key: float(value) for key, value in metrics.items()}, {key: value / (1 - 0.9) for key, value in mu.items()}, mu, nu


@pytest.fixture(scope="module")
def port_results(jax_flagship, tmp_path_factory):
    """Every multi-process job, run once in the session by one spawned group
    of 8 ranks (``shared_across_workers``)."""
    return shared_across_workers(tmp_path_factory, "port-parallel", lambda directory: _port_results(jax_flagship, directory))


def _port_results(jax_flagship, workdir):
    _config, _built, variables = jax_flagship
    state = {name: value.numpy() for name, value in state_dict_from_jax(variables, 2).items()}
    batch = dryrun.prediction_batch()
    jobs = [
        {"name": "dp2", "kind": "step", "data_parallel": 2, "model_parallel": 1, "microbatches": _microbatches(2)},
        {"name": "dp4", "kind": "step", "data_parallel": 4, "model_parallel": 1, "microbatches": _microbatches(4)},
        {"name": "dp4xtp2", "kind": "step", "data_parallel": 4, "model_parallel": 2, "microbatches": _microbatches(4)},
        {"name": "dryrun", "kind": "dryrun", "data_parallel": 4, "model_parallel": 2},
        {"name": "draws", "kind": "draws", "data_parallel": 4, "model_parallel": 2},
        *[
            {
                "name": f"tp2_remat_{remat}", "kind": "step", "data_parallel": 2, "model_parallel": 2,
                "microbatches": _microbatches(2), "dropout_seed": 3, "architecture": DROPOUT_ARCHITECTURE, "remat": remat,
            }
            for remat in (False, True)
        ],
        {
            "name": "tp2_dropout", "kind": "step", "data_parallel": 1, "model_parallel": 2,
            "microbatches": _microbatches(1), "dropout_seed": 3, "architecture": DROPOUT_ARCHITECTURE,
        },
        {
            "name": "checkpoint", "kind": "checkpoint", "data_parallel": 2, "model_parallel": 2,
            "path": str(workdir / "sharded.ckpt"), "microbatches": _microbatches(2),
        },
        {"name": "predict_dp4", "kind": "predict", "data_parallel": 4, "model_parallel": 1, "batch": batch},
        {"name": "predict_dp4xtp2", "kind": "predict", "data_parallel": 4, "model_parallel": 2, "batch": batch},
    ]
    inputs, outputs = str(workdir / "inputs.pt"), str(workdir / "outputs.pt")
    torch.save({"state": state, "jobs": jobs}, inputs)
    # The group is spawned from a process of its own: the test process starts
    # no process pool and no child that could read its standard input.
    result = subprocess.run(
        [sys.executable, "-m", "allophant_tpu_torch.parallel.dryrun", "--checks", inputs, outputs, str(WORLD)],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, cwd=str(ROOT), timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert result.returncode == 0, result.stdout[-4000:] + result.stderr[-4000:]
    results = torch.load(outputs, weights_only=False)
    results["checkpoint_path"] = str(workdir / "sharded.ckpt")
    results["one_device_dropout"] = dryrun.sharded_step(
        None, "cpu", _microbatches(1), state, 3, DROPOUT_ARCHITECTURE
    )
    single = dryrun.sharded_predictions(dryrun.serving_flagship("cpu", state=state), batch)
    return results, single


def _port_tree(named):
    return _flatten(jax_params_from_state(named, dryrun.TINY_ARCHITECTURE))


# --- the rules, the mesh and the slice: no processes --------------------------------


def _jax_leaf_names(port_name: str):
    """JAX's (parent, leaf) names of a port parameter: the fused QKV is JAX's
    three projections; torch's ``weight`` is a norm's ``scale`` or a
    kernel."""
    *path, leaf = port_name.split(".")
    parent = path[-1]
    if leaf == "weight":
        leaf = "scale" if any("norm" in part for part in path) else "kernel"
    parents = ("q_proj", "k_proj", "v_proj") if parent == "qkv_proj" else (parent,)
    return [(*path[:-1], name, leaf) for name in parents]


def _port_model(kind: str):
    """The dry run's tiny flagship (a wav2vec2 encoder, the flagship's head)
    or the mini transformer with an attention classifier on its head."""
    if kind == "flagship":
        return dryrun.tiny_flagship("cpu")[1]
    return dryrun.config_model("cpu", None, mini_transformer_inputs())[1]


def test_param_spec_matches_jax_on_the_port_names():
    """On every parameter of the tiny flagship and of the mini transformer
    with a head attention. Sharded leaves: a wav2vec2 layer's q/k/v weight
    and bias, out_proj weight and the FFN's three, in 2 layers; a transformer
    layer's the same with linear1 and linear2, and the head attention's input
    projection, q, k and v (weight and bias) and out_proj weight."""
    for kind, expected_sharded in (("flagship", 2 * 6), ("transformer", 2 * 6 + 9)):
        sharded = 0
        for name, parameter in _port_model(kind).named_parameters():
            spec = sharding.param_spec(name)
            for path in _jax_leaf_names(name):
                expected = tuple(jax_param_spec(path))
                expected += (None,) * (parameter.ndim - len(expected))
                # JAX keeps a dense kernel [in, out], torch a weight [out, in].
                if path[-1] == "kernel" and parameter.ndim == 2:
                    expected = expected[::-1]
                assert spec.partition(parameter.ndim) == expected, (name, path, expected)
            sharded += spec.sharded
            assert spec.parts == (3 if name.endswith(("qkv_proj.weight", "qkv_proj.bias")) else 1) or not spec.sharded
        assert sharded == expected_sharded, kind


def test_transformer_and_head_attention_shard_as_jax():
    """The transformer's fused QKV, out_proj, linear1 and linear2 and the
    projection head attention's input projection, q/k/v and out_proj shard
    as JAX's rules shard them (column-parallel: torch dimension 0;
    row-parallel: dimension 1, the weight only)."""
    column, row = sharding.ParamSpec(0), sharding.ParamSpec(1)
    expected = {
        "acoustic_model.layers.0.qkv_proj.weight": sharding.ParamSpec(0, 3),
        "acoustic_model.layers.0.qkv_proj.bias": sharding.ParamSpec(0, 3),
        "acoustic_model.layers.0.out_proj.weight": row,
        "acoustic_model.layers.0.out_proj.bias": sharding.ParamSpec(),
        "acoustic_model.layers.0.linear1.weight": column,
        "acoustic_model.layers.0.linear1.bias": column,
        "acoustic_model.layers.0.linear2.weight": row,
        "acoustic_model.layers.0.linear2.bias": sharding.ParamSpec(),
        "projection.classifiers.phoneme.input_projection.weight": column,
        "projection.classifiers.phoneme.input_projection.bias": column,
        "projection.classifiers.phoneme.q_proj.weight": column,
        "projection.classifiers.phoneme.v_proj.bias": column,
        "projection.classifiers.phoneme.out_proj.weight": row,
        "projection.classifiers.phoneme.layer_norm.weight": sharding.ParamSpec(),
    }
    for name, spec in expected.items():
        assert sharding.param_spec(name) == spec, name
    assert column.partition(2) == tuple(reversed(jax_param_spec(("layers_0", "linear1", "kernel"))))
    assert jax_param_spec(("layers_0", "linear1", "kernel")) == PartitionSpec(None, jax_mesh.MODEL_AXIS)
    assert jax_param_spec(("phoneme", "input_projection", "bias")) == PartitionSpec(jax_mesh.MODEL_AXIS)


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_fused_qkv_shards_take_each_projections_heads(model_parallel):
    """Rank r's fused QKV shard is JAX's q, k and v kernels' column shards r,
    transposed and stacked; a row-parallel weight's shards are its column
    blocks."""
    rng = np.random.default_rng(model_parallel)
    width = 16
    kernels = [rng.standard_normal((width, width)).astype(np.float32) for _ in range(3)]
    biases = [rng.standard_normal(width).astype(np.float32) for _ in range(3)]
    fused = torch.from_numpy(np.concatenate([kernel.T for kernel in kernels]))
    fused_bias = torch.from_numpy(np.concatenate(biases))
    spec = sharding.param_spec("acoustic_model.encoder.layers.0.attention.qkv_proj.weight")
    columns = width // model_parallel
    for rank in range(model_parallel):
        cut = slice(rank * columns, (rank + 1) * columns)
        shard = sharding.shard_tensor(fused, spec, rank, model_parallel)
        np.testing.assert_array_equal(shard.numpy(), np.concatenate([kernel[:, cut].T for kernel in kernels]))
        bias = sharding.shard_tensor(fused_bias, sharding.param_spec("acoustic_model.encoder.layers.0.attention.qkv_proj.bias"), rank, model_parallel)
        np.testing.assert_array_equal(bias.numpy(), np.concatenate([value[cut] for value in biases]))
    row = sharding.param_spec("acoustic_model.encoder.layers.0.feed_forward.output_dense.weight")
    weight = torch.from_numpy(rng.standard_normal((width, 4 * width)).astype(np.float32))
    pieces = [sharding.shard_tensor(weight, row, rank, model_parallel) for rank in range(model_parallel)]
    assert torch.equal(torch.cat(pieces, dim=1), weight)


def test_mesh_shapes_and_layout_match_jax():
    grid = jax_mesh.create_mesh(jax.devices()[:8], model_parallel=2)
    assert grid.shape[jax_mesh.DATA_AXIS] == 4 and grid.shape[jax_mesh.MODEL_AXIS] == 2
    ids = np.vectorize(lambda device: device.id)(grid.devices)
    for rank in range(8):
        placed = mesh.Mesh(4, 2, tuple(range(8)), rank, None, None, None)
        assert placed.shape == {mesh.DATA_AXIS: 4, mesh.MODEL_AXIS: 2}
        (row,), (column,) = np.nonzero(ids == rank)
        assert (placed.data_rank, placed.model_rank) == (row, column)
        assert placed.model_ranks == tuple(ids[row]) and placed.data_ranks == tuple(ids[:, column])


def test_mismatched_mesh_shapes_raise():
    with pytest.raises(ValueError):
        jax_mesh.create_mesh(jax.devices()[:8], data_parallel=3, model_parallel=2)
    with pytest.raises(ValueError, match="does not match 8 devices"):
        mesh.create_mesh(3, 2, ranks=range(8))
    with pytest.raises(ValueError, match="does not match 1 devices"):
        mesh.create_mesh(1, 2)
    # This process alone holds no rank 1.
    with pytest.raises(ValueError, match="do not exist"):
        mesh.create_mesh(2, 1, ranks=range(2))
    alone = mesh.create_mesh()
    assert (alone.size, alone.group, alone.data_group, alone.model_group) == (1, None, None, None)


def test_process_local_slice():
    alone = mesh.create_mesh()
    assert mesh.process_local_slice(16, alone) == jax_mesh.process_local_slice(16) == slice(0, 16)
    assert mesh.process_local_slice(7, alone) == jax_mesh.process_local_slice(7) == slice(0, 7)
    placed = mesh.Mesh(4, 2, tuple(range(8)), 5, None, None, None)
    assert mesh.process_local_slice(8, placed) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible by 4"):
        mesh.process_local_slice(7, placed)


def test_dropout_stream_zero_is_the_one_device_generator():
    one, zero, other = DropoutRng.from_seed(7, "cpu"), DropoutRng.from_seed(7, "cpu", 0), DropoutRng.from_seed(7, "cpu", 1)
    assert one.kernel_seeds() == zero.kernel_seeds() != other.kernel_seeds()


# --- the spawned group -----------------------------------------------------------


@pytest.mark.parametrize("data_parallel", [2, 4])
def test_data_parallel_steps_match_jax(jax_steps, port_results, data_parallel):
    metrics, tensors = port_results[0][f"dp{data_parallel}"]
    expected, grads, mu, nu = jax_steps(data_parallel, 1)
    for key, value in expected.items():
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(metrics[key], value, rtol=rtol, err_msg=key)
    _assert_leaves_close(_port_tree(tensors["grads"]), grads, GRAD_SHARE, "gradient")
    _assert_leaves_close(_port_tree(tensors["exp_avg"]), mu, GRAD_SHARE, "first moment")
    _assert_leaves_close(_port_tree(tensors["exp_avg_sq"]), nu, SECOND_MOMENT_SHARE, "second moment")


def test_dp4_tp2_step_matches_jax(jax_steps, port_results):
    """The port's dp 4 x tp 2 step equals JAX's dp 4 step (the one-device
    step of that batch) in every metric, gradient and moment, and JAX's
    dp 4 x tp 2 step in every unclipped gradient but the positional conv's
    kernel, which JAX's mesh step doubles."""
    metrics, tensors = port_results[0]["dp4xtp2"]
    expected, grads, mu, nu = jax_steps(4, 1)
    for key, value in expected.items():
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(metrics[key], value, rtol=rtol, err_msg=key)
    port_grads = _port_tree(tensors["grads"])
    _assert_leaves_close(port_grads, grads, GRAD_SHARE, "gradient")
    _assert_leaves_close(_port_tree(tensors["exp_avg"]), mu, GRAD_SHARE, "first moment")
    _assert_leaves_close(_port_tree(tensors["exp_avg_sq"]), nu, SECOND_MOMENT_SHARE, "second moment")

    mesh_metrics, mesh_grads, _mu, _nu = jax_steps(4, 2)
    for key in ("loss_sum", "label_count", "mean_loss"):
        np.testing.assert_allclose(metrics[key], mesh_metrics[key], rtol=METRIC_RTOL, err_msg=key)
    # Clipping divides by each step's own norm: compare the gradients before it.
    unclipped = {key: value * metrics["grad_norm"] for key, value in port_grads.items()}
    jax_unclipped = {key: value * mesh_metrics["grad_norm"] for key, value in mesh_grads.items()}
    _assert_leaves_close(unclipped, jax_unclipped, GRAD_SHARE, "unclipped gradient", skip=(POSITIONAL_CONV,))
    doubled = jax_unclipped[POSITIONAL_CONV]
    np.testing.assert_allclose(doubled, 2 * unclipped[POSITIONAL_CONV], rtol=0, atol=GRAD_SHARE * np.abs(doubled).max())
    corrected = np.sqrt(mesh_metrics["grad_norm"] ** 2 - 0.75 * np.square(doubled).sum())
    np.testing.assert_allclose(metrics["grad_norm"], corrected, rtol=GRAD_NORM_RTOL)


def test_dryrun_as_configured_lands_in_jax_golden_bands(jax_steps, port_results, record_property):
    """Tap dropout on: the port's masks are its own draws, so the dry run is
    held to bands. The loss to JAX's golden band; the gradient norm to the
    band around JAX's golden value with JAX's doubled positional-conv
    gradient halved (the golden value itself is reproduced first)."""
    loss, grad_norm = port_results[0]["dryrun"]
    metrics, grads, _mu, _nu = jax_steps(4, 2, 0.2)
    np.testing.assert_allclose(metrics["mean_loss"], dryrun.GOLDEN_LOSS_8DEV, rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"], dryrun.GOLDEN_GRAD_NORM_8DEV, rtol=1e-4)
    doubled = grads[POSITIONAL_CONV] * metrics["grad_norm"]
    corrected = float(np.sqrt(metrics["grad_norm"] ** 2 - 0.75 * np.square(doubled).sum()))
    record_property("port_loss", loss)
    record_property("port_grad_norm", grad_norm)
    record_property("jax_grad_norm_without_its_doubled_leaf", corrected)
    assert 0.9 * dryrun.GOLDEN_LOSS_8DEV <= loss <= 1.1 * dryrun.GOLDEN_LOSS_8DEV
    assert 0.9 * corrected <= grad_norm <= 1.1 * corrected


def test_dropout_draws_differ_between_data_ranks_and_shards(port_results):
    """On a dp 4 x tp 2 mesh every model rank draws the one-device masks of
    its data rank's stream: its kernel seeds are that stream's, and its
    columns of a sharded activation's mask are its columns of the stream's
    whole mask. The streams of data ranks differ; data rank 0's is one
    device's."""
    from allophant_tpu_torch.models.layers import dropout

    draws = port_results[0]["draws"].reshape(4, 2, -1)
    for data_rank in range(4):
        rng = DropoutRng.from_seed(5, "cpu", data_rank)
        whole = dropout(torch.ones(1, 64), 0.5, rng)[0].double().numpy()
        seeds = rng.kernel_seeds()
        for model_rank in range(2):
            np.testing.assert_array_equal(draws[data_rank, model_rank, :32], whole[32 * model_rank : 32 * (model_rank + 1)])
            np.testing.assert_array_equal(draws[data_rank, model_rank, 32:], seeds)
    for first in range(4):
        for second in range(first + 1, 4):
            assert not np.array_equal(draws[first, 0], draws[second, 0])
            assert not np.array_equal(draws[first, 0, 32:], draws[second, 0, 32:])
    one_device = DropoutRng.for_mesh(5, "cpu")
    np.testing.assert_array_equal(draws[0, 0, :32], dropout(torch.ones(1, 64), 0.5, one_device)[0, :32].double().numpy())


def test_tp2_dropout_step_matches_one_device(port_results):
    """Dropout on at every encoder site (attention, activation, hidden) and
    the heads' tap: the tp = 2 step draws the one-device step's masks, the
    heads' by their global index and the FFN columns' cut from the whole
    mask, so its metrics, gradients and Adam moments equal the one-device
    step's within 1e-5 of each leaf's largest (the mesh steps' limit).
    Adam's first update of a leaf whose gradient is near 0 magnifies the
    row-parallel sums' rounding, so the parameters are not compared."""
    metrics, tensors = port_results[0]["tp2_dropout"]
    expected_metrics, expected = port_results[0]["one_device_dropout"]
    for key, value in expected_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-5, err_msg=key)
    for kind in ("grads", "exp_avg", "exp_avg_sq"):
        for name, value in expected[kind].items():
            atol = max(1e-5 * np.abs(value).max(), 1e-12)
            np.testing.assert_allclose(tensors[kind][name], value, rtol=0, atol=atol, err_msg=f"{kind} {name}")


def test_remat_under_tensor_parallelism(port_results):
    """Dropout on at every encoder site: remat's recompute replays the
    row-parallel reduces and the dropout draws, and its gradients equal those
    without remat."""
    plain = port_results[0]["tp2_remat_False"]
    remat = port_results[0]["tp2_remat_True"]
    assert plain[0] == remat[0]
    for name, value in plain[1]["grads"].items():
        np.testing.assert_allclose(remat[1]["grads"][name], value, rtol=0, atol=1e-6 * max(np.abs(value).max(), 1e-12), err_msg=name)


def test_sharded_save_restores_over_the_mesh_and_on_one_device(port_results):
    """Over a dp 2 x tp 2 mesh, ``Estimator.save`` writes the whole checkpoint
    (parameters and Adam's moments gathered from the shards) and ``restore``
    cuts it again: every rank's shards come back bit for bit. The file is the
    one-device checkpoint: JAX's ``load_checkpoint`` reads its parameters, and
    one process restores them and the moments whole."""
    from allophant_tpu.training import checkpoint as jax_checkpoint
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.run import TrainingRun

    results = port_results[0]
    result, path = results["checkpoint"], results["checkpoint_path"]
    assert result["largest_difference"] == 0.0 and result["count"] == (1, 1)
    saved = _port_tree(result["params"])
    theirs = _flatten(jax_checkpoint.load_checkpoint(path).variables["params"])
    assert set(theirs) == set(saved)
    for key, value in theirs.items():
        np.testing.assert_array_equal(saved[key], value, err_msg=key)
    restored, _indexer = Estimator.restore(path, wav2vec2_architecture=dryrun.TINY_ARCHITECTURE, precision="float32", device="cpu")
    for name, parameter in restored.model.named_parameters():
        np.testing.assert_array_equal(parameter.detach().numpy(), result["params"][name], err_msg=name)
    state = TrainingRun(restored, None, training_state=restored.training_state)._optimizer.optimizer.state
    for name, parameter in restored.model.named_parameters():
        np.testing.assert_array_equal(state[parameter]["exp_avg"].numpy(), result["exp_avg"][name], err_msg=name)


@pytest.mark.parametrize("job", ["predict_dp4", "predict_dp4xtp2"])
def test_sharded_predictions_match_one_process(port_results, job):
    results, single = port_results
    sharded = results[job]
    assert set(sharded) == set(single)
    # Under tensor parallelism the row-parallel projections add their partial
    # products in another order: 1e-5 relative there as well.
    rtol = 0.0 if job == "predict_dp4" else LOG_PROB_ATOL
    for key, value in single.items():
        if key.startswith("log_probs/") or key == "beam_scores":
            np.testing.assert_allclose(sharded[key], value, rtol=rtol, atol=LOG_PROB_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(sharded[key], value, err_msg=key)
