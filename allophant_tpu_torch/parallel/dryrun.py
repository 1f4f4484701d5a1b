"""Dry runs of the multi-device paths on tiny shapes (the port's counterparts
of ``__graft_entry__.dryrun_multichip`` and ``tools/multiprocess_dryrun.py``).

``dryrun_multichip`` takes one training step of the flagship head over a tiny
wav2vec2 encoder (width 64, 2 layers of 2 heads, FFN 128, convs (16, 16)) on
a (data, model) mesh, from the same numpy draws as the JAX dry run: batch
2 x data ranks, A = 2 microbatches of 960 samples, 4 labels a head, the
phoneme head's from its row's language inventory. It checks the fused CTC
losses against the per-head ones and reports ``loss`` and ``grad_norm``;
JAX's golden values for 8 devices (a 4 x 2 mesh, the heads' tap dropout 0.2
on) are ``GOLDEN_LOSS_8DEV`` and ``GOLDEN_GRAD_NORM_8DEV``. The port draws
its own dropout masks, so with dropout on the golden values are a band, not
an equality.

    python -m allophant_tpu_torch.parallel.dryrun [--checks INPUTS OUTPUTS RANKS]

runs the dry run on a 4 x 2 mesh of 8 gloo processes on the CPU (seed-0
weights), or with ``--checks`` the jobs of ``run_checks`` in RANKS processes.

``sharded_step`` is the step without dropout, returning the whole gradients,
Adam moments and parameters for comparison with one device or with JAX;
``config_step`` the same step of a model built from a configuration (the
transformer acoustic model, a head with attention classifiers);
``sharded_predictions`` the three prediction paths under
``Estimator.use_data_parallel``. The tests and ``chip_smoke.py`` run them in
spawned processes (``parallel.launch.spawn``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.parallel.mesh import Mesh, process_local_slice
from allophant_tpu_torch.parallel.sharding import gather_state

TINY_ARCHITECTURE = Wav2Vec2Architecture(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=2,
    intermediate_size=128,
    conv_dim=(16, 16),
    conv_kernel=(4, 3),
    conv_stride=(2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
    hidden_dropout=0.0,
    activation_dropout=0.0,
    attention_dropout=0.0,
)
# The JAX dry run's mean_loss and grad_norm on 8 devices (data 4 x model 2),
# from JAX's initial weights (``PRNGKey(0)``), pinned there in +-10% bands.
GOLDEN_LOSS_8DEV = 78.3845
GOLDEN_GRAD_NORM_8DEV = 111.3662
ACCUMULATION, SAMPLES, LABEL_LENGTH = 2, 960, 4


def dryrun_microbatches(model, data_parallel: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX dry run's [A, 2 x data_parallel, ...] microbatches of the
    flagship ``model``, drawn in its order from ``np.random.default_rng(seed)``."""
    from allophant_tpu_torch.demo import demo_indexer
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_config_dict

    indexer = demo_indexer(Config.load(demo_config_dict()))
    batch = data_parallel * 2
    rng = np.random.default_rng(seed)
    language_ids = np.tile(np.arange(batch, dtype=np.int32) % 4, (ACCUMULATION, 1))
    micro = {
        "audio": rng.standard_normal((ACCUMULATION, batch, SAMPLES)).astype(np.float32),
        "lengths": np.full((ACCUMULATION, batch), SAMPLES, dtype=np.int32),
        "language_ids": language_ids,
    }
    pools = {
        language: np.fromiter(mapping.keys(), dtype=np.int64) + 1
        for language, mapping in indexer.language_allophones.allophones.items()
    }
    for node in model.plan.nodes:
        if node.has_allophone:
            labels = np.empty((ACCUMULATION, batch, LABEL_LENGTH), dtype=np.int32)
            for step in range(ACCUMULATION):
                for row in range(batch):
                    labels[step, row] = rng.choice(pools[int(language_ids[step, row])], size=LABEL_LENGTH)
        else:
            labels = rng.integers(1, node.output_size, (ACCUMULATION, batch, LABEL_LENGTH)).astype(np.int32)
        micro[f"labels_{node.name}"] = labels
        micro[f"label_lengths_{node.name}"] = np.full((ACCUMULATION, batch), LABEL_LENGTH, dtype=np.int32)
    return micro


def tiny_flagship(
    device, mesh: Optional[Mesh] = None, state: Optional[Mapping] = None, seed: int = 0, architecture=None, remat: bool = False
):
    """(training config, model) of the flagship over ``architecture``
    (default ``TINY_ARCHITECTURE``) in float32 on ``device``, this rank's
    shard over ``mesh``; weights from the one-device ``state`` (by name) or
    drawn from ``seed``; ``remat`` rematerialises the encoder layers."""
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.weights import load_full_state

    config, model = build_flagship_for_training(
        seed, TINY_ARCHITECTURE if architecture is None else architecture, "float32", device, remat=remat, mesh=mesh
    )
    if state is not None:
        load_full_state(model, state, mesh)
    return config, model


def local_rows(microbatches: Mapping[str, np.ndarray], mesh: Optional[Mesh], device) -> Dict[str, torch.Tensor]:
    """This rank's rows (axis 1) of stacked microbatches, on ``device``."""
    rows = slice(None) if mesh is None else process_local_slice(next(iter(microbatches.values())).shape[1], mesh)
    return {key: torch.from_numpy(np.ascontiguousarray(value[:, rows])).to(device) for key, value in microbatches.items()}


def _host(named: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: value.detach().float().cpu().numpy() for name, value in named.items()}


def check_fused_ctc(model, microbatch: Mapping[str, torch.Tensor], loss_plan) -> None:
    """The dry run's numerics gate: the fused per-class-count CTC losses of a
    deterministic forward equal the per-head ones."""
    from allophant_tpu_torch.ops.ctc import ctc_loss_sum, ctc_loss_sum_heads

    with torch.no_grad():
        predictions = model(microbatch["audio"], microbatch["lengths"], microbatch["language_ids"])
        heads = [
            (name, predictions.outputs[name], microbatch[f"labels_{name}"], microbatch[f"label_lengths_{name}"])
            for name in loss_plan.ctc_heads
        ]
        fused = ctc_loss_sum_heads(heads, predictions.lengths)
        for name, logits, labels, lengths in heads:
            unfused = float(ctc_loss_sum(logits, predictions.lengths, labels, lengths))
            value = float(fused[name])
            if abs(value - unfused) > 1e-3 + 1e-4 * abs(unfused):
                raise AssertionError(f"fused/unfused CTC disagree on head {name}: {value} vs {unfused}")


def sharded_step(
    mesh: Optional[Mesh],
    device,
    microbatches: Mapping[str, np.ndarray],
    state: Optional[Mapping] = None,
    dropout_seed: Optional[int] = None,
    architecture=None,
    gather: bool = True,
    remat: bool = False,
) -> Tuple[Dict[str, float], Optional[Dict[str, Dict[str, np.ndarray]]]]:
    """One step of the tiny (or ``architecture``'s) float32 flagship over
    ``mesh`` (None: this process alone) on this rank's rows of the global
    ``microbatches``; dropout off unless ``dropout_seed`` is given; ``remat``
    rematerialises the encoder layers. Returns
    (metrics, whole tensors): with ``gather``, the clipped gradients, Adam's
    two moments and the updated parameters by name, gathered over the model
    group (every rank of the mesh takes part), as numpy."""
    config, model = tiny_flagship(device, mesh, state, architecture=architecture, remat=remat)
    return _step(config, model, mesh, device, microbatches, dropout_seed, gather)


def config_model(device, mesh: Optional[Mesh], model_inputs: Mapping, state: Optional[Mapping] = None):
    """(nn config, float32 model) of ``model_inputs`` (``config``: a Config
    dict, ``table``: a feature table's CSV text, ``inventories``: the
    indexer's ``LanguageInventories`` or None, ``feature_size``) on
    ``device``, this rank's shard over ``mesh``; weights from the one-device
    ``state`` (by name) or seed 0."""
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config, build_model
    from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
    from allophant_tpu_torch.weights import load_full_state, seeded_initialization

    config = Config.load(model_inputs["config"])
    indexer = PhoneticAttributeIndexer.from_config(config, model_inputs["table"], model_inputs.get("inventories"))
    model = build_model(
        config.nn, model_inputs["feature_size"], 16_000, attribute_graph_from_config(config, indexer), indexer,
        device=device, param_dtype=torch.float32, mesh=mesh,
    ).model
    if state is None:
        seeded_initialization(model, 0, mesh)
    else:
        load_full_state(model, state, mesh)
    return config.nn, model


def config_step(
    mesh: Optional[Mesh],
    device,
    model_inputs: Mapping,
    microbatches: Mapping[str, np.ndarray],
    state: Optional[Mapping] = None,
    dropout_seed: Optional[int] = None,
) -> Tuple[Dict[str, float], Dict[str, Dict[str, np.ndarray]]]:
    """``sharded_step`` of the float32 model of ``model_inputs``
    (``config_model``). The whole tensors also hold ``initial``, the loaded
    parameters gathered back over the model group before the step."""
    config, model = config_model(device, mesh, model_inputs, state)
    named = dict(model.named_parameters())
    # Copies: a CPU parameter's numpy view would follow the step's update.
    initial = {name: value.copy() for name, value in _host(named if mesh is None else gather_state(named, mesh)).items()}
    metrics, tensors = _step(config, model, mesh, device, microbatches, dropout_seed, True)
    tensors["initial"] = initial
    return metrics, tensors


def _step(config, model, mesh: Optional[Mesh], device, microbatches, dropout_seed: Optional[int], gather: bool):
    from allophant_tpu_torch.training import train_step

    optimizer = train_step.create_optimizer(config, model.architecture.hidden_size, model.parameters())
    loss_plan = train_step.build_loss_plan(config, model.plan.allophone_shape is not None)
    step = train_step.make_train_step(
        model, optimizer, loss_plan, train_step.build_freeze_plan(config.acoustic_model), mesh
    )
    rng = None
    if dropout_seed is not None:
        rng = DropoutRng.for_mesh(dropout_seed, device, mesh)
    local = local_rows(microbatches, mesh, device)
    check_fused_ctc(model, {key: value[0] for key, value in local.items()}, loss_plan)
    metrics = step(local, rng)
    if not gather:
        return metrics, None
    named = dict(model.named_parameters())
    adam = optimizer.optimizer.state

    def whole(tensors):
        return _host(tensors if mesh is None else gather_state(tensors, mesh))

    tensors = {
        "grads": whole({name: parameter.grad for name, parameter in named.items()}),
        "exp_avg": whole({name: adam[parameter]["exp_avg"] for name, parameter in named.items()}),
        "exp_avg_sq": whole({name: adam[parameter]["exp_avg_sq"] for name, parameter in named.items()}),
        "params": whole(named),
    }
    return metrics, tensors


def dryrun_multichip(mesh: Mesh, device, state: Optional[Mapping] = None, dropout_seed: int = 1) -> Tuple[float, float]:
    """The JAX dry run's step on ``mesh``: the tiny flagship, its microbatches
    for the mesh's data ranks, the heads' tap dropout on (drawn from
    ``dropout_seed``); weights from ``state`` (by name; e.g. JAX's initial
    ones) or the port's seed 0. Returns (mean_loss, grad_norm), finite, and
    prints them on the mesh's first rank."""
    from allophant_tpu_torch.demo import build_flagship_for_training

    _config, template = build_flagship_for_training(0, TINY_ARCHITECTURE, "float32", "cpu")
    microbatches = dryrun_microbatches(template, mesh.data_parallel)
    metrics, _ = sharded_step(mesh, device, microbatches, state, dropout_seed, gather=False)
    loss, grad_norm = metrics["mean_loss"], metrics["grad_norm"]
    if not (np.isfinite(loss) and np.isfinite(grad_norm)):
        raise AssertionError(f"non-finite dry run: loss {loss}, grad_norm {grad_norm}")
    if mesh.index == 0:
        print(
            f"dryrun_multichip OK: mesh={mesh.shape} loss={loss:.4f} grad_norm={grad_norm:.4f}"
            f" (JAX's 8-device golden values {GOLDEN_LOSS_8DEV} and {GOLDEN_GRAD_NORM_8DEV})"
            " fused_unfused_agree=yes",
            flush=True,
        )
    return loss, grad_norm


def prediction_batch(rows: int = 5, seed: int = 11):
    """A deterministic inference batch of ``rows`` rows (not a multiple of
    most data-rank counts) of 1,600 samples and less, languages 0-3."""
    from allophant_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(seed)
    lengths = np.array([1600, 1280, 1600, 960, 1440, 1600, 1120, 1600][:rows], dtype=np.int32)
    audio = (0.5 * rng.standard_normal((rows, 1600))).astype(np.float32)
    return Batch(audio, lengths, (np.arange(rows) % 4).astype(np.int32))


def sharded_predictions(estimator, batch, beam_width: int = 4) -> Dict[str, np.ndarray]:
    """``predict`` log-probs (batch-first), ``predict_decoded``'s grid and
    ``predict_beam_decoded``'s tokens and scores of ``batch`` by
    ``estimator`` (under ``use_data_parallel`` or alone), on the host."""
    heads = tuple(estimator.classes)
    predictions = estimator.predict(batch, time_major=False)
    results = {f"log_probs/{name}": value.cpu().numpy() for name, value in predictions.outputs.items()}
    results["lengths"] = predictions.lengths.cpu().numpy()
    grid, _lengths = estimator.predict_decoded(batch, heads=heads)
    results["grid"] = grid.to(torch.int32).cpu().numpy()
    collected, scores, _lengths = estimator.predict_beam_decoded(batch, heads=heads[:3], beam_width=beam_width)
    results["beam_tokens"] = collected.cpu().numpy()
    results["beam_scores"] = scores.cpu().numpy()
    return results


def serving_flagship(device, mesh: Optional[Mesh] = None, state: Optional[Mapping] = None, architecture=None):
    """A float32 serving Estimator of the tiny (or ``architecture``'s) flagship
    on ``device``, its shard over ``mesh``, from ``state`` or seed 0."""
    from allophant_tpu_torch.training.estimator import Estimator

    config, model = tiny_flagship(device, mesh, state, architecture=architecture)
    return Estimator(model.eval(), "float32", device)



def dropout_draws(mesh: Mesh, device, seed: int = 5) -> np.ndarray:
    """[ranks, 64 / tp + 2] draws of every rank of ``mesh``, in grid order,
    from the loop's ``DropoutRng`` for this rank: its columns of a 64-wide
    activation's keep mask (scaled by 2, the FFN's activation dropout at rate
    0.5 on its shard) and two attention-kernel seeds."""
    from allophant_tpu_torch.models.layers import dropout
    from allophant_tpu_torch.parallel.mesh import gather_rows

    rng = DropoutRng.for_mesh(seed, device, mesh)
    columns = 64 // mesh.model_parallel
    mask = dropout(torch.ones(1, columns, device=device), 0.5, rng, 64, mesh.model_rank * columns)[0]
    seeds = torch.tensor(rng.kernel_seeds(), dtype=torch.float64, device=device)
    return gather_rows(torch.cat([mask.double(), seeds])[None], mesh.index, mesh.size, mesh.group).cpu().numpy()


def checkpoint_round_trip(mesh: Mesh, device, path: str, microbatches: Mapping[str, np.ndarray]) -> Dict[str, object]:
    """``Estimator.save`` and ``restore`` over ``mesh``: a float32 Estimator of
    the tiny flagship from the demo config takes one step through
    ``TrainingRun``'s step on this rank's rows, saves (the first rank writes
    the whole checkpoint, the optimizer's moments gathered), restores over
    the same mesh and loads the training state. Returns, on every rank, the
    largest difference of any local parameter or moment shard between the
    saved and the restored run, and the whole parameters and moments that
    were saved (numpy, by name)."""
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_config_dict, demo_indexer
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.run import TrainingRun

    config = Config.load(demo_config_dict())
    indexer = demo_indexer(config)
    estimator = Estimator.from_config(
        config, 1, 16_000, attribute_graph_from_config(config, indexer), indexer, TINY_ARCHITECTURE,
        precision="float32", device=device, mesh=mesh,
    )
    run = TrainingRun(estimator, None)
    run._train_step(local_rows(microbatches, mesh, device), None, 0, (0.0, 0.0))
    estimator.save(path, optimizer_state=run.serialized_training_state(), phonetic_indexer_state=indexer.state())
    restored, _indexer = Estimator.restore(path, wav2vec2_architecture=TINY_ARCHITECTURE, precision="float32", device=device, mesh=mesh)
    resumed = TrainingRun(restored, None, training_state=restored.training_state)

    def moments(training_run):
        state = training_run._optimizer.optimizer.state
        return [state[parameter][key] for parameter in training_run._estimator.model.parameters() for key in ("exp_avg", "exp_avg_sq")]

    pairs = [
        *zip(estimator.model.parameters(), restored.model.parameters()),
        *zip(moments(run), moments(resumed)),
    ]
    named = dict(estimator.model.named_parameters())
    adam = run._optimizer.optimizer.state
    return {
        "largest_difference": max(float((saved.detach() - loaded.detach()).abs().max()) for saved, loaded in pairs),
        "count": (run._optimizer.count, resumed._optimizer.count),
        "params": _host(estimator.full_parameters()),
        "exp_avg": _host(gather_state({name: adam[parameter]["exp_avg"] for name, parameter in named.items()}, mesh)),
    }


def run_checks(rank: int, world_size: int, device, inputs_path: str, output_path: str) -> None:
    """Runs the jobs of ``inputs_path`` (a ``torch.save``d dict: ``jobs``, a
    list of dicts with ``name``, ``kind`` ("step", "config_step", "dryrun",
    "draws", "checkpoint" or "predict"), ``data_parallel``, ``model_parallel``
    and the kind's inputs;
    ``state``, the one-device weights by name, or None for seed 0) on every
    rank of a spawned group (``launch.spawn``); the first rank writes
    {name: result} to ``output_path``. Each job runs on a mesh over the first
    data x model ranks; the meshes are made first, by every rank."""
    from allophant_tpu_torch.parallel.mesh import create_mesh

    inputs = torch.load(inputs_path, weights_only=False)
    state = inputs.get("state")
    meshes = {}
    for job in inputs["jobs"]:
        shape = (job["data_parallel"], job["model_parallel"])
        if shape not in meshes:
            meshes[shape] = create_mesh(*shape, ranks=range(shape[0] * shape[1]))
    results = {}
    for job in inputs["jobs"]:
        mesh = meshes[(job["data_parallel"], job["model_parallel"])]
        if mesh is None:
            continue
        architecture = job.get("architecture")
        kind = job["kind"]
        if kind == "step":
            result = sharded_step(
                mesh, device, job["microbatches"], state, job.get("dropout_seed"), architecture,
                job.get("gather", True), job.get("remat", False),
            )
        elif kind == "config_step":
            result = config_step(mesh, device, job["model"], job["microbatches"], job.get("state"), job.get("dropout_seed"))
        elif kind == "dryrun":
            result = dryrun_multichip(mesh, device, state, job.get("dropout_seed", 1))
        elif kind == "draws":
            result = dropout_draws(mesh, device)
        elif kind == "checkpoint":
            result = checkpoint_round_trip(mesh, device, job["path"], job["microbatches"])
        elif kind == "predict":
            estimator = serving_flagship(device, mesh if mesh.model_parallel > 1 else None, state, architecture)
            result = sharded_predictions(estimator.use_data_parallel(mesh), job["batch"], job.get("beam_width", 4))
        else:
            raise ValueError(f"Unknown job kind {kind!r}")
        if rank == 0:
            results[job["name"]] = result
    if rank == 0:
        torch.save(results, output_path)


def _dryrun_rank(rank: int, world_size: int, device) -> None:
    from allophant_tpu_torch.parallel.mesh import create_mesh

    dryrun_multichip(create_mesh(model_parallel=2), device)


def main(arguments=None) -> int:
    import argparse
    import tempfile

    from allophant_tpu_torch.parallel import launch

    parser = argparse.ArgumentParser(description="Dry runs of the multi-device paths on the CPU (gloo processes)")
    parser.add_argument("--checks", nargs=3, metavar=("INPUTS", "OUTPUTS", "RANKS"), help="run_checks' jobs")
    options = parser.parse_args(arguments)
    if options.checks is not None:
        inputs, outputs, ranks = options.checks
        with tempfile.TemporaryDirectory() as workdir:
            launch.spawn(run_checks, workdir, ["cpu"] * int(ranks), (inputs, outputs), cpu_threads=1)
        return 0
    with tempfile.TemporaryDirectory() as workdir:
        launch.spawn(_dryrun_rank, workdir, ["cpu"] * 8, cpu_threads=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
