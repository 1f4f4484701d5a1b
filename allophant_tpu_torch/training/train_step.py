"""Training step: multi-task CTC objective, gradient accumulation, optimizer
(counterpart of ``allophant_tpu/training/train_step.py``, with its names).

- Objective: the sum of the per-classifier losses over a microbatch divided by
  its label count, plus ``allophone_l2_alpha * l2_penalty``.
- Accumulation: each microbatch's objective is backpropagated in turn, so
  ``.grad`` sums the microbatch gradients; the sum is divided by the count.
- Then the freeze mask, the global gradient norm (reported before clipping),
  optax's clip by global norm, and the configured optimizer at the schedule's
  learning rate for the update count before the increment.

The step updates the model's parameters in place (the torch idiom; JAX
returns new ones) and returns the JAX step's metric keys, moved to the host
in one stacked transfer.

Over a ``parallel.mesh.Mesh`` (one process a device) each rank runs its rows
of the global batch and the step is the one-device step of that batch, as
JAX's is over its mesh:
- each microbatch's objective divides this rank's loss by the label count of
  the whole microbatch (summed over the data group before the forward), and
  the allophone L2 penalty enters on the first data rank only;
- after the microbatches, one sum of the gradients over the data group, in
  flat buckets (no DDP: its hooks would reduce every microbatch);
- the global norm counts each model-parallel shard once and each replicated
  parameter once; clipping and the optimizer then run on every rank alike,
  each on its own shards;
- the metrics are summed over the data group, so every rank returns the
  global numbers."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from allophant_tpu_torch import tracing
from allophant_tpu_torch.config import Adam, Architecture, SequenceCrossEntropyLossConfig, SGD, Wav2Vec2PretrainedConfig
from allophant_tpu_torch.models.allophant import AllophantModel
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.ops.ctc import ctc_loss_sum_heads, sequence_cross_entropy_sum
from allophant_tpu_torch.parallel.mesh import Mesh, all_reduce
from allophant_tpu_torch.parallel.sharding import param_spec

#: Bytes of one flat bucket of the gradient all-reduce.
ALL_REDUCE_BUCKET_BYTES = 64 << 20


def global_norm(grads: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None, model_group=None) -> torch.Tensor:
    """optax's ``global_norm`` (the 2-norm of all gradients together) as an f32
    scalar, accumulated in f64: an f32 sum of squares over a leaf of millions
    of elements drifts by 1e-4 on the CPU. Under tensor parallelism
    ``sharded`` marks the gradients that are this rank's shard: their squares
    are summed over ``model_group``, the replicated ones counted once."""
    norms = torch.stack(torch._foreach_norm(list(grads), 2, dtype=torch.float64))
    if model_group is None or sharded is None or not any(sharded):
        return torch.linalg.vector_norm(norms).float()
    mask = torch.tensor(list(sharded), device=norms.device)
    squares = norms.square()
    shard_sum = all_reduce(squares[mask].sum(), model_group)
    return (squares[~mask].sum() + shard_sum).sqrt().float()


def all_reduce_gradients(grads: Sequence[torch.Tensor], group) -> None:
    """Sums ``grads`` in place over ``group``: the gradients of each dtype
    flattened into buckets of about ALL_REDUCE_BUCKET_BYTES, one all-reduce a
    bucket."""
    if group is None:
        return
    buckets: Dict[torch.dtype, list] = {}
    for grad in grads:
        dtype_buckets = buckets.setdefault(grad.dtype, [[]])
        if sum(part.numel() * part.element_size() for part in dtype_buckets[-1]) >= ALL_REDUCE_BUCKET_BYTES:
            dtype_buckets.append([])
        dtype_buckets[-1].append(grad)
    for bucket in (bucket for dtype_buckets in buckets.values() for bucket in dtype_buckets):
        flat = all_reduce(torch.cat([part.reshape(-1) for part in bucket]), group)
        torch._foreach_copy_(bucket, [chunk.view_as(part) for chunk, part in zip(flat.split([part.numel() for part in bucket]), bucket)])


def clip_by_global_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place, without a host sync: each
    gradient stays as it is when ``norm < max_norm`` and becomes
    ``(g / norm) * max_norm`` otherwise (``clip_grad_norm_`` adds 1e-6 to the
    norm instead)."""
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(list(grads), torch.where(below, one, norm))
    torch._foreach_mul_(list(grads), torch.where(below, one, torch.full_like(one, max_norm)))


class Optimizer:
    """``create_optimizer``'s result: optional clipping by global norm, then
    Adam or SGD (coupled L2 as torch's ``weight_decay``) at the schedule's
    learning rate. ``count`` is the update count (optax's)."""

    def __init__(self, optimizer: torch.optim.Optimizer, learning_rate: Callable[[int], float], clip_norm: Optional[float]):
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.count = 0

    def update(self, grad_norm: torch.Tensor) -> None:
        """Clips the ``.grad`` of every parameter in place (``grad_norm`` is
        their global norm), then steps at the learning rate of the current
        count."""
        grads = [parameter.grad for group in self.optimizer.param_groups for parameter in group["params"]]
        if self.clip_norm is not None:
            clip_by_global_norm(grads, grad_norm, self.clip_norm)
        learning_rate = self.learning_rate(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate
        self.optimizer.step()
        self.count += 1


def create_optimizer(architecture: Architecture, d_model: int, parameters) -> Optimizer:
    """The configured optimizer over ``parameters``, with the warmup schedule
    over ``d_model`` when the config has one (else the optimizer's constant
    learning rate) and the config's clip norm."""
    config = architecture.optimizer
    if architecture.lr_schedule is not None:
        learning_rate = architecture.lr_schedule.schedule(d_model)
    else:
        learning_rate = lambda _count: config.learning_rate  # noqa: E731
    parameters = list(parameters)
    if isinstance(config, Adam):
        optimizer = torch.optim.Adam(
            parameters, lr=learning_rate(0), betas=(config.beta_1, config.beta_2), eps=1e-8,
            weight_decay=config.l2_regularization,
        )
    elif isinstance(config, SGD):
        optimizer = torch.optim.SGD(
            parameters, lr=learning_rate(0), momentum=config.momentum, weight_decay=config.l2_regularization
        )
    else:
        raise ValueError(f"Unknown optimizer {config!r}")
    return Optimizer(optimizer, learning_rate, architecture.clip_norm)


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """Per-classifier loss selection derived from the projection config."""

    ctc_heads: Tuple[str, ...]
    cross_entropy_heads: Tuple[Tuple[str, float], ...]  # (name, label_smoothing)
    allophone_l2_alpha: float
    has_allophone_penalty: bool

    @property
    def head_names(self) -> Tuple[str, ...]:
        return self.ctc_heads + tuple(name for name, _ in self.cross_entropy_heads)


def build_loss_plan(architecture: Architecture, has_allophone: bool) -> LossPlan:
    ctc_heads, cross_entropy_heads = [], []
    for entry in architecture.projection.classes:
        if isinstance(entry.loss, SequenceCrossEntropyLossConfig):
            cross_entropy_heads.append((entry.name, entry.loss.label_smoothing))
        else:
            ctc_heads.append(entry.name)
    return LossPlan(tuple(ctc_heads), tuple(cross_entropy_heads), architecture.projection.allophone_l2_alpha, has_allophone)


def label_count(batch: Dict[str, torch.Tensor], loss_plan: LossPlan) -> torch.Tensor:
    """The objective's denominator of a (micro)batch, an f32 scalar: every CTC
    head's label lengths, and one label a row (a real row, with
    ``row_weights``) for each cross-entropy head."""
    count = torch.zeros((), dtype=torch.float32, device=batch["audio"].device)
    for name in loss_plan.ctc_heads:
        count = count + batch[f"label_lengths_{name}"].sum()
    row_weights = batch.get("row_weights")
    for name, _smoothing in loss_plan.cross_entropy_heads:
        count = count + (batch[f"labels_{name}"].shape[0] if row_weights is None else row_weights.sum())
    return count


def multitask_loss(
    model: AllophantModel,
    batch: Dict[str, torch.Tensor],
    loss_plan: LossPlan,
    rng: Optional[DropoutRng] = None,
    total_labels: Optional[torch.Tensor] = None,
    penalty: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(objective, metrics) of one microbatch. ``batch`` keys: audio [B, S],
    lengths [B], language_ids [B], ``labels_<name>`` [B, N] and
    ``label_lengths_<name>`` [B] per head, optional ``row_weights`` [B] (0/1,
    batch-padding filler rows excluded). ``rng=None`` is deterministic.
    ``total_labels`` replaces the batch's own label count as the objective's
    denominator (a data-parallel rank divides by the whole microbatch's);
    ``penalty=False`` leaves the allophone L2 penalty out of the objective."""
    with tracing.span("train.forward"):
        predictions = model(batch["audio"], batch["lengths"], batch["language_ids"], rng=rng)
    with tracing.span("train.loss"):
        outputs = predictions.outputs
        row_weights = batch.get("row_weights")
        head_losses = ctc_loss_sum_heads(
            [(name, outputs[name], batch[f"labels_{name}"], batch[f"label_lengths_{name}"]) for name in loss_plan.ctc_heads],
            predictions.lengths,
            row_weights=row_weights,
        )
        total_loss = torch.zeros((), dtype=torch.float32, device=batch["audio"].device)
        for name in loss_plan.ctc_heads:
            total_loss = total_loss + head_losses[name]
        for name, smoothing in loss_plan.cross_entropy_heads:
            loss = sequence_cross_entropy_sum(
                outputs[name], predictions.lengths, batch[f"labels_{name}"], label_smoothing=smoothing, row_weights=row_weights
            )
            head_losses[name] = loss
            total_loss = total_loss + loss
        total_length = label_count(batch, loss_plan)
        denominator = total_length if total_labels is None else total_labels
        objective = total_loss / denominator.clamp_min(1.0)
        if loss_plan.has_allophone_penalty and penalty:
            objective = objective + loss_plan.allophone_l2_alpha * model.l2_penalty()
        return objective, {"loss": total_loss, "label_count": total_length, **head_losses}


@dataclasses.dataclass(frozen=True)
class FreezePlan:
    """Gradient-masking plan for parameter groups of the acoustic model: each
    entry maps a parameter-name prefix to an unfreeze step (None: frozen for
    the whole run; an int: trainable once the update step reaches it)."""

    groups: Tuple[Tuple[Tuple[str, ...], Optional[int]], ...] = ()

    def __bool__(self) -> bool:
        return bool(self.groups)


def build_freeze_plan(acoustic_config) -> FreezePlan:
    """The freeze plan of a wav2vec2-pretrained config (the unfreeze schedule
    only thaws groups the flags froze); other acoustic models train all."""
    if not isinstance(acoustic_config, Wav2Vec2PretrainedConfig):
        return FreezePlan()
    return FreezePlan(
        tuple((("acoustic_model", group), thaw) for group, frozen, thaw in acoustic_config.freeze_groups() if frozen)
    )


def apply_freeze_plan(model: AllophantModel, plan: FreezePlan, step: int) -> None:
    """Multiplies the ``.grad`` of each frozen group by 0 in place (JAX scales
    the gradient leaves by a 0/1 factor)."""
    for prefix, threshold in plan.groups:
        if threshold is not None and step >= threshold:
            continue
        for name, parameter in model.named_parameters():
            if tuple(name.split("."))[: len(prefix)] == prefix:
                parameter.grad.mul_(0.0)


def _to_host(names: Sequence[str], values: Sequence[torch.Tensor]) -> Dict[str, float]:
    """One stacked device-to-host transfer of scalar metrics."""
    tracing.count("host_reads")
    stacked = torch.stack([value.detach().float().reshape(()) for value in values]).cpu().tolist()
    return dict(zip(names, stacked))


def accumulate_gradients(
    model: AllophantModel,
    microbatches: Dict[str, torch.Tensor],
    loss_plan: LossPlan,
    rng: Optional[DropoutRng],
    mesh: Optional[Mesh] = None,
    extra: Sequence[float] = (),
) -> torch.Tensor:
    """Sets every parameter's ``.grad`` to the mean over the microbatches
    (leading axis of ``microbatches``) of the objective's gradient, zeros
    where none flows (a frozen prefix); returns the device tensor of the
    summed metrics, in the order loss, label_count, heads, then ``extra``.
    Over a ``mesh`` the microbatches are this rank's rows: the gradients and
    the metrics (``extra`` too) are the sums over the data group, i.e. those
    of the whole batch."""
    parameters = list(model.parameters())
    for parameter in parameters:
        parameter.grad = None
    count = next(iter(microbatches.values())).shape[0]
    data_group = None if mesh is None else mesh.data_group
    totals = [None] * count
    if data_group is not None:
        # The denominators of every microbatch in one reduce, before the forwards.
        totals = all_reduce(
            torch.stack([label_count({key: value[index] for key, value in microbatches.items()}, loss_plan) for index in range(count)]),
            data_group,
        )
    penalty = mesh is None or mesh.data_rank == 0
    summed = None
    for index in range(count):
        microbatch = {key: value[index] for key, value in microbatches.items()}
        objective, metrics = multitask_loss(model, microbatch, loss_plan, rng, totals[index], penalty)
        with tracing.span("train.backward"):
            objective.backward()
        values = torch.stack(
            [metrics[name].detach().float() for name in ("loss", "label_count", *loss_plan.head_names)]
        )
        summed = values if summed is None else summed + values
    for parameter in parameters:
        if parameter.grad is None:
            parameter.grad = torch.zeros_like(parameter)
        else:
            parameter.grad.div_(count)
    all_reduce_gradients([parameter.grad for parameter in parameters], data_group)
    if extra:
        summed = torch.cat([summed, torch.tensor(list(extra), dtype=summed.dtype, device=summed.device)])
    return all_reduce(summed, data_group)


def make_eval_step(model: AllophantModel, loss_plan: LossPlan, mesh: Optional[Mesh] = None) -> Callable:
    """A deterministic validation step: batch -> {loss_sum, label_count, per-head
    loss sums} as host floats; over a ``mesh``, of this rank's rows summed
    over the data group."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        _objective, metrics = multitask_loss(model, batch, loss_plan)
        names = ("loss", "label_count", *loss_plan.head_names)
        if mesh is not None and mesh.data_group is not None:
            summed = all_reduce(torch.stack([metrics[name].detach().float() for name in names]), mesh.data_group)
            metrics = dict(zip(names, summed))
        values = _to_host(names, [metrics[name] for name in names])
        values["loss_sum"] = values.pop("loss")
        return values

    return eval_step


def make_train_step(
    model: AllophantModel,
    optimizer: Optimizer,
    loss_plan: LossPlan,
    freeze_plan: FreezePlan = FreezePlan(),
    mesh: Optional[Mesh] = None,
) -> Callable:
    """A train step over ``microbatches`` (a dict of tensors with a leading
    accumulation axis [A, ...]) with dropout from ``rng`` (None:
    deterministic); ``global_step`` drives the unfreeze schedule. Updates the
    model in place and returns {loss_sum, label_count, mean_loss, grad_norm,
    per-head loss sums} as host floats; ``grad_norm`` is the norm of the
    averaged, freeze-masked gradients before clipping. After the step each
    parameter's ``.grad`` holds the clipped gradient the optimizer used.

    Over a ``mesh`` the microbatches are this rank's rows of the global batch
    (see the module's docstring). ``extra`` values of this rank ride on the
    metrics' reduce, summed over the data group and their largest taken over
    the model group; the result then holds them under ``extra`` (the loop's
    stop flag and row count)."""
    names = [name for name, _parameter in model.named_parameters()]
    model_group = None if mesh is None else mesh.model_group
    sharded = [param_spec(name).sharded for name in names] if model_group is not None else None

    def train_step(
        microbatches: Dict[str, torch.Tensor],
        rng: Optional[DropoutRng] = None,
        global_step: int = 0,
        extra: Sequence[float] = (),
    ):
        with tracing.span("train.step"):
            summed = accumulate_gradients(model, microbatches, loss_plan, rng, mesh, extra)
            if extra and model_group is not None:
                # A flag of one column reaches the others; counts are the same in each.
                all_reduce(summed[-len(extra) :], model_group, dist.ReduceOp.MAX)
            with tracing.span("train.optimizer"):
                apply_freeze_plan(model, freeze_plan, global_step)
                grads = [parameter.grad for parameter in model.parameters()]
                grad_norm = global_norm(grads, sharded, model_group)
                optimizer.update(grad_norm)
            with tracing.span("train.metrics"):
                tracing.count("host_reads")
                values = torch.cat([summed, grad_norm.reshape(1)]).detach().float().cpu().tolist()
        metric_names = ("loss_sum", "label_count", *loss_plan.head_names)
        metrics = dict(zip((*metric_names, "grad_norm"), values[: len(metric_names)] + values[-1:]))
        metrics["mean_loss"] = metrics["loss_sum"] / max(metrics["label_count"], 1.0)
        if extra:
            metrics["extra"] = values[len(metric_names) : -1]
        return metrics

    return train_step
