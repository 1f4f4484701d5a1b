"""Training cells: the step of ``make_train_step`` (``create_optimizer``,
``build_loss_plan``, ``build_freeze_plan``, a seeded ``DropoutRng`` an
update, ``global_step`` advancing) on groups of the traffic's microbatches
stacked by ``stack_microbatches`` and copied to the device by
``microbatches_to_device``, as ``allophant train`` feeds it.

Set-up builds the model and its optimizer and runs the first
``check.steps`` updates through the window's own call: they are the
warm-up, and the reference follows them. The window then runs whole
updates until ``--seconds`` have passed; its rate is the real audio of every
update it completed over the time to the end of the last. With ``--trace 0``
on the card the window runs under a profiler of the device alone, whose
union of device operations over the audio seconds of the stacked groups,
padding included, is the end-to-end ``train_device_ms_per_padded_s``: the
device's time is proportional to the stacked shapes, so it reads the same
whichever groups the host's pace fits into the window. With ``--trace 1``
the window runs unprofiled, and its rate is the per-layer
``wall_audio_s_per_s.train``."""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from cardbench.core import card, port, registry
from cardbench.core.context import Check, Context, Result
from cardbench.core.trace import Trace, device_profiler, kernel_seconds, profiled_device_seconds
from cardbench.reference import judge
from cardbench.reference.model import ReferenceAllophant
from cardbench.reference.numerics import full_float32
from cardbench.reference.train import Microbatch, ReferenceTrainer
from cardbench.core import weights as weights_module

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dropout_seed(seed: int, update: int) -> int:
    """The dropout seed of an update: the run's seed folded into 30 bits, plus
    the update's index."""
    return int(seed) % (1 << 30) + update


def _check_training_config(nn_config, training: dict, hidden: int) -> None:
    """Raises unless the port's training configuration is the one the
    benchmark's file states."""
    optimizer, schedule = nn_config.optimizer, nn_config.lr_schedule
    acoustic = nn_config.acoustic_model
    stated = training["optimizer"], training["lr_schedule"]
    pairs = {
        "beta_1": (optimizer.beta_1, stated[0]["beta_1"]),
        "beta_2": (optimizer.beta_2, stated[0]["beta_2"]),
        "l2_regularization": (optimizer.l2_regularization, stated[0]["l2_regularization"]),
        "warmup_steps": (schedule.warmup_steps, stated[1]["warmup_steps"]),
        "constant_steps": (schedule.constant_steps, stated[1]["constant_steps"]),
        "factor": (schedule.factor, stated[1]["factor"]),
        "clip_norm": (nn_config.clip_norm, training["clip_norm"]),
        "allophone_l2_alpha": (nn_config.projection.allophone_l2_alpha, training["allophone_l2_alpha"]),
        "acoustic_model_dropout": (nn_config.projection.acoustic_model_dropout, training["acoustic_model_dropout"]),
        "freeze_feature_encoder": (acoustic.freeze_feature_encoder, training["freeze_feature_encoder"]),
        "freeze_feature_projection": (acoustic.freeze_feature_projection, training["freeze_feature_projection"]),
        "freeze_encoder": (acoustic.freeze_encoder, training["freeze_encoder"]),
    }
    wrong = {name: values for name, values in pairs.items() if values[0] != values[1]}
    if wrong:
        raise ValueError(f"the port's training configuration differs from the benchmark's: {wrong}")


class Trainer:
    """The timed call: stack a group, copy it to the device, take the step."""

    def __init__(self, context: Context, model, device):
        from allophant_tpu_torch.data.batch import LabeledBatch
        from allophant_tpu_torch.demo import flagship_config
        from allophant_tpu_torch.device import set_float32_precision
        from allophant_tpu_torch.models.layers import DropoutRng
        from allophant_tpu_torch.training.estimator import resolve_precision
        from allophant_tpu_torch.training.run import microbatches_to_device, stack_microbatches
        from allophant_tpu_torch.training.train_step import (
            build_freeze_plan,
            build_loss_plan,
            create_optimizer,
            make_train_step,
        )

        config = context.config
        hidden = config["architecture"]["hidden_size"]
        nn_config = flagship_config()
        _check_training_config(nn_config, config["training"], hidden)
        self.optimizer = create_optimizer(nn_config, hidden, model.parameters())
        loss_plan = build_loss_plan(nn_config, model.plan.allophone_shape is not None)
        self.step = make_train_step(model, self.optimizer, loss_plan, build_freeze_plan(nn_config.acoustic_model))
        if "step" in context.faults:
            self.step = context.faults["step"](self.step, model, self.optimizer)
        set_float32_precision(resolve_precision(config["precision"])[2])
        self.labeled = LabeledBatch
        self.stack = stack_microbatches
        self.to_device = microbatches_to_device
        self.rng = DropoutRng
        self.device = device
        self.seed = context.seed
        self.model = model

    def update(self, group, index: int):
        """(metrics, host seconds of stacking and copying, stacked host arrays)."""
        started = time.perf_counter()
        stacked = self.stack([
            self.labeled(r.audio, r.lengths, r.language_ids, attribute_indices=r.labels, label_lengths=r.label_lengths)
            for r in group
        ])
        tensors = self.to_device(stacked, self.device)
        host_s = time.perf_counter() - started
        metrics = self.step(tensors, self.rng.from_seed(dropout_seed(self.seed, index), self.device), index)
        return metrics, host_s, stacked


def check_steps_of(context: Context) -> int:
    """The updates the reference follows: the traffic's, or fewer where the
    configuration says its reference would outlast the window."""
    return int(context.config.get("check_steps", context.traffic["check"]["steps"]))


def _group_frames(config: dict, stacked) -> Dict:
    """Real and padded frames of a stacked group, and each microbatch's
    shape as the attention kernels see it."""
    padded = int(port.frame_lengths(config, [stacked["audio"].shape[2]])[0])
    rows = stacked["audio"].shape[1]
    microbatches = []
    real = 0
    for index in range(stacked["audio"].shape[0]):
        weights = stacked["row_weights"][index] > 0
        frames = np.where(weights, port.frame_lengths(config, stacked["lengths"][index]), 0).clip(min=0)
        real += int(frames.sum())
        microbatches.append({"padded_frames": padded, "frames": [int(value) for value in frames]})
    return {"real": real, "padded": padded * rows * stacked["audio"].shape[0], "microbatches": microbatches}


def run(context: Context) -> Result:
    config, traffic, head = context.config, context.traffic, context.head
    device = torch.device(context.device)
    on_card = device.type == "cuda"
    kind = registry.traffic_kind(traffic["kind"])
    model, initial = port.build(config, head, context.seed, device, training=True)
    trainer = Trainer(context, model, device)
    context.log(f"model built, weights loaded: {time.perf_counter() - context.started:.3f} s")
    accumulation = int(traffic["microbatches"])
    stream = kind.requests(traffic, context.seed, head)
    layers = config["architecture"]["num_hidden_layers"]

    def next_group():
        return [next(stream) for _ in range(accumulation)]

    trained = {name: parameter for name, parameter in model.named_parameters()}
    check_steps = check_steps_of(context)
    checked_groups, program_losses = [], []
    first_grads: Dict[str, float] = {}
    beta_1 = config["training"]["optimizer"]["beta_1"]
    for index in range(check_steps):
        group = next_group()
        metrics, _host_s, _stacked = trainer.update(group, index)
        checked_groups.append(group)
        program_losses.append(float(metrics["mean_loss"]))
        context.log(f"checked update {index}: {time.perf_counter() - context.started:.3f} s")
        if index == 0:
            state = trainer.optimizer.optimizer.state
            for name, parameter in trained.items():
                moment = state.get(parameter, {}).get("exp_avg")
                first_grads[name] = float(moment.norm()) / (1 - beta_1) if moment is not None else 0.0
    with torch.no_grad():
        changes = {name: float((parameter - initial[name].to(device)).norm()) for name, parameter in trained.items()}
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - context.started
    context.log(f"set-up {setup_s:.3f} s ({check_steps} checked updates)")

    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = card.counters()
    totals = {"real_samples": 0, "padded_samples": 0, "real_frames": 0, "padded_frames": 0, "updates": 0, "host_s": 0.0}
    lengths_done: List[int] = []
    attempted = failed = 0
    index = check_steps
    start = time.perf_counter()
    deadline = start + context.seconds
    last = start
    profiler = device_profiler() if on_card and not context.trace else contextlib.nullcontext()
    with card.TwinsForbidden() if on_card else contextlib.nullcontext(), profiler:
        while time.perf_counter() < deadline:
            group = next_group()
            attempted += 1
            try:
                metrics, host_s, stacked = trainer.update(group, index)
                if not math.isfinite(float(metrics["mean_loss"])):
                    raise FloatingPointError(f"update {index}: mean loss {metrics['mean_loss']}")
            except Exception as error:  # noqa: BLE001 - a failed update counts, the run goes on
                failed += 1
                print(f"cardbench: update {index} failed: {error!r}", flush=True)
                index += 1
                continue
            last = time.perf_counter()
            index += 1
            frames = _group_frames(config, stacked)
            totals["real_samples"] += sum(request.real_samples for request in group)
            totals["padded_samples"] += int(stacked["audio"].size)
            totals["real_frames"] += frames["real"]
            totals["padded_frames"] += frames["padded"]
            totals["updates"] += 1
            totals["host_s"] += host_s
            lengths_done.extend(int(value) for request in group for value in request.lengths)
    wall = last - start
    device_s = None
    if on_card and not context.trace:
        device_s, operations = profiled_device_seconds(profiler, wall)
        context.log(f"window: {operations} device operations, {device_s:.6f} s of device time in {wall:.6f} s")
    launches = card.counted_since(before)
    departures = port.precision_departures(config)
    if departures:
        context.log(f"precision departs from the configuration: {departures}")
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    audio_s = totals["real_samples"] / traffic["sample_rate"]
    context.log(f"window: {totals['updates']} updates, {audio_s:.3f} audio-s in {wall:.6f} s")
    end_to_end = {"setup_s": setup_s, "train_peak_gib": window_peak / 2**30}
    if device_s is not None and totals["padded_samples"]:
        end_to_end["train_device_ms_per_padded_s"] = 1e3 * device_s / (totals["padded_samples"] / traffic["sample_rate"])
    from cardbench.work import model_flops

    parts = config["precision_parts"]
    flops = model_flops.total_flops(
        config, head["plan"], lengths_done, parts["encoder"],
        "tf32" if parts["float32_matmul"] == "high" else "float32", training=True,
    )
    readings: Dict = {"window": {"wall_s": wall, "audio_s": audio_s, "flops": flops, **totals}, "config": config}
    microbatches = totals["updates"] * accumulation
    per_microbatch = registry.encoder(config["encoder"]).train_launches(config["architecture"])
    expected = {name: count * microbatches for name, count in per_microbatch.items()}
    launch_gap = card.launch_gap(launches, expected) if on_card else 0
    print("cardbench launches: " + ", ".join(f"{name} {launches[name]} (expected {expected.get(name, 0)})" for name in launches), flush=True)

    busy_s = window_s = breakdown = None
    if context.trace:
        busy_s, window_s, breakdown, readings["trace"] = _traced_update(context, trainer, next_group(), index, layers)
    memory_peak = max(setup_peak, window_peak, torch.cuda.max_memory_allocated(device) if on_card else 0)

    del trainer, model, stream, trained
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    reference = reference_steps(context, checked_groups, initial, device)
    context.log(f"reference check {time.perf_counter() - check_start:.3f} s")
    checks = compare(context, program_losses, first_grads, changes, reference)
    checks["updates_failed"] = Check(float(failed), 0.0)
    checks["kernel_launches_off"] = Check(float(launch_gap), 0.0)
    checks["precision_off"] = Check(float(len(departures)), 0.0)
    return Result(end_to_end, readings, attempted, failed, checks, int(memory_peak), busy_s, window_s, breakdown)


def _traced_update(context: Context, trainer: Trainer, group, index: int, layers: int):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as profiler:
        with record_function("cardbench.stretch"):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            with record_function("cardbench.update"):
                _metrics, _host_s, stacked = trainer.update(group, index)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = context.trace_path()
    profiler.export_chrome_trace(str(path))
    trace = Trace.read(path)
    path.unlink()
    start, end = trace.window("cardbench.stretch")
    busy = trace.busy_us(start, end)
    frames = _group_frames(context.config, stacked)
    kernel_s = kernel_seconds(trace)
    context.log(f"device seconds by kernel in the traced stretch: {kernel_s}")
    readings = {
        "wall_s": (end - start) * 1e-6,
        "busy_s": busy * 1e-6,
        "layers": layers,
        "microbatches": frames["microbatches"],
        "kernel_s": kernel_s,
        "k4_s": kernel_s["K4"],
        "k5_s": kernel_s["K5"],
    }
    return busy * 1e-6, (end - start) * 1e-6, trace.breakdown(start, end), readings


def microbatches_of(group, config: dict, traffic: dict) -> List[Microbatch]:
    """The reference's view of a group as the program stacked it: each
    microbatch's real rows, cut to their longest, with the group's padded
    rows and samples (which fix the dropout draws' shapes)."""
    multiple = int(traffic.get("length_multiple", 1))
    padded_samples = max(request.audio.shape[1] for request in group)
    padded_samples = -(-padded_samples // multiple) * multiple
    padded_rows = max(len(request.lengths) for request in group)
    out = []
    for request in group:
        longest = int(request.lengths.max())
        out.append(Microbatch(
            request.audio[:, :longest], request.lengths, request.language_ids,
            request.labels, request.label_lengths, padded_rows, padded_samples,
        ))
    return out


def reference_steps(context: Context, groups, initial: Dict[str, torch.Tensor], device, numerics=None):
    """The reference's losses, first clipped gradients and parameter changes
    over the checked updates, from the benchmark's initial weights."""
    from cardbench.reference.model import Numerics

    config, head = context.config, context.head
    model = ReferenceAllophant(config, head, device=device)
    weights_module.load_into(model, {name: value.to(device) for name, value in initial.items()})
    trainer = ReferenceTrainer(model, config, numerics or Numerics())
    dtypes = (_DTYPES[config["precision_parts"]["encoder"]], _DTYPES[config["precision_parts"]["head"]])
    losses, first = [], None
    with full_float32():
        for index, group in enumerate(groups):
            result = trainer.step(microbatches_of(group, config, context.traffic), dropout_seed(context.seed, index), dtypes)
            losses.append(result.mean_loss)
            if first is None:
                first = result.grad_norms
    with torch.no_grad():
        changes = {
            name: float((parameter - initial[name].to(device)).norm()) for name, parameter in trainer.trained.items()
        }
    del trainer, model
    return {"losses": losses, "grads": first, "changes": changes}


def compare(context: Context, losses, grads, changes, reference) -> Dict[str, Check]:
    """The three numbers of the training check, each beside its limit."""
    loss_gap = max(
        (abs(ours - theirs) / abs(theirs) if math.isfinite(ours) else math.inf)
        for ours, theirs in zip(losses, reference["losses"])
    )
    counted = judge.counted_leaves(reference["grads"])
    grad_gap, grad_leaf = judge.relative_leaf_gaps(grads, reference["grads"], counted)
    change_gap, change_leaf = judge.relative_leaf_gaps(changes, reference["changes"], counted)
    context.log(
        f"losses {losses} against {reference['losses']}; worst gradient leaf {grad_leaf}; worst change leaf {change_leaf};"
        f" {len(counted)} of {len(reference['grads'])} trained leaves counted"
    )
    limits = context.limits
    return {
        "loss_gap": Check(loss_gap, limits["loss_gap"]),
        "first_grad_gap": Check(grad_gap, limits["first_grad_gap"]),
        "change_gap": Check(change_gap, limits["change_gap"]),
    }
