"""High-level training runtime: dataset manager, epoch/step loop, validation,
early stopping, unfreeze schedule, profiling and metrics (counterpart of
``allophant_tpu/training/run.py``).

The loop drives the port's ``make_train_step`` / ``make_eval_step``
(``training/train_step.py``): each accumulation group of batches is stacked on
a leading axis on the host (``stack_microbatches``), copied to the device on
the main thread and run as one step, whose metrics come back in one host
transfer. It yields ``(TrainingStatus, EpochStatistics)`` per validation point
exactly like the JAX package's generator. Batches are the JAX loop's, padded to
the same length and label multiples, drawn in the same order from the same
seeds. Dropout draws from ``DropoutRng.from_seed(seed + step)``; its bits are
the port's own, like the attention-dropout mask.

Over the estimator's mesh (one process a device, JAX's data-parallel loop):
every rank draws the same batch sequence and loads only its rows
(``process_shard``), a batch whose rows do not divide padded with zero-weight
filler rows; each data rank folds its rank into the dropout generators; a
stop asked of any rank (SIGTERM) is summed with the step's metrics, so all
stop after the same step; validation batches are split the same way and
their sums reduced, so every rank takes the same early-stopping decision;
the optimizer's moments are gathered from the model-parallel shards for a
checkpoint, which only the mesh's first rank writes."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
import time
from enum import Enum
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch import tracing
from allophant_tpu_torch.config import Config, ProfilingConfig, Wav2Vec2Config, Wav2Vec2PretrainedConfig
from allophant_tpu_torch.data.batch import LabeledBatch
from allophant_tpu_torch.data.batching import Batcher
from allophant_tpu_torch.data.dataset import (
    BatchType,
    PhonemeDataset,
    PhoneticallySegmentedDataset,
    SamplesProcessor,
    TranscribedDataset,
)
from allophant_tpu_torch.data.speech_corpus import MultilingualCorpus, MultilingualSplits
from allophant_tpu_torch.device import set_float32_precision
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.parallel.sharding import gather_state, param_spec, replicate, shard_tensor
from allophant_tpu_torch.phonetics.attribute_graph import AttributeGraph
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.training import msgpack_codec
from allophant_tpu_torch.training.train_step import (
    build_freeze_plan,
    build_loss_plan,
    create_optimizer,
    make_eval_step,
    make_train_step,
)
from allophant_tpu_torch.utils import progress_bar


class TrainingStatus(Enum):
    """Yielded alongside statistics by `TrainingRun` (reference estimator.py:884-928)."""

    STEP = "step"
    EPOCH = "epoch"
    IMPROVED = "improved"
    EARLY_STOPPED = "early_stopped"
    FINISHED = "finished"
    # Graceful preemption: `TrainingRun.request_stop` was called (e.g. from a
    # SIGTERM handler); the loop finished the in-flight step, synced all state
    # back to the estimator and stopped without running validation. Callers
    # should checkpoint unconditionally on this status — the run resumes
    # exactly (optimizer moments, schedule counter, mid-epoch batch position).
    INTERRUPTED = "interrupted"


@dataclasses.dataclass
class EarlyStopping:
    """Patience-based early stopping on validation loss (reference estimator.py:108-132)."""

    patience: Optional[int] = None
    best_loss: float = math.inf
    stagnation: int = 0

    def update(self, validation_loss: float) -> bool:
        """Records a validation result; returns True if it improved on the best."""
        if validation_loss < self.best_loss:
            self.best_loss = validation_loss
            self.stagnation = 0
            return True
        self.stagnation += 1
        return False

    @property
    def should_stop(self) -> bool:
        # Stop as soon as stagnation REACHES patience (reference
        # estimator.py:132 compares ==); `>` would train one extra stagnant
        # validation window.
        return self.patience is not None and self.stagnation >= self.patience

    def state_dict(self) -> Dict[str, Any]:
        return {"best_loss": self.best_loss, "stagnation": self.stagnation}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_loss = state["best_loss"]
        self.stagnation = state["stagnation"]


@dataclasses.dataclass
class EpochStatistics:
    """Per-validation-point statistics with wall-clock deltas (reference
    estimator.py:170-187)."""

    epoch: int
    global_step: int
    train_loss: float
    classifier_losses: Dict[str, float]
    validation_loss: Optional[float] = None
    validation_classifier_losses: Optional[Dict[str, float]] = None
    learning_rate: Optional[float] = None
    gradient_norm: Optional[float] = None
    batch_count: int = 0
    utterance_count: int = 0
    duration_seconds: float = 0.0

    def __str__(self) -> str:
        parts = [
            f"epoch {self.epoch} step {self.global_step}:",
            f"train loss {self.train_loss:.4f}",
        ]
        if self.validation_loss is not None:
            parts.append(f"validation loss {self.validation_loss:.4f}")
        if self.learning_rate is not None:
            parts.append(f"lr {self.learning_rate:.3e}")
        parts.append(f"({self.batch_count} batches, {self.duration_seconds:.1f}s)")
        return " ".join(parts)


class _MeanAccumulator:
    """Accumulates label-count-normalized loss sums over batches."""

    def __init__(self) -> None:
        self.loss_sum = 0.0
        self.label_count = 0.0
        self.head_sums: Dict[str, float] = {}

    def add(self, metrics: Dict[str, Any]) -> None:
        self.loss_sum += float(metrics["loss_sum"] if "loss_sum" in metrics else metrics["loss"])
        self.label_count += float(metrics["label_count"])
        for name, value in metrics.items():
            if name in ("loss_sum", "loss", "label_count", "mean_loss", "grad_norm"):
                continue
            self.head_sums[name] = self.head_sums.get(name, 0.0) + float(value)

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.label_count, 1.0)

    def head_means(self) -> Dict[str, float]:
        scale = max(self.label_count, 1.0)
        return {name: value / scale for name, value in self.head_sums.items()}


# ---------------------------------------------------------------------------
# Dataset manager
# ---------------------------------------------------------------------------


# Audio-sample bucket for training shapes: lengths round up to multiples of 2 s at
# 16 kHz, as the JAX loop buckets them for its jit cache; the port has no shape
# cache, and keeps the multiples so that the same batches reach the step. Only
# used when the acoustic model downsamples raw audio (wav2vec2's conv stack);
# models that consume the input at frame rate bucket by FRAME_LENGTH_MULTIPLE.
TRAIN_LENGTH_MULTIPLE = 32_000
FRAME_LENGTH_MULTIPLE = 128
# Label-length bucket (CTC target axis).
TRAIN_LABEL_MULTIPLE = 32


def default_length_multiple(config: Config) -> int:
    """Length bucket by acoustic model: second-scale sample buckets for the
    heavily-downsampling wav2vec2 conv frontend, frame-scale buckets otherwise
    (the from-scratch transformer attends at input rate)."""

    if isinstance(config.nn.acoustic_model, (Wav2Vec2Config, Wav2Vec2PretrainedConfig)):
        return TRAIN_LENGTH_MULTIPLE
    return FRAME_LENGTH_MULTIPLE


@dataclasses.dataclass
class DatasetManager:
    """Couples config + corpus splits + the samples processor; builds training and
    validation batchers and the attribute graph (reference estimator.py:287-402)."""

    config: Config
    splits: MultilingualSplits
    processor: SamplesProcessor
    train_dataset: PhonemeDataset
    validation_dataset: Optional[PhonemeDataset]
    train_lengths: Optional[np.ndarray] = None
    validation_lengths: Optional[np.ndarray] = None
    length_multiple: int = TRAIN_LENGTH_MULTIPLE
    label_multiple: int = TRAIN_LABEL_MULTIPLE
    # None -> one prefetch thread builds host arrays; 0 -> synchronous.
    data_workers: Optional[int] = None

    @property
    def attribute_indexer(self) -> PhoneticAttributeIndexer:
        return self.processor.attribute_indexer

    @property
    def feature_size(self) -> int:
        return self.processor.feature_size

    @property
    def split_batch_size(self) -> int:
        """Per-microbatch size: the configured batch budget divided by the
        accumulation factor (reference estimator.py:252-256)."""
        architecture = self.config.nn
        split = architecture.batch_size // max(architecture.accumulation_factor, 1)
        return max(split, 1)

    def attribute_graph(self) -> AttributeGraph:
        from allophant_tpu_torch.models.allophant import attribute_graph_from_config

        return attribute_graph_from_config(self.config, self.attribute_indexer)

    def _batcher(self) -> Batcher:
        architecture = self.config.nn
        return Batcher(
            self.split_batch_size,
            architecture.batching_mode,
            architecture.language_oversampling_factor,
            data_workers=self.data_workers,
            length_multiple=self.length_multiple,
            label_multiple=self.label_multiple,
        )

    def training_batches(self, seed: Optional[int] = None, skip_batches: int = 0, process_shard=None):
        """The training batches of an epoch; with ``process_shard=(index,
        count)`` this process's rows of each (``Batcher.batches``)."""
        return self._batcher().batches(
            self.train_dataset,
            self.train_lengths,
            shuffle=True,
            seed=self.config.nn.seed if seed is None else seed,
            skip_batches=skip_batches,
            process_shard=process_shard,
        )

    def validation_batches(self, process_shard=None):
        if self.validation_dataset is None:
            return iter(())
        batcher = Batcher(
            self.split_batch_size,
            self.config.nn.batching_mode,
            data_workers=self.data_workers,
            length_multiple=self.length_multiple,
            label_multiple=self.label_multiple,
        )
        return batcher.batches(self.validation_dataset, self.validation_lengths, process_shard=process_shard)

    @classmethod
    def from_config(
        cls,
        config: Config,
        splits: MultilingualSplits,
        attribute_indexer: PhoneticAttributeIndexer,
        sample_rate: int = 16_000,
        train_features=None,
        validation_features=None,
        train_lengths: Optional[np.ndarray] = None,
        validation_lengths: Optional[np.ndarray] = None,
        length_multiple: int | None = None,
        label_multiple: int = TRAIN_LABEL_MULTIPLE,
        data_workers: Optional[int] = None,
    ) -> "DatasetManager":
        processor = SamplesProcessor.from_config(config, sample_rate, attribute_indexer)

        def build(corpus: MultilingualCorpus, features, inventories=None):
            if not len(corpus):
                return None
            if corpus.UTTERANCE_TYPE == "phonetically-segmented":
                return PhoneticallySegmentedDataset(
                    BatchType.INDEXED, corpus, processor, 1, features, inventories
                )
            return TranscribedDataset(
                BatchType.INDEXED, corpus, processor, 1, features, inventories
            )

        train_dataset = build(splits.train, train_features)
        if train_dataset is None:
            raise ValueError("Training split is empty")
        # Dev labels are filtered to the training vocabulary so CTC targets stay in
        # range (reference estimator.py:322-330).
        train_phonemes = set(attribute_indexer.attributes.phonemes)
        dev_inventories = {
            splits.dev.language_id(language): train_phonemes for language in splits.dev.languages
        } or None
        validation_dataset = build(splits.dev, validation_features, dev_inventories)

        if length_multiple is None:
            length_multiple = default_length_multiple(config)

        if train_lengths is None:
            train_lengths = _maybe_lengths(splits.train)
        if validation_lengths is None and validation_dataset is not None:
            validation_lengths = _maybe_lengths(splits.dev)

        return cls(
            config,
            splits,
            processor,
            train_dataset,
            validation_dataset,
            train_lengths,
            validation_lengths,
            length_multiple,
            label_multiple,
            data_workers,
        )


def _maybe_lengths(corpus: MultilingualCorpus) -> Optional[np.ndarray]:
    """Per-utterance frame lengths if the corpus can provide them cheaply (audio
    header probing), required for frame-budget batching."""
    reader = getattr(corpus, "read_lengths", None)
    if reader is None:
        return None
    try:
        lengths: List[int] = []
        for _language, generator in reader():
            lengths.extend(generator)
        return np.asarray(lengths, dtype=np.int64)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Microbatch stacking
# ---------------------------------------------------------------------------


def batch_to_arrays(batch: LabeledBatch) -> Dict[str, np.ndarray]:
    """Flattens a labeled batch into the dict layout the train step consumes.

    Filler rows (batch padding for even sharding) are marked by length 0; they
    become zero ``row_weights`` so they contribute nothing to any loss, and their
    lengths are clamped to 1 to keep the masking math valid."""
    lengths = np.asarray(batch.lengths, dtype=np.int32)
    arrays: Dict[str, np.ndarray] = {
        "audio": np.asarray(batch.audio_features, dtype=np.float32),
        "lengths": np.maximum(lengths, 1),
        "language_ids": np.asarray(batch.language_ids, dtype=np.int32),
        "row_weights": (lengths > 0).astype(np.float32),
    }
    for name, labels in batch.attribute_indices.items():
        arrays[f"labels_{name}"] = np.asarray(labels, dtype=np.int32)
        arrays[f"label_lengths_{name}"] = np.asarray(batch.label_lengths[name], dtype=np.int32)
    return arrays


def stack_microbatches(batches: List[LabeledBatch]) -> Dict[str, np.ndarray]:
    """Stacks an accumulation group on a leading axis, padding members to the group
    maximum along batch/time/label axes (bucketing makes shapes mostly equal)."""
    dicts = [batch_to_arrays(batch) for batch in batches]
    keys = dicts[0].keys()
    stacked: Dict[str, np.ndarray] = {}
    for key in keys:
        arrays = [entry[key] for entry in dicts]
        target_shape = tuple(
            max(array.shape[axis] for array in arrays) for axis in range(arrays[0].ndim)
        )
        padded = []
        for array in arrays:
            if array.shape != target_shape:
                widths = [(0, target - size) for size, target in zip(array.shape, target_shape)]
                array = np.pad(array, widths)
            padded.append(array)
        stacked[key] = np.stack(padded)
    # Rows created by batch-axis padding arrive with zeros everywhere: their
    # row_weights stay 0 (np.pad) so they carry no loss, and their lengths are
    # clamped so downstream masking math stays valid.
    stacked["lengths"] = np.maximum(stacked["lengths"], 1)
    return stacked


def _group(iterator: Iterator, size: int, drop_last: bool) -> Iterator[List]:
    group: List = []
    for item in iterator:
        group.append(item)
        if len(group) == size:
            yield group
            group = []
    if group and not drop_last:
        yield group


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


class _StackSampler:
    """Sampling profiler for the main thread: collapsed-stack output compatible
    with flamegraph.pl / speedscope (the analogue of the reference's
    ``export_stacks(path, "self_cpu_time_total")``, estimator.py:405-418)."""

    def __init__(self, interval_seconds: float = 0.005) -> None:
        import threading

        self._interval = interval_seconds
        self._counts: Dict[str, int] = {}
        self._stop_event = threading.Event()
        self._target = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import sys

        while not self._stop_event.wait(self._interval):
            frame = sys._current_frames().get(self._target)
            if frame is None:
                continue
            stack = []
            while frame is not None:
                code = frame.f_code
                stack.append(f"{code.co_name} ({code.co_filename}:{frame.f_lineno})")
                frame = frame.f_back
            key = ";".join(reversed(stack))
            self._counts[key] = self._counts.get(key, 0) + 1

    def write(self, path: str) -> None:
        self._stop_event.set()
        self._thread.join(timeout=1.0)
        with open(path, "w", encoding="utf-8") as file:
            for stack, count in sorted(self._counts.items()):
                file.write(f"{stack} {count}\n")


class StepProfiler:
    """Profiling over a window of steps with ``torch.profiler`` and the
    reference's schedule (wait 1, warmup 2, active ``active_steps``, repeated
    ``repeat`` times; reference estimator.py:405-418, 829-842): the device and
    host trace into ``tensorboard_dir`` (TensorBoard's trace handler) and the
    device stacks (self CUDA time) at ``flame_graph_path_gpu``; a sampled
    host flame graph in collapsed-stack format at ``flame_graph_path_cpu``.

    While the profiler runs, the port's spans are on (``tracing.py``): the
    profiler keeps those of the steps it records."""

    WAIT_STEPS, WARMUP_STEPS = 1, 2

    def __init__(self, config: Optional[ProfilingConfig]) -> None:
        self._config = config
        self._profiler = None
        self._sampler: Optional[_StackSampler] = None
        self._tracing = contextlib.ExitStack()
        if config is None or not (config.tensorboard_dir or config.flame_graph_path_cpu or config.flame_graph_path_gpu):
            return
        if config.tensorboard_dir or config.flame_graph_path_gpu:
            from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(
                activities=activities,
                schedule=schedule(
                    wait=self.WAIT_STEPS, warmup=self.WARMUP_STEPS, active=max(config.active_steps, 1), repeat=config.repeat
                ),
                on_trace_ready=tensorboard_trace_handler(config.tensorboard_dir) if config.tensorboard_dir else None,
                record_shapes=config.record_shapes,
                profile_memory=config.profile_memory,
                with_stack=bool(config.flame_graph_path_gpu),
            )
            self._profiler.start()
            self._tracing.enter_context(tracing.recording())
        if config.flame_graph_path_cpu:
            self._sampler = _StackSampler()

    def step(self, global_step: int) -> None:
        """Marks the end of a training step."""
        if self._profiler is not None:
            self._profiler.step()

    def stop(self) -> None:
        if self._profiler is not None:
            self._tracing.close()
            self._profiler.stop()
            if self._config.flame_graph_path_gpu:
                self._profiler.export_stacks(self._config.flame_graph_path_gpu, "self_cuda_time_total")
            self._profiler = None
        if self._sampler is not None:
            self._sampler.write(self._config.flame_graph_path_cpu)
            self._sampler = None


class MetricsLogger:
    """Optional TensorBoard logging (reference estimator.py:521-565); needs the
    ``tensorboard`` package only when a log directory is given."""

    def __init__(self, log_dir: Optional[str]) -> None:
        self._writer = None
        if log_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)

    def log_step(self, step: int, metrics: Dict[str, float], prefix: str = "training") -> None:
        if self._writer is None:
            return
        for name, value in metrics.items():
            self._writer.add_scalar(f"{prefix}/{name}", value, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


# ---------------------------------------------------------------------------
# Training run
# ---------------------------------------------------------------------------


def _unpack_training_state(data: bytes) -> Dict[str, Any]:
    """Decodes the bundled training state written by
    ``TrainingRun.serialized_training_state``."""
    decoded = msgpack_codec.unpackb(data)
    if not isinstance(decoded, dict) or decoded.get("format") != 1:
        raise ValueError("Not a training state written by the port")
    return decoded


def microbatches_to_device(microbatches: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The stacked host arrays as tensors on ``device`` (the one host-to-device
    copy of a step, on the caller's thread)."""
    return {key: torch.from_numpy(value).to(device, non_blocking=True) for key, value in microbatches.items()}


class TrainingRun:
    """Iterable training loop yielding `(TrainingStatus, EpochStatistics)` at every
    validation point (each `step_size` updates if configured, else per epoch), with
    a trailing `(FINISHED | EARLY_STOPPED, stats)` (reference estimator.py:800-928).

    Updates the estimator's model in place, so callers can checkpoint between
    yields exactly like the reference CLI does."""

    def __init__(
        self,
        estimator,
        dataset_manager: DatasetManager,
        tensorboard_dir: Optional[str] = None,
        skip_batches: int = 0,
        training_state: Optional[bytes] = None,
        show_progress: bool = False,
    ) -> None:
        self._show_progress = show_progress
        self._estimator = estimator
        self._manager = dataset_manager
        self._config = estimator.config
        architecture = self._config.nn
        self._accumulation = max(architecture.accumulation_factor, 1)
        self._skip_batches = skip_batches
        self._device = estimator.device
        mesh = estimator.mesh
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None

        model = estimator.model
        if self._mesh is not None:
            replicate(model, self._mesh)
        self._names = [name for name, _parameter in model.named_parameters()]
        d_model = int(model.architecture.hidden_size)
        self._optimizer = create_optimizer(architecture, d_model, model.parameters())
        loss_plan = build_loss_plan(architecture, model.plan.allophone_shape is not None)
        self._train_step = make_train_step(
            model, self._optimizer, loss_plan, build_freeze_plan(architecture.acoustic_model), self._mesh
        )
        # Label ids each head takes (the allophone head's are the pooled
        # phonemes): an id outside them would index past the CTC input.
        self._label_limits = {
            node.name: model.plan.allophone_shape[2] if node.has_allophone else node.output_size
            for node in model.plan.nodes
        }
        self._eval_step = make_eval_step(model, loss_plan, self._mesh)
        self._lr_schedule = self._optimizer.learning_rate if architecture.lr_schedule else None

        self.early_stopping = EarlyStopping(architecture.early_stopping_patience)
        self.global_step = int(estimator.epoch.global_step or 0)
        self._profiler: Optional[StepProfiler] = None
        self._metrics: Optional[MetricsLogger] = None
        self._tensorboard_dir = tensorboard_dir
        self._stop_requested = False
        self._epoch_batches = 0
        if training_state is not None:
            restored = _unpack_training_state(training_state)
            self._load_optimizer(restored["optimizer"])
            early_stopping_state = restored.get("early_stopping")
            if early_stopping_state is not None:
                self.early_stopping.load_state_dict(early_stopping_state)

    def request_stop(self) -> None:
        """Asks the loop to stop at the next step boundary (async-signal safe:
        only sets a flag). The generator then yields one final
        ``(INTERRUPTED, statistics)``, with every piece of resumable state
        synced to the estimator, and returns."""
        self._stop_requested = True

    def _data_shard(self):
        """(data rank, data ranks) for ``Batcher.batches``, or None on one."""
        mesh = self._mesh
        return None if mesh is None or mesh.data_parallel == 1 else (mesh.data_rank, mesh.data_parallel)

    def _map_moments(self, state: Dict[str, Any], convert) -> Dict[str, Any]:
        """``state`` (an optimizer ``state_dict``) with each parameter's
        moments ``convert(name, tensor)``; scalars as they are."""
        moments = {
            index: {
                key: convert(self._names[index], value) if isinstance(value, torch.Tensor) and value.ndim else value
                for key, value in entry.items()
            }
            for index, entry in state["state"].items()
        }
        return {**state, "state": moments}

    def _optimizer_bytes(self) -> bytes:
        """The optimizer's state in torch's serialization, its moments whole
        (gathered over the model group: every rank calls it)."""
        state = self._optimizer.optimizer.state_dict()
        mesh = self._mesh
        if mesh is not None and mesh.model_parallel > 1:
            state = self._map_moments(state, lambda name, value: gather_state({name: value}, mesh)[name])
        buffer = io.BytesIO()
        torch.save({"count": self._optimizer.count, "state": state}, buffer)
        return buffer.getvalue()

    def _load_optimizer(self, data: bytes) -> None:
        saved = torch.load(io.BytesIO(data), map_location=self._device, weights_only=True)
        mesh = self._mesh
        if mesh is not None and mesh.model_parallel > 1:
            saved["state"] = self._map_moments(
                saved["state"],
                lambda name, value: shard_tensor(value, param_spec(name), mesh.model_rank, mesh.model_parallel).to(value.device),
            )
        try:
            self._optimizer.optimizer.load_state_dict(saved["state"])
        except (KeyError, ValueError) as error:
            raise ValueError(
                "Checkpoint optimizer state does not match the configured optimizer; resume with the same"
                f" optimizer/schedule config ({error})"
            ) from error
        self._optimizer.count = int(saved["count"])

    def serialized_training_state(self) -> bytes:
        """The optimizer's state (its moments and update count, in torch's
        serialization) and the early-stopping progress, bundled for
        ``Estimator.save(optimizer_state=...)`` and ``Estimator.training_state``."""
        return msgpack_codec.packb(
            {"format": 1, "optimizer": self._optimizer_bytes(), "early_stopping": self.early_stopping.state_dict()}
        )

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Checks the host arrays' labels against their heads, then copies
        them to the device."""
        for name, limit in self._label_limits.items():
            labels = arrays.get(f"labels_{name}")
            if labels is not None and labels.size and (labels.min() < 0 or labels.max() >= limit):
                raise ValueError(f"Labels of head {name!r} lie outside its {limit} classes")
        return microbatches_to_device(arrays, self._device)

    def _validate(self) -> Optional[_MeanAccumulator]:
        if self._manager.validation_dataset is None:
            return None
        accumulator = _MeanAccumulator()
        batches = progress_bar(
            self._manager.validation_batches(self._data_shard()),
            enabled=self._show_progress, desc="validation", unit="batch", leave=False,
        )
        for batch in batches:
            accumulator.add(self._eval_step(self._to_device(batch_to_arrays(batch))))
        return accumulator

    def __iter__(self) -> Iterator[Tuple[TrainingStatus, EpochStatistics]]:
        architecture = self._config.nn
        set_float32_precision(self._estimator.f32_matmul_precision)
        self._profiler = StepProfiler(self._config.profiling)
        self._metrics = MetricsLogger(self._tensorboard_dir)
        seed = architecture.seed or 0
        step_size = architecture.step_size
        maximum_iterations = architecture.maximum_iterations

        epoch = int(self._estimator.epoch.epoch or 0)
        # Mid-epoch resume skips batches only in the epoch the checkpoint was
        # taken in (a snapshot: epoch.epoch advances at every epoch's end).
        resume_epoch = epoch
        stopped = False
        final_status = TrainingStatus.FINISHED

        try:
            while not stopped and (maximum_iterations is None or epoch < maximum_iterations):
                epoch_started = time.perf_counter()
                window = _MeanAccumulator()
                window_batches = 0
                window_utterances = 0
                last_grad_norm = None
                skip = self._skip_batches if epoch == resume_epoch else 0
                self._epoch_batches = skip
                groups = _group(
                    self._manager.training_batches(seed=seed + epoch, skip_batches=skip, process_shard=self._data_shard()),
                    self._accumulation,
                    drop_last=True,
                )
                progress = progress_bar(enabled=self._show_progress, desc=f"epoch {epoch}", unit="step")
                for group in groups:
                    microbatches = self._to_device(stack_microbatches(group))
                    rng = DropoutRng.for_mesh(seed + self.global_step, self._device, self._mesh)
                    utterances = sum(len(batch) for batch in group)
                    if self._mesh is None:
                        host_metrics = self._train_step(microbatches, rng, self.global_step)
                    else:
                        # Every rank stops after the same step: its stop flag
                        # and its real rows (filler rows have length 0) are
                        # summed with the step's metrics.
                        utterances = sum(int((np.asarray(batch.lengths) > 0).sum()) for batch in group)
                        host_metrics = self._train_step(
                            microbatches, rng, self.global_step, (float(self._stop_requested), float(utterances))
                        )
                        stop, utterances = host_metrics.pop("extra")
                        self._stop_requested = stop > 0
                    self.global_step += 1
                    window.add(host_metrics)
                    last_grad_norm = host_metrics.get("grad_norm")
                    window_batches += len(group)
                    window_utterances += int(utterances)
                    self._epoch_batches += len(group)
                    progress.update(1)
                    progress.set_postfix(step=self.global_step, loss=f"{host_metrics['mean_loss']:.4f}", refresh=False)
                    self._profiler.step(self.global_step)
                    self._metrics.log_step(
                        self.global_step,
                        {
                            "loss": host_metrics["mean_loss"],
                            "gradient_norm": host_metrics["grad_norm"],
                            **({"learning_rate": self._lr_schedule(self.global_step - 1)} if self._lr_schedule else {}),
                        },
                    )

                    if self._stop_requested:
                        progress.close()
                        status, statistics, _ = self._validation_point(
                            epoch, window, window_batches, window_utterances, last_grad_norm, epoch_started,
                            TrainingStatus.INTERRUPTED, validate=False,
                        )
                        # Ends the batch generator now: a pool of batch
                        # workers is terminated before the caller saves.
                        groups.close()
                        yield status, statistics
                        return

                    if step_size is not None and self.global_step % step_size == 0:
                        progress.close()
                        status, statistics, stopped = self._validation_point(
                            epoch, window, window_batches, window_utterances, last_grad_norm, epoch_started,
                            TrainingStatus.STEP,
                        )
                        yield status, statistics
                        if stopped:
                            final_status = TrainingStatus.EARLY_STOPPED
                            break
                        progress = progress_bar(enabled=self._show_progress, desc=f"epoch {epoch}", unit="step")
                        window = _MeanAccumulator()
                        window_batches = 0
                        window_utterances = 0
                        epoch_started = time.perf_counter()

                progress.close()
                if stopped:
                    break
                epoch += 1
                self._estimator.epoch.epoch = epoch
                # A finished epoch leaves no batches to skip on resume.
                self._epoch_batches = 0
                self._estimator.epoch.step = 0
                if step_size is None:
                    status, statistics, stopped = self._validation_point(
                        epoch, window, window_batches, window_utterances, last_grad_norm, epoch_started,
                        TrainingStatus.EPOCH,
                    )
                    yield status, statistics
                    if stopped:
                        final_status = TrainingStatus.EARLY_STOPPED
                        break
        finally:
            # Runs on normal completion too (before the yield below).
            self._profiler.stop()
            self._metrics.close()

        yield final_status, EpochStatistics(epoch, self.global_step, 0.0, {}, validation_loss=self.early_stopping.best_loss)

    def _validation_point(
        self,
        epoch: int,
        window: _MeanAccumulator,
        window_batches: int,
        window_utterances: int,
        last_grad_norm: Optional[float],
        window_started: float,
        base_status: TrainingStatus,
        validate: bool = True,
    ) -> Tuple[TrainingStatus, EpochStatistics, bool]:
        # Interrupt points (graceful preemption) sync state without paying for a
        # validation pass: the preemption grace window may be seconds.
        validation = self._validate() if validate else None
        validation_loss = None if validation is None else validation.mean_loss
        improved = validation_loss is not None and self.early_stopping.update(validation_loss)
        if validation_loss is not None:
            self._metrics.log_step(self.global_step, {"loss": validation_loss}, prefix="validation")

        statistics = EpochStatistics(
            epoch=epoch,
            global_step=self.global_step,
            train_loss=window.mean_loss,
            classifier_losses=window.head_means(),
            validation_loss=validation_loss,
            validation_classifier_losses=None if validation is None else validation.head_means(),
            learning_rate=self._lr_schedule(self.global_step - 1) if self._lr_schedule else None,
            gradient_norm=last_grad_norm,
            batch_count=window_batches,
            utterance_count=window_utterances,
            duration_seconds=time.perf_counter() - window_started,
        )
        self._estimator.epoch.global_step = self.global_step
        # Batches consumed in the current epoch: lets a restored run resume
        # mid-epoch by skipping them.
        self._estimator.epoch.step = self._epoch_batches
        self._estimator.history.append(dataclasses.asdict(statistics))

        status = TrainingStatus.IMPROVED if improved else base_status
        return status, statistics, self.early_stopping.should_stop
