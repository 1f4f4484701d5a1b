"""Configuration schema: model architecture, preprocessing, data and profiling
(the port's copy of ``allophant_tpu/config.py``, one schema for every part of
the port).

The serialized dict shapes (tagged unions keyed by "type"/"algorithm"/
"architecture", enums by value except ``FeatureType``, which serializes by
name) are the JAX package's, so ``Config.load(d).dump()`` of the port and of
the JAX package give equal dicts, and a checkpoint embeds its config in that
shape. Plain dataclasses and ``tomllib``; the optimizers themselves are built
by ``training/train_step.create_optimizer``."""

from __future__ import annotations

import dataclasses
import json
import re
import tomllib
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, ClassVar, Dict, List, Optional, Pattern, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Learning rate schedule
# ---------------------------------------------------------------------------


@dataclass
class WarmupConfig:
    """Noam warmup with an added constant plateau before decay (reference
    config.py:139-160): ``factor * d_model**-0.5 * phase(step)`` with phases
    warmup -> constant -> inverse-sqrt decay. Step counting starts at 1."""

    TYPE: ClassVar[str] = "warmup"

    warmup_steps: int
    constant_steps: int = 0
    factor: int = 2

    def learning_rate(self, step: int, model_size: int) -> float:
        scale = self.factor * model_size**-0.5
        if step < self.warmup_steps:
            return scale * step * self.warmup_steps**-1.5
        if step < self.warmup_steps + self.constant_steps:
            return scale * self.warmup_steps**-0.5
        return scale * (step - self.constant_steps) ** -0.5

    def schedule(self, model_size: int) -> Callable[[int], float]:
        """The learning rate as a function of the update count (0-based: count
        0 is step 1), in f32 arithmetic as the JAX (optax) schedule computes
        it."""
        scale = np.float32(self.factor * model_size**-0.5)
        warmup_rate = np.float32(self.warmup_steps**-1.5)
        plateau = np.float32(self.warmup_steps**-0.5)

        def schedule_fn(count: int) -> float:
            step = count + 1
            if step < self.warmup_steps:
                phase = np.float32(step) * warmup_rate
            elif step < self.warmup_steps + self.constant_steps:
                phase = plateau
            else:
                phase = np.float32(max(step - self.constant_steps, 1)) ** np.float32(-0.5)
            return float(scale * phase)

        return schedule_fn

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.TYPE,
            "warmup_steps": self.warmup_steps,
            "constant_steps": self.constant_steps,
            "factor": self.factor,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "WarmupConfig":
        return cls(
            int(data["warmup_steps"]), int(data.get("constant_steps", 0)), int(data.get("factor", 2))
        )


LrSchedulerConfig = WarmupConfig


def _lr_schedule_from_dict(data: Dict[str, Any] | None) -> Optional[LrSchedulerConfig]:
    if data is None:
        return None
    if data.get("type") != WarmupConfig.TYPE:
        raise ValueError(f"Unknown lr schedule type: {data.get('type')!r}")
    return WarmupConfig.from_dict(data)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@dataclass
class SGD:
    TYPE: ClassVar[str] = "sgd"

    learning_rate: float
    l2_regularization: float = 0
    momentum: float = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "algorithm": self.TYPE,
            "learning_rate": self.learning_rate,
            "l2_regularization": self.l2_regularization,
            "momentum": self.momentum,
        }


@dataclass
class Adam:
    """Adam with *coupled* L2 (``l2_regularization`` added to the gradient
    before the moments: torch ``optim.Adam(weight_decay=...)``, not AdamW)."""

    TYPE: ClassVar[str] = "adam"

    learning_rate: float = 0.01
    l2_regularization: float = 0
    beta_1: float = 0.9
    beta_2: float = 0.98

    def to_dict(self) -> Dict[str, Any]:
        return {
            "algorithm": self.TYPE,
            "learning_rate": self.learning_rate,
            "l2_regularization": self.l2_regularization,
            "beta_1": self.beta_1,
            "beta_2": self.beta_2,
        }


Optimizer = Union[SGD, Adam]

_OPTIMIZERS = {SGD.TYPE: SGD, Adam.TYPE: Adam}


def _optimizer_from_dict(data: Dict[str, Any]) -> Optimizer:
    algorithm = data.get("algorithm")
    if algorithm not in _OPTIMIZERS:
        raise ValueError(f"Unknown optimizer algorithm: {algorithm!r}")
    cls = _OPTIMIZERS[algorithm]
    kwargs = {key: value for key, value in data.items() if key != "algorithm"}
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@dataclass
class CTCLossConfig:
    TYPE: ClassVar[str] = "CTC"
    # Offset reserving index 0 for the CTC blank label.
    BLANK_OFFSET: ClassVar[int] = 1

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.TYPE}


@dataclass
class SequenceCrossEntropyLossConfig:
    TYPE: ClassVar[str] = "sequence-cross-entropy"
    BLANK_OFFSET: ClassVar[int] = 0

    label_smoothing: float = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.TYPE, "label_smoothing": self.label_smoothing}


ClassifierLossConfig = Union[CTCLossConfig, SequenceCrossEntropyLossConfig]


def _loss_from_dict(data: Dict[str, Any]) -> ClassifierLossConfig:
    loss_type = data.get("type")
    if loss_type == CTCLossConfig.TYPE:
        return CTCLossConfig()
    if loss_type == SequenceCrossEntropyLossConfig.TYPE:
        return SequenceCrossEntropyLossConfig(float(data.get("label_smoothing", 0)))
    raise ValueError(f"Unknown loss type: {loss_type!r}")


# ---------------------------------------------------------------------------
# Projection (hierarchical classifier) configuration
# ---------------------------------------------------------------------------


@dataclass
class MultiheadAttentionConfig:
    TYPE: ClassVar[str] = "multi-head-attention"

    num_heads: int = 1
    positional_embeddings: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.TYPE,
            "num_heads": self.num_heads,
            "positional_embeddings": self.positional_embeddings,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None) -> Optional["MultiheadAttentionConfig"]:
        if data is None:
            return None
        return cls(int(data.get("num_heads", 1)), bool(data.get("positional_embeddings", False)))


@dataclass
class ProjectionEntryConfig:
    """One classifier node: name, dependency names ("OUTPUT"/"OUTPUT_<i>" taps the
    acoustic model), optional attention time layer, and loss."""

    OUTPUT_DEPENDENCY: ClassVar[str] = "OUTPUT"
    OUTPUT_PATTERN: ClassVar[Pattern] = re.compile(r"^OUTPUT(?:_(\d+))?$")
    PHONEME_LAYER: ClassVar[str] = "phoneme"
    PHONE: ClassVar[str] = "phone"

    name: str
    dependencies: List[str] = field(default_factory=lambda: [ProjectionEntryConfig.OUTPUT_DEPENDENCY])
    time_layer: Optional[MultiheadAttentionConfig] = None
    loss: ClassifierLossConfig = field(default_factory=CTCLossConfig)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dependencies": list(self.dependencies),
            "time_layer": None if self.time_layer is None else self.time_layer.to_dict(),
            "loss": self.loss.to_dict(),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ProjectionEntryConfig":
        return cls(
            data["name"],
            list(data.get("dependencies", [cls.OUTPUT_DEPENDENCY])),
            MultiheadAttentionConfig.from_dict(data.get("time_layer")),
            _loss_from_dict(data["loss"]) if data.get("loss") is not None else CTCLossConfig(),
        )


class PhonemeLayerType(Enum):
    SHARED = "shared"
    PRIVATE = "private"
    ALLOPHONES = "allophones"


@dataclass
class EmbeddingCompositionConfig:
    embedding_size: int

    def to_dict(self) -> Dict[str, Any]:
        return {"embedding_size": self.embedding_size}


@dataclass
class ProjectionConfig:
    classes: List[ProjectionEntryConfig]
    feature_set: str = "phoible"
    phoneme_layer: PhonemeLayerType = PhonemeLayerType.SHARED
    acoustic_model_dropout: float = 0
    dependency_blanks: bool = True
    # Same default alpha as Li et al. (2020), "Universal Phone Recognition with a
    # Multilingual Allophone System".
    allophone_l2_alpha: float = 10
    embedding_composition: Optional[EmbeddingCompositionConfig] = None

    def loss_configs(self) -> Dict[str, ClassifierLossConfig]:
        return {classifier.name: classifier.loss for classifier in self.classes}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "classes": [entry.to_dict() for entry in self.classes],
            "feature_set": self.feature_set,
            "phoneme_layer": self.phoneme_layer.value,
            "acoustic_model_dropout": self.acoustic_model_dropout,
            "dependency_blanks": self.dependency_blanks,
            "allophone_l2_alpha": self.allophone_l2_alpha,
            "embedding_composition": None
            if self.embedding_composition is None
            else self.embedding_composition.to_dict(),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ProjectionConfig":
        composition = data.get("embedding_composition")
        return cls(
            [ProjectionEntryConfig.from_dict(entry) for entry in data["classes"]],
            data.get("feature_set", "phoible"),
            PhonemeLayerType(data.get("phoneme_layer", "shared")),
            float(data.get("acoustic_model_dropout", 0)),
            bool(data.get("dependency_blanks", True)),
            float(data.get("allophone_l2_alpha", 10)),
            None if composition is None else EmbeddingCompositionConfig(int(composition["embedding_size"])),
        )


# ---------------------------------------------------------------------------
# Acoustic model configurations
# ---------------------------------------------------------------------------


@dataclass
class DirectFrontendConfig:
    TYPE: ClassVar[str] = "direct"

    input_dropout: float = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"architecture": self.TYPE, "input_dropout": self.input_dropout}


@dataclass
class LinearFrontendConfig:
    TYPE: ClassVar[str] = "linear"

    neurons: int
    input_dropout: float = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"architecture": self.TYPE, "neurons": self.neurons, "input_dropout": self.input_dropout}


FrontendConfig = Union[DirectFrontendConfig, LinearFrontendConfig]


def _frontend_from_dict(data: Dict[str, Any]) -> FrontendConfig:
    architecture = data.get("architecture")
    if architecture == DirectFrontendConfig.TYPE:
        return DirectFrontendConfig(float(data.get("input_dropout", 0)))
    if architecture == LinearFrontendConfig.TYPE:
        return LinearFrontendConfig(int(data["neurons"]), float(data.get("input_dropout", 0)))
    raise ValueError(f"Unknown frontend architecture: {architecture!r}")


@dataclass
class DropoutConfig:
    TYPE: ClassVar[str] = "dropout"
    rate: float = 0

    def to_dict(self):
        return {"type": self.TYPE, "rate": self.rate}


@dataclass
class LayerNormConfig:
    TYPE: ClassVar[str] = "layer_norm"
    affine: bool = False

    def to_dict(self):
        return {"type": self.TYPE, "affine": self.affine}


@dataclass
class Glu1dConfig:
    TYPE: ClassVar[str] = "glu1d"
    out_channels: int
    kernel: int
    stride: int = 1

    def to_dict(self):
        return {"type": self.TYPE, "out_channels": self.out_channels, "kernel": self.kernel, "stride": self.stride}


@dataclass
class MaxPoolingConfig:
    TYPE: ClassVar[str] = "max_pool"
    size: int

    def to_dict(self):
        return {"type": self.TYPE, "size": self.size}


Layer = Union[Glu1dConfig, MaxPoolingConfig, DropoutConfig, LayerNormConfig]

_LAYER_TYPES = {
    Glu1dConfig.TYPE: Glu1dConfig,
    MaxPoolingConfig.TYPE: MaxPoolingConfig,
    DropoutConfig.TYPE: DropoutConfig,
    LayerNormConfig.TYPE: LayerNormConfig,
}


def _layer_from_dict(data: Dict[str, Any]) -> Layer:
    layer_type = data.get("type")
    if layer_type not in _LAYER_TYPES:
        raise ValueError(f"Unknown layer type: {layer_type!r}")
    kwargs = {key: value for key, value in data.items() if key != "type"}
    return _LAYER_TYPES[layer_type](**kwargs)


@dataclass
class SequentialFrontendConfig:
    layers: List[Layer]

    def to_dict(self):
        return {"layers": [layer.to_dict() for layer in self.layers]}

    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None):
        if data is None:
            return None
        return cls([_layer_from_dict(layer) for layer in data["layers"]])


@dataclass
class TransformerConfig:
    feedforward_neurons: int
    heads: int
    activation: str = "relu"
    num_layers: int = 1
    dropout_rate: float = 0
    positional_embeddings: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TransformerConfig":
        return cls(
            int(data["feedforward_neurons"]),
            int(data["heads"]),
            data.get("activation", "relu"),
            int(data.get("num_layers", 1)),
            float(data.get("dropout_rate", 0)),
            bool(data.get("positional_embeddings", True)),
        )


@dataclass
class TransformerAcousticModelConfig:
    TYPE: ClassVar[str] = "pre-ln-transformer"

    transformer: TransformerConfig
    frontend: FrontendConfig
    sequential_frontend: Optional[SequentialFrontendConfig] = None
    elementwise_affine: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.TYPE,
            "transformer": self.transformer.to_dict(),
            "frontend": self.frontend.to_dict(),
            "sequential_frontend": None
            if self.sequential_frontend is None
            else self.sequential_frontend.to_dict(),
            "elementwise_affine": self.elementwise_affine,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TransformerAcousticModelConfig":
        return cls(
            TransformerConfig.from_dict(data["transformer"]),
            _frontend_from_dict(data["frontend"]),
            SequentialFrontendConfig.from_dict(data.get("sequential_frontend")),
            bool(data.get("elementwise_affine", False)),
        )


@dataclass
class Wav2Vec2Config:
    TYPE: ClassVar[str] = "wav2vec2"

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.TYPE}


@dataclass
class UnfreezeScheduleConfig:
    feature_encoder_steps: Optional[int] = None
    feature_projection_steps: Optional[int] = None
    encoder_steps: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None):
        if data is None:
            return None
        return cls(
            data.get("feature_encoder_steps"),
            data.get("feature_projection_steps"),
            data.get("encoder_steps"),
        )


@dataclass
class Wav2Vec2PretrainedConfig:
    TYPE: ClassVar[str] = "wav2vec2-pretrained"

    model_id: str
    freeze_feature_encoder: bool = True
    freeze_feature_projection: bool = False
    freeze_encoder: bool = False
    unfreeze_schedule: Optional[UnfreezeScheduleConfig] = None

    def freeze_groups(self) -> Tuple[Tuple[str, bool, Optional[int]], ...]:
        """(params subtree, freeze flag, thaw step or None) per freezable group,
        in forward-chain order feature_extractor -> feature_projection ->
        encoder. Single source for both gradient masking
        (``training/train_step.py:build_freeze_plan``) and the no-grad prefix
        (``whole_run_frozen_prefix``) — the two must agree, or the no-grad
        prefix would silently zero gradients the freeze plan considers
        trainable."""
        schedule = self.unfreeze_schedule
        return (
            (
                "feature_extractor",
                self.freeze_feature_encoder,
                None if schedule is None else schedule.feature_encoder_steps,
            ),
            (
                "feature_projection",
                self.freeze_feature_projection,
                None if schedule is None else schedule.feature_projection_steps,
            ),
            (
                "encoder",
                self.freeze_encoder,
                None if schedule is None else schedule.encoder_steps,
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.TYPE,
            "model_id": self.model_id,
            "freeze_feature_encoder": self.freeze_feature_encoder,
            "freeze_feature_projection": self.freeze_feature_projection,
            "freeze_encoder": self.freeze_encoder,
            "unfreeze_schedule": None
            if self.unfreeze_schedule is None
            else self.unfreeze_schedule.to_dict(),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Wav2Vec2PretrainedConfig":
        return cls(
            data["model_id"],
            bool(data.get("freeze_feature_encoder", True)),
            bool(data.get("freeze_feature_projection", False)),
            bool(data.get("freeze_encoder", False)),
            UnfreezeScheduleConfig.from_dict(data.get("unfreeze_schedule")),
        )


AcousticModelConfig = Union[TransformerAcousticModelConfig, Wav2Vec2Config, Wav2Vec2PretrainedConfig]


def whole_run_frozen_prefix(acoustic_model) -> int:
    """Longest prefix of (feature_extractor, feature_projection, encoder) that
    stays frozen for the whole run (flag set, never thawed): the model runs it
    without gradients. Groups a schedule thaws keep their backward and are
    masked by ``apply_freeze_plan`` instead. 0 for other acoustic models."""
    if not isinstance(acoustic_model, Wav2Vec2PretrainedConfig):
        return 0
    prefix = 0
    for _group, frozen, thaw_steps in acoustic_model.freeze_groups():
        if not frozen or thaw_steps is not None:
            break
        prefix += 1
    return prefix


def _acoustic_model_from_dict(data: Dict[str, Any]) -> AcousticModelConfig:
    model_type = data.get("type")
    if model_type == TransformerAcousticModelConfig.TYPE:
        return TransformerAcousticModelConfig.from_dict(data)
    if model_type == Wav2Vec2Config.TYPE:
        return Wav2Vec2Config()
    if model_type == Wav2Vec2PretrainedConfig.TYPE:
        return Wav2Vec2PretrainedConfig.from_dict(data)
    raise ValueError(f"Unknown acoustic model type: {model_type!r}")


# ---------------------------------------------------------------------------
# Architecture / preprocessing / data / profiling / top level
# ---------------------------------------------------------------------------


class BatchingMode(Enum):
    FRAMES = "frames"
    UTTERANCES = "utterances"


@dataclass
class Architecture:
    batch_size: int
    projection: ProjectionConfig
    acoustic_model: AcousticModelConfig
    optimizer: Optimizer
    loss: CTCLossConfig = field(default_factory=CTCLossConfig)
    early_stopping_patience: Optional[int] = None
    batching_mode: BatchingMode = BatchingMode.FRAMES
    language_oversampling_factor: Optional[float] = None
    seed: Optional[int] = None
    maximum_iterations: Optional[int] = None
    clip_norm: Optional[float] = None
    lr_schedule: Optional[LrSchedulerConfig] = None
    accumulation_factor: int = 1
    step_size: Optional[int] = None
    mixed_precision: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batch_size": self.batch_size,
            "projection": self.projection.to_dict(),
            "acoustic_model": self.acoustic_model.to_dict(),
            "optimizer": self.optimizer.to_dict(),
            "loss": self.loss.to_dict(),
            "early_stopping_patience": self.early_stopping_patience,
            "batching_mode": self.batching_mode.value,
            "language_oversampling_factor": self.language_oversampling_factor,
            "seed": self.seed,
            "maximum_iterations": self.maximum_iterations,
            "clip_norm": self.clip_norm,
            "lr_schedule": None if self.lr_schedule is None else self.lr_schedule.to_dict(),
            "accumulation_factor": self.accumulation_factor,
            "step_size": self.step_size,
            "mixed_precision": self.mixed_precision,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Architecture":
        return cls(
            int(data["batch_size"]),
            ProjectionConfig.from_dict(data["projection"]),
            _acoustic_model_from_dict(data["acoustic_model"]),
            _optimizer_from_dict(data["optimizer"]),
            CTCLossConfig() if data.get("loss", {}).get("type", "CTC") == "CTC" else CTCLossConfig(),
            data.get("early_stopping_patience"),
            BatchingMode(data.get("batching_mode", "frames")),
            data.get("language_oversampling_factor"),
            data.get("seed"),
            data.get("maximum_iterations"),
            data.get("clip_norm"),
            _lr_schedule_from_dict(data.get("lr_schedule")),
            int(data.get("accumulation_factor", 1)),
            data.get("step_size"),
            bool(data.get("mixed_precision", False)),
        )


class FeatureType(Enum):
    MFCC = "MFCC"
    FILTERBANKS = "Filterbanks"
    RAW = "raw"


@dataclass
class Window:
    """STFT window parameters in milliseconds."""

    frame_duration: int
    frame_stride: int

    @staticmethod
    def _ms_to_samples(milliseconds: int, sample_rate: int) -> int:
        return int((milliseconds / 1000) * sample_rate)

    def frame_duration_samples(self, sample_rate: int) -> int:
        return self._ms_to_samples(self.frame_duration, sample_rate)

    def frame_stride_samples(self, sample_rate: int) -> int:
        return self._ms_to_samples(self.frame_stride, sample_rate)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class Preprocessing:
    feature_type: FeatureType = FeatureType.RAW
    window: Optional[Window] = None
    resample: Optional[int] = 16_000
    num_filters: int = 40

    def to_dict(self) -> Dict[str, Any]:
        return {
            # FeatureType serializes by *name* in the reference (default EnumField).
            "feature_type": self.feature_type.name,
            "window": None if self.window is None else self.window.to_dict(),
            "resample": self.resample,
            "num_filters": self.num_filters,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Preprocessing":
        window = data.get("window")
        return cls(
            FeatureType[data["feature_type"]] if data.get("feature_type") else FeatureType.RAW,
            None if window is None else Window(int(window["frame_duration"]), int(window["frame_stride"])),
            data.get("resample", 16_000),
            int(data.get("num_filters", 40)),
        )


@dataclass
class DataConfig:
    languages: List[str]
    validation_limits: Dict[str, int] | int | None = None
    only_primary_script: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "DataConfig":
        return cls(
            list(data["languages"]),
            data.get("validation_limits"),
            bool(data.get("only_primary_script", False)),
        )


@dataclass
class ProfilingConfig:
    active_steps: int
    flame_graph_path_gpu: Optional[str] = None
    flame_graph_path_cpu: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    profile_memory: bool = False
    record_shapes: bool = False
    repeat: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None):
        if data is None:
            return None
        return cls(
            int(data["active_steps"]),
            data.get("flame_graph_path_gpu"),
            data.get("flame_graph_path_cpu"),
            data.get("tensorboard_dir"),
            bool(data.get("profile_memory", False)),
            bool(data.get("record_shapes", False)),
            int(data.get("repeat", 1)),
        )


@dataclass
class Config:
    nn: Architecture
    preprocessing: Preprocessing
    data: DataConfig
    profiling: Optional[ProfilingConfig] = None

    @classmethod
    def load(cls, mapping: Dict[str, Any]) -> "Config":
        return cls(
            Architecture.from_dict(mapping["nn"]),
            Preprocessing.from_dict(mapping["preprocessing"]),
            DataConfig.from_dict(mapping["data"]),
            ProfilingConfig.from_dict(mapping.get("profiling")),
        )

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        with open(path, "rb") as file:
            return cls.load(tomllib.load(file))

    @classmethod
    def from_toml_string(cls, text: str) -> "Config":
        return cls.load(tomllib.loads(text))

    @classmethod
    def default(cls) -> "Config":
        """The bundled ``package_data/default_config.toml``."""
        from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH

        return cls.from_toml(DEFAULT_CONFIG_PATH)

    def dump(self) -> Dict[str, Any]:
        return {
            "nn": self.nn.to_dict(),
            "preprocessing": self.preprocessing.to_dict(),
            "data": self.data.to_dict(),
            "profiling": None if self.profiling is None else self.profiling.to_dict(),
        }

    def dumps(self) -> str:
        return json.dumps(self.dump())
