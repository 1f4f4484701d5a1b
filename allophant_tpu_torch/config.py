"""What training reads from the JAX package's configuration schema
(counterpart of the training half of ``allophant_tpu/config.py``): the warmup
schedule, the optimizers, clipping, accumulation, the seed, the allophone L2
weight, the freeze flags and unfreeze schedule, and each class's loss.

``Architecture.from_dict`` reads the ``nn`` section as the JAX config
serialises it (``Architecture.to_dict``), which
``tools/export_torch_flagship_plan.py`` freezes into
``package_data/flagship_plan.json``. The port keeps its own copy of these
dataclasses: it imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class WarmupConfig:
    """Noam warmup with a constant plateau before inverse-sqrt decay:
    ``factor * d_model**-0.5 * phase(step)``, steps counted from 1."""

    warmup_steps: int
    constant_steps: int = 0
    factor: int = 2

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

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "WarmupConfig":
        if data.get("type") != "warmup":
            raise ValueError(f"Unknown lr schedule type: {data.get('type')!r}")
        return cls(int(data["warmup_steps"]), int(data.get("constant_steps", 0)), int(data.get("factor", 2)))


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: float
    l2_regularization: float = 0.0
    momentum: float = 0.0


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with *coupled* L2 (``l2_regularization`` added to the gradient
    before the moments: torch ``optim.Adam(weight_decay=...)``, not AdamW)."""

    learning_rate: float = 0.01
    l2_regularization: float = 0.0
    beta_1: float = 0.9
    beta_2: float = 0.98


Optimizer = Union[SGD, Adam]


def _optimizer_from_dict(data: Dict[str, Any]) -> Optimizer:
    kinds = {"sgd": SGD, "adam": Adam}
    algorithm = data.get("algorithm")
    if algorithm not in kinds:
        raise ValueError(f"Unknown optimizer algorithm: {algorithm!r}")
    return kinds[algorithm](**{key: value for key, value in data.items() if key != "algorithm"})


@dataclasses.dataclass(frozen=True)
class CTCLossConfig:
    pass


@dataclasses.dataclass(frozen=True)
class SequenceCrossEntropyLossConfig:
    label_smoothing: float = 0.0


ClassifierLossConfig = Union[CTCLossConfig, SequenceCrossEntropyLossConfig]


def _loss_from_dict(data: Optional[Dict[str, Any]]) -> ClassifierLossConfig:
    loss_type = "CTC" if data is None else data.get("type")
    if loss_type == "CTC":
        return CTCLossConfig()
    if loss_type == "sequence-cross-entropy":
        return SequenceCrossEntropyLossConfig(float(data.get("label_smoothing", 0)))
    raise ValueError(f"Unknown loss type: {loss_type!r}")


@dataclasses.dataclass(frozen=True)
class ProjectionEntryConfig:
    name: str
    loss: ClassifierLossConfig = CTCLossConfig()


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    classes: Tuple[ProjectionEntryConfig, ...]
    allophone_l2_alpha: float = 10.0

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ProjectionConfig":
        return cls(
            tuple(ProjectionEntryConfig(entry["name"], _loss_from_dict(entry.get("loss"))) for entry in data["classes"]),
            float(data.get("allophone_l2_alpha", 10)),
        )


@dataclasses.dataclass(frozen=True)
class UnfreezeScheduleConfig:
    feature_encoder_steps: Optional[int] = None
    feature_projection_steps: Optional[int] = None
    encoder_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Wav2Vec2PretrainedConfig:
    model_id: str
    freeze_feature_encoder: bool = True
    freeze_feature_projection: bool = False
    freeze_encoder: bool = False
    unfreeze_schedule: Optional[UnfreezeScheduleConfig] = None

    def freeze_groups(self) -> Tuple[Tuple[str, bool, Optional[int]], ...]:
        """(module group, freeze flag, thaw step or None) per freezable group in
        forward order feature_extractor -> feature_projection -> encoder: the
        one source of both the gradient mask (``build_freeze_plan``) and the
        no-grad prefix (``whole_run_frozen_prefix``)."""
        schedule = self.unfreeze_schedule or UnfreezeScheduleConfig()
        return (
            ("feature_extractor", self.freeze_feature_encoder, schedule.feature_encoder_steps),
            ("feature_projection", self.freeze_feature_projection, schedule.feature_projection_steps),
            ("encoder", self.freeze_encoder, schedule.encoder_steps),
        )

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Wav2Vec2PretrainedConfig":
        schedule = data.get("unfreeze_schedule")
        return cls(
            data["model_id"],
            bool(data.get("freeze_feature_encoder", True)),
            bool(data.get("freeze_feature_projection", False)),
            bool(data.get("freeze_encoder", False)),
            None if schedule is None else UnfreezeScheduleConfig(**schedule),
        )


def whole_run_frozen_prefix(acoustic_model: Wav2Vec2PretrainedConfig) -> int:
    """Longest prefix of (feature_extractor, feature_projection, encoder) that
    stays frozen for the whole run (flag set, never thawed): the model runs it
    without gradients. Groups a schedule thaws keep their backward and are
    masked by ``apply_freeze_plan`` instead."""
    prefix = 0
    for _group, frozen, thaw_steps in acoustic_model.freeze_groups():
        if not frozen or thaw_steps is not None:
            break
        prefix += 1
    return prefix


@dataclasses.dataclass(frozen=True)
class Architecture:
    """The ``nn`` section's training settings (the port trains the
    wav2vec2-pretrained acoustic model only). The dropout rates live in the
    architecture and the projection plan, which the model is built from."""

    projection: ProjectionConfig
    acoustic_model: Wav2Vec2PretrainedConfig
    optimizer: Optimizer
    seed: Optional[int] = None
    clip_norm: Optional[float] = None
    lr_schedule: Optional[WarmupConfig] = None
    accumulation_factor: int = 1

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Architecture":
        acoustic = data["acoustic_model"]
        if acoustic.get("type") != "wav2vec2-pretrained":
            raise ValueError(f"The port trains wav2vec2-pretrained acoustic models, not {acoustic.get('type')!r}")
        schedule = data.get("lr_schedule")
        return cls(
            ProjectionConfig.from_dict(data["projection"]),
            Wav2Vec2PretrainedConfig.from_dict(acoustic),
            _optimizer_from_dict(data["optimizer"]),
            data.get("seed"),
            data.get("clip_norm"),
            None if schedule is None else WarmupConfig.from_dict(schedule),
            int(data.get("accumulation_factor", 1)),
        )
