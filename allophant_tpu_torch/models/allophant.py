"""Top-level Allophant model, wav2vec2 acoustic model only (counterpart of
``allophant_tpu/models/allophant.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.models.projection import OUTPUT_DEPENDENCY, HierarchicalProjection, ProjectionPlan
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture, Wav2Vec2Model


@dataclasses.dataclass
class Predictions:
    """Per-task output logits (or log-probabilities) plus output frame counts.
    Outputs are batch-first [B, T, C] unless a caller transposes them."""

    outputs: Dict[str, torch.Tensor]
    lengths: torch.Tensor

    def __len__(self) -> int:
        return len(self.lengths)


def needs_intermediate_taps(plan: ProjectionPlan) -> bool:
    """Whether any classifier consumes an "OUTPUT_<i>" intermediate encoder tap;
    when none does, the encoder keeps only its final state."""
    return any(name != OUTPUT_DEPENDENCY for name in plan.output_dependencies)


class AllophantModel(nn.Module):
    """wav2vec2 encoder + hierarchical projection.

    ``head_dtype`` (None = ``dtype``) is the compute dtype of the classifier
    head; the "mixed" preset runs the encoder in bf16 and the head in f32, with
    the hidden states cast once at the boundary. ``param_dtype`` stores the
    matmul and convolution weights: None keeps each module's compute dtype (a
    serving model, where the casts are no-ops), float32 gives a training
    model its f32 master weights, cast at each call as flax casts them.
    ``frozen_prefix`` is the acoustic model's whole-run-frozen prefix
    (``whole_run_frozen_prefix``)."""

    def __init__(
        self,
        architecture: Wav2Vec2Architecture,
        plan: ProjectionPlan,
        dtype: torch.dtype = torch.float32,
        head_dtype: Optional[torch.dtype] = None,
        device=None,
        param_dtype: Optional[torch.dtype] = None,
        frozen_prefix: int = 0,
    ):
        super().__init__()
        self.architecture = architecture
        self.plan = plan
        self.dtype = dtype
        self.head_dtype = dtype if head_dtype is None else head_dtype
        self.acoustic_model = Wav2Vec2Model(
            architecture, dtype, needs_intermediate_taps(plan), device, param_dtype, frozen_prefix
        )
        self.projection = HierarchicalProjection(plan, self.head_dtype, device, param_dtype)

    def forward(
        self,
        audio: torch.Tensor,
        lengths: torch.Tensor,
        language_ids: torch.Tensor,
        target_feature_indices: Optional[torch.Tensor] = None,
        predict: bool = False,
        rng: Optional[DropoutRng] = None,
    ) -> Predictions:
        """``rng=None`` is the deterministic forward; with a ``DropoutRng``
        every dropout site of the model draws from it."""
        hidden_states, frame_lengths = self.acoustic_model(audio, lengths, rng)
        if self.head_dtype != self.dtype:
            hidden_states = [states.to(self.head_dtype) for states in hidden_states]
        outputs = self.projection(hidden_states, frame_lengths, language_ids, target_feature_indices, predict, rng)
        return Predictions(outputs, frame_lengths)

    def l2_penalty(self) -> Optional[torch.Tensor]:
        return self.projection.l2_penalty()

    def map_allophones(self, phone_logits: torch.Tensor, language_ids: torch.Tensor) -> torch.Tensor:
        return self.projection.map_allophones(phone_logits, language_ids)

    @property
    def classes(self) -> List[str]:
        return [node.name for node in self.plan.nodes]
