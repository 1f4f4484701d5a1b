"""Top-level Allophant model over either acoustic model, the wav2vec2 encoder
or the from-scratch transformer (counterpart of
``allophant_tpu/models/allophant.py``), and its builders from a configuration:
``attribute_graph_from_config`` and ``build_model``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from allophant_tpu_torch.config import (
    Architecture,
    PhonemeLayerType,
    ProjectionEntryConfig,
    TransformerAcousticModelConfig,
    Wav2Vec2PretrainedConfig,
    whole_run_frozen_prefix,
)
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.models.projection import (
    OUTPUT_DEPENDENCY,
    HierarchicalProjection,
    ProjectionPlan,
    build_projection_plan,
)
from allophant_tpu_torch.models.transformer import TransformerAcousticModel, TransformerArchitecture
from allophant_tpu_torch.models.wav2vec2 import REMAT_SAVE_NAMES_BASE, Wav2Vec2Architecture, Wav2Vec2Model
from allophant_tpu_torch.phonetics.attribute_graph import AttributeGraph, AttributeNode, TimeLayerConfig
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer


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
    """Acoustic model (the wav2vec2 encoder of a ``Wav2Vec2Architecture``, or
    the transformer of a ``TransformerArchitecture``) + hierarchical projection.

    ``head_dtype`` (None = ``dtype``) is the compute dtype of the classifier
    head; the "mixed" preset runs the encoder in bf16 and the head in f32, with
    the hidden states cast once at the boundary. ``param_dtype`` stores the
    matmul and convolution weights: None keeps each module's compute dtype (a
    serving model, where the casts are no-ops), float32 gives a training
    model its f32 master weights, cast at each call as flax casts them.
    ``frozen_prefix`` is the acoustic model's whole-run-frozen prefix
    (``whole_run_frozen_prefix``); ``remat`` rematerialises the wav2vec2
    encoder layers in training, keeping ``remat_save_names`` (the
    transformer takes neither, as in the JAX model). ``mesh`` (a
    ``parallel.mesh.Mesh``) shards over its model axis what JAX's rules shard
    (``parallel/sharding.py``): the wav2vec2 encoder layers or the
    transformer's layers, and the projection head's attention classifiers;
    everything else is replicated on every model rank."""

    def __init__(
        self,
        architecture: Wav2Vec2Architecture | TransformerArchitecture,
        plan: ProjectionPlan,
        dtype: torch.dtype = torch.float32,
        head_dtype: Optional[torch.dtype] = None,
        device=None,
        param_dtype: Optional[torch.dtype] = None,
        frozen_prefix: int = 0,
        remat: bool = False,
        remat_save_names=REMAT_SAVE_NAMES_BASE,
        mesh=None,
    ):
        super().__init__()
        self.architecture = architecture
        self.mesh = mesh
        self.plan = plan
        self.dtype = dtype
        self.head_dtype = dtype if head_dtype is None else head_dtype
        if isinstance(architecture, Wav2Vec2Architecture):
            self.acoustic_model = Wav2Vec2Model(
                architecture, dtype, needs_intermediate_taps(plan), device, param_dtype, frozen_prefix,
                remat, remat_save_names, mesh,
            )
        elif isinstance(architecture, TransformerArchitecture):
            self.acoustic_model = TransformerAcousticModel(architecture, dtype, device, param_dtype, mesh)
        else:
            raise ValueError(f"Unsupported acoustic model architecture: {type(architecture).__name__}")
        self.projection = HierarchicalProjection(plan, self.head_dtype, device, param_dtype, mesh)

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


def highest_specific_output_layer(graph: AttributeGraph) -> Optional[int]:
    """Exclusive index of the highest "OUTPUT_<i>" tap, or None if only the final
    output is used (reference :932-941): encoder layers above it are dropped."""
    indices = []
    for node in graph:
        for dependency in node.dependencies:
            match = ProjectionEntryConfig.OUTPUT_PATTERN.match(dependency)
            if match is not None and match.group(1) is not None:
                indices.append(int(match.group(1)))
    return max(indices) + 1 if indices else None


def attribute_graph_from_config(config, attribute_indexer: PhoneticAttributeIndexer) -> AttributeGraph:
    """The attribute graph of the configured classifiers with the indexer's
    class counts (reference estimator.py:271-281)."""
    nodes = []
    for entry in config.nn.projection.classes:
        time_layer = None
        if entry.time_layer is not None:
            time_layer = TimeLayerConfig(entry.time_layer.num_heads, entry.time_layer.positional_embeddings)
        nodes.append(AttributeNode(entry.name, attribute_indexer.size(entry.name), time_layer, list(entry.dependencies)))
    return AttributeGraph(nodes)


@dataclasses.dataclass
class BuiltModel:
    """A model built from a configuration, with its plan's static tables
    already written into it."""

    model: AllophantModel
    static_data: Dict[str, np.ndarray]


def build_model(
    architecture: Architecture,
    feature_size: int,
    sample_rate: int,
    attribute_graph: AttributeGraph,
    attribute_indexer: Optional[PhoneticAttributeIndexer] = None,
    wav2vec2_architecture: Optional[Wav2Vec2Architecture] = None,
    dtype: torch.dtype = torch.float32,
    head_dtype: Optional[torch.dtype] = None,
    device=None,
    param_dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    remat_save_names=REMAT_SAVE_NAMES_BASE,
    mesh=None,
) -> BuiltModel:
    """The Allophant model of an ``nn`` configuration (reference :988-1025),
    on ``device``, with zero weights and the plan's static tables in place.
    A wav2vec2-pretrained encoder is XLS-R 300M unless
    ``wav2vec2_architecture`` replaces it, cut above the highest "OUTPUT_<i>"
    tap; a pre-LN transformer reads ``feature_size`` features a frame.
    ``mesh`` shards the model over its model axis (``AllophantModel``)."""
    layer_config = architecture.acoustic_model
    if isinstance(layer_config, Wav2Vec2PretrainedConfig):
        if sample_rate != 16_000:
            raise ValueError(
                "Audio resampling config and the sampling rate required by Wav2Vec2 do not"
                f" match. Expected 16000Hz, got {sample_rate}Hz"
            )
        arch = wav2vec2_architecture if wav2vec2_architecture is not None else Wav2Vec2Architecture()
        arch = arch.truncated(highest_specific_output_layer(attribute_graph))
    elif isinstance(layer_config, TransformerAcousticModelConfig):
        arch = TransformerArchitecture(layer_config, int(feature_size))
    else:
        raise ValueError(f"Unsupported model type: {type(layer_config).__name__}")

    language_allophones = None
    if attribute_indexer is not None and architecture.projection.phoneme_layer != PhonemeLayerType.SHARED:
        language_allophones = attribute_indexer.language_allophones
    plan, static_data = build_projection_plan(
        arch.hidden_size,
        attribute_graph,
        architecture.loss.BLANK_OFFSET,
        architecture.projection,
        language_allophones,
        attribute_indexer,
    )
    model = AllophantModel(
        arch, plan, dtype, head_dtype, device=device, param_dtype=param_dtype,
        frozen_prefix=whole_run_frozen_prefix(layer_config), remat=remat, remat_save_names=remat_save_names,
        mesh=mesh,
    )
    from allophant_tpu_torch.weights import load_static_data

    load_static_data(model, static_data)
    return BuiltModel(model, static_data)
