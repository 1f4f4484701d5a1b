"""Hierarchical multi-task classifier head (counterpart of
``allophant_tpu/models/projection.py``): one classifier per attribute node in
plan order, each reading its dependencies' softmaxed posteriors and/or raw
acoustic-model taps ("OUTPUT"/"OUTPUT_<i>"), with the embedding-composition
phoneme layer (the zero-shot mechanism) and the allophone layer.

The plan arrives as data (``ProjectionPlan.from_dict``): this module does not
derive it from an attribute graph and phonetic indexer."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from allophant_tpu_torch.models.layers import Dense, DropoutRng, LayerNorm, dropout
from allophant_tpu_torch.ops import masking
from allophant_tpu_torch.ops.oneshot_attention import NEG_INF

OUTPUT_DEPENDENCY = "OUTPUT"
PHONEME_LAYER = "phoneme"
PHONE = "phone"


@dataclasses.dataclass(frozen=True)
class DependencyPlan:
    name: str
    size: int  # with blank offset applied when applicable
    is_output_tap: bool


@dataclasses.dataclass(frozen=True)
class NodePlan:
    name: str
    input_size: int
    projection_size: int  # output size of the time-distributed layer
    output_size: int  # classifier output size (with blank)
    dependencies: Tuple[DependencyPlan, ...]
    attention: Optional[Tuple[int, bool]] = None  # (num_heads, positional_embeddings)
    has_composition: bool = False
    has_allophone: bool = False


@dataclasses.dataclass(frozen=True)
class ProjectionPlan:
    """Static plan of the hierarchical projection."""

    nodes: Tuple[NodePlan, ...]
    blank_offset: int
    dependency_blanks: bool
    output_dependencies: Tuple[str, ...]
    # (embedding_size, num_embeddings, category_offsets, unused_category_rows,
    #  training_feature_table_shape)
    composition: Optional[Tuple[int, int, Tuple[int, ...], Tuple[int, ...], Tuple[int, int]]] = None
    allophone_shape: Optional[Tuple[int, int, int, int]] = None  # (L, S, P, K)
    # Dropout on the acoustic-model taps the classifiers read (training only).
    acoustic_model_dropout: float = 0.0

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "ProjectionPlan":
        """Builds a plan from plain data: ``dataclasses.asdict`` of the JAX
        package's plan, or the same structure read back from JSON (lists in
        place of tuples)."""
        nodes = []
        for node in data["nodes"]:
            attention = node.get("attention")
            nodes.append(
                NodePlan(
                    node["name"],
                    int(node["input_size"]),
                    int(node["projection_size"]),
                    int(node["output_size"]),
                    tuple(
                        DependencyPlan(dependency["name"], int(dependency["size"]), bool(dependency["is_output_tap"]))
                        for dependency in node["dependencies"]
                    ),
                    None if attention is None else (int(attention[0]), bool(attention[1])),
                    bool(node.get("has_composition", False)),
                    bool(node.get("has_allophone", False)),
                )
            )
        composition = data.get("composition")
        if composition is not None:
            size, count, offsets, unused, table_shape = composition
            composition = (
                int(size),
                int(count),
                tuple(int(value) for value in offsets),
                tuple(int(value) for value in unused),
                tuple(int(value) for value in table_shape),
            )
        allophone_shape = data.get("allophone_shape")
        return cls(
            tuple(nodes),
            int(data["blank_offset"]),
            bool(data["dependency_blanks"]),
            tuple(data["output_dependencies"]),
            composition,
            None if allophone_shape is None else tuple(int(value) for value in allophone_shape),
            float(data.get("acoustic_model_dropout", 0.0)),
        )

    def with_output_features(self, output_features: int) -> "ProjectionPlan":
        """The same plan over an acoustic model of another width: every
        "OUTPUT"/"OUTPUT_<i>" tap dependency takes the new size."""

        def resize(node: NodePlan) -> NodePlan:
            dependencies = tuple(
                dataclasses.replace(dependency, size=output_features) if dependency.is_output_tap else dependency
                for dependency in node.dependencies
            )
            return dataclasses.replace(
                node,
                input_size=sum(dependency.size for dependency in dependencies),
                dependencies=dependencies,
            )

        return dataclasses.replace(self, nodes=tuple(resize(node) for node in self.nodes))


def sinusoidal_positions(length: int, size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sinusoidal position embeddings, interleaved sin/cos over paired dims."""
    component = np.exp(np.arange(0, size, 2, dtype=np.float32) * -(math.log(10000) / size))
    bases = np.stack([component] * 2, 1).reshape(-1)
    positions = np.arange(length, dtype=np.float32)[:, None] * bases[None, :]
    positions[:, 0::2] = np.sin(positions[:, 0::2])
    positions[:, 1::2] = np.cos(positions[:, 1::2])
    return torch.as_tensor(positions, dtype=dtype, device=device)


class EmbeddingCompositionLayer(nn.Module):
    """Compositional phone embeddings: each phone's embedding is the sum of its
    attribute-category embeddings; logits are dot products scaled by 1/sqrt(E).
    Row 0 of the table is the blank class's embedding."""

    def __init__(
        self,
        embedding_size: int,
        num_embeddings: int,
        category_offsets: Sequence[int],
        dtype: torch.dtype,
        device=None,
    ):
        super().__init__()
        self.embedding_size = embedding_size
        self.dtype = dtype
        self.attribute_embeddings = nn.Parameter(
            torch.zeros(num_embeddings, embedding_size, dtype=torch.float32, device=device)
        )
        self.register_buffer(
            "category_offsets", torch.tensor(list(category_offsets), dtype=torch.long, device=device), persistent=False
        )

    def forward(self, inputs: torch.Tensor, feature_indices: torch.Tensor) -> torch.Tensor:
        indices = feature_indices.long() + self.category_offsets[None, :]
        embeddings = self.attribute_embeddings.to(self.dtype)
        composed = embeddings[indices].sum(dim=1)  # [P, E]
        composed = torch.cat((embeddings[:1], composed), dim=0)
        return (inputs @ composed.t()) * (1.0 / math.sqrt(self.embedding_size))


class AllophoneMapping(nn.Module):
    """Allophone layer: per-language [S, P] phone->phoneme matrices; the
    initialization (the L2 pull's target) and the [L, P, K] gather table of
    allophone indices (-1 padding) are buffers."""

    def __init__(self, num_languages: int, shared_count: int, phoneme_count: int, max_gather: int, device=None):
        super().__init__()
        shape = (num_languages, shared_count, phoneme_count)
        self.allophone_matrices = nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
        self.register_buffer("initialization", torch.zeros(shape, dtype=torch.float32, device=device))
        self.register_buffer(
            "gather_indices",
            torch.full((num_languages, phoneme_count, max_gather), -1, dtype=torch.long, device=device),
        )

    def forward(self, phone_logits, language_ids, predict: bool = False) -> Dict[str, torch.Tensor]:
        if predict:
            # Language ids of other corpora are meaningless: the raw phone logits
            # pass through as both tasks.
            return {PHONE: phone_logits, PHONEME_LAYER: phone_logits}
        return {PHONEME_LAYER: self.map_allophones(phone_logits, language_ids)}

    def map_allophones(self, phone_logits: torch.Tensor, language_ids: torch.Tensor) -> torch.Tensor:
        """[B, T, S] phone logits -> [B, T, P] phoneme logits: per phoneme, the
        max over its allophones of logit * matrix weight; non-allophones give
        -1e9 (zero probability after softmax, finite losses)."""
        batch, time, shared = phone_logits.shape
        if shared != self.allophone_matrices.shape[1]:
            raise ValueError(
                f"Phone logits have {shared} classes; the allophone layer maps"
                f" {self.allophone_matrices.shape[1]}"
            )
        gather = self.gather_indices[language_ids]  # [B, P, K]
        valid = gather >= 0
        safe = torch.where(valid, gather, torch.zeros_like(gather))
        phonemes, width = safe.shape[1:]
        gathered = torch.gather(
            phone_logits, 2, safe.reshape(batch, 1, phonemes * width).expand(batch, time, phonemes * width)
        ).reshape(batch, time, phonemes, width)
        matrices = self.allophone_matrices[language_ids].transpose(1, 2)  # [B, P, S]
        weights = torch.gather(matrices, 2, safe)  # [B, P, K]
        products = gathered * weights[:, None].to(gathered.dtype)
        products = products.masked_fill(~valid[:, None], NEG_INF)
        return products.amax(dim=-1)

    def l2_penalty(self) -> torch.Tensor:
        """Sum over languages of the Frobenius norms of (W - W0). The square
        root is guarded twice (a double ``where``), so the gradient at W == W0
        is 0, torch's norm subgradient, and not NaN."""
        squared = (self.allophone_matrices - self.initialization).square().sum(dim=(1, 2))
        positive = squared > 0
        safe = torch.where(positive, squared, torch.ones_like(squared))
        return torch.where(positive, safe.sqrt(), torch.zeros_like(squared)).sum()


class ProjectingMultiheadAttention(nn.Module):
    """Linear projection -> LayerNorm -> optional sinusoidal positions -> MHA
    -> output dropout."""

    def __init__(
        self,
        input_dimensions: int,
        hidden_dimensions: int,
        num_heads: int,
        add_positional_embeddings: bool,
        dtype: torch.dtype,
        device=None,
        param_dtype=None,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.hidden_dimensions = hidden_dimensions
        self.num_heads = num_heads
        self.add_positional_embeddings = add_positional_embeddings
        self.dropout_rate = dropout_rate
        self.input_projection = Dense(input_dimensions, hidden_dimensions, dtype, device, param_dtype)
        # flax nn.LayerNorm's default epsilon.
        self.layer_norm = LayerNorm(hidden_dimensions, 1e-6, dtype, device)
        self.q_proj = Dense(hidden_dimensions, hidden_dimensions, dtype, device, param_dtype)
        self.k_proj = Dense(hidden_dimensions, hidden_dimensions, dtype, device, param_dtype)
        self.v_proj = Dense(hidden_dimensions, hidden_dimensions, dtype, device, param_dtype)
        self.out_proj = Dense(hidden_dimensions, hidden_dimensions, dtype, device, param_dtype)

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        hidden = self.layer_norm(self.input_projection(inputs))
        batch, time, _ = hidden.shape
        if self.add_positional_embeddings:
            hidden = hidden + sinusoidal_positions(time, self.hidden_dimensions, hidden.dtype, hidden.device)[None]
        heads = self.num_heads
        head_dim = self.hidden_dimensions // heads
        shape = (batch, time, heads, head_dim)
        query = self.q_proj(hidden).reshape(shape) * head_dim**-0.5
        key = self.k_proj(hidden).reshape(shape)
        value = self.v_proj(hidden).reshape(shape)
        logits = torch.einsum("bthd,bshd->bhts", query, key)
        pad_mask = masking.mask_sequence(lengths, time)
        logits = logits.masked_fill(~pad_mask[:, None, None, :], NEG_INF)
        weights = torch.softmax(logits.float(), dim=-1).to(hidden.dtype)
        context = torch.einsum("bhts,bshd->bthd", weights, value).reshape(batch, time, self.hidden_dimensions)
        return dropout(self.out_proj(context), self.dropout_rate, rng)


class HierarchicalProjection(nn.Module):
    """Executes a :class:`ProjectionPlan` over acoustic-model hidden states."""

    def __init__(self, plan: ProjectionPlan, dtype: torch.dtype = torch.float32, device=None, param_dtype=None):
        super().__init__()
        self.plan = plan
        self.classifiers = nn.ModuleDict()
        self.composition: Optional[EmbeddingCompositionLayer] = None
        self.allophone: Optional[AllophoneMapping] = None
        for node in plan.nodes:
            if node.attention is not None:
                self.classifiers[node.name] = ProjectingMultiheadAttention(
                    node.input_size, node.projection_size, node.attention[0], node.attention[1], dtype, device,
                    param_dtype, plan.acoustic_model_dropout,
                )
            else:
                self.classifiers[node.name] = Dense(node.input_size, node.projection_size, dtype, device, param_dtype)
            if node.has_composition:
                embedding_size, num_embeddings, offsets, _unused, _table_shape = plan.composition
                self.composition = EmbeddingCompositionLayer(embedding_size, num_embeddings, offsets, dtype, device)
            if node.has_allophone:
                self.allophone = AllophoneMapping(*plan.allophone_shape, device=device)
        if plan.composition is not None:
            # The training inventory's dense feature table (category ids per feature).
            self.register_buffer(
                "composition_feature_table", torch.zeros(plan.composition[4], dtype=torch.long, device=device)
            )

    def forward(
        self,
        inputs: Sequence[torch.Tensor],
        input_lengths: torch.Tensor,
        language_ids: torch.Tensor,
        target_feature_indices: Optional[torch.Tensor] = None,
        predict: bool = False,
        rng: Optional[DropoutRng] = None,
    ) -> Dict[str, torch.Tensor]:
        plan = self.plan
        outputs: Dict[str, torch.Tensor] = {f"{OUTPUT_DEPENDENCY}_{index}": tap for index, tap in enumerate(inputs)}
        outputs[OUTPUT_DEPENDENCY] = inputs[-1]
        for dependency in plan.output_dependencies:
            outputs[dependency] = dropout(outputs[dependency], plan.acoustic_model_dropout, rng)

        projection_outputs: Dict[str, torch.Tensor] = {}
        for node in plan.nodes:
            if len(node.dependencies) == 1 and node.dependencies[0].is_output_tap:
                dependency_outputs = outputs[node.dependencies[0].name]
            else:
                parts = []
                for dependency in node.dependencies:
                    value = outputs[dependency.name]
                    if not dependency.is_output_tap:
                        if not plan.dependency_blanks:
                            value = value[..., plan.blank_offset :]
                        value = torch.softmax(value, dim=-1)
                    parts.append(value)
                dependency_outputs = torch.cat(parts, dim=-1)

            layer = self.classifiers[node.name]
            if isinstance(layer, ProjectingMultiheadAttention):
                hidden = layer(dependency_outputs, input_lengths, rng)
            else:
                hidden = layer(dependency_outputs)

            if node.has_composition:
                table = self.composition_feature_table if target_feature_indices is None else target_feature_indices
                hidden = self.composition(hidden, table)

            if node.has_allophone:
                result = self.allophone(hidden, language_ids, predict)
                projection_outputs.update(result)
                outputs.update(result)
            else:
                projection_outputs[node.name] = hidden
                outputs[node.name] = hidden
        return projection_outputs

    def l2_penalty(self) -> Optional[torch.Tensor]:
        return None if self.allophone is None else self.allophone.l2_penalty()

    def map_allophones(self, phone_logits: torch.Tensor, language_ids: torch.Tensor) -> torch.Tensor:
        if self.allophone is None:
            raise ValueError("Can't map phones to allophones with a model without an allophone layer")
        return self.allophone.map_allophones(phone_logits, language_ids)
