"""From-scratch transformer acoustic model with configurable frontends
(counterpart of ``allophant_tpu/models/transformer.py``).

A direct or linear frontend, an optional sequential frontend (GLU convolutions
with variable-length reflect padding, max pooling, layer norm, dropout),
sinusoidal position embeddings and a pre-LN transformer encoder that returns
every layer's output through the final layer norm, for the intermediate
classifier taps. Batch-first [B, T, F] throughout; raw samples [B, T] enter as
[B, T, 1].

As in the JAX model, max-pool output lengths use the strided length arithmetic
(the reference's stride-1 conv arithmetic would corrupt CTC lengths).
Attention reads q, k and v from one fused projection over [B, T, H·hd]
(``ops/attention.multi_head_attention``): K1 when deterministic, and K5
forward with K4 backward in training with attention dropout. The JAX layer
trains through einsum attention with ``nn.Dropout`` on the softmaxed weights;
the semantics are the same (dropout on the weights), the random draws are the
port's Philox mask.

Tensor parallelism (``mesh`` with a model axis of tp > 1, JAX's shardings,
``parallel/sharding.py``): each layer holds H/tp heads of the fused QKV
projection and feedforward/tp columns of ``linear1``; the attention kernels run
on the rank's heads (keyed by their global index, so the dropout masks are one
device's); ``out_proj`` and ``linear2`` are row-parallel, their partial sums
reduced over the model group before the bias; the backward reduces the input
gradient of the column-parallel projections (``parallel/tensor_parallel.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from allophant_tpu_torch.config import (
    DirectFrontendConfig,
    DropoutConfig,
    Glu1dConfig,
    LayerNormConfig,
    LinearFrontendConfig,
    MaxPoolingConfig,
    SequentialFrontendConfig,
    TransformerAcousticModelConfig,
)
from allophant_tpu_torch.models.layers import Conv1d, Dense, DropoutRng, LayerNorm, dropout
from allophant_tpu_torch.models.projection import sinusoidal_positions
from allophant_tpu_torch.ops import masking
from allophant_tpu_torch.ops.activations import fast_gelu
from allophant_tpu_torch.ops.attention import key_bias_from_mask, multi_head_attention
from allophant_tpu_torch.parallel.tensor_parallel import (
    copy_to_model_parallel,
    model_parallel,
    output_dense,
    rank_offset,
    split_evenly,
)

#: flax ``nn.LayerNorm``'s default epsilon.
LAYER_NORM_EPS = 1e-6


def leaky_relu(features: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """flax ``nn.leaky_relu``: slope 1 at 0 (``x >= 0``), where torch's takes
    the negative slope. The linear frontend meets 0 exactly: LayerNorm over
    a single feature (raw samples) is 0, so the first step's gradient is the
    bias's at 0."""
    return torch.where(features >= 0, features, negative_slope * features)


def variable_length_reflect_pad(features: torch.Tensor, lengths: torch.Tensor, padding: Tuple[int, int]) -> torch.Tensor:
    """Per-sequence reflect padding at true sequence boundaries (reference
    padding.py:24-53): the left edge reflects the sequence start; the right edge
    reflects at each sequence's true length rather than the padded buffer end."""
    left, right = padding
    batch, time, channels = features.shape
    positions = torch.arange(time + left + right, device=features.device)[None, :]
    lengths = lengths.to(positions.dtype)[:, None]

    middle_source = positions - left
    left_source = left - positions
    right_source = 2 * lengths - 2 - middle_source  # reflect at length boundary

    in_left = positions < left
    in_right = (middle_source >= lengths) & (middle_source < lengths + right)
    source = torch.where(in_left, left_source, torch.where(in_right, right_source, middle_source))
    source = source.clamp(0, time - 1).expand(batch, -1)
    return torch.gather(features, 1, source[:, :, None].expand(-1, -1, channels))


class Glu1d(nn.Module):
    """1D convolution with gated linear units over time (reference frontend.py:98-136)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int, stride: int, dtype, device=None, param_dtype=None,
        reflect_pad: bool = True,
    ):
        super().__init__()
        self.kernel_size, self.stride, self.reflect_pad = kernel_size, stride, reflect_pad
        self.weights = Conv1d(in_channels, 2 * out_channels, kernel_size, stride, dtype=dtype, device=device, param_dtype=param_dtype)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        padding = masking.get_padding(self.kernel_size, self.stride)
        if self.reflect_pad:
            features = variable_length_reflect_pad(features, lengths, padding)
        else:
            features = F.pad(features, (0, 0, *padding))
        values, gates = self.weights(features).chunk(2, dim=-1)
        return values * torch.sigmoid(gates)


@dataclasses.dataclass(frozen=True)
class _SequentialLayerPlan:
    kind: str  # "glu1d" | "max_pool" | "dropout" | "layer_norm"
    out_channels: int = 0
    kernel: int = 0
    stride: int = 1
    rate: float = 0.0
    affine: bool = False
    size: int = 0


def _sequential_plan(
    config: SequentialFrontendConfig, feature_size: int
) -> Tuple[Tuple[_SequentialLayerPlan, ...], int, float]:
    layers = []
    previous = feature_size
    upscale = 1.0
    for layer in config.layers:
        if isinstance(layer, DropoutConfig):
            layers.append(_SequentialLayerPlan("dropout", rate=layer.rate))
        elif isinstance(layer, Glu1dConfig):
            layers.append(_SequentialLayerPlan("glu1d", out_channels=layer.out_channels, kernel=layer.kernel, stride=layer.stride))
            previous = layer.out_channels
            upscale *= layer.stride
        elif isinstance(layer, LayerNormConfig):
            layers.append(_SequentialLayerPlan("layer_norm", affine=layer.affine, out_channels=previous))
        elif isinstance(layer, MaxPoolingConfig):
            layers.append(_SequentialLayerPlan("max_pool", size=layer.size))
            upscale *= layer.size
        else:
            raise ValueError(f"Unsupported layer config of type: {layer.__class__.__name__}")
    return tuple(layers), previous, upscale


def sequential_frontend_lengths(plan: Tuple[_SequentialLayerPlan, ...], lengths):
    """Output lengths of a sequential frontend (tensors, numpy arrays or ints)."""
    for layer in plan:
        if layer.kind == "glu1d":
            padding = sum(masking.get_padding(layer.kernel, layer.stride))
            lengths = masking.conv_output_length(lengths, layer.kernel, layer.stride, padding)
        elif layer.kind == "max_pool":
            lengths = masking.conv_output_length(lengths, layer.size, layer.size)
    return lengths


class SequentialFrontend(nn.Module):
    """The configured frontend layers in order; modules are named ``glu_<i>``
    and ``norm_<i>`` after their position, as in the JAX model."""

    def __init__(self, plan: Tuple[_SequentialLayerPlan, ...], in_channels: int, dtype, device=None, param_dtype=None):
        super().__init__()
        self.plan = plan
        self.layers = nn.ModuleDict()
        channels = in_channels
        for index, layer in enumerate(plan):
            if layer.kind == "glu1d":
                self.layers[f"glu_{index}"] = Glu1d(
                    channels, layer.out_channels, layer.kernel, layer.stride, dtype, device, param_dtype
                )
                channels = layer.out_channels
            elif layer.kind == "layer_norm":
                self.layers[f"norm_{index}"] = LayerNorm(channels, LAYER_NORM_EPS, dtype, device, layer.affine)

    def forward(self, features: torch.Tensor, lengths: torch.Tensor, rng: Optional[DropoutRng] = None):
        for index, layer in enumerate(self.plan):
            if layer.kind == "dropout":
                features = dropout(features, layer.rate, rng)
            elif layer.kind == "glu1d":
                # Mask padding before the convolution (reference MaskInfo handling).
                features = features * masking.mask_sequence(lengths, features.shape[1])[:, :, None].to(features.dtype)
                features = self.layers[f"glu_{index}"](features, lengths)
                padding = sum(masking.get_padding(layer.kernel, layer.stride))
                lengths = masking.conv_output_length(lengths, layer.kernel, layer.stride, padding)
            elif layer.kind == "layer_norm":
                features = self.layers[f"norm_{index}"](features)
            elif layer.kind == "max_pool":
                features = features * masking.mask_sequence(lengths, features.shape[1])[:, :, None].to(features.dtype)
                features = F.max_pool1d(features.transpose(1, 2), layer.size, layer.size).transpose(1, 2)
                lengths = masking.conv_output_length(lengths, layer.size, layer.size)
        return features, lengths


class PreLNTransformerLayer(nn.Module):
    """Pre-LN transformer layer matching the reference's modified torch layer
    (acoustic_model.py:564-611): the attention residual is taken *after* norm1.
    Over a ``mesh`` with a model axis, this rank's heads and FFN columns."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        feedforward_size: int,
        dropout_rate: float,
        activation: str,
        elementwise_affine: bool,
        dtype,
        device=None,
        param_dtype=None,
        mesh=None,
    ):
        super().__init__()
        tp, self.group = model_parallel(mesh)
        self.total_heads = num_heads
        self.heads = split_evenly(num_heads, tp, "attention heads")
        self.head_offset = rank_offset(mesh, self.heads)
        self.head_dim = d_model // num_heads
        self.width = self.heads * self.head_dim
        self.feedforward_size = feedforward_size
        self.column_offset = rank_offset(mesh, split_evenly(feedforward_size, tp, "feedforward columns"))
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.norm1 = LayerNorm(d_model, LAYER_NORM_EPS, dtype, device, elementwise_affine)
        self.qkv_proj = Dense(d_model, 3 * self.width, dtype, device, param_dtype)
        self.out_proj = output_dense(d_model, d_model, dtype, device, param_dtype, mesh)
        self.norm2 = LayerNorm(d_model, LAYER_NORM_EPS, dtype, device, elementwise_affine)
        self.linear1 = Dense(d_model, feedforward_size // tp, dtype, device, param_dtype)
        self.linear2 = output_dense(feedforward_size, d_model, dtype, device, param_dtype, mesh)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rate = self.dropout_rate
        hidden = self.norm1(hidden)
        qkv = self.qkv_proj(copy_to_model_parallel(hidden, self.group))
        query, key, value = qkv.split(self.width, dim=-1)
        attention = multi_head_attention(
            query, key, value, key_bias, self.head_dim**-0.5, self.heads, rate, rng, self.total_heads, self.head_offset
        )
        hidden = hidden + dropout(self.out_proj(attention), rate, rng)

        feed = self.linear1(copy_to_model_parallel(self.norm2(hidden), self.group))
        feed = torch.relu(feed) if self.activation == "relu" else fast_gelu(feed)
        feed = self.linear2(dropout(feed, rate, rng, self.feedforward_size, self.column_offset))
        return hidden + dropout(feed, rate, rng)


@dataclasses.dataclass(frozen=True)
class TransformerArchitecture:
    """The static shape of a transformer acoustic model: its configuration and
    input feature size (what ``Wav2Vec2Architecture`` is to the encoder)."""

    config: TransformerAcousticModelConfig
    feature_size: int

    @property
    def frontend_output_size(self) -> int:
        frontend = self.config.frontend
        if isinstance(frontend, LinearFrontendConfig):
            return frontend.neurons
        return self.feature_size

    @property
    def hidden_size(self) -> int:
        """d_model: the frontend's width, or the sequential frontend's last."""
        if self.config.sequential_frontend is not None:
            return _sequential_plan(self.config.sequential_frontend, self.frontend_output_size)[1]
        return self.frontend_output_size

    @property
    def num_hidden_layers(self) -> int:
        return self.config.transformer.num_layers

    def downsampled_lengths(self, lengths):
        if self.config.sequential_frontend is None:
            return lengths
        plan, _, _ = _sequential_plan(self.config.sequential_frontend, self.frontend_output_size)
        return sequential_frontend_lengths(plan, lengths)


class TransformerAcousticModel(nn.Module):
    """Frontend + optional sequential frontend + pre-LN transformer collecting every
    layer's output, each passed through the final layer norm (reference :704-722):
    (features [B, T, F] or samples [B, T], lengths) -> (outputs, lengths).
    ``mesh`` shards the transformer layers over its model axis; the frontends
    and the norms stay replicated."""

    def __init__(
        self, architecture: TransformerArchitecture, dtype: torch.dtype = torch.float32, device=None, param_dtype=None, mesh=None
    ):
        super().__init__()
        self.arch = architecture
        config = architecture.config
        affine = config.elementwise_affine
        frontend = config.frontend
        if isinstance(frontend, LinearFrontendConfig):
            self.frontend_norm = LayerNorm(architecture.feature_size, LAYER_NORM_EPS, dtype, device, affine)
            self.frontend_linear = Dense(architecture.feature_size, frontend.neurons, dtype, device, param_dtype)
        elif not isinstance(frontend, DirectFrontendConfig):
            raise ValueError(f"Unsupported frontend config type {frontend.__class__.__name__}")
        self.sequential_frontend = None
        if config.sequential_frontend is not None:
            plan, _, _ = _sequential_plan(config.sequential_frontend, architecture.frontend_output_size)
            self.sequential_frontend = SequentialFrontend(plan, architecture.frontend_output_size, dtype, device, param_dtype)
        transformer = config.transformer
        d_model = architecture.hidden_size
        self.layers = nn.ModuleList(
            PreLNTransformerLayer(
                d_model, transformer.heads, transformer.feedforward_neurons, transformer.dropout_rate,
                transformer.activation, affine, dtype, device, param_dtype, mesh,
            )
            for _ in range(transformer.num_layers)
        )
        self.final_norm = LayerNorm(d_model, LAYER_NORM_EPS, dtype, device, affine)

    def forward(
        self, features: torch.Tensor, lengths: torch.Tensor, rng: Optional[DropoutRng] = None
    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        config = self.arch.config
        frontend = config.frontend
        if features.dim() == 2:
            features = features[:, :, None]
        features = dropout(features, frontend.input_dropout, rng)
        if isinstance(frontend, LinearFrontendConfig):
            features = leaky_relu(self.frontend_linear(self.frontend_norm(features)))

        transformer = config.transformer
        features = dropout(features, transformer.dropout_rate, rng)
        if self.sequential_frontend is not None:
            features, lengths = self.sequential_frontend(features, lengths, rng)

        batch, time, d_model = features.shape
        if transformer.positional_embeddings:
            features = features + sinusoidal_positions(time, d_model, features.dtype, features.device)[None]

        key_bias = key_bias_from_mask(masking.mask_sequence(lengths, time), batch, time, features.device)
        outputs = []
        hidden = features
        for layer in self.layers:
            hidden = layer(hidden, key_bias, rng)
            outputs.append(hidden)
        return [self.final_norm(output) for output in outputs], lengths
