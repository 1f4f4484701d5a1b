"""wav2vec2 / XLS-R speech encoder (counterpart of
``allophant_tpu/models/wav2vec2.py``).

Batch-first [B, T, D] layout throughout, as in the JAX model. Differences that
do not change valid outputs:
- no 128-frame alignment padding: the attention kernels take any T, and frames
  past each row's length are masked (keys) or dropped downstream (queries);
- q, k and v come from one fused [D, 3D] projection, and the attention kernels
  read them in place through their strides;
- no rematerialisation yet: activations are kept for the backward.

Every dropout site of the JAX model is here (feature projection, encoder
input, attention weights, after attention, FFN activation and output); a
forward with ``rng=None`` is deterministic. ``frozen_prefix`` (JAX
``Wav2Vec2Model.frozen_prefix``) runs the whole-run-frozen prefix of
(feature extractor, feature projection, encoder) under ``torch.no_grad()``."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from allophant_tpu_torch.models.layers import ChannelGroupNorm, Conv1d, Dense, DropoutRng, LayerNorm, dropout
from allophant_tpu_torch.ops import masking
from allophant_tpu_torch.ops.activations import fast_gelu
from allophant_tpu_torch.ops.attention import key_bias_from_mask, multi_head_attention
from allophant_tpu_torch.ops.frame_encoder import FusedFrameConv


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Architecture:
    """Static architecture hyperparameters (mirrors the public wav2vec2 config;
    the defaults are XLS-R 300M)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (XLS-R) or "group" (base wav2vec2)
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    do_normalize: bool = True
    use_attention_mask: bool = True

    def downsampled_lengths(self, lengths):
        """CTC frame counts after the conv feature extractor (no padding)."""
        return masking.stacked_conv_output_lengths(lengths, self.conv_kernel, self.conv_stride)

    def truncated(self, maximum_encoder_layers: Optional[int]) -> "Wav2Vec2Architecture":
        """Limits encoder depth to the highest required intermediate tap."""
        if maximum_encoder_layers is None or maximum_encoder_layers >= self.num_hidden_layers:
            return self
        return dataclasses.replace(self, num_hidden_layers=maximum_encoder_layers)

    @property
    def fuses_first_layer(self) -> bool:
        """Whether the first conv + LayerNorm + GELU run as the fused frame
        encoder kernel (the JAX model's condition, wav2vec2.py:171-176)."""
        return self.feat_extract_norm == "layer" and self.conv_kernel[0] == 10 and self.conv_stride[0] == 5


class ConvFeatureEncoder(nn.Module):
    """Strided 1D convolutions over raw audio: [B, S] -> [B, T', C]."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        in_channels = 1
        for layer_id, (out_channels, kernel, stride) in enumerate(
            zip(arch.conv_dim, arch.conv_kernel, arch.conv_stride)
        ):
            # The fused first layer reads f32 weights, as the TPU kernel does.
            fused = layer_id == 0 and arch.fuses_first_layer
            self.convs.append(
                Conv1d(
                    in_channels, out_channels, kernel, stride, bias=arch.conv_bias,
                    dtype=torch.float32 if fused else dtype, device=device,
                    param_dtype=torch.float32 if fused else param_dtype,
                )
            )
            if arch.feat_extract_norm == "layer":
                self.norms.append(LayerNorm(out_channels, arch.layer_norm_eps, dtype, device))
            elif layer_id == 0:
                self.norms.append(ChannelGroupNorm(out_channels, arch.layer_norm_eps, dtype, device))
            in_channels = out_channels

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        first = 0
        if arch.fuses_first_layer:
            conv, norm = self.convs[0], self.norms[0]
            bias = conv.bias if conv.bias is not None else torch.zeros_like(norm.bias)
            hidden = FusedFrameConv.apply(
                audio, conv.weight[:, 0, :].t(), bias, norm.weight, norm.bias, arch.layer_norm_eps, self.dtype
            )
            first = 1
        else:
            hidden = audio[:, :, None].to(self.dtype)
        for layer_id in range(first, len(self.convs)):
            hidden = self.convs[layer_id](hidden)
            if layer_id < len(self.norms):
                hidden = self.norms[layer_id](hidden)
            hidden = fast_gelu(hidden)
        return hidden


class FeatureProjection(nn.Module):
    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.dropout_rate = arch.feat_proj_dropout
        self.layer_norm = LayerNorm(arch.conv_dim[-1], arch.layer_norm_eps, dtype, device)
        self.projection = Dense(arch.conv_dim[-1], arch.hidden_size, dtype, device, param_dtype)

    def forward(self, features: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return dropout(self.projection(self.layer_norm(features)), self.dropout_rate, rng)


class PositionalConvEmbedding(nn.Module):
    """Grouped convolutional relative position embeddings (weight norm folded
    into the plain kernel, as in the JAX model)."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        kernel = arch.num_conv_pos_embeddings
        self.trim = kernel % 2 == 0
        self.conv = Conv1d(
            arch.hidden_size, arch.hidden_size, kernel, padding=kernel // 2,
            groups=arch.num_conv_pos_embedding_groups, dtype=dtype, device=device, param_dtype=param_dtype,
        )

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        embeddings = self.conv(hidden)
        if self.trim:
            # Padding kernel//2 on both sides makes one frame too many for an
            # even kernel; the trailing one is dropped.
            embeddings = embeddings[:, :-1]
        return fast_gelu(embeddings)


class SelfAttention(nn.Module):
    """Multi-head self-attention over the one-shot kernels; q/k/v come from one
    fused projection whose [B, T, 3D] output the kernels read through strides.
    Training attention dropout runs inside the kernel (K5) for every
    0 < rate < 1."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.heads = arch.num_attention_heads
        self.hidden_size = arch.hidden_size
        self.dropout_rate = arch.attention_dropout
        self.qkv_proj = Dense(arch.hidden_size, 3 * arch.hidden_size, dtype, device, param_dtype)
        self.out_proj = Dense(arch.hidden_size, arch.hidden_size, dtype, device, param_dtype)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        qkv = self.qkv_proj(hidden)
        query, key, value = qkv.split(self.hidden_size, dim=-1)
        head_dim = self.hidden_size // self.heads
        context = multi_head_attention(
            query, key, value, key_bias, head_dim**-0.5, self.heads, self.dropout_rate, rng
        )
        return self.out_proj(context)


class FeedForward(nn.Module):
    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.activation_dropout = arch.activation_dropout
        self.hidden_dropout = arch.hidden_dropout
        self.intermediate_dense = Dense(arch.hidden_size, arch.intermediate_size, dtype, device, param_dtype)
        self.output_dense = Dense(arch.intermediate_size, arch.hidden_size, dtype, device, param_dtype)

    def forward(self, hidden: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        hidden = dropout(fast_gelu(self.intermediate_dense(hidden)), self.activation_dropout, rng)
        return dropout(self.output_dense(hidden), self.hidden_dropout, rng)


class EncoderLayer(nn.Module):
    """Transformer encoder layer: pre-LN ("stable layer norm", XLS-R) or post-LN."""

    def __init__(self, arch: Wav2Vec2Architecture, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.stable = arch.do_stable_layer_norm
        self.hidden_dropout = arch.hidden_dropout
        self.layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.attention = SelfAttention(arch, dtype, device, param_dtype)
        self.final_layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.feed_forward = FeedForward(arch, dtype, device, param_dtype)

    def forward(self, hidden: torch.Tensor, key_bias: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        attention_input = self.layer_norm(hidden) if self.stable else hidden
        attention_output = dropout(self.attention(attention_input, key_bias, rng), self.hidden_dropout, rng)
        hidden = hidden + attention_output
        if not self.stable:
            hidden = self.layer_norm(hidden)
        feed_forward_input = self.final_layer_norm(hidden) if self.stable else hidden
        hidden = hidden + self.feed_forward(feed_forward_input, rng)
        return hidden if self.stable else self.final_layer_norm(hidden)


class Wav2Vec2Encoder(nn.Module):
    """Encoder stack. With ``collect_all`` it returns every layer's input plus
    the final (normed) output — the taps "OUTPUT_<i>" classifiers read; without
    it, only the final state."""

    def __init__(
        self, arch: Wav2Vec2Architecture, dtype: torch.dtype, collect_all: bool = True, device=None, param_dtype=None
    ):
        super().__init__()
        self.stable = arch.do_stable_layer_norm
        self.hidden_dropout = arch.hidden_dropout
        self.collect_all = collect_all
        self.pos_conv_embed = PositionalConvEmbedding(arch, dtype, device, param_dtype)
        self.layer_norm = LayerNorm(arch.hidden_size, arch.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(
            EncoderLayer(arch, dtype, device, param_dtype) for _ in range(arch.num_hidden_layers)
        )

    def forward(
        self, hidden: torch.Tensor, pad_mask: Optional[torch.Tensor], rng: Optional[DropoutRng] = None
    ) -> List[torch.Tensor]:
        if pad_mask is not None:
            # Zero padded positions so the positional conv sees silence there.
            hidden = hidden * pad_mask[:, :, None].to(hidden.dtype)
        hidden = hidden + self.pos_conv_embed(hidden)
        if not self.stable:
            hidden = self.layer_norm(hidden)
        hidden = dropout(hidden, self.hidden_dropout, rng)
        batch, time, _ = hidden.shape
        key_bias = key_bias_from_mask(pad_mask, batch, time, hidden.device)
        states = [hidden] if self.collect_all else []
        for layer in self.layers:
            hidden = layer(hidden, key_bias, rng)
            if self.collect_all:
                states.append(hidden)
        if self.stable:
            hidden = self.layer_norm(hidden)
        if not self.collect_all:
            return [hidden]
        states[-1] = hidden
        return states


class Wav2Vec2Model(nn.Module):
    """Raw audio [B, S] + lengths -> (hidden_states, frame_lengths), where
    hidden_states is a list of [B, T', D] tensors (num_hidden_layers + 1 of
    them with ``collect_all``, else just the final one).

    ``param_dtype`` (None = ``dtype``) stores the matmul and convolution
    weights; ``frozen_prefix`` is the number of leading groups of
    (feature_extractor, feature_projection, encoder) that run without
    gradients (JAX: ``stop_gradient`` at the prefix boundary)."""

    def __init__(
        self,
        arch: Wav2Vec2Architecture,
        dtype: torch.dtype = torch.float32,
        collect_all: bool = True,
        device=None,
        param_dtype=None,
        frozen_prefix: int = 0,
    ):
        super().__init__()
        self.arch = arch
        self.frozen_prefix = frozen_prefix
        self.feature_extractor = ConvFeatureEncoder(arch, dtype, device, param_dtype)
        self.feature_projection = FeatureProjection(arch, dtype, device, param_dtype)
        self.encoder = Wav2Vec2Encoder(arch, dtype, collect_all, device, param_dtype)

    def _prefix(self, group: int):
        """The gradient mode of the ``group``-th group (1-based)."""
        return torch.no_grad() if self.frozen_prefix >= group else contextlib.nullcontext()

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor, rng: Optional[DropoutRng] = None):
        arch = self.arch
        with self._prefix(1):
            if arch.do_normalize:
                sample_mask = masking.mask_sequence(lengths, audio.shape[1])
                audio = masking.zero_mean_unit_var_norm(audio, lengths, sample_mask)
            features = self.feature_extractor(audio)
        frame_lengths = arch.downsampled_lengths(lengths)
        pad_mask = masking.mask_sequence(frame_lengths, features.shape[1]) if arch.use_attention_mask else None
        with self._prefix(2):
            hidden = self.feature_projection(features, rng)
        with self._prefix(3):
            hidden_states = self.encoder(hidden, pad_mask, rng)
        return hidden_states, frame_lengths
