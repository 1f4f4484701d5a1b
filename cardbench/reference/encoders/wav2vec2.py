"""Plain PyTorch reference of the wav2vec2 / XLS-R encoder (Baevski et al.
2020; Babu et al. 2021): a 7-layer convolutional extractor with layer norm
and GELU, a grouped positional convolution, pre-LN transformer layers.

Everything is float32 with TF32 off unless ``Numerics`` asks for a lower
precision (the control). The parameters carry the names of the benchmark's
weights under ``acoustic_model.``. Departures from the published
description, each shared with the program by construction of the
benchmark's weights:
- the positional convolution's weight norm is folded into a plain kernel;
- q, k and v are the three row blocks of one ``qkv_proj`` matrix.
Nothing here imports the program."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cardbench.reference.dropout import attention_scale
from cardbench.reference.layers import NEG_INF, Conv, Linear, Norm, Sites, gelu
from cardbench.reference.numerics import round_operand

#: The architecture keys this reference reads.
KEYS = (
    "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
    "conv_dim", "conv_kernel", "conv_stride", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
    "layer_norm_eps", "hidden_dropout", "activation_dropout", "attention_dropout", "feat_proj_dropout",
    "do_normalize",
)
#: Keys whose one value this reference implements: biased convolutions, the
#: extractor's layer norm (XLS-R, not base wav2vec2's group norm), pre-LN.
FIXED = {"conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True}


def frame_lengths(lengths: torch.Tensor, kernels, strides) -> torch.Tensor:
    for kernel, stride in zip(kernels, strides):
        lengths = (lengths - kernel) // stride + 1
    return lengths


class _Extractor(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        channels = [1] + list(arch["conv_dim"])
        self.convs = nn.ModuleList(
            Conv(channels[i], channels[i + 1], kernel, stride, device=device)
            for i, (kernel, stride) in enumerate(zip(arch["conv_kernel"], arch["conv_stride"]))
        )
        self.norms = nn.ModuleList(Norm(width, arch["layer_norm_eps"], device) for width in arch["conv_dim"])


class _FeatureProjection(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.layer_norm = Norm(arch["conv_dim"][-1], arch["layer_norm_eps"], device)
        self.projection = Linear(arch["conv_dim"][-1], arch["hidden_size"], device)


class _PositionalConv(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        kernel = arch["num_conv_pos_embeddings"]
        self.conv = Conv(
            arch["hidden_size"], arch["hidden_size"], kernel, padding=kernel // 2,
            groups=arch["num_conv_pos_embedding_groups"], device=device,
        )


class _Attention(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.qkv_proj = Linear(arch["hidden_size"], 3 * arch["hidden_size"], device)
        self.out_proj = Linear(arch["hidden_size"], arch["hidden_size"], device)


class _FeedForward(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.intermediate_dense = Linear(arch["hidden_size"], arch["intermediate_size"], device)
        self.output_dense = Linear(arch["intermediate_size"], arch["hidden_size"], device)


class _Layer(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.layer_norm = Norm(arch["hidden_size"], arch["layer_norm_eps"], device)
        self.attention = _Attention(arch, device)
        self.final_layer_norm = Norm(arch["hidden_size"], arch["layer_norm_eps"], device)
        self.feed_forward = _FeedForward(arch, device)


class _Encoder(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(arch, device)
        self.layer_norm = Norm(arch["hidden_size"], arch["layer_norm_eps"], device)
        self.layers = nn.ModuleList(_Layer(arch, device) for _ in range(arch["num_hidden_layers"]))


class AcousticModel(nn.Module):
    """The encoder: ``extract`` (audio to features, frozen), ``encode``
    (features to the hidden states the head reads) and ``frame_lengths``."""

    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.arch = arch
        self.feature_extractor = _Extractor(arch, device)
        self.feature_projection = _FeatureProjection(arch, device)
        self.encoder = _Encoder(arch, device)

    def frame_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return frame_lengths(lengths, self.arch["conv_kernel"], self.arch["conv_stride"])

    def extract(self, audio: torch.Tensor, lengths: torch.Tensor, kind: str) -> torch.Tensor:
        """Normalised audio [B, S] -> features [B, T, C] (the frozen extractor)."""
        arch = self.arch
        if arch["do_normalize"]:
            mask = (torch.arange(audio.shape[1], device=audio.device)[None] < lengths[:, None]).float()
            count = lengths.clamp_min(1).float()[:, None]
            mean = (audio * mask).sum(1, keepdim=True) / count
            variance = (((audio - mean) * mask) ** 2).sum(1, keepdim=True) / count
            audio = (audio - mean) / torch.sqrt(variance + 1e-7) * mask
        extractor = self.feature_extractor
        hidden = audio[:, None, :]
        for conv, norm in zip(extractor.convs, extractor.norms):
            hidden = gelu(norm(conv(hidden, kind).transpose(1, 2)).transpose(1, 2))
        return hidden.transpose(1, 2)

    def encode(self, features: torch.Tensor, frames: torch.Tensor, kind: str, sites: Optional[Sites]) -> torch.Tensor:
        arch = self.arch
        batch, time, _ = features.shape
        width = arch["hidden_size"]
        hidden = self.feature_projection.projection(self.feature_projection.layer_norm(features), kind)
        if sites is not None and arch["feat_proj_dropout"] > 0:
            hidden = hidden * sites.keep(width, arch["feat_proj_dropout"], sites.encoder_dtype, batch, time)
        valid = torch.arange(time, device=features.device)[None] < frames[:, None]
        hidden = hidden * valid[:, :, None].float()
        encoder = self.encoder
        position = encoder.pos_conv_embed.conv(hidden.transpose(1, 2), kind).transpose(1, 2)
        if arch["num_conv_pos_embeddings"] % 2 == 0:
            position = position[:, :-1]
        hidden = hidden + gelu(position)
        if sites is not None:
            hidden = hidden * sites.keep(width, arch["hidden_dropout"], sites.encoder_dtype, batch, time)
        bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
        heads = arch["num_attention_heads"]
        head_dim = width // heads
        for layer in encoder.layers:
            qkv = layer.attention.qkv_proj(layer.layer_norm(hidden), kind)
            query, key, value = (
                part.reshape(batch, time, heads, head_dim).transpose(1, 2) for part in qkv.split(width, dim=-1)
            )
            scores = round_operand(query, kind) @ round_operand(key, kind).transpose(-1, -2) * head_dim**-0.5
            weights = torch.softmax(scores + bias, dim=-1)
            if sites is not None and arch["attention_dropout"] > 0:
                seeds = sites.draws.attention_seeds()
                weights = weights * attention_scale(seeds, batch, heads, time, arch["attention_dropout"], weights.device)
            context = (round_operand(weights, kind) @ round_operand(value, kind)).transpose(1, 2).reshape(batch, time, width)
            attended = layer.attention.out_proj(context, kind)
            if sites is not None:
                attended = attended * sites.keep(width, arch["hidden_dropout"], sites.encoder_dtype, batch, time)
            hidden = hidden + attended
            inner = gelu(layer.feed_forward.intermediate_dense(layer.final_layer_norm(hidden), kind))
            if sites is not None:
                inner = inner * sites.keep(arch["intermediate_size"], arch["activation_dropout"], sites.encoder_dtype, batch, time)
            out = layer.feed_forward.output_dense(inner, kind)
            if sites is not None:
                out = out * sites.keep(width, arch["hidden_dropout"], sites.encoder_dtype, batch, time)
            hidden = hidden + out
        return encoder.layer_norm(hidden)
