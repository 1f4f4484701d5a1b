"""Plain PyTorch reference of the benchmark's models: the wav2vec2 / XLS-R
encoder (Baevski et al. 2020; Babu et al. 2021: a 7-layer convolutional
extractor with layer norm and GELU, a grouped positional convolution,
pre-LN transformer layers) under allophant's hierarchical head (Glocker et
al. 2023: one linear CTC classifier per articulatory attribute, a phoneme
layer of attribute-embedding composition and the allophone layer's max
over each phoneme's allophones).

Everything is float32 with TF32 off unless ``Numerics`` asks for a lower
precision (the control). The parameters carry the names of the benchmark's
weights. Departures from the published description, each shared with the
program by construction of the benchmark's weights:
- the positional convolution's weight norm is folded into a plain kernel;
- q, k and v are the three row blocks of one ``qkv_proj`` matrix;
- the head's tables (composition features, allophone gathers) are the
  frozen demo head's, not Allophoible's.
Nothing here imports the program."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.dropout import DropoutDraws, attention_scale
from cardbench.reference.numerics import round_operand

NEG_INF = -1e9


@dataclass(frozen=True)
class Numerics:
    """Operand rounding of the encoder's and the head's products."""

    encoder: str = "float32"
    head: str = "float32"


def gelu(value: torch.Tensor) -> torch.Tensor:
    return 0.5 * value * (1.0 + torch.erf(value * 2.0**-0.5))


def frame_lengths(lengths: torch.Tensor, kernels, strides) -> torch.Tensor:
    for kernel, stride in zip(kernels, strides):
        lengths = (lengths - kernel) // stride + 1
    return lengths


class Linear(nn.Module):
    def __init__(self, inputs: int, outputs: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(outputs, inputs, device=device))
        self.bias = nn.Parameter(torch.empty(outputs, device=device))

    def forward(self, value: torch.Tensor, kind: str) -> torch.Tensor:
        return F.linear(round_operand(value, kind), round_operand(self.weight, kind), self.bias)


class Conv(nn.Module):
    def __init__(self, inputs: int, outputs: int, kernel: int, stride: int = 1, padding: int = 0, groups: int = 1, device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(outputs, inputs // groups, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(outputs, device=device))

    def forward(self, value: torch.Tensor, kind: str) -> torch.Tensor:
        """[B, C, T] -> [B, C', T']."""
        weight = round_operand(self.weight, kind)
        return F.conv1d(round_operand(value, kind), weight, self.bias, self.stride, self.padding, 1, self.groups)


class Norm(nn.Module):
    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, value: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(value, value.shape[-1:], self.weight, self.bias, self.eps)


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


class _AcousticModel(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.feature_extractor = _Extractor(arch, device)
        self.feature_projection = _FeatureProjection(arch, device)
        self.encoder = _Encoder(arch, device)


class _Composition(nn.Module):
    def __init__(self, count: int, size: int, device=None):
        super().__init__()
        self.attribute_embeddings = nn.Parameter(torch.empty(count, size, device=device))


class _Allophone(nn.Module):
    def __init__(self, shape, device=None):
        super().__init__()
        self.allophone_matrices = nn.Parameter(torch.empty(shape, device=device))


class _Head(nn.Module):
    def __init__(self, hidden: int, plan: dict, device=None):
        super().__init__()
        self.classifiers = nn.ModuleDict(
            {node["name"]: Linear(hidden, node["projection_size"], device) for node in plan["nodes"]}
        )
        size, count = plan["composition"][0], plan["composition"][1]
        self.composition = _Composition(count, size, device)
        languages, shared, phonemes, _gathers = plan["allophone_shape"]
        self.allophone = _Allophone((languages, shared, phonemes), device)


@dataclass
class Sites:
    """Where a training forward draws its dropout: the generators, the port's
    padded [rows, frames] of this microbatch, and the dtypes of the encoder's
    and the head's activations there."""

    draws: DropoutDraws
    rows: int
    frames: int
    encoder_dtype: torch.dtype
    head_dtype: torch.dtype

    def keep(self, width: int, rate: float, dtype: torch.dtype, rows: int, time: int) -> Optional[torch.Tensor]:
        if rate == 0.0:
            return None
        mask = self.draws.keep((self.rows, self.frames, width), dtype, rate)
        return mask[:rows, :time] / (1.0 - rate)


class ReferenceAllophant(nn.Module):
    """The whole model: ``forward(audio, lengths, language_ids)`` gives the
    head's logits by name, batch-first [B, T, C], and the frame lengths."""

    def __init__(self, arch: dict, head: dict, training: dict, device=None):
        super().__init__()
        self.arch = arch
        self.plan = head["plan"]
        self.training_config = training
        self.acoustic_model = _AcousticModel(arch, device)
        self.projection = _Head(arch["hidden_size"], self.plan, device)
        static = head["static"]
        table = torch.as_tensor(static["composition_feature_table"].astype(np.int64), device=device)
        offsets = torch.as_tensor(np.asarray(self.plan["composition"][2], dtype=np.int64), device=device)
        self.register_buffer("composition_indices", table + offsets[None, :], persistent=False)
        gather = torch.as_tensor(static["allophone_gather"].astype(np.int64), device=device)
        self.register_buffer("allophone_gather", gather, persistent=False)
        start = torch.as_tensor(static["allophone_matrices"], device=device)
        self.register_buffer("allophone_initialization", start, persistent=False)
        self.attribute_names = [node["name"] for node in self.plan["nodes"] if not node.get("has_composition")]
        self.phoneme_name = next(node["name"] for node in self.plan["nodes"] if node.get("has_composition"))

    def shapes(self):
        return [(name, tuple(parameter.shape)) for name, parameter in self.named_parameters()]

    def frame_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return frame_lengths(lengths, self.arch["conv_kernel"], self.arch["conv_stride"])

    # -- encoder -------------------------------------------------------------

    def extract(self, audio: torch.Tensor, lengths: torch.Tensor, kind: str) -> torch.Tensor:
        """Normalised audio [B, S] -> features [B, T, C] (the frozen extractor)."""
        arch = self.arch
        if arch["do_normalize"]:
            mask = (torch.arange(audio.shape[1], device=audio.device)[None] < lengths[:, None]).float()
            count = lengths.clamp_min(1).float()[:, None]
            mean = (audio * mask).sum(1, keepdim=True) / count
            variance = (((audio - mean) * mask) ** 2).sum(1, keepdim=True) / count
            audio = (audio - mean) / torch.sqrt(variance + 1e-7) * mask
        extractor = self.acoustic_model.feature_extractor
        hidden = audio[:, None, :]
        for conv, norm in zip(extractor.convs, extractor.norms):
            hidden = gelu(norm(conv(hidden, kind).transpose(1, 2)).transpose(1, 2))
        return hidden.transpose(1, 2)

    def encode(self, features: torch.Tensor, frames: torch.Tensor, kind: str, sites: Optional[Sites]) -> torch.Tensor:
        arch = self.arch
        model = self.acoustic_model
        batch, time, _ = features.shape
        width = arch["hidden_size"]
        hidden = model.feature_projection.projection(model.feature_projection.layer_norm(features), kind)
        if sites is not None and arch["feat_proj_dropout"] > 0:
            hidden = hidden * sites.keep(width, arch["feat_proj_dropout"], sites.encoder_dtype, batch, time)
        valid = torch.arange(time, device=features.device)[None] < frames[:, None]
        hidden = hidden * valid[:, :, None].float()
        encoder = model.encoder
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

    # -- head ----------------------------------------------------------------

    def head_logits(self, hidden: torch.Tensor, kind: str, sites: Optional[Sites]) -> Dict[str, torch.Tensor]:
        """Logits of every classifier; the phoneme classifier's are the
        composed phone logits [B, T, P + 1]."""
        if sites is not None:
            batch, time, width = hidden.shape
            hidden = hidden * sites.keep(width, self.training_config["acoustic_model_dropout"], sites.head_dtype, batch, time)
        head = self.projection
        outputs = {name: head.classifiers[name](hidden, kind) for name in self.attribute_names}
        projected = head.classifiers[self.phoneme_name](hidden, kind)
        embeddings = head.composition.attribute_embeddings
        composed = torch.cat((embeddings[:1], embeddings[self.composition_indices].sum(dim=1)), dim=0)
        size = embeddings.shape[1]
        logits = F.linear(round_operand(projected, kind), round_operand(composed, kind)) * (1.0 / math.sqrt(size))
        outputs[self.phoneme_name] = logits
        return outputs

    def map_allophones(self, phone_logits: torch.Tensor, language_ids: torch.Tensor) -> torch.Tensor:
        """Each phoneme's logit: the largest of its allophones' phone logits
        times their weights in the language's allophone matrix."""
        gather = self.allophone_gather[language_ids]  # [B, P, K]
        valid = gather >= 0
        safe = gather.clamp_min(0)
        batch, phonemes, width = safe.shape
        time = phone_logits.shape[1]
        gathered = torch.gather(
            phone_logits, 2, safe.reshape(batch, 1, phonemes * width).expand(batch, time, phonemes * width)
        ).reshape(batch, time, phonemes, width)
        matrices = self.projection.allophone.allophone_matrices[language_ids].transpose(1, 2)  # [B, P, S]
        weights = torch.gather(matrices, 2, safe)
        return (gathered * weights[:, None]).masked_fill(~valid[:, None], NEG_INF).amax(dim=-1)

    def l2_penalty(self) -> torch.Tensor:
        difference = self.projection.allophone.allophone_matrices - self.allophone_initialization
        squared = difference.square().sum(dim=(1, 2))
        positive = squared > 0
        return torch.where(positive, torch.where(positive, squared, torch.ones_like(squared)).sqrt(), 0.0).sum()

    def forward(
        self,
        audio: torch.Tensor,
        lengths: torch.Tensor,
        language_ids: torch.Tensor,
        numerics: Numerics = Numerics(),
        sites: Optional[Sites] = None,
        serve: bool = True,
    ):
        """(outputs by name [B, T, C], frame lengths [B]). Serving gives the
        38 outputs (the phone layer as both ``phone`` and ``phoneme``);
        training the 37 CTC heads, the phoneme head through the allophone
        layer. The extractor runs without gradients (frozen)."""
        with torch.no_grad():
            features = self.extract(audio, lengths, numerics.encoder)
        frames = self.frame_lengths(lengths)
        hidden = self.encode(features, frames, numerics.encoder, sites)
        outputs = self.head_logits(hidden, numerics.head, sites)
        if serve:
            outputs["phone"] = outputs[self.phoneme_name]
        else:
            outputs[self.phoneme_name] = self.map_allophones(outputs[self.phoneme_name], language_ids)
        return outputs, frames


def serving_heads(plan: dict) -> List[str]:
    """The 38 outputs a serving request decodes, in the order the benchmark
    asks for them: the classifiers in plan order, then the phone layer."""
    return [node["name"] for node in plan["nodes"]] + ["phone"]
