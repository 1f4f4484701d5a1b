"""Plain PyTorch reference of the w2v-BERT 2.0 encoder (Seamless
Communication, Barrault et al. 2023; https://huggingface.co/facebook/w2v-bert-2.0):
``SeamlessM4TFeatureExtractor``'s Kaldi-style filterbank, a feature
projection and Conformer layers with relative-key self-attention, as
transformers' ``Wav2Vec2BertModel`` computes them
(``models/wav2vec2_bert/modeling_wav2vec2_bert.py``; no adapter).

The front end runs row by row over each row's own samples in float64, as
the extractor does, and hands float32 features on; everything after is
float32 with TF32 off unless ``Numerics`` asks for a lower precision (the
control), which rounds the operands of every product, the relative-key
one included. The parameters carry the names of the benchmark's weights
under ``acoustic_model.``, transformers' names but for one. Departures from
the published description, each shared with the program by construction of
the benchmark's weights or of its traffic:
- q, k and v are the three row blocks of one ``qkv_proj`` matrix
  (transformers' ``linear_q``, ``linear_k``, ``linear_v``);
- the extractor keeps the spectrum in complex64 between the FFT and the
  power; this keeps it in float64;
- the features are not padded to an even number of frames and then cut:
  a row's encoder frames are its whole pairs of frames, which is what the
  extractor's attention mask keeps.
Nothing here imports the program."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.layers import NEG_INF, Linear, Norm, Sites
from cardbench.reference.numerics import round_operand

#: The architecture keys this reference reads.
KEYS = (
    "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size", "feature_projection_input_dim",
    "layer_norm_eps", "left_max_position_embeddings", "right_max_position_embeddings", "conv_depthwise_kernel_size",
    "num_mel_bins", "stride",
)
#: Keys whose one value this reference implements.
FIXED = {"position_embeddings_type": "relative_key", "hidden_act": "swish", "add_adapter": False}

#: ``SeamlessM4TFeatureExtractor``'s front end at 16 kHz.
SAMPLE_RATE = 16_000
FRAME_LENGTH, HOP_LENGTH, FFT_LENGTH = 400, 160, 512
PREEMPHASIS = 0.97
MIN_FREQUENCY = 20.0
MEL_FLOOR = 1.192092955078125e-07


def frame_lengths(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    """Encoder frames of rows of ``lengths`` samples: whole ``stride``-frame
    stacks of the filterbank's frames (400 samples every 160)."""
    frames = ((lengths - FRAME_LENGTH) // HOP_LENGTH + 1).clamp_min(0)
    return frames // stride


def _mel(hertz):
    return 1127.0 * np.log(1.0 + hertz / 700.0)


def mel_filters(bins: int) -> np.ndarray:
    """[257, bins]: triangles on Kaldi's mel scale from 20 Hz to 8 kHz, drawn
    over the FFT bins' mel values (``mel_filter_bank(..., mel_scale="kaldi",
    triangularize_in_mel_space=True)``)."""
    centres = np.linspace(_mel(MIN_FREQUENCY), _mel(SAMPLE_RATE / 2), bins + 2)
    points = _mel(SAMPLE_RATE / FFT_LENGTH * np.arange(FFT_LENGTH // 2 + 1))[:, None]
    down = (points - centres[None, :-2]) / (centres[1:-1] - centres[:-2])
    up = (centres[None, 2:] - points) / (centres[2:] - centres[1:-1])
    return np.maximum(0.0, np.minimum(down, up))


def swish(value: torch.Tensor) -> torch.Tensor:
    return value * torch.sigmoid(value)


class _Kernel(nn.Module):
    """A convolution without bias (transformers' pointwise and depthwise
    ones), its operands rounded as ``Numerics`` asks."""

    def __init__(self, inputs: int, outputs: int, kernel: int, groups: int = 1, device=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(outputs, inputs // groups, kernel, device=device))

    def forward(self, value: torch.Tensor, kind: str) -> torch.Tensor:
        """[B, C, T] -> [B, C', T - kernel + 1]."""
        return F.conv1d(round_operand(value, kind), round_operand(self.weight, kind), None, 1, 0, 1, self.groups)


class _Table(nn.Module):
    def __init__(self, rows: int, columns: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, columns, device=device))


class _FeatureProjection(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.layer_norm = Norm(arch["feature_projection_input_dim"], arch["layer_norm_eps"], device)
        self.projection = Linear(arch["feature_projection_input_dim"], arch["hidden_size"], device)


class _FeedForward(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.intermediate_dense = Linear(arch["hidden_size"], arch["intermediate_size"], device)
        self.output_dense = Linear(arch["intermediate_size"], arch["hidden_size"], device)

    def forward(self, value: torch.Tensor, kind: str) -> torch.Tensor:
        return self.output_dense(swish(self.intermediate_dense(value, kind)), kind)


class _Attention(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        width = arch["hidden_size"]
        self.qkv_proj = Linear(width, 3 * width, device)
        self.linear_out = Linear(width, width, device)
        positions = arch["left_max_position_embeddings"] + arch["right_max_position_embeddings"] + 1
        self.distance_embedding = _Table(positions, width // arch["num_attention_heads"], device)


class _ConvolutionModule(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        width, eps = arch["hidden_size"], arch["layer_norm_eps"]
        self.layer_norm = Norm(width, eps, device)
        self.pointwise_conv1 = _Kernel(width, 2 * width, 1, device=device)
        self.depthwise_conv = _Kernel(width, width, arch["conv_depthwise_kernel_size"], groups=width, device=device)
        self.depthwise_layer_norm = Norm(width, eps, device)
        self.pointwise_conv2 = _Kernel(width, width, 1, device=device)

    def forward(self, hidden: torch.Tensor, valid: torch.Tensor, kind: str) -> torch.Tensor:
        """[B, T, C] -> [B, T, C]: LN, padded frames zeroed, GLU, the causal
        depthwise convolution (kernel - 1 zeros on the left), LN, swish."""
        value = (self.layer_norm(hidden) * valid[:, :, None]).transpose(1, 2)
        value = F.glu(self.pointwise_conv1(value, kind), dim=1)
        value = self.depthwise_conv(F.pad(value, (self.depthwise_conv.weight.shape[-1] - 1, 0)), kind)
        value = swish(self.depthwise_layer_norm(value.transpose(1, 2)))
        return self.pointwise_conv2(value.transpose(1, 2), kind).transpose(1, 2)


class _Layer(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        width, eps = arch["hidden_size"], arch["layer_norm_eps"]
        self.ffn1_layer_norm = Norm(width, eps, device)
        self.ffn1 = _FeedForward(arch, device)
        self.self_attn_layer_norm = Norm(width, eps, device)
        self.self_attn = _Attention(arch, device)
        self.conv_module = _ConvolutionModule(arch, device)
        self.ffn2_layer_norm = Norm(width, eps, device)
        self.ffn2 = _FeedForward(arch, device)
        self.final_layer_norm = Norm(width, eps, device)


class _Encoder(nn.Module):
    def __init__(self, arch: dict, device=None):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(arch, device) for _ in range(arch["num_hidden_layers"]))


class AcousticModel(nn.Module):
    """The encoder: ``extract`` (audio to stacked filterbank features),
    ``encode`` (features to the last layer's output, which the head reads)
    and ``frame_lengths``."""

    def __init__(self, arch: dict, device=None):
        super().__init__()
        if arch["feature_projection_input_dim"] != arch["num_mel_bins"] * arch["stride"]:
            raise ValueError("feature_projection_input_dim must be num_mel_bins x stride")
        self.arch = arch
        self.feature_projection = _FeatureProjection(arch, device)
        self.encoder = _Encoder(arch, device)

    def frame_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return frame_lengths(lengths, self.arch["stride"])

    def _row_features(self, samples: torch.Tensor) -> torch.Tensor:
        """One row's real samples in [-1, 1] -> its normalised log-mel
        frames [n, bins], as the extractor computes them (float64)."""
        arch = self.arch
        waveform = samples.double() * 2.0**15
        frames = waveform.unfold(0, FRAME_LENGTH, HOP_LENGTH)
        frames = frames - frames.mean(dim=1, keepdim=True)
        frames = torch.cat((frames[:, :1] * (1.0 - PREEMPHASIS), frames[:, 1:] - PREEMPHASIS * frames[:, :-1]), dim=1)
        window = torch.as_tensor(np.hanning(FRAME_LENGTH) ** 0.85, device=samples.device)
        power = torch.fft.rfft(frames * window, n=FFT_LENGTH).abs() ** 2
        filters = torch.as_tensor(mel_filters(arch["num_mel_bins"]), device=samples.device)
        energies = (power @ filters).clamp_min(MEL_FLOOR).log().float()
        return (energies - energies.mean(dim=0)) / torch.sqrt(energies.var(dim=0, correction=1) + 1e-7)

    def extract(self, audio: torch.Tensor, lengths: torch.Tensor, kind: str) -> torch.Tensor:
        """Audio [B, S] in [-1, 1] -> stacked features [B, T, stride * bins],
        zero past each row's frames (the front end has no products to round)."""
        stride = self.arch["stride"]
        frames = self.frame_lengths(lengths)
        features = torch.zeros(
            audio.shape[0], int(frames.max()), self.arch["feature_projection_input_dim"], device=audio.device
        )
        for row, (length, count) in enumerate(zip(lengths.tolist(), frames.tolist())):
            if count:
                energies = self._row_features(audio[row, :length])
                features[row, :count] = energies[: count * stride].reshape(count, -1)
        return features

    def encode(self, features: torch.Tensor, frames: torch.Tensor, kind: str, sites: Optional[Sites]) -> torch.Tensor:
        if sites is not None:
            raise ValueError("the w2v-BERT reference has no training forward: the configuration is served")
        arch = self.arch
        batch, time, _ = features.shape
        width, heads = arch["hidden_size"], arch["num_attention_heads"]
        head_dim = width // heads
        left, right = arch["left_max_position_embeddings"], arch["right_max_position_embeddings"]
        valid = torch.arange(time, device=features.device)[None] < frames[:, None]
        hidden = self.feature_projection.projection(self.feature_projection.layer_norm(features), kind)
        hidden = hidden * valid[:, :, None].float()
        bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
        positions = torch.arange(time, device=features.device)
        distance = (positions[None, :] - positions[:, None]).clamp(-left, right) + left
        for layer in self.encoder.layers:
            hidden = hidden + 0.5 * layer.ffn1(layer.ffn1_layer_norm(hidden), kind)
            attention = layer.self_attn
            qkv = attention.qkv_proj(layer.self_attn_layer_norm(hidden), kind)
            query, key, value = (
                round_operand(part.reshape(batch, time, heads, head_dim).transpose(1, 2), kind)
                for part in qkv.split(width, dim=-1)
            )
            table = round_operand(attention.distance_embedding.weight, kind)[distance]
            scores = (query @ key.transpose(-1, -2) + torch.einsum("bhld,lrd->bhlr", query, table)) * head_dim**-0.5
            weights = torch.softmax(scores + bias, dim=-1)
            context = (round_operand(weights, kind) @ value).transpose(1, 2).reshape(batch, time, width)
            hidden = hidden + attention.linear_out(context, kind)
            hidden = hidden + layer.conv_module(hidden, valid.float(), kind)
            hidden = layer.final_layer_norm(hidden + 0.5 * layer.ffn2(layer.ffn2_layer_norm(hidden), kind))
        return hidden
