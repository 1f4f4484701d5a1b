"""Building blocks with flax's dtype semantics.

A flax layer built with ``dtype=bf16`` keeps float32 parameters, casts its
operands to bf16 for the matmul or convolution, and computes normalisation
statistics in float32. Here matmul and convolution weights are stored directly
in the compute dtype (the same numbers as a cast at every call, without the
cast), and the normalisation layers keep float32 parameters and upcast their
input, as flax does. No autocast: its per-op dtype rules are not flax's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: statistics, scale and shift in f32,
    output in the compute dtype."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        normalized = F.layer_norm(hidden.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return normalized.to(self.dtype)


class ChannelGroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=C)`` over channel-last [B, T, C]: each
    channel normalised over time, in f32, output in the compute dtype."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        channels = hidden.shape[-1]
        normalized = F.group_norm(
            hidden.float().transpose(1, 2), channels, self.weight, self.bias, self.eps
        )
        return normalized.transpose(1, 2).to(self.dtype)


def conv1d_channels_last(hidden: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Runs a torch Conv1d over channel-last [B, T, C] (flax's layout)."""
    return conv(hidden.transpose(1, 2)).transpose(1, 2)
