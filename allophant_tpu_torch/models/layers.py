"""Building blocks with flax's dtype semantics, and explicit-generator dropout.

A flax layer built with ``dtype=bf16`` keeps float32 parameters (its
``param_dtype``), casts its operands to bf16 for the matmul or convolution,
and computes normalisation statistics in float32. ``Dense`` and ``Conv1d``
do the same: the parameters live in ``param_dtype`` (float32 for training,
where the optimizer needs float32 master weights) and are cast to the compute
``dtype`` at each call. A serving model may store them in the compute dtype,
which makes the cast a no-op. The normalisation layers keep float32
parameters and upcast their input, as flax does. No autocast: its per-op
dtype rules are not flax's.

Dropout draws from an explicit ``torch.Generator`` (``DropoutRng``), never
from PyTorch's global one, so a training step is a function of its seeds."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class DropoutRng:
    """The random state of one training forward: ``host`` (a CPU generator)
    draws the attention-dropout kernel seeds without a device sync, ``device``
    (a generator on the activations' device) draws the elementwise masks."""

    host: torch.Generator
    device: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "DropoutRng":
        device = torch.device(device)
        host = torch.Generator(device="cpu").manual_seed(seed)
        return cls(host, torch.Generator(device=device).manual_seed(seed + 1))

    def kernel_seeds(self):
        """Two int32 seeds for the attention-dropout kernels, drawn on the host."""
        seeds = torch.randint(-(2**31), 2**31 - 1, (2,), generator=self.host, dtype=torch.int64)
        return int(seeds[0]), int(seeds[1])


def dropout(hidden: torch.Tensor, rate: float, rng: Optional[DropoutRng]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: identity without ``rng`` (deterministic) or at
    rate 0, zeros at rate >= 1, else a Bernoulli keep mask from ``rng.device``
    with the kept values scaled by 1 / (1 - rate), in the input's dtype."""
    if rng is None or rate == 0.0:
        return hidden
    if rate >= 1.0:
        return torch.zeros_like(hidden)
    keep_prob = 1.0 - rate
    mask = torch.empty_like(hidden).bernoulli_(keep_prob, generator=rng.device)
    return hidden * mask / keep_prob


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=param_dtype)``: weight [out, in]
    (torch's layout) and bias in ``param_dtype``, cast with the input to
    ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        param_dtype = dtype if param_dtype is None else param_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        return F.linear(inputs.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over channel-last [B, T, C]: weight [Cout, Cin/groups, K]
    (torch's layout) and bias in ``param_dtype``, cast with the input to
    ``dtype``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        groups: int = 1,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
        param_dtype=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        param_dtype = dtype if param_dtype is None else param_dtype
        shape = (out_channels, in_channels // groups, kernel_size)
        self.weight = nn.Parameter(torch.empty(shape, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, dtype=param_dtype, device=device)) if bias else None

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        out = F.conv1d(hidden.to(dtype).transpose(1, 2), self.weight.to(dtype), bias, self.stride, self.padding, 1, self.groups)
        return out.transpose(1, 2)


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
