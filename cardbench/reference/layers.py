"""The reference's building blocks, shared by every encoder under
``reference/encoders/`` and by the head in ``reference/model.py``: products
and convolutions that round their operands as ``Numerics`` asks, layer
norm, exact GELU, and the dropout sites of a training forward. Nothing here
imports the program."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cardbench.reference.dropout import DropoutDraws
from cardbench.reference.numerics import round_operand

NEG_INF = -1e9


def gelu(value: torch.Tensor) -> torch.Tensor:
    return 0.5 * value * (1.0 + torch.erf(value * 2.0**-0.5))


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
