"""Megatron's pair of autograd functions and the row-parallel Dense layer of
the tensor-parallel encoder.

A column-parallel projection takes the whole input and gives this rank's
columns of the output; a row-parallel one takes this rank's columns and gives
its partial sum of the whole output. Around them:

- ``copy_to_model_parallel`` ("f"): the identity forward; the backward sums
  the input gradient over the model group (each rank's columns contributed
  their part of it);
- ``reduce_from_model_parallel`` ("g"): the forward sums the partial outputs
  over the model group; the backward is the identity.

With a model group of one rank (``group`` None) both are the identity."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from allophant_tpu_torch.models.layers import Dense
from allophant_tpu_torch.parallel.mesh import all_reduce


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, group):
        ctx.group = group
        return inputs.view_as(inputs)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, group):
        return all_reduce(inputs.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_parallel(inputs: torch.Tensor, group) -> torch.Tensor:
    return inputs if group is None else _CopyToModelParallel.apply(inputs, group)


def reduce_from_model_parallel(inputs: torch.Tensor, group) -> torch.Tensor:
    return inputs if group is None else _ReduceFromModelParallel.apply(inputs, group)


class RowParallelDense(Dense):
    """A Dense layer of which this rank holds ``in_features`` input columns:
    its partial product is summed over the model group, then the (replicated)
    bias is added."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None, param_dtype=None, group=None):
        super().__init__(in_features, out_features, dtype, device, param_dtype)
        self.group = group

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        partial = F.linear(inputs.to(dtype), self.weight.to(dtype))
        return reduce_from_model_parallel(partial, self.group) + self.bias.to(dtype)
