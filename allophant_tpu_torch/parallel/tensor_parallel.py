"""Megatron's autograd functions and the row-parallel Dense layer of the
tensor-parallel models (the wav2vec2 encoder, the transformer acoustic model
and the projection head's attention).

A column-parallel projection takes the whole input and gives this rank's
columns of the output; a row-parallel one takes this rank's columns and gives
its partial sum of the whole output. Around them:

- ``copy_to_model_parallel`` ("f"): the identity forward; the backward sums
  the input gradient over the model group (each rank's columns contributed
  their part of it);
- ``reduce_from_model_parallel`` ("g"): the forward sums the partial outputs
  over the model group; the backward is the identity;
- ``gather_from_model_parallel``: the forward lays the ranks' column blocks
  side by side (a layer that needs the whole width, as the head attention's
  LayerNorm after its column-parallel input projection); the backward takes
  this rank's columns of the gradient, which every rank holds whole.

With a model group of one rank (``group`` None) each is the identity."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from typing import Optional, Tuple

from allophant_tpu_torch.models.layers import Dense
from allophant_tpu_torch.parallel.mesh import all_reduce, gather_rows


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


class _GatherFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, group, rank, parallel):
        width = inputs.shape[-1]
        ctx.columns = slice(rank * width, (rank + 1) * width)
        blocks = gather_rows(inputs.movedim(-1, 0).contiguous(), rank * width, parallel * width, group)
        return blocks.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.columns].contiguous(), None, None, None


def copy_to_model_parallel(inputs: torch.Tensor, group) -> torch.Tensor:
    return inputs if group is None else _CopyToModelParallel.apply(inputs, group)


def reduce_from_model_parallel(inputs: torch.Tensor, group) -> torch.Tensor:
    return inputs if group is None else _ReduceFromModelParallel.apply(inputs, group)


def gather_from_model_parallel(inputs: torch.Tensor, mesh) -> torch.Tensor:
    """The whole last axis of which ``inputs`` holds this rank's equal block,
    on every rank of ``mesh``'s model group (None, or a group of one: the
    identity). The gather is an all-reduce of zero-padded blocks: exact."""
    if mesh is None or mesh.model_group is None:
        return inputs
    return _GatherFromModelParallel.apply(inputs, mesh.model_group, mesh.model_rank, mesh.model_parallel)


def model_parallel(mesh) -> Tuple[int, Optional[object]]:
    """(tp, model group) of ``mesh`` (None: one device)."""
    return (1, None) if mesh is None else (mesh.model_parallel, mesh.model_group)


def split_evenly(size: int, parts: int, what: str) -> int:
    """``size / parts``; raises when ``size`` does not split."""
    if size % parts:
        raise ValueError(f"{size} {what} do not split over {parts} model-parallel ranks")
    return size // parts


def rank_offset(mesh, local: int) -> int:
    """The first of this rank's ``local`` units (heads, columns) of the whole."""
    return 0 if mesh is None else mesh.model_rank * local


def output_dense(in_features: int, out_features: int, dtype, device, param_dtype, mesh) -> Dense:
    """A Dense of the whole input (one device) or its row-parallel shard."""
    tp, group = model_parallel(mesh)
    if tp == 1:
        return Dense(in_features, out_features, dtype, device, param_dtype)
    return RowParallelDense(in_features // tp, out_features, dtype, device, param_dtype, group)


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
