"""Length and mask utilities (counterpart of ``allophant_tpu/ops/masking.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mask_sequence(lengths: torch.Tensor, max_length: int, inverse: bool = False, batch_first: bool = True):
    """Boolean [B, T] (or [T, B]) mask of valid positions from a length vector."""
    positions = torch.arange(max_length, device=lengths.device)
    if batch_first:
        mask = positions[None, :] < lengths[:, None]
    else:
        mask = positions[:, None] < lengths[None, :]
    return ~mask if inverse else mask


def conv_output_length(lengths, kernel_size: int, stride: int = 1, padding: int = 0):
    """Output length of a 1D convolution: floor((len + padding - kernel) / stride) + 1.

    Works on tensors, numpy arrays and plain ints."""
    return (lengths + padding - kernel_size) // stride + 1


def stacked_conv_output_lengths(
    lengths, kernels: Sequence[int], strides: Sequence[int], paddings: Sequence[int] | None = None
):
    if paddings is None:
        paddings = [0] * len(kernels)
    for kernel_size, stride, padding in zip(kernels, strides, paddings):
        lengths = conv_output_length(lengths, kernel_size, stride, padding)
    return lengths


def zero_mean_unit_var_norm(features: torch.Tensor, lengths: torch.Tensor, mask: torch.Tensor):
    """Per-utterance normalization over valid positions only. ``features``: [B, T];
    ``mask``: [B, T] bool.

    The length in the denominator is clamped to 1: a zero-length filler row
    would otherwise divide 0 by 0 and carry NaNs into the encoder."""
    mask = mask.to(features.dtype)
    lengths = lengths.clamp_min(1).to(features.dtype)
    means = (features * mask).sum(dim=1, keepdim=True) / lengths[:, None]
    deviations = (features - means) * mask
    variances = (deviations**2).sum(dim=1, keepdim=True) / lengths[:, None]
    return ((features - means) / torch.sqrt(variances + 1e-7)) * mask


def get_padding(kernel_size: int, stride: int = 1, stft_type: bool = False) -> Tuple[int, int]:
    """Symmetric-ish padding amounts of the from-scratch frontend convolutions
    (reference padding.py:10-21)."""
    if stft_type:
        padding = kernel_size // 2
        if stride == 1:
            return (padding, padding - 1)
        return (padding, padding)
    if stride > 1:
        # Enough padding for a strided filter to reach the edge.
        return (kernel_size // 2, kernel_size - 1)
    padding = kernel_size // 2
    return (padding, padding)
