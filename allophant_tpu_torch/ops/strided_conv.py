"""Strided 1D convolution as stride-grouped matmuls (counterpart of
``allophant_tpu/ops/strided_conv.py``).

Because the stride divides the sequence into disjoint sample groups, a
VALID-padding strided conv is exactly a sum of ``ceil(K / stride)`` matmuls
over a stride-grouped relayout (a pad-or-slice copy whenever ``rows * stride``
differs from ``T``):

    grouped[b, r, :] = concat(x[b, r*s], ..., x[b, r*s + s - 1])    # [B, R, s*C]
    out[b, t] = sum_g grouped[b, t + g, :taps_g * C] @ W_g

where ``W_g`` stacks kernel taps ``[g*s, min(K, (g+1)*s))``. For the stride-2
layers of the wav2vec2 feature extractor this is one [B, T', 2C] x [2C, C']
matmul (kernel 2: the whole conv) plus, for kernel 3, a second [B, T', C] x
[C, C'] matmul for the odd tap: the convolution's arithmetic, all of it in
dense matmuls.

The JAX package measured this formulation end to end against the
convolution and kept it out of its encoder: the relayouts of the early
layers' large activations cost more memory traffic than the denser matmul
tiling saved. The port's encoder does not call it either (its feature
extractor runs cuDNN's convolutions); it is kept, held to JAX's function and
to ``F.conv1d``, as the same documented study. Plain PyTorch: the JAX module
is no Pallas kernel."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def strided_conv_matmul(
    hidden: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor], stride: int, *, dtype=None
) -> torch.Tensor:
    """VALID-padding 1D convolution via stride-grouped matmuls.

    Args:
        hidden: [B, T, C_in] input activations.
        kernel: [K, C_in, C_out] convolution kernel (JAX's ``nn.Conv`` layout).
        bias: [C_out] bias or None.
        stride: convolution stride (must be >= 1).
        dtype: compute dtype; kernel and bias are cast to it. Defaults to
            ``hidden.dtype``.

    Returns:
        [B, (T - K) // stride + 1, C_out] outputs, matching a VALID
        convolution of that stride (``F.conv1d`` over the channels-first
        layout).
    """
    taps_total, c_in, c_out = kernel.shape
    batch, length, _ = hidden.shape
    out_len = (length - taps_total) // stride + 1
    if out_len < 1:
        raise ValueError(f"input length {length} shorter than kernel {taps_total}")
    compute_dtype = dtype or hidden.dtype
    hidden = hidden.to(compute_dtype)
    kernel = kernel.to(compute_dtype)

    groups = -(-taps_total // stride)
    rows = out_len + groups - 1
    needed = rows * stride
    if needed > length:
        hidden = F.pad(hidden, (0, 0, 0, needed - length))
    elif needed < length:
        hidden = hidden[:, :needed]
    grouped = hidden.reshape(batch, rows, stride * c_in)

    out = None
    for group in range(groups):
        taps = min(taps_total - group * stride, stride)
        weights = kernel[group * stride : group * stride + taps].reshape(taps * c_in, c_out)
        window = grouped[:, group : group + out_len, : taps * c_in]
        term = window @ weights
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.to(compute_dtype)
    return out
