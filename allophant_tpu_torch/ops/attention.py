"""Multi-head attention dispatch (counterpart of ``allophant_tpu/ops/attention.py``).

Inference attention keeps heads folded in the projection layout [B, T, H*hd]
(the encoder's fused q/k/v projection), expresses padding as an additive f32
key bias (0 valid / -1e9 padded, ``key_bias_from_mask``) and runs
``oneshot_attention``: the CUDA kernel for CUDA tensors, its plain twin for CPU
tensors. Unlike the JAX router there is no 128-frame alignment padding and no
hand-over to a library flash kernel for long sequences: the kernel takes any T."""

from __future__ import annotations

from typing import Optional

import torch

from allophant_tpu_torch.ops.oneshot_attention import NEG_INF


def key_bias_from_mask(pad_mask: Optional[torch.Tensor], batch: int, time: int, device) -> torch.Tensor:
    """Additive f32 key bias [B, T] from a validity mask (True = valid, or None)."""
    bias = torch.zeros(batch, time, dtype=torch.float32, device=device)
    return bias if pad_mask is None else bias.masked_fill_(~pad_mask, NEG_INF)


def reference_attention(query, key, value, pad_mask, sm_scale: float) -> torch.Tensor:
    """Plain einsum attention with an f32 softmax (the JAX package's
    ``reference_attention`` without dropout): masked keys get a -1e9 logit."""
    logits = torch.einsum("bthd,bshd->bhts", query * sm_scale, key)
    if pad_mask is not None:
        logits = logits.masked_fill(~pad_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    return torch.einsum("bhts,bshd->bthd", weights, value)
