"""Multi-head attention dispatch (counterpart of ``allophant_tpu/ops/attention.py``).

The encoder keeps heads folded in the projection layout [B, T, H*hd] (q, k and
v are strided views of one fused projection), expresses padding as an additive
f32 key bias (0 valid / -1e9 padded, ``key_bias_from_mask``) and calls
``multi_head_attention``:

- deterministic, or an attention-dropout rate of 0: ``OneshotAttention``
  (K1 forward, K4 backward);
- 0 < rate < 1: ``dropout_attention``, the dropout drawn inside the kernel
  (K5 forward, K4 backward). JAX asks ``kernel_dropout_supported`` first and
  falls back to einsum + ``nn.Dropout`` above T = 512; the CUDA kernels serve
  every T, so the port always takes K5;
- rate >= 1: ``reference_attention`` with a dropout that zeroes every weight
  (the kernel's keep_prob normalisation would be 0/0), as JAX does.

Unlike the JAX router there is no 128-frame alignment padding and no hand-over
to a library flash kernel for long sequences: the kernels take any T."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from allophant_tpu_torch.models.layers import DropoutRng, dropout
from allophant_tpu_torch.ops.oneshot_attention import NEG_INF, OneshotAttention, OneshotDropoutAttention


def key_bias_from_mask(pad_mask: Optional[torch.Tensor], batch: int, time: int, device) -> torch.Tensor:
    """Additive f32 key bias [B, T] from a validity mask (True = valid, or None)."""
    bias = torch.zeros(batch, time, dtype=torch.float32, device=device)
    return bias if pad_mask is None else bias.masked_fill_(~pad_mask, NEG_INF)


def reference_attention(
    query, key, value, pad_mask, sm_scale: float, dropout_module: Optional[Callable] = None
) -> torch.Tensor:
    """Plain einsum attention over [B, T, H, hd] with an f32 softmax (the JAX
    package's ``reference_attention``): masked keys get a -1e9 logit, and
    ``dropout_module`` (if any) is applied to the weights."""
    logits = torch.einsum("bthd,bshd->bhts", query * sm_scale, key)
    if pad_mask is not None:
        logits = logits.masked_fill(~pad_mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    if dropout_module is not None:
        weights = dropout_module(weights)
    return torch.einsum("bhts,bshd->bthd", weights, value)


def dropout_attention(
    query, key, value, key_bias, sm_scale: float, heads: int, rate: float, rng: DropoutRng,
    total_heads: Optional[int] = None, head_offset: int = 0,
):
    """[B, T, H*hd] attention with weight dropout drawn inside the kernel: the
    mask is a pure function of two int32 seeds drawn on the host from
    ``rng.host`` and of (batch, global head, row, col), so the backward
    regenerates it (reference HF attention-dropout semantics: dropout on
    softmaxed weights)."""
    seeds = rng.kernel_seeds()
    return OneshotDropoutAttention.apply(
        query, key, value, key_bias, seeds, sm_scale, heads, rate, total_heads, head_offset
    )


def multi_head_attention(
    query,
    key,
    value,
    key_bias,
    sm_scale: float,
    heads: int,
    dropout_rate: float = 0.0,
    rng: Optional[DropoutRng] = None,
    total_heads: Optional[int] = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Dispatch over [B, T, H*hd] q/k/v (strided views allowed) and a [B, T]
    f32 key bias; ``rng=None`` is the deterministic forward. The heads are
    heads ``head_offset ..`` of the model's ``total_heads`` (a tensor-parallel
    shard; default: all of them), which key the dropout mask."""
    if rng is None or dropout_rate == 0.0:
        return OneshotAttention.apply(query, key, value, key_bias, sm_scale, heads)
    if dropout_rate < 1.0:
        return dropout_attention(
            query, key, value, key_bias, sm_scale, heads, dropout_rate, rng, total_heads, head_offset
        )
    batch, time, model_dim = query.shape
    shape = (batch, time, heads, model_dim // heads)
    context = reference_attention(
        query.reshape(shape), key.reshape(shape), value.reshape(shape), key_bias == 0.0, sm_scale,
        lambda weights: dropout(weights, dropout_rate, rng),
    )
    return context.reshape(batch, time, model_dim)
