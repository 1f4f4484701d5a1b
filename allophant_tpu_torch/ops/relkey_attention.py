"""Relative-key one-shot attention (K7) of w2v-BERT 2.0's Conformer layers,
over the projection layout [B, T, H*hd] with an additive f32 key bias.

Score (i, j) of a head is ``(q_i . k_j + q_i . E[clamp(j - i, -left, right)
+ left]) / sqrt(hd)`` plus the key bias of j, where ``E`` is the layer's
[left + right + 1, hd] table of distance embeddings (transformers'
``Wav2Vec2BertSelfAttention`` with ``position_embeddings_type =
"relative_key"``). As a bias the relative term depends on the query, so it
would be a [B, H, T, T] tensor; the kernel (``csrc/relkey_attention.cu``)
forms each query tile's [64, left + right + 1] dot products with ``E`` in
shared memory and gathers them by ``j - i``, and never writes it.

``relkey_attention`` launches the kernel for CUDA tensors (bf16 only: the
card runs no float32 route, and a float32 call there raises) and runs the
plain twin ``reference_relkey_attention`` for CPU tensors; a launch can be
captured in a CUDA graph. The twin keeps transformers' einsum form and K1's
arithmetic: a base-2 softmax whose peak takes the biased scores, the
unnormalised weights rounded to the value's dtype before P.V and the total
clamped at 1e-30. Neither has a backward (w2v-BERT is served, not trained,
by the port)."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from allophant_tpu_torch import tracing
from allophant_tpu_torch.kernels.build import check_launch, load_kernel
from allophant_tpu_torch.ops.oneshot_attention import (
    LOG2E,
    MAX_TILE_HEAD_DIM,
    TINY_TOTAL,
    _check_kernel_inputs,
    _merge_heads,
    _split_heads,
    _strides,
    _unpad_heads,
)

#: The most distances the kernel's shared memory holds (left + right + 1).
MAX_POSITIONS = 256


def relative_distances(time: int, left: int, right: int, device=None) -> torch.Tensor:
    """[T, T] rows of ``E`` for each (query i, key j): clamp(j - i, -left,
    right) + left."""
    positions = torch.arange(time, device=device)
    return (positions[None, :] - positions[:, None]).clamp(-left, right) + left


def reference_relkey_attention(
    query, key, value, key_bias, distance_embedding, sm_scale: float, heads: int, left: int, right: int
) -> torch.Tensor:
    """Plain twin of K7: transformers' ``einsum("bhld,lrd->bhlr", q, E[distance])``
    added to q.k^T in f32, then K1's base-2 softmax and bf16 weights."""
    batch, time, _ = query.shape
    q = _split_heads(query, heads)
    table = distance_embedding.to(query.dtype).float()[relative_distances(time, left, right, query.device)]
    scores = q @ _split_heads(key, heads).transpose(-1, -2) + torch.einsum("bhld,lrd->bhlr", q, table)
    scores = scores * (sm_scale * LOG2E)
    bias = (key_bias.float() * LOG2E)[:, None, None, :]
    peak = (scores + bias).amax(dim=-1, keepdim=True)
    exponentials = torch.exp2((scores - peak) + bias)
    total = exponentials.sum(dim=-1, keepdim=True).clamp_min(TINY_TOTAL)
    weights = exponentials.to(value.dtype).float()
    return _merge_heads(weights @ _split_heads(value, heads) / total, query.dtype)


def relkey_attention(
    query, key, value, key_bias, distance_embedding, sm_scale: float, heads: int, left: int, right: int
) -> torch.Tensor:
    """K7: [B, T, H*hd] q/k/v (strided views allowed), an f32 key bias [B, T]
    and the distance table ``distance_embedding`` [left + right + 1, hd] ->
    [B, T, H*hd] in the query's dtype. CPU tensors run the plain twin; CUDA
    tensors launch the kernel and raise on anything it does not take.
    ``relkey_attention.launches`` counts launches; a launch under CUDA graph
    capture is recorded, not made, and counts in ``relkey_attention.captured``
    instead, so that a graph adds the launches its capture recorded at each
    replay (``models/w2v_bert.py``)."""
    capturing = query.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing:
        tracing.count("relkey_attention_calls")
    positions = left + right + 1
    if left < 0 or right < 0 or distance_embedding.shape[0] != positions:
        raise ValueError(
            f"relkey_attention: left {left} and right {right} need a table of {positions} distances,"
            f" not {tuple(distance_embedding.shape)}"
        )
    if query.device.type == "cpu":
        return reference_relkey_attention(query, key, value, key_bias, distance_embedding, sm_scale, heads, left, right)
    if query.dtype != torch.bfloat16:
        raise ValueError(f"relkey_attention runs bf16 on the card (K7 has no {query.dtype} route)")
    if positions > MAX_POSITIONS:
        raise ValueError(f"relkey_attention holds at most {MAX_POSITIONS} distances in shared memory, not {positions}")
    (query, key, value), head_dim, padded = _check_kernel_inputs("relkey_attention", query, (key, value), key_bias, heads)
    if padded > MAX_TILE_HEAD_DIM:
        raise ValueError(f"relkey_attention takes heads up to {MAX_TILE_HEAD_DIM} wide, not {head_dim}")
    if distance_embedding.shape[1] != head_dim or distance_embedding.device != query.device:
        raise ValueError(f"relkey_attention: the distance table must be [{positions}, {head_dim}] on the query's device")
    table = distance_embedding.to(torch.bfloat16)
    table = F.pad(table, (0, padded - head_dim)) if padded != head_dim else table.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("relkey_attention: the distance table needs a 16-byte-aligned data pointer")
    batch, time, model_dim = query.shape
    key_bias = key_bias.contiguous()
    out = torch.empty(batch, time, model_dim, dtype=query.dtype, device=query.device)
    if batch == 0 or time == 0:
        return _unpad_heads(out, heads, head_dim).contiguous()
    forward = load_kernel("relkey_attention")
    with torch.cuda.device(query.device):
        status = forward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), key_bias.data_ptr(), table.data_ptr(), out.data_ptr(),
            batch, time, heads, padded, left, right, ctypes.cast(_strides(query, key, value, out), ctypes.c_void_p),
            sm_scale * LOG2E, LOG2E, torch.cuda.current_stream(query.device).cuda_stream,
        )
    check_launch("relkey_attention", status)
    if capturing:
        relkey_attention.captured += 1
    else:
        relkey_attention.launches += 1
    return out if padded == head_dim else _unpad_heads(out, heads, head_dim).contiguous()


relkey_attention.launches = 0
relkey_attention.captured = 0
