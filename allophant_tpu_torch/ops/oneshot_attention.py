"""One-shot attention over the projection layout [B, T, H*hd] with an additive
f32 key bias (counterpart of ``allophant_tpu/ops/oneshot_attention.py``).

``oneshot_attention`` launches the CUDA kernel ``csrc/oneshot_attention.cu``
for CUDA tensors and runs the plain twin ``reference_oneshot`` for CPU
tensors. The kernel serves every sequence length, so the TPU's plan table
(full / head-blocked / query-blocked, bounded by VMEM) has no counterpart."""

from __future__ import annotations

import ctypes

import torch

from allophant_tpu_torch.kernels.build import check_launch, load_kernel

NEG_INF = -1e9
LOG2E = 1.4426950408889634
# Softmax denominator clamp: a fully padded (zero-length) row stays finite.
TINY_TOTAL = 1e-30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # every released wav2vec2 / XLS-R encoder


def reference_oneshot(query, key, value, key_bias, sm_scale: float, heads: int) -> torch.Tensor:
    """Plain twin of the kernel: einsum over [B, T, H, hd] views with the same
    base-2 softmax, biased peak, (s - peak) + bias exponent, bf16 rounding of the
    unnormalised weights and 1e-30 clamp on the denominator."""
    batch, time, model_dim = query.shape
    head_dim = model_dim // heads
    shape = (batch, time, heads, head_dim)
    scores = torch.einsum(
        "bthd,bshd->bhts", query.reshape(shape).float(), key.reshape(shape).float()
    ) * (sm_scale * LOG2E)
    bias = (key_bias.float() * LOG2E)[:, None, None, :]
    peak = (scores + bias).amax(dim=-1, keepdim=True)
    weights = torch.exp2((scores - peak) + bias)
    total = weights.sum(dim=-1, keepdim=True).clamp_min(TINY_TOTAL)
    weights = weights.to(value.dtype).float()
    context = torch.einsum("bhts,bshd->bthd", weights, value.reshape(shape).float())
    context = context / total.permute(0, 2, 1, 3)
    return context.reshape(batch, time, model_dim).to(query.dtype)


def oneshot_attention(query, key, value, key_bias, sm_scale: float, heads: int) -> torch.Tensor:
    """[B, T, H*hd] attention with additive key bias [B, T] f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and raise on
    anything it does not take). ``oneshot_attention.launches`` counts launches."""
    if query.device.type == "cpu":
        return reference_oneshot(query, key, value, key_bias, sm_scale, heads)
    if query.device.type != "cuda":
        raise ValueError(f"oneshot_attention runs on CPU or CUDA tensors, not {query.device}")
    batch, time, model_dim = query.shape
    head_dim = model_dim // heads
    if query.dtype not in _DTYPE_CODES:
        raise ValueError(f"oneshot_attention kernel takes f32 or bf16, not {query.dtype}")
    if head_dim * heads != model_dim or head_dim != _HEAD_DIM:
        raise ValueError(f"oneshot_attention kernel takes head_dim {_HEAD_DIM}, got {model_dim}/{heads}")
    for name, tensor in (("key", key), ("value", value)):
        if tensor.shape != query.shape or tensor.dtype != query.dtype or tensor.device != query.device:
            raise ValueError(f"{name} must match query in shape, dtype and device")
    for tensor in (query, key, value):
        if tensor.stride(2) != 1:
            raise ValueError("oneshot_attention kernel needs a contiguous feature axis")
    if key_bias.shape != (batch, time) or key_bias.dtype != torch.float32 or key_bias.device != query.device:
        raise ValueError("key_bias must be f32 [B, T] on the query's device")
    key_bias = key_bias.contiguous()
    out = torch.empty(batch, time, model_dim, dtype=query.dtype, device=query.device)
    if batch == 0 or time == 0:
        return out
    strides = (ctypes.c_longlong * 8)(
        query.stride(0), query.stride(1), key.stride(0), key.stride(1),
        value.stride(0), value.stride(1), out.stride(0), out.stride(1),
    )
    forward = load_kernel("oneshot_attention")
    with torch.cuda.device(query.device):
        status = forward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            batch, time, heads, head_dim, ctypes.cast(strides, ctypes.c_void_p),
            sm_scale * LOG2E, LOG2E, _DTYPE_CODES[query.dtype],
            torch.cuda.current_stream(query.device).cuda_stream,
        )
    check_launch("oneshot_attention", status)
    oneshot_attention.launches += 1
    return out


oneshot_attention.launches = 0
