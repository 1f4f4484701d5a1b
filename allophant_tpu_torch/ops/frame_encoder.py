"""Fused first wav2vec2 feature-extractor layer (counterpart of
``allophant_tpu/ops/frame_encoder.py``): conv(k=10, s=5, 1 -> C) + bias +
LayerNorm over channels + exact GELU over raw audio, [B, S] -> [B, S//5 - 1, C].

``fused_frame_conv`` launches the CUDA kernel ``csrc/frame_encoder.cu`` for
CUDA tensors and runs the plain twin ``reference_frame_conv`` for CPU tensors,
through the custom op ``allophant_torch::frame_conv`` (``kernels/library.py``,
whose CUDA implementation is ``launch_frame_conv``).
``FusedFrameConv`` makes it differentiable: its backward differentiates the
plain twin, as the JAX package's ``custom_vjp`` differentiates its jnp
formulation (the TPU kernel has no backward either). The flagship never
reaches it, since its frozen feature extractor runs without gradients; a
configuration with ``freeze_feature_encoder`` false does.
The dot takes f32 operands as the TPU kernel's does (the JAX package's jnp
``_reference_frame_conv`` casts to bf16 first, but that is the formulation of
its backward pass, not the kernel's)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from allophant_tpu_torch.kernels.build import check_launch, load_kernel

_TAPS = 10
_STRIDE = 5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _trim(audio: torch.Tensor) -> torch.Tensor:
    """A VALID conv never reads past the last full stride-5 window: drop the tail."""
    samples = audio.shape[1]
    return audio[:, : samples - samples % _STRIDE]


def reference_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps: float, out_dtype) -> torch.Tensor:
    """Plain twin: unfold + f32 matmul, F.layer_norm and exact (erf) GELU."""
    frames = _trim(audio).float().unfold(1, _TAPS, _STRIDE)  # [B, F, 10]
    hidden = frames @ kernel.float() + bias.float()
    normalized = F.layer_norm(hidden, (hidden.shape[-1],), ln_scale.float(), ln_bias.float(), eps)
    return F.gelu(normalized).to(out_dtype)


def frame_count(samples: int) -> int:
    """Output frames of ``samples`` raw samples: S // 5 - 1, and none below 10
    (a symbolic count under ``torch.export``)."""
    return torch.sym_max(samples // _STRIDE - 1, 0)


def fused_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps: float = 1e-5, out_dtype=torch.bfloat16):
    """``audio``: [B, S] f32; ``kernel``: [10, C] f32, any C >= 1 (the kernel
    takes up to 1,024 channels in one pass and more in chunks of 1,024).
    Returns [B, S//5 - 1, C] in ``out_dtype``, through the custom op
    ``allophant_torch::frame_conv`` (``kernels/library.py``): the twin for CPU
    tensors, the kernel for CUDA tensors.
    ``fused_frame_conv.launches`` counts kernel launches."""
    from allophant_tpu_torch.kernels import library

    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_frame_conv runs on CPU or CUDA tensors, not {audio.device}")
    return library.frame_conv(audio, kernel, bias, ln_scale, ln_bias, float(eps), out_dtype)


fused_frame_conv.launches = 0


def launch_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps: float, out_dtype) -> torch.Tensor:
    """The CUDA implementation of the frame encoder's custom op: launches the
    kernel on CUDA tensors and raises on anything it does not take."""
    if audio.device.type != "cuda":
        raise ValueError(f"the frame encoder kernel takes CUDA tensors, not {audio.device}")
    audio = _trim(audio)
    batch, samples = audio.shape
    if audio.dtype != torch.float32 or audio.stride(1) != 1:
        raise ValueError("frame encoder kernel takes f32 audio with contiguous samples")
    if kernel.ndim != 2 or kernel.shape[0] != _TAPS or kernel.shape[1] < 1:
        raise ValueError(f"frame encoder kernel takes a [10, C] kernel with C >= 1, got {tuple(kernel.shape)}")
    channels = kernel.shape[1]
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"frame encoder kernel writes f32 or bf16, not {out_dtype}")
    parameters = [
        tensor.to(torch.float32).contiguous() for tensor in (kernel, bias, ln_scale, ln_bias)
    ]
    for tensor in parameters:
        if tensor.device != audio.device:
            raise ValueError("frame encoder parameters must be on the audio's device")
    frames = frame_count(samples)
    out = torch.empty(batch, frames, channels, dtype=out_dtype, device=audio.device)
    if batch == 0 or frames == 0:
        return out
    forward = load_kernel("frame_encoder")
    with torch.cuda.device(audio.device):
        status = forward(
            audio.data_ptr(), *(tensor.data_ptr() for tensor in parameters), out.data_ptr(),
            batch, frames, channels, audio.stride(0), eps, _DTYPE_CODES[out_dtype],
            torch.cuda.current_stream(audio.device).cuda_stream,
        )
    check_launch("frame_encoder", status)
    fused_frame_conv.launches += 1
    return out


class FusedFrameConv(torch.autograd.Function):
    """``fused_frame_conv`` forward; backward through the plain twin."""

    @staticmethod
    def forward(ctx, audio, kernel, bias, ln_scale, ln_bias, eps: float, out_dtype):
        ctx.save_for_backward(audio, kernel, bias, ln_scale, ln_bias)
        ctx.eps, ctx.out_dtype = eps, out_dtype
        return fused_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        inputs = [tensor.detach().requires_grad_(needed) for tensor, needed in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = reference_frame_conv(*inputs, ctx.eps, ctx.out_dtype)
            wanted = [tensor for tensor in inputs if tensor.requires_grad]
            gradients = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(gradients) if tensor.requires_grad else None for tensor in inputs), None, None)
