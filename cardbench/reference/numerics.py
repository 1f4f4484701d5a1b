"""How the reference rounds the operands of its matrix products and
convolutions: not at all (float32, the reference), or to a lower precision
(the control that the comparison has to fail).

- ``float32``: the operands as they are, TF32 off;
- ``bfloat16``: each operand rounded to bfloat16;
- ``tf32``: each operand's mantissa rounded to TF32's 10 bits, as a tensor
  core does with ``allow_tf32`` (emulated, so that the CPU gives the same);
- ``fp8``: each operand scaled by its absolute maximum to float8 e4m3's
  range (448), rounded to e4m3 and scaled back: per-tensor fp8 as fp8
  inference quantises.

The backward of a rounding is the identity (straight through): the
gradients flow through the rounded operands' products in float32."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
KINDS = ("float32", "bfloat16", "tf32", "fp8")


def _tf32(value: torch.Tensor) -> torch.Tensor:
    bits = value.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _fp8(value: torch.Tensor) -> torch.Tensor:
    scale = value.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (value / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_operand(value: torch.Tensor, kind: str) -> torch.Tensor:
    """``value`` (float32) rounded as ``kind`` says, straight through in the
    backward."""
    if kind == "float32":
        return value
    detached = value.detach()
    if kind == "bfloat16":
        rounded = detached.to(torch.bfloat16).to(torch.float32)
    elif kind == "tf32":
        rounded = _tf32(detached)
    elif kind == "fp8":
        rounded = _fp8(detached)
    else:
        raise ValueError(f"unknown rounding {kind!r} (expected one of {KINDS})")
    return value + (rounded - detached) if value.requires_grad else rounded


@contextlib.contextmanager
def full_float32():
    """Float32 products and convolutions with TF32 off for the duration (the
    port's preset switches are process-global), restored afterwards."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
