"""Device resolution and the global matmul/convolution precision switches."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for another.

    Raises when CUDA is requested (explicitly or by default) and no CUDA device
    is present — the port never carries on quietly on the CPU."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available; pass device='cpu' to run the plain PyTorch path"
        )
    return resolved


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``. To a CUDA device it
    goes through pinned memory and an asynchronous copy, so the caller does
    not wait for the work already queued on the stream."""
    tensor = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def set_float32_precision(f32_matmul_precision: str) -> None:
    """Sets how float32 matmuls and convolutions run on the GPU.

    ``"highest"`` is full float32: TF32 is switched off for cuBLAS matmuls AND
    for cuDNN convolutions (cuDNN runs float32 convolutions in TF32 by default,
    and the later feature-extractor convs and the positional conv go through
    it). ``"high"`` allows TF32 for both — the GPU's fast float32 mode. It is not
    the TPU's 3-pass bf16 lowering that the JAX preset of the same name selects:
    TF32 keeps a 10-bit mantissa per operand, the 3-pass scheme about 16 bits.

    The switches are process-global torch state; the CPU ignores them."""
    if f32_matmul_precision not in ("highest", "high"):
        raise ValueError(f"Unknown float32 matmul precision {f32_matmul_precision!r}")
    allow_tf32 = f32_matmul_precision == "high"
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
