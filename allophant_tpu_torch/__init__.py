"""PyTorch/CUDA port of allophant_tpu for NVIDIA Hopper GPUs.

The JAX package ``allophant_tpu`` is the reference; this package mirrors its
layout module by module (``ops/``, ``models/``, ``training/``, ``data/``) and
imports none of it. Plain tensor code is PyTorch; every Pallas kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``, built on first use
by ``kernels/build.py``, with a plain-PyTorch twin beside it that runs for CPU
tensors.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with no
CUDA device they raise instead of falling back to the CPU."""

from allophant_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
