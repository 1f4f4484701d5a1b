"""The benchmark's weights: every parameter drawn from the run's seed on the
device in one call, then scaled leaf by leaf. The same tensors are loaded
into the port's model and into the plain reference, whose parameters carry
the same names.

- matrices and convolution kernels: N(0, 1) / sqrt(fan_in);
- normalisation scales: 1 + 0.1 N(0, 1); other vectors: 0.02 N(0, 1);
- attribute embeddings: N(0, 1);
- allophone matrices: the head's frozen table (they start at the
  allophone relation, which the L2 pull holds them to)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw(shapes: Shapes, seed: int, device, static: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """float32 tensors by name, views of one flat draw on ``device``."""
    total = sum(int(np.prod(shape)) for _name, shape in shapes)
    flat = torch.randn(total, generator=generator(seed, device), device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape in shapes:
        size = int(np.prod(shape))
        value = flat[offset : offset + size].view(shape)
        offset += size
        leaf = name.rpartition(".")[2]
        if leaf == "allophone_matrices":
            value.copy_(torch.as_tensor(static["allophone_matrices"], device=device))
        elif leaf == "attribute_embeddings":
            pass
        elif len(shape) == 1:
            if leaf == "weight" and "norm" in name:
                value.mul_(0.1).add_(1.0)
            else:
                value.mul_(0.02)
        else:
            value.mul_(float(np.prod(shape[1:])) ** -0.5)
        out[name] = value
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copies ``weights`` into the module's parameters of the same names, each
    cast to the parameter's own dtype; raises unless the names are exactly
    the module's parameters."""
    parameters = dict(module.named_parameters())
    if set(parameters) != set(weights):
        missing = sorted(set(parameters) - set(weights))[:5]
        extra = sorted(set(weights) - set(parameters))[:5]
        raise KeyError(f"weights do not match the model's parameters: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, parameter in parameters.items():
            if tuple(parameter.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: model {tuple(parameter.shape)}, weights {tuple(weights[name].shape)}")
            parameter.copy_(weights[name])
