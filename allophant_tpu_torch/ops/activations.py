"""GELU with the JAX package's per-dtype rule (``allophant_tpu/ops/activations.py``).

float32 (and wider) inputs take the exact erf form. bf16/f16 inputs take the
tanh-polynomial fit of erf(x / sqrt(2)) evaluated in float32 with the same
constants, then round back — using exact erf there instead would move bf16
activations by up to one ulp against the reference."""

from __future__ import annotations

import torch

# Least-squares fit of erf(x / sqrt(2)) ~= tanh(x * (C1 + x^2 (C3 + x^2 (C5 + x^2 C7))))
# over x in [0, 6] (max erf error 1.4e-5); x^2 clamped at 36 so the tail saturates.
_C1 = 7.978187993e-01
_C3 = 3.654991252e-02
_C5 = -1.958085291e-04
_C7 = -1.356392330e-05
_CLAMP = 36.0
_INV_SQRT2 = 2.0**-0.5


def gelu_exact(value: torch.Tensor) -> torch.Tensor:
    return 0.5 * value * (1.0 + torch.erf(value * _INV_SQRT2))


def fast_gelu(value: torch.Tensor) -> torch.Tensor:
    """Exact-GELU semantics; sub-f32 dtypes use the tanh-polynomial erf in f32."""
    if value.dtype in (torch.float32, torch.float64):
        return gelu_exact(value)
    x = value.float()
    x2 = torch.clamp(x * x, max=_CLAMP)
    p = x * (_C1 + x2 * (_C3 + x2 * (_C5 + x2 * _C7)))
    return (0.5 * x * (1.0 + torch.tanh(p))).to(value.dtype)
