"""The port's ``ops/strided_conv.py`` against the JAX package's
``strided_conv_matmul`` and against ``F.conv1d`` on the same seeded inputs,
at the eight feature-extractor shapes of ``tests/test_ops.py`` (rtol = atol
= 1e-5, float32), and its no-bias and too-short cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from allophant_tpu.ops.strided_conv import strided_conv_matmul as jax_strided_conv_matmul
from allophant_tpu_torch.ops.strided_conv import strided_conv_matmul

TOLERANCE = 1e-5


def _conv1d(hidden, kernel, bias, stride):
    """``F.conv1d`` over [B, T, C_in] and a [K, C_in, C_out] kernel."""
    out = F.conv1d(hidden.transpose(1, 2), kernel.permute(2, 1, 0), bias, stride=stride)
    return out.transpose(1, 2)


@pytest.mark.parametrize(
    "kernel_size,stride,length",
    [(2, 2, 64), (3, 2, 64), (3, 2, 65), (4, 2, 50), (6, 2, 51), (10, 5, 163), (5, 3, 47), (3, 1, 20)],
)
def test_matches_jax_and_conv1d(kernel_size, stride, length):
    rng = np.random.default_rng(kernel_size * 100 + stride)
    c_in, c_out = 6, 5
    hidden = rng.standard_normal((2, length, c_in)).astype(np.float32)
    kernel = rng.standard_normal((kernel_size, c_in, c_out)).astype(np.float32)
    bias = rng.standard_normal((c_out,)).astype(np.float32)

    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jax_strided_conv_matmul(jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(bias), stride))
    tensors = [torch.from_numpy(array) for array in (hidden, kernel, bias)]
    got = strided_conv_matmul(*tensors, stride)
    assert got.shape == (2, (length - kernel_size) // stride + 1, c_out) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=TOLERANCE, atol=TOLERANCE)
    np.testing.assert_allclose(got.numpy(), _conv1d(*tensors, stride).numpy(), rtol=TOLERANCE, atol=TOLERANCE)


def test_no_bias_and_short_input():
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((1, 3, 4)).astype(np.float32)
    kernel = rng.standard_normal((3, 4, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        expected = np.asarray(jax_strided_conv_matmul(jnp.asarray(hidden), jnp.asarray(kernel), None, 2))
    got = strided_conv_matmul(torch.from_numpy(hidden), torch.from_numpy(kernel), None, 2)
    np.testing.assert_allclose(got.numpy(), expected, rtol=TOLERANCE, atol=TOLERANCE)
    np.testing.assert_allclose(
        got.numpy(), _conv1d(torch.from_numpy(hidden), torch.from_numpy(kernel), None, 2).numpy(), rtol=TOLERANCE, atol=TOLERANCE
    )
    with pytest.raises(ValueError, match="shorter than kernel"):
        strided_conv_matmul(torch.from_numpy(hidden[:, :2]), torch.from_numpy(kernel), None, 2)


def test_compute_dtype_casts_kernel_and_bias():
    """``dtype`` casts the input, kernel and bias, as flax's promotion does:
    bf16 outputs within bf16's rounding of the float32 result."""
    rng = np.random.default_rng(3)
    hidden, kernel, bias = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for shape in ((2, 40, 8), (3, 8, 4), (4,)))
    got = strided_conv_matmul(hidden, kernel, bias, 2, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    expected = strided_conv_matmul(hidden, kernel, bias, 2)
    np.testing.assert_allclose(got.float().numpy(), expected.numpy(), rtol=0, atol=0.1)
