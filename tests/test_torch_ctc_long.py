"""The port's CTC gradient at long sequences (``ops/ctc.py``), held to the
exact gradient: at 500 frames (10 s of the flagship) and 1,000 frames it lies
no farther from the float64 gradient than the JAX package's float32 CTC
(``allophant_tpu/ops/ctc.py``, a log-space ``lax.scan``) does. Inputs as in
``tools/torch_ctc_precision.py``: seeded logits N(0, 3^2) of [2, T, 40], 30
labels a row, all frames valid; the largest gradient is about 1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.ops import ctc as jax_ctc
from allophant_tpu_torch.ops import ctc

BATCH, CLASSES, LABELS = 2, 40, 30


def _inputs(time_steps: int):
    rng = np.random.default_rng(time_steps)
    logits = (3 * rng.standard_normal((BATCH, time_steps, CLASSES))).astype(np.float32)
    labels = rng.integers(1, CLASSES, (BATCH, LABELS)).astype(np.int64)
    return logits, labels, np.full(BATCH, LABELS), np.full(BATCH, time_steps)


def _exact_gradient(logits, labels, label_lengths, lengths) -> np.ndarray:
    exact = torch.from_numpy(logits.astype(np.float64)).requires_grad_()
    torch.nn.functional.ctc_loss(
        torch.log_softmax(exact, -1).transpose(0, 1), torch.from_numpy(labels),
        torch.from_numpy(lengths), torch.from_numpy(label_lengths), reduction="sum",
    ).backward()
    return exact.grad.numpy()


@pytest.mark.parametrize("time_steps", [500, 1000])
def test_gradient_is_as_close_to_float64_as_jax_float32(time_steps):
    logits, labels, label_lengths, lengths = _inputs(time_steps)
    exact = _exact_gradient(logits, labels, label_lengths, lengths)

    tensor = torch.from_numpy(logits).requires_grad_()
    losses = ctc.ctc_loss_sum_heads(
        [("head", tensor, torch.from_numpy(labels), torch.from_numpy(label_lengths))], torch.from_numpy(lengths)
    )
    losses["head"].backward()
    assert tensor.grad.dtype == torch.float32
    port_error = np.abs(tensor.grad.numpy() - exact).max()

    jax_gradient = jax.grad(
        lambda values: jax_ctc.ctc_loss_sum_heads(
            [("head", values, jnp.asarray(labels, jnp.int32), jnp.asarray(label_lengths, jnp.int32))],
            jnp.asarray(lengths, jnp.int32),
        )["head"]
    )(jnp.asarray(logits))
    jax_error = np.abs(np.asarray(jax_gradient) - exact).max()

    assert np.abs(exact).max() == pytest.approx(1.0, abs=0.01)
    assert port_error <= jax_error, (port_error, jax_error)
