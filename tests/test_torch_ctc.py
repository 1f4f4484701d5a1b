"""The port's losses against the JAX package's on the CPU: the per-head CTC sums
(``ctc_loss_sum_heads``, heads grouped by class count in the port, one fused
scan in JAX) and their gradients with respect to the logits, the single-head
``ctc_loss_sum``, and ``sequence_cross_entropy_sum``; with an infeasible row
(too many labels), an infeasible row by repeats, a zero-length row and
``row_weights``. Inputs come from seeded numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.ops import ctc as jax_ctc
from allophant_tpu_torch.ops import ctc

TIME = 12
# Frames per row: full, ragged, short (7 frames), zero-length, full.
LOGIT_LENGTHS = np.array([TIME, TIME - 3, 7, 0, TIME], dtype=np.int32)
ROW_WEIGHTS = np.array([1.0, 1.0, 1.0, 0.0, 1.0], dtype=np.float32)
# f32 log-space recurrences in another order: losses of O(30) to 1e-5
# relative, gradients of O(1) to 1e-5 absolute.
RTOL, GRAD_ATOL = 1e-5, 1e-5


def _head(rng, classes: int, width: int):
    batch = len(LOGIT_LENGTHS)
    logits = (1.5 * rng.standard_normal((batch, TIME, classes))).astype(np.float32)
    labels = rng.integers(1, classes, (batch, width)).astype(np.int32)
    # Row 1 has 9 frames: a head with more labels than that is infeasible
    # there. Row 2 has 7 frames: 5 labels with 3 repeats need 8, so it is
    # infeasible by repeats.
    label_lengths = np.array([width, width if width > TIME - 3 else 4, 5, 0, 3], dtype=np.int32)
    labels[2, :5] = [1, 1, 1, 1, 2]
    return logits, labels, label_lengths


def _heads(seed=0):
    rng = np.random.default_rng(seed)
    # Two 4-class heads (one grouped call in the port) and a 7-class head with
    # 10 labels, more than row 1 has frames.
    return [("a", *_head(rng, 4, 5)), ("b", *_head(rng, 4, 6)), ("c", *_head(rng, 7, 10))]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "row-weights"])
def test_head_losses_and_logit_gradients_match_jax(weighted):
    heads = _heads()
    coefficients = np.random.default_rng(1).uniform(0.5, 2.0, len(heads)).astype(np.float32)
    weights = ROW_WEIGHTS if weighted else None

    def jax_objective(logits_list):
        losses = jax_ctc.ctc_loss_sum_heads(
            [(name, logits, jnp.asarray(labels), jnp.asarray(lengths)) for (name, _, labels, lengths), logits in zip(heads, logits_list)],
            jnp.asarray(LOGIT_LENGTHS),
            row_weights=None if weights is None else jnp.asarray(weights),
        )
        return sum(c * losses[name] for c, (name, *_rest) in zip(coefficients, heads)), losses

    (_, expected), expected_grads = jax.value_and_grad(jax_objective, has_aux=True)([jnp.asarray(h[1]) for h in heads])

    logits = [torch.from_numpy(h[1]).requires_grad_() for h in heads]
    losses = ctc.ctc_loss_sum_heads(
        [(name, tensor, torch.from_numpy(labels), torch.from_numpy(lengths)) for (name, _, labels, lengths), tensor in zip(heads, logits)],
        torch.from_numpy(LOGIT_LENGTHS),
        row_weights=None if weights is None else torch.from_numpy(weights),
    )
    assert list(losses) == [name for name, *_ in heads]
    sum(float(c) * losses[name] for c, (name, *_rest) in zip(coefficients, heads)).backward()
    for (name, *_rest), tensor, expected_grad in zip(heads, logits, expected_grads):
        np.testing.assert_allclose(losses[name].item(), float(expected[name]), rtol=RTOL, err_msg=name)
        assert np.isfinite(tensor.grad.numpy()).all(), name
        np.testing.assert_allclose(tensor.grad.numpy(), np.asarray(expected_grad), atol=GRAD_ATOL, err_msg=name)
        # The infeasible and zero-length rows contribute no gradient.
        assert not tensor.grad[2:4].any(), name
        assert tensor.grad[1].any() == (name != "c"), name


def test_single_head_loss_matches_jax_optax_path():
    _name, logits, labels, lengths = _heads(2)[1]
    expected = jax_ctc.ctc_loss_sum(*map(jnp.asarray, (logits, LOGIT_LENGTHS, labels, lengths)), row_weights=jnp.asarray(ROW_WEIGHTS))
    got = ctc.ctc_loss_sum(*map(torch.from_numpy, (logits, LOGIT_LENGTHS, labels, lengths)), row_weights=torch.from_numpy(ROW_WEIGHTS))
    np.testing.assert_allclose(got.item(), float(expected), rtol=RTOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_sequence_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((len(LOGIT_LENGTHS), TIME, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (len(LOGIT_LENGTHS), 1)).astype(np.int32)
    arguments = (logits, LOGIT_LENGTHS, labels)
    expected = jax_ctc.sequence_cross_entropy_sum(
        *map(jnp.asarray, arguments), label_smoothing=smoothing, row_weights=jnp.asarray(ROW_WEIGHTS)
    )
    got = ctc.sequence_cross_entropy_sum(
        *map(torch.from_numpy, arguments), label_smoothing=smoothing, row_weights=torch.from_numpy(ROW_WEIGHTS)
    )
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(expected), rtol=RTOL)
