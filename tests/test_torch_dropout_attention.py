"""The port's attention-dropout kernels' plain twins against the JAX package,
on the CPU: the Philox mask (K6) against the Random123 known-answer vectors,
the dropout forward (K5) against JAX's ``_reference_bthd_dropout`` fed the
port's mask, and the fused backward (K4) against ``jax.vjp`` of JAX's
references, with padded keys and a zero-length row. Mosaic's PRNG stream has
no CPU lowering and cannot be reproduced on CUDA, so the mask is the port's
own and both sides are given it. Inputs come from seeded numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.ops.oneshot_attention import _keep_threshold, _reference_bthd, _reference_bthd_dropout
from allophant_tpu_torch.ops.oneshot_attention import (
    OneshotAttention,
    OneshotDropoutAttention,
    dropout_mask_bits,
    keep_threshold,
    oneshot_attention_backward,
    oneshot_dropout_attention,
    philox4x32,
    reference_dropout_mask_bits,
    reference_oneshot_backward,
    reference_oneshot_dropout,
)

SEEDS = (-123_456_789, 2_024)
# f32 einsum on both sides, differing only in summation order and in the
# kernels' base-2 exponent: 2e-5 on O(1) outputs and gradients.
ATOL = 2e-5


@pytest.mark.parametrize(
    "counter, key, expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_reproduces_random123_known_answers(counter, key, expected):
    words = philox4x32([torch.tensor(word, dtype=torch.int64) for word in counter], key)
    assert tuple(int(word) for word in words) == expected


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.2, 0.5, 0.9, 1.0])
def test_keep_threshold_equals_jax(rate):
    assert keep_threshold(rate) == int(_keep_threshold(rate))


def test_mask_bits_are_pure_in_seeds_batch_and_head():
    bits = reference_dropout_mask_bits(SEEDS, 3, 2, 13).to(torch.int64)
    assert bits.shape == (3, 2, 13, 13)
    # A smaller batch is a prefix of a larger one: each (b, h) tile depends on
    # nothing but the seeds and its indices.
    np.testing.assert_array_equal(reference_dropout_mask_bits(SEEDS, 2, 2, 13).to(torch.int64), bits[:2])
    np.testing.assert_array_equal(reference_dropout_mask_bits(SEEDS, 3, 2, 13).to(torch.int64), bits)
    # Column 4c + w of a row is word w of the draw for counter (c, row, b*H + h, 0).
    words = philox4x32([torch.tensor(value) for value in (2, 5, 1 * 2 + 1, 0)], SEEDS)
    np.testing.assert_array_equal(bits[1, 1, 5, 8:12], torch.stack(words))
    other = reference_dropout_mask_bits((SEEDS[0], SEEDS[1] + 1), 3, 2, 13).to(torch.int64)
    assert (other != bits).float().mean() > 0.99
    keep = (reference_dropout_mask_bits(SEEDS, 4, 4, 64).to(torch.int64) < keep_threshold(0.1)).double().mean()
    assert abs(keep.item() - 0.9) < 5e-3


def _inputs(batch=3, time=21, heads=2, head_dim=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((batch, time, heads * head_dim)).astype(np.float32) for _ in range(4))
    lengths = np.array([time, time - 8, 0])[:batch]  # a ragged and a zero-length row
    bias = np.where(np.arange(time)[None] < lengths[:, None], 0.0, -1e9).astype(np.float32)
    return q, k, v, g, bias


def _jax_keep_mask(batch, heads, time, rate):
    return jnp.asarray((reference_dropout_mask_bits(SEEDS, batch, heads, time).to(torch.int64) < keep_threshold(rate)).numpy())


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_twin_matches_jax_reference_given_the_mask(rate):
    q, k, v, _g, bias = _inputs()
    scale, heads = 8**-0.5, 2
    keep = _jax_keep_mask(q.shape[0], heads, q.shape[1], rate)
    expected = np.asarray(_reference_bthd_dropout(*map(jnp.asarray, (q, k, v, bias)), keep, scale, heads, rate))
    got = reference_oneshot_dropout(*map(torch.from_numpy, (q, k, v, bias)), SEEDS, scale, heads, rate).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expected, atol=ATOL)
    # The wrapper on CPU tensors is the twin, and launches nothing.
    before = oneshot_dropout_attention.launches
    wrapped = oneshot_dropout_attention(*map(torch.from_numpy, (q, k, v, bias)), SEEDS, scale, heads, rate)
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert oneshot_dropout_attention.launches == before


def test_dropout_twin_at_rate_zero_is_plain_attention():
    q, k, v, _g, bias = _inputs(seed=1)
    expected = np.asarray(_reference_bthd(*map(jnp.asarray, (q, k, v, bias)), 0.3, 2))
    got = reference_oneshot_dropout(*map(torch.from_numpy, (q, k, v, bias)), SEEDS, 0.3, 2, 0.0).numpy()
    np.testing.assert_allclose(got, expected, atol=ATOL)


@pytest.mark.parametrize("rate", [None, 0.1, 0.5])
def test_backward_twin_matches_jax_vjp_on_every_entry(rate):
    """dq, dk and dv of every row (the zero-length row averages all keys,
    padded ones included, on both sides) against jax.vjp of JAX's reference."""
    q, k, v, g, bias = _inputs(seed=2)
    scale, heads = 8**-0.5, 2
    if rate is None:
        function = lambda *qkv: _reference_bthd(*qkv, jnp.asarray(bias), scale, heads)  # noqa: E731
    else:
        keep = _jax_keep_mask(q.shape[0], heads, q.shape[1], rate)
        function = lambda *qkv: _reference_bthd_dropout(*qkv, jnp.asarray(bias), keep, scale, heads, rate)  # noqa: E731
    _, vjp = jax.vjp(function, *map(jnp.asarray, (q, k, v)))
    expected = vjp(jnp.asarray(g))
    seeds = SEEDS if rate is not None else None
    got = reference_oneshot_backward(*map(torch.from_numpy, (q, k, v, g, bias)), seeds, scale, heads, rate)
    for name, got_part, expected_part in zip(("dq", "dk", "dv"), got, expected):
        assert np.isfinite(got_part.numpy()).all(), name
        np.testing.assert_allclose(got_part.numpy(), np.asarray(expected_part), atol=ATOL, err_msg=name)
    before = oneshot_attention_backward.launches
    wrapped = oneshot_attention_backward(*map(torch.from_numpy, (q, k, v, g, bias)), seeds, scale, heads, rate)
    for got_part, wrapped_part in zip(got, wrapped):
        np.testing.assert_array_equal(wrapped_part.numpy(), got_part.numpy())
    assert oneshot_attention_backward.launches == before


@pytest.mark.parametrize("head_dim", [32, 80, 120])
def test_twins_match_jax_at_other_head_widths(head_dim):
    """K5 at rate 0.1 against JAX's _reference_bthd_dropout given the mask,
    and K4 (with that mask and without one) against jax.vjp of JAX's
    references, at head widths other than 64, at the tolerance of the
    narrower cases above."""
    q, k, v, g, bias = _inputs(time=13, head_dim=head_dim, seed=4)
    scale, heads, rate = head_dim**-0.5, 2, 0.1
    keep = _jax_keep_mask(q.shape[0], heads, q.shape[1], rate)
    expected = np.asarray(_reference_bthd_dropout(*map(jnp.asarray, (q, k, v, bias)), keep, scale, heads, rate))
    got = reference_oneshot_dropout(*map(torch.from_numpy, (q, k, v, bias)), SEEDS, scale, heads, rate).numpy()
    np.testing.assert_allclose(got, expected, atol=ATOL)
    for seeds, backward_rate in ((SEEDS, rate), (None, None)):
        if backward_rate is None:
            function = lambda *qkv: _reference_bthd(*qkv, jnp.asarray(bias), scale, heads)  # noqa: E731
        else:
            function = lambda *qkv: _reference_bthd_dropout(*qkv, jnp.asarray(bias), keep, scale, heads, rate)  # noqa: E731
        _, vjp = jax.vjp(function, *map(jnp.asarray, (q, k, v)))
        expected = vjp(jnp.asarray(g))
        got = reference_oneshot_backward(*map(torch.from_numpy, (q, k, v, g, bias)), seeds, scale, heads, backward_rate)
        for name, got_part, expected_part in zip(("dq", "dk", "dv"), got, expected):
            np.testing.assert_allclose(got_part.numpy(), np.asarray(expected_part), atol=ATOL, err_msg=f"{name} rate={backward_rate}")


@pytest.mark.parametrize("rate", [None, 0.2])
def test_autograd_functions_route_the_backward_through_the_twin(rate):
    q, k, v, g, bias = (torch.from_numpy(array) for array in _inputs(seed=3))
    inputs = [tensor.clone().requires_grad_() for tensor in (q, k, v)]
    if rate is None:
        out = OneshotAttention.apply(*inputs, bias, 0.4, 2)
    else:
        out = OneshotDropoutAttention.apply(*inputs, bias, SEEDS, 0.4, 2, rate)
    out.backward(g)
    expected = reference_oneshot_backward(q, k, v, g, bias, SEEDS if rate else None, 0.4, 2, rate)
    for tensor, want in zip(inputs, expected):
        np.testing.assert_array_equal(tensor.grad.numpy(), want.numpy())


def test_cpu_takes_the_twins_and_other_devices_raise():
    q, k, v, g, bias = (torch.from_numpy(array) for array in _inputs(batch=2, time=8))
    before = dropout_mask_bits.launches
    np.testing.assert_array_equal(
        dropout_mask_bits(SEEDS, 2, 2, 8, "cpu").to(torch.int64), reference_dropout_mask_bits(SEEDS, 2, 2, 8).to(torch.int64)
    )
    assert dropout_mask_bits.launches == before
    with pytest.raises(ValueError):
        dropout_mask_bits(SEEDS, 2, 2, 8, "meta")
    meta = [tensor.to("meta") for tensor in (q, k, v, g, bias)]
    with pytest.raises(ValueError):
        oneshot_dropout_attention(*meta[:3], meta[4], SEEDS, 0.3, 2, 0.1)
    with pytest.raises(ValueError):
        oneshot_attention_backward(*meta, None, 0.3, 2, None)
    with pytest.raises(ValueError, match="rate"):
        oneshot_dropout_attention(q, k, v, bias, SEEDS, 0.3, 2, 1.0)
