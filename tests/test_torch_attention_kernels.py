"""What the port's bf16 tensor-core attention kernels (K1 forward, K5 forward
with dropout, K4 backward) rely on, checked on the CPU through their plain
twins and the JAX package:

- the tile skip: a block stops after the 64-key tile of its batch row's last
  valid key, since every key after it carries a -1e9 bias and its
  exponential is exactly 0 in f32, so it adds nothing to the total and, kept
  or dropped, nothing to P.V; a zero-length row visits every key;
- the layout rule of the wrappers: cp.async and ldmatrix move 16-byte rows,
  so every head row of a bf16 input must start on a 16-byte boundary, which
  the encoder's strided q/k/v views of one fused projection do;
- the head widths the wrappers plan: zero-padded to a multiple of 8, and
  above 128 split into 128-column chunks (the twins at those widths against
  JAX's references).

Inputs come from seeded numpy."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allophant_tpu.ops.oneshot_attention import _reference_bthd, _reference_bthd_dropout
from allophant_tpu_torch.ops.oneshot_attention import (
    NEG_INF,
    _exponentials,
    _keep_mask,
    _keep_probability,
    _merge_heads,
    _pad_heads,
    _split_heads,
    _unpad_heads,
    check_row_alignment,
    head_plan,
    reference_oneshot,
    reference_oneshot_backward,
    reference_oneshot_dropout,
)

TIME, HEADS, HEAD_DIM, KEY_TILE = 512, 2, 64, 64
SCALE = HEAD_DIM**-0.5
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])


def _inputs(length: int, dtype, seed: int = 0):
    """q, k (f32 holding values of ``dtype``), v in ``dtype`` and the key bias
    [1, T] of one row with ``length`` valid keys. The f32 q and k give the
    twin the same scores as ``dtype`` inputs and keep its output f32, so the
    comparisons below see summation order only; a bf16 v still makes the twin
    round its weights to bf16 before P.V, as the kernel does."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, TIME, HEADS * HEAD_DIM)).astype(np.float32)).to(dtype) for _ in range(3))
    bias = torch.from_numpy(np.where(np.arange(TIME)[None] < length, 0.0, NEG_INF).astype(np.float32))
    return q.float(), k.float(), v, bias


@DTYPES
@pytest.mark.parametrize("length", [1, 63, 64, 65, TIME - 123])
def test_keys_past_the_last_valid_tile_have_exactly_zero_weight(length, dtype):
    q, k, v, bias = _inputs(length, dtype)
    cut = math.ceil(length / KEY_TILE) * KEY_TILE
    exponentials, _total = _exponentials(q, k, bias, SCALE, HEADS)
    assert bool((exponentials[..., length:] == 0.0).all())  # padded keys flush to an exact 0
    assert bool((exponentials[..., :length].amax(dim=-1) == 1.0).all())  # a valid key sets each row's peak
    whole = reference_oneshot(q, k, v, bias, SCALE, HEADS)
    cut_short = reference_oneshot(q, k[:, :cut], v[:, :cut], bias[:, :cut], SCALE, HEADS)
    torch.testing.assert_close(cut_short, whole, rtol=1e-6, atol=1e-6 * whole.abs().max().item())
    if dtype == torch.float32:
        # The cut twin is attention over the whole row, as the JAX package
        # computes it (natural-exp softmax against the kernels' base-2 one).
        expected = np.asarray(_reference_bthd(*(jnp.asarray(x.numpy()) for x in (q, k, v, bias)), SCALE, HEADS))
        np.testing.assert_allclose(cut_short.numpy(), expected, atol=2e-5)


@DTYPES
def test_a_zero_length_row_keeps_every_key(dtype):
    """With no valid key the peak is set by -1e9-biased scores, every
    exponential is non-zero and the output averages all the values: no key
    tile may be skipped."""
    q, k, v, bias = _inputs(0, dtype, seed=1)
    exponentials, _total = _exponentials(q, k, bias, SCALE, HEADS)
    assert bool((exponentials[..., KEY_TILE:] > 0.0).all())
    whole = reference_oneshot(q, k, v, bias, SCALE, HEADS)
    first_tile = reference_oneshot(q, k[:, :KEY_TILE], v[:, :KEY_TILE], bias[:, :KEY_TILE], SCALE, HEADS)
    assert (whole - first_tile).abs().max().item() > 0.1


SEEDS, RATE = (1_234_567, -89_101_112), 0.1


def _dropout_twin_over_keys(q, k, v, bias, keys: int) -> torch.Tensor:
    """The dropout twin's arithmetic over the first ``keys`` keys only, with
    the Philox mask of the whole row cut to the same columns: what the bf16
    K5 computes when it stops after the tile of the last valid key."""
    exponentials, total = _exponentials(q, k[:, :keys], bias[:, :keys], SCALE, HEADS)
    keep = _keep_mask(SEEDS, 1, HEADS, TIME, RATE, "cpu")[..., :keys]
    weights = torch.where(keep, exponentials, 0.0).to(v.dtype).float()
    out = weights @ _split_heads(v[:, :keys], HEADS) / (total * _keep_probability(RATE))
    return _merge_heads(out, q.dtype)


@DTYPES
@pytest.mark.parametrize("length", [1, 63, 64, 65, TIME - 123])
def test_dropout_keys_past_the_last_valid_tile_change_nothing(length, dtype):
    """The total sums the unmasked exponentials and the kept ones go into
    P.V; past the last valid key's tile both are exactly 0, so the twin cut
    there equals the whole twin."""
    q, k, v, bias = _inputs(length, dtype, seed=2)
    cut = math.ceil(length / KEY_TILE) * KEY_TILE
    whole = reference_oneshot_dropout(q, k, v, bias, SEEDS, SCALE, HEADS, RATE)
    assert torch.equal(_dropout_twin_over_keys(q, k, v, bias, TIME), whole)  # the helper is the twin
    cut_short = _dropout_twin_over_keys(q, k, v, bias, cut)
    torch.testing.assert_close(cut_short, whole, rtol=1e-6, atol=1e-6 * whole.abs().max().item())


@DTYPES
def test_dropout_zero_length_row_keeps_every_key(dtype):
    q, k, v, bias = _inputs(0, dtype, seed=3)
    whole = reference_oneshot_dropout(q, k, v, bias, SEEDS, SCALE, HEADS, RATE)
    first_tile = _dropout_twin_over_keys(q, k, v, bias, KEY_TILE)
    assert bool(torch.isfinite(whole).all())
    assert (whole - first_tile).abs().max().item() > 0.1


def _fused_qkv(block: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Column block ``block`` (q, k or v) of a fused [B, T, 3 * 1024]
    projection, as the flagship encoder splits it."""
    return torch.empty(2, 37, 3 * 1024, dtype=dtype).split(1024, dim=-1)[block]


LAYOUTS = {
    "fused q": (lambda: _fused_qkv(0), None),
    "fused k": (lambda: _fused_qkv(1), None),
    "fused v": (lambda: _fused_qkv(2), None),
    "fused k, f32": (lambda: _fused_qkv(1, torch.float32), None),
    "contiguous": (lambda: torch.empty(2, 37, 1024, dtype=torch.bfloat16), None),
    "one batch row, odd batch stride": (lambda: torch.empty(37 * 1024 + 1, dtype=torch.bfloat16).as_strided((1, 37, 1024), (37 * 1024 + 1, 1024, 1)), None),
    "1-element offset": (lambda: torch.empty(2 * 37 * 1024 + 1, dtype=torch.bfloat16)[1:].view(2, 37, 1024), "storage offset"),
    "odd time stride": (lambda: torch.empty(2, 37, 1025, dtype=torch.bfloat16)[..., :1024], "time stride"),
    "time stride of 4 bf16": (lambda: torch.empty(2, 37, 1028, dtype=torch.bfloat16)[..., :1024], "time stride"),
    "odd batch stride": (lambda: torch.empty(2 * 37 * 1024 + 1, dtype=torch.bfloat16).as_strided((2, 37, 1024), (37 * 1024 + 1, 1024, 1)), "batch stride"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_row_alignment_rule(layout):
    make, error = LAYOUTS[layout]
    tensor = make()
    arguments = ("oneshot_attention", tensor.shape, tensor.stride(), tensor.storage_offset(), tensor.element_size())
    if error is None:
        check_row_alignment(*arguments)
    else:
        with pytest.raises(ValueError, match=error):
            check_row_alignment(*arguments)


# Head widths the CUDA kernels take since they zero-pad to a multiple of 8
# (12, 20) and split above 128 into 128-column chunks (192, 256): the twins,
# which the kernels are held to on the card, against JAX's references.
WIDE_AND_ODD_WIDTHS = pytest.mark.parametrize("head_dim", [12, 20, 192, 256])


def _width_inputs(head_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    batch, time, heads = 2, 96, 2
    q, k, v, g = (rng.standard_normal((batch, time, heads * head_dim)).astype(np.float32) for _ in range(4))
    bias = np.where(np.arange(time)[None] < np.array([[time], [time - 29]]), 0.0, NEG_INF).astype(np.float32)
    return q, k, v, g, bias, heads


@WIDE_AND_ODD_WIDTHS
def test_twin_at_other_head_widths_equals_jax(head_dim):
    q, k, v, _g, bias, heads = _width_inputs(head_dim, seed=head_dim)
    scale = head_dim**-0.5
    expected = np.asarray(_reference_bthd(*map(jnp.asarray, (q, k, v, bias)), scale, heads))
    got = reference_oneshot(*map(torch.from_numpy, (q, k, v, bias)), scale, heads).numpy()
    np.testing.assert_allclose(got, expected, atol=2e-5)


@WIDE_AND_ODD_WIDTHS
def test_dropout_twin_at_other_head_widths_equals_jax(head_dim):
    """The dropout twin against ``_reference_bthd_dropout`` given the port's
    Philox mask; the backward twin against JAX's gradient of it."""
    import jax

    q, k, v, g, bias, heads = _width_inputs(head_dim, seed=head_dim + 1)
    scale = head_dim**-0.5
    keep = jnp.asarray(_keep_mask(SEEDS, q.shape[0], heads, q.shape[1], RATE, "cpu").numpy())
    function = lambda *qkv: _reference_bthd_dropout(*qkv, jnp.asarray(bias), keep, scale, heads, RATE)  # noqa: E731
    expected, vjp = jax.vjp(function, *map(jnp.asarray, (q, k, v)))
    tensors = [torch.from_numpy(x) for x in (q, k, v, g, bias)]
    got = reference_oneshot_dropout(*tensors[:3], tensors[4], SEEDS, scale, heads, RATE)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=2e-5)
    gradients = reference_oneshot_backward(*tensors, SEEDS, scale, heads, RATE)
    for name, ours, theirs in zip(("dq", "dk", "dv"), gradients, vjp(jnp.asarray(g))):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, atol=5e-5 * np.abs(theirs).max(), err_msg=name)


@pytest.mark.parametrize(
    "head_dim, launched, chunks",
    [(8, 8, 1), (12, 16, 1), (20, 24, 1), (64, 64, 1), (120, 120, 1), (128, 128, 1), (130, 136, 2), (136, 136, 2),
     (192, 192, 2), (256, 256, 2), (257, 264, 3), (1, 8, 1)],
)
def test_head_plan(head_dim, launched, chunks):
    """The wrappers' plan as a pure function of the head width: the width
    the kernels are launched at (the next multiple of 8) and the 128-column
    chunks a block of the chunked route owns."""
    assert head_plan(head_dim) == (launched, chunks)


@pytest.mark.parametrize("head_dim", [12, 20])
def test_padded_heads_are_exact(head_dim):
    """Zero columns add nothing to q.k^T and their output columns are cut
    off: the twin over the padded heads, unpadded, is the twin itself
    (bit for bit, f32)."""
    q, k, v, g, bias, heads = _width_inputs(head_dim, seed=7)
    padded, _ = head_plan(head_dim)
    tensors = [torch.from_numpy(x) for x in (q, k, v, g)]
    scale = head_dim**-0.5
    wide = [_pad_heads(tensor, heads, padded) for tensor in tensors]
    assert wide[0].shape[-1] == heads * padded
    assert torch.equal(_unpad_heads(_pad_heads(tensors[0], heads, padded), heads, head_dim), tensors[0])
    bias_tensor = torch.from_numpy(bias)
    direct = reference_oneshot(*tensors[:3], bias_tensor, scale, heads)
    through_padding = _unpad_heads(reference_oneshot(*wide[:3], bias_tensor, scale, heads), heads, head_dim)
    torch.testing.assert_close(through_padding, direct, rtol=0, atol=1e-6)
    direct = reference_oneshot_backward(*tensors, bias_tensor, SEEDS, scale, heads, RATE)
    through = reference_oneshot_backward(*wide, bias_tensor, SEEDS, scale, heads, RATE)
    for ours, theirs in zip(through, direct):
        torch.testing.assert_close(_unpad_heads(ours, heads, head_dim), theirs, rtol=0, atol=1e-6)
