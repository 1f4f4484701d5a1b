"""The PyTorch port's ops against the JAX package's, on the CPU: masking,
fast_gelu, the plain twins of the two CUDA kernels (fused frame encoder and
one-shot attention) against the Pallas kernels in interpret mode, and greedy
decoding. Inputs come from seeded numpy and go through both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allophant_tpu.ops import activations as jax_activations
from allophant_tpu.ops import attention as jax_attention
from allophant_tpu.ops import decode as jax_decode
from allophant_tpu.ops import masking as jax_masking
from allophant_tpu.ops.frame_encoder import fused_frame_conv as jax_fused_frame_conv
from allophant_tpu.ops.oneshot_attention import _oneshot_forward
from allophant_tpu_torch.ops import activations, attention, decode, masking
from allophant_tpu_torch.ops.frame_encoder import FusedFrameConv, fused_frame_conv, reference_frame_conv
from allophant_tpu_torch.ops.oneshot_attention import kernel_head_dim, oneshot_attention, reference_oneshot


def _bf16_values(array: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(array, jnp.bfloat16).astype(jnp.float32))


class TestMasking:
    def test_mask_sequence_both_layouts(self):
        lengths = np.array([0, 3, 7, 5], dtype=np.int32)
        for batch_first in (True, False):
            for inverse in (True, False):
                expected = np.asarray(jax_masking.mask_sequence(jnp.asarray(lengths), 7, inverse, batch_first))
                got = masking.mask_sequence(torch.from_numpy(lengths), 7, inverse, batch_first).numpy()
                np.testing.assert_array_equal(got, expected)

    def test_conv_lengths_match(self):
        lengths = np.array([0, 1, 399, 400, 16000, 163840], dtype=np.int64)
        kernels, strides = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
        expected = np.asarray(jax_masking.stacked_conv_output_lengths(jnp.asarray(lengths), kernels, strides))
        got = masking.stacked_conv_output_lengths(torch.from_numpy(lengths), kernels, strides).numpy()
        np.testing.assert_array_equal(got, expected)
        assert masking.conv_output_length(100, 4, 2, 1) == jax_masking.conv_output_length(100, 4, 2, 1)

    def test_zero_mean_unit_var_norm_with_zero_length_row(self):
        rng = np.random.default_rng(0)
        features = rng.standard_normal((3, 50)).astype(np.float32) * 3 + 1
        lengths = np.array([50, 17, 0], dtype=np.int32)
        mask = np.arange(50)[None] < lengths[:, None]
        expected = np.asarray(
            jax_masking.zero_mean_unit_var_norm(jnp.asarray(features), jnp.asarray(lengths), jnp.asarray(mask))
        )
        got = masking.zero_mean_unit_var_norm(
            torch.from_numpy(features), torch.from_numpy(lengths), torch.from_numpy(mask)
        ).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, expected, atol=1e-5)


class TestFastGelu:
    def _inputs(self):
        return np.random.default_rng(1).uniform(-8, 8, size=4096).astype(np.float32)

    def test_f32_is_exact_gelu(self):
        values = self._inputs()
        expected = np.asarray(jax_activations.fast_gelu(jnp.asarray(values)))
        got = activations.fast_gelu(torch.from_numpy(values)).numpy()
        np.testing.assert_allclose(got, expected, atol=1e-6)

    def test_bf16_uses_the_tanh_polynomial(self):
        values = _bf16_values(self._inputs())
        expected = np.asarray(jax_activations.fast_gelu(jnp.asarray(values, jnp.bfloat16)).astype(jnp.float32))
        got = activations.fast_gelu(torch.from_numpy(values).bfloat16()).float().numpy()
        # Same f32 polynomial, one rounding to bf16: bit-equal above the deep
        # negative tail; below x = -2.5, 1 + tanh(p) cancels and the two tanh
        # implementations' last-ulp differences show, within the 3e-5 absolute
        # bound the JAX module documents for that tail.
        head = values > -2.5
        np.testing.assert_array_equal(got[head], expected[head])
        np.testing.assert_allclose(got, expected, rtol=0, atol=3e-5)
        exact = activations.gelu_exact(torch.from_numpy(values)).bfloat16().float().numpy()
        assert (exact[head] != expected[head]).any(), "exact erf would not be told apart"


class TestFrameEncoderTwin:
    """The K2 twin against the Pallas kernel (interpret mode on the CPU)."""

    def _inputs(self, channels=128, samples=5 * 300 + 3):
        rng = np.random.default_rng(2)
        audio = rng.standard_normal((2, samples)).astype(np.float32)
        kernel = (rng.standard_normal((10, channels)) / np.sqrt(10)).astype(np.float32)
        bias = (0.1 * rng.standard_normal(channels)).astype(np.float32)
        scale = (1 + 0.1 * rng.standard_normal(channels)).astype(np.float32)
        shift = (0.1 * rng.standard_normal(channels)).astype(np.float32)
        return audio, kernel, bias, scale, shift

    @pytest.mark.parametrize(
        "jax_dtype, torch_dtype, exact_erf, atol",
        [
            (jnp.float32, torch.float32, True, 1e-5),
            (jnp.float32, torch.float32, False, 2.5e-3),
            (jnp.bfloat16, torch.bfloat16, False, 2e-2),
        ],
        ids=["f32-exact-erf", "f32-tpu-erf", "bf16"],
    )
    def test_matches_pallas_kernel(self, monkeypatch, jax_dtype, torch_dtype, exact_erf, atol):
        # The TPU kernel's erf is Abramowitz-Stegun with an approximate
        # reciprocal, which interpret mode evaluates in bf16: 1.7e-3 from exact
        # GELU at these inputs, hence 2.5e-3 against the twin's exact erf. With
        # that erf swapped for the exact one (at trace time, in this test only)
        # the conv + LayerNorm + GELU agree to 1e-5 in f32. bf16 outputs differ
        # by at most one bf16 rounding (2e-2 at |x| ~ 3).
        import jax

        from allophant_tpu.ops import frame_encoder as jax_frame_encoder

        if exact_erf:
            monkeypatch.setattr(jax_frame_encoder, "_erf", jax.lax.erf)
        jax.clear_caches()
        audio, kernel, bias, scale, shift = self._inputs()
        expected = np.asarray(
            jax_fused_frame_conv(*map(jnp.asarray, (audio, kernel, bias, scale, shift)), eps=1e-5, out_dtype=jax_dtype)
        ).astype(np.float32)
        jax.clear_caches()
        got = fused_frame_conv(
            *map(torch.from_numpy, (audio, kernel, bias, scale, shift)), eps=1e-5, out_dtype=torch_dtype
        )
        assert got.dtype == torch_dtype and got.shape == (2, audio.shape[1] // 5 - 1, 128)
        np.testing.assert_allclose(got.float().numpy(), expected, atol=atol)

    @pytest.mark.parametrize("channels", [64, 100, 1280])
    @pytest.mark.parametrize(
        "jax_dtype, torch_dtype, atol",
        [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)],
        ids=["f32-exact-erf", "bf16"],
    )
    def test_matches_pallas_kernel_at_other_channel_counts(self, monkeypatch, channels, jax_dtype, torch_dtype, atol):
        """C other than 512, which the CUDA kernel takes in one pass up to
        1024 and in chunks of 1024 above (1280): the twin against the Pallas
        kernel with the exact erf swapped in, at the tolerances of
        test_matches_pallas_kernel."""
        import jax

        from allophant_tpu.ops import frame_encoder as jax_frame_encoder

        monkeypatch.setattr(jax_frame_encoder, "_erf", jax.lax.erf)
        jax.clear_caches()
        audio, kernel, bias, scale, shift = self._inputs(channels=channels, samples=5 * 90 + 4)
        expected = np.asarray(
            jax_fused_frame_conv(*map(jnp.asarray, (audio, kernel, bias, scale, shift)), eps=1e-5, out_dtype=jax_dtype)
        ).astype(np.float32)
        jax.clear_caches()
        got = fused_frame_conv(*map(torch.from_numpy, (audio, kernel, bias, scale, shift)), eps=1e-5, out_dtype=torch_dtype)
        assert got.dtype == torch_dtype and got.shape == (2, audio.shape[1] // 5 - 1, channels)
        np.testing.assert_allclose(got.float().numpy(), expected, atol=atol)

    def test_cpu_tensors_take_the_twin_without_a_launch(self):
        inputs = [torch.from_numpy(array) for array in self._inputs(channels=32, samples=100)]
        before = fused_frame_conv.launches
        out = fused_frame_conv(*inputs, eps=1e-5, out_dtype=torch.float32)
        torch.testing.assert_close(out, reference_frame_conv(*inputs, 1e-5, torch.float32), rtol=0, atol=0)
        assert fused_frame_conv.launches == before

    def test_other_devices_raise(self):
        inputs = [torch.from_numpy(array).to("meta") for array in self._inputs(channels=32, samples=100)]
        with pytest.raises(ValueError):
            fused_frame_conv(*inputs, eps=1e-5, out_dtype=torch.float32)

    def test_backward_matches_jax_custom_vjp(self):
        """FusedFrameConv's backward differentiates the plain twin, as JAX's
        custom_vjp differentiates its jnp formulation. That formulation casts
        the frames and the kernel to bf16 for the dot, so the parameter
        gradients agree within 1e-2 of each one's largest magnitude (one bf16
        rounding of the conv operands); the twin's own autograd is matched
        exactly."""
        import jax

        audio, kernel, bias, scale, shift = self._inputs(channels=32, samples=5 * 60 + 2)
        cotangent = np.random.default_rng(3).standard_normal((2, audio.shape[1] // 5 - 1, 32)).astype(np.float32)

        def jax_loss(*parameters):
            out = jax_fused_frame_conv(jnp.asarray(audio), *parameters, eps=1e-5, out_dtype=jnp.float32)
            return (out * cotangent).sum()

        expected = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (kernel, bias, scale, shift)))
        parameters = [torch.from_numpy(array).requires_grad_() for array in (kernel, bias, scale, shift)]
        out = FusedFrameConv.apply(torch.from_numpy(audio), *parameters, 1e-5, torch.float32)
        out.backward(torch.from_numpy(cotangent))
        twin = [tensor.detach().clone().requires_grad_() for tensor in parameters]
        reference_frame_conv(torch.from_numpy(audio), *twin, 1e-5, torch.float32).backward(torch.from_numpy(cotangent))
        for name, got, want, exact in zip(("kernel", "bias", "scale", "shift"), parameters, expected, twin):
            torch.testing.assert_close(got.grad, exact.grad, rtol=0, atol=0)
            want = np.asarray(want)
            np.testing.assert_allclose(got.grad.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max(), err_msg=name)


class TestOneshotAttentionTwin:
    """The K1 twin against the Pallas one-shot kernels in interpret mode."""

    def _inputs(self, batch, time, heads, head_dim, seed=3):
        rng = np.random.default_rng(seed)
        shape = (batch, time, heads * head_dim)
        q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
        lengths = np.full(batch, time, dtype=np.int32)
        lengths[-1] = time - 37
        if batch > 2:
            lengths[1] = 0  # a zero-length filler row
        mask = np.arange(time)[None, :] < lengths[:, None]
        bias = np.where(mask, 0.0, -1e9).astype(np.float32)
        return q, k, v, bias, mask

    @pytest.mark.parametrize(
        "batch, time, heads, head_dim",
        [(3, 128, 4, 16), (1, 896, 4, 16), (1, 1664, 2, 16)],
        ids=["full", "headblock", "qblock"],
    )
    def test_matches_pallas_kernel_on_valid_rows(self, batch, time, heads, head_dim):
        q, k, v, bias, mask = self._inputs(batch, time, heads, head_dim)
        scale = head_dim**-0.5
        expected = np.asarray(_oneshot_forward(*map(jnp.asarray, (q, k, v, bias)), scale, heads, interpret=True))
        got = oneshot_attention(*map(torch.from_numpy, (q, k, v, bias)), scale, heads).numpy()
        assert np.isfinite(got).all()
        valid = np.broadcast_to(mask[:, :, None], got.shape)
        np.testing.assert_allclose(got[valid], expected[valid], atol=2e-5)

    @pytest.mark.parametrize("head_dim", [32, 80, 120])
    def test_matches_pallas_kernel_at_other_head_widths(self, head_dim):
        """Head widths other than 64 (XLS-R 1B's 80, 2B's 120): the Pallas
        kernel's interpret-mode plan takes every width."""
        q, k, v, bias, mask = self._inputs(3, 128, 2, head_dim)
        scale = head_dim**-0.5
        expected = np.asarray(_oneshot_forward(*map(jnp.asarray, (q, k, v, bias)), scale, 2, interpret=True))
        got = oneshot_attention(*map(torch.from_numpy, (q, k, v, bias)), scale, 2).numpy()
        valid = np.broadcast_to(mask[:, :, None], got.shape)
        np.testing.assert_allclose(got[valid], expected[valid], atol=2e-5)

    def test_kernel_head_widths(self):
        """The CUDA kernels take every head width (the wrappers zero-pad one
        that is not a multiple of 8, and above 128 the chunked route runs);
        only a width that does not split into the heads raises."""
        widths = (8, 64, 80, 120, 128, 136, 100, 4, 12, 20, 192, 256)
        assert [kernel_head_dim("k", 16 * width, 16) for width in widths] == list(widths)
        with pytest.raises(ValueError, match="does not split"):
            kernel_head_dim("k", 100, 3)

    def test_zero_length_row_is_finite_average(self):
        q, k, v, bias, _ = self._inputs(3, 64, 2, 8)
        got = reference_oneshot(*map(torch.from_numpy, (q, k, v, bias)), 8**-0.5, 2).numpy()
        assert np.isfinite(got).all()
        # Every key is padded alike, so each query row averages the values.
        np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=0), got[1].shape), atol=1e-5)

    def test_bf16_twin_tracks_f32(self):
        q, k, v, bias, mask = self._inputs(3, 128, 4, 16)
        as_bf16 = [torch.from_numpy(_bf16_values(array)).bfloat16() for array in (q, k, v)]
        got = reference_oneshot(*as_bf16, torch.from_numpy(bias), 0.25, 4).float().numpy()
        expected = reference_oneshot(*(tensor.float() for tensor in as_bf16), torch.from_numpy(bias), 0.25, 4).numpy()
        valid = np.broadcast_to(mask[:, :, None], got.shape)
        np.testing.assert_allclose(got[valid], expected[valid], atol=2e-2)

    def test_dispatch_matches_jax_reference_attention(self):
        """The encoder's attention path (q/k/v as column blocks of one fused
        projection, a key bias from the frame mask, the one-shot dispatch) and
        the port's einsum reference, against the JAX einsum reference."""
        rng = np.random.default_rng(4)
        batch, time, heads, head_dim = 2, 40, 4, 8
        scale = head_dim**-0.5
        q, k, v = (rng.standard_normal((batch, time, heads, head_dim)).astype(np.float32) for _ in range(3))
        mask = np.arange(time)[None, :] < np.array([40, 23])[:, None]
        expected = np.asarray(jax_attention.reference_attention(*map(jnp.asarray, (q, k, v, mask)), scale))

        fused = torch.from_numpy(np.concatenate([array.reshape(batch, time, -1) for array in (q, k, v)], axis=-1))
        query, key, value = fused.split(heads * head_dim, dim=-1)
        bias = attention.key_bias_from_mask(torch.from_numpy(mask), batch, time, "cpu")
        got = oneshot_attention(query, key, value, bias, scale, heads).reshape(batch, time, heads, head_dim).numpy()
        np.testing.assert_allclose(got[mask], expected[mask], atol=2e-5)

        got = attention.reference_attention(*(torch.from_numpy(array) for array in (q, k, v, mask)), scale).numpy()
        np.testing.assert_allclose(got[mask], expected[mask], atol=2e-5)

    def test_cpu_tensors_take_the_twin_and_other_devices_raise(self):
        q, k, v, bias, _ = self._inputs(2, 16, 2, 8)
        before = oneshot_attention.launches
        oneshot_attention(*map(torch.from_numpy, (q, k, v, bias)), 0.3, 2)
        assert oneshot_attention.launches == before
        with pytest.raises(ValueError):
            oneshot_attention(*(torch.from_numpy(array).to("meta") for array in (q, k, v, bias)), 0.3, 2)


class TestGreedyDecode:
    def _logits(self):
        rng = np.random.default_rng(5)
        # Coarse values force argmax ties: the first maximal index must win.
        logits = rng.integers(-3, 4, size=(4, 60, 7)).astype(np.float32)
        lengths = np.array([60, 41, 0, 1], dtype=np.int32)
        return logits, lengths

    @pytest.mark.parametrize("blank_index", [0, 3])
    def test_logits_decode_is_integer_exact(self, blank_index):
        logits, lengths = self._logits()
        expected = jax_decode.greedy_decode_logits(jnp.asarray(logits), jnp.asarray(lengths), blank_index)
        got = decode.greedy_decode_logits(torch.from_numpy(logits), torch.from_numpy(lengths), blank_index)
        for index in range(3):  # tokens, timesteps, counts
            np.testing.assert_array_equal(got[index].numpy(), np.asarray(expected[index]).astype(np.int64))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(expected[3]), rtol=1e-5)

    def test_padded_decode_is_integer_exact(self):
        logits, lengths = self._logits()
        log_probs = np.asarray(torch.log_softmax(torch.from_numpy(logits), dim=-1))
        expected = jax_decode.greedy_decode_padded(jnp.asarray(log_probs), jnp.asarray(lengths))
        got = decode.greedy_decode_padded(torch.from_numpy(log_probs), torch.from_numpy(lengths))
        for index in range(3):
            np.testing.assert_array_equal(got[index].numpy(), np.asarray(expected[index]).astype(np.int64))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(expected[3]), rtol=1e-5)


def test_entry_points_never_fall_back_to_the_cpu():
    """Without a CUDA device, entry points that default to the GPU raise;
    only an explicit device="cpu" runs the plain path."""
    from allophant_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert resolve_device("cpu") == torch.device("cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="No CUDA device"):
            resolve_device(device)
