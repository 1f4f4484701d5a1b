"""The port's beam search against the JAX package's, on the CPU: the plain
version of the CUDA beam kernel (``beam_search_padded``) against JAX's
``lax.scan`` search and against the Pallas kernel in interpret mode, the
backtraces, the decoders built on them and the stacking of heads that share a
class count. Inputs come from seeded numpy and go through both packages.

Parents, emitted tokens and backtraced grids must be integer-exact; scores
agree within 1e-4 (XLA's and PyTorch's CPU exp/log1p differ in the last
ulps, and a search sums hundreds of them)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.ops import decode as jax_decode
from allophant_tpu.ops.beam_kernel import beam_search_padded_pallas
from allophant_tpu_torch.ops import decode
from allophant_tpu_torch.ops.beam_kernel import MAX_CLASSES, backtrace_cuda, beam_search_cuda

SCORE_ATOL = 1e-4


def _log_probs(batch, time, classes, seed, scale=2.0, quantised=False):
    """Seeded log-softmax emissions. Scale 0 makes every emission of a step
    equal; ``quantised`` rounds the logits to integers, so a step's emissions
    take a few levels: both make exact ties between candidates."""
    logits = np.random.default_rng(seed).standard_normal((batch, time, classes)).astype(np.float32) * scale
    if quantised:
        logits = np.round(logits)
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _port_search(log_probs, lengths, beam_width, blank_index=0):
    parents, emitted, scores = decode.beam_search_padded(
        torch.from_numpy(log_probs), torch.from_numpy(np.asarray(lengths, np.int32)), beam_width, blank_index
    )
    return parents.numpy(), emitted.numpy(), scores.numpy()


def _assert_search_equal(expected, got):
    np.testing.assert_array_equal(got[0], np.asarray(expected[0]))
    np.testing.assert_array_equal(got[1], np.asarray(expected[1]))
    np.testing.assert_allclose(got[2], np.asarray(expected[2]), atol=SCORE_ATOL)


# (batch, time, classes, beam_width, lengths, seed, scale, blank_index, pallas,
# quantised)
SEARCH_CASES = {
    "ragged": (4, 48, 12, 4, [48, 31, 9, 1], 0, 2.0, 0, True, False),
    # Near-uniform emissions maximise prefix merges (the hash-match path).
    "near-uniform-merging": (4, 32, 5, 4, [32, 32, 17, 32], 1, 0.3, 0, True, False),
    "zero-length-rows": (2, 16, 7, 3, [0, 16], 2, 2.0, 0, True, False),
    "k1": (3, 24, 9, 1, [24, 11, 0], 3, 1.0, 0, True, False),
    "k2": (4, 24, 9, 2, [24, 17, 1, 24], 6, 0.5, 0, True, False),
    "k8": (2, 24, 6, 8, [24, 19], 4, 0.5, 0, True, False),
    # The JAX fused serving path fixes the blank at 0; its scan takes any.
    "blank-3": (3, 30, 7, 4, [30, 22, 5], 5, 0.5, 3, False, False),
    # Exact ties, the order a selection must reproduce (value descending,
    # ties to the lowest k-major lane k * C + c): every emission of a step
    # equal, so every extension of a beam ties; and logits on a few levels.
    "uniform-ties": (4, 24, 5, 4, [24, 24, 9, 1], 7, 0.0, 0, True, False),
    "uniform-ties-40": (2, 16, 40, 4, [16, 11], 8, 0.0, 0, True, False),
    "quantised-ties": (4, 32, 6, 4, [32, 27, 32, 0], 9, 1.0, 0, True, True),
    "quantised-ties-k2": (4, 32, 9, 2, [32, 20, 5, 32], 10, 1.0, 0, True, True),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_matches_jax_scan_and_pallas_kernel(case):
    batch, time, classes, beam_width, lengths, seed, scale, blank_index, pallas, quantised = SEARCH_CASES[case]
    log_probs = _log_probs(batch, time, classes, seed, scale, quantised)
    got = _port_search(log_probs, lengths, beam_width, blank_index)
    assert got[0].shape == got[1].shape == (time, batch, beam_width)
    assert got[0].dtype == got[1].dtype == np.int32
    jax_lengths = jnp.asarray(lengths, jnp.int32)
    _assert_search_equal(
        jax_decode.beam_search_padded(jnp.asarray(log_probs), jax_lengths, beam_width=beam_width, blank_index=blank_index),
        got,
    )
    if pallas:
        _assert_search_equal(
            beam_search_padded_pallas(
                jnp.asarray(log_probs), jax_lengths, beam_width=beam_width, blank_index=blank_index,
                block_rows=2 if batch % 2 == 0 else 1, interpret=True,
            ),
            got,
        )


# Beam widths above 16 (the CUDA wide kernel's range): (batch, time, classes,
# beam_width, lengths, seed, scale, quantised). A beam set wider than the
# live prefixes keeps dead slots; quantised logits make exact ties.
WIDE_CASES = {
    "k17": (3, 14, 6, 17, [14, 9, 0], 12, 1.0, False),
    "k32-quantised": (2, 12, 5, 32, [12, 7], 13, 1.0, True),
    "k100": (2, 10, 4, 100, [10, 6], 14, 1.0, False),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_beam_search_matches_jax_scan(case):
    """Parents, emitted tokens and backtraced grids integer-exact against
    JAX's lax.scan search at K = 17, 32 and 100; scores within SCORE_ATOL."""
    batch, time, classes, beam_width, lengths, seed, scale, quantised = WIDE_CASES[case]
    log_probs = _log_probs(batch, time, classes, seed, scale, quantised)
    got = _port_search(log_probs, lengths, beam_width)
    assert got[0].shape == got[1].shape == (time, batch, beam_width)
    jax_lengths = jnp.asarray(lengths, jnp.int32)
    expected = jax_decode.beam_search_padded(jnp.asarray(log_probs), jax_lengths, beam_width=beam_width)
    _assert_search_equal(expected, got)
    expected_grid = np.asarray(jax_decode.backtrace_beams_device(expected[0], expected[1], jax_lengths))
    got_grid = decode.backtrace_beams_device(*(torch.from_numpy(array) for array in got[:2]), torch.tensor(lengths))
    np.testing.assert_array_equal(got_grid.numpy(), expected_grid)


def test_rolling_hash_wraps_as_int32():
    rng = np.random.default_rng(6)
    hashes = rng.integers(-(2**31), 2**31, size=(3, 4), dtype=np.int64).astype(np.int32)
    class_ids = np.arange(9, dtype=np.int32)
    for multiplier in (decode._HASH_P1, decode._HASH_P2):
        expected = jnp.asarray(hashes)[:, :, None] * np.int32(multiplier) + (jnp.asarray(class_ids)[None, None, :] + 1)
        got = decode._rolling_hash(torch.from_numpy(hashes.astype(np.int64)), multiplier, torch.from_numpy(class_ids).long())
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected).astype(np.int64))
    assert (decode._HASH_P1, decode._HASH_P2) == (int(jax_decode._HASH_P1), int(jax_decode._HASH_P2))
    assert decode._NEG_INF == jax_decode._NEG_INF


def test_backtraces_match_both_jax_functions():
    log_probs = _log_probs(5, 20, 7, seed=3, scale=1.0)
    lengths = np.array([20, 15, 8, 3, 0], dtype=np.int32)
    parents, emitted, scores = jax_decode.beam_search_padded(jnp.asarray(log_probs), jnp.asarray(lengths), beam_width=4)
    expected_device = np.asarray(jax_decode.backtrace_beams_device(parents, emitted, jnp.asarray(lengths)))
    expected_host, _ = jax_decode.backtrace_beams(np.asarray(parents), np.asarray(emitted), np.asarray(scores), lengths)
    np.testing.assert_array_equal(expected_device, expected_host)

    port_parents, port_emitted = (torch.from_numpy(np.array(array)) for array in (parents, emitted))
    got_device = decode.backtrace_beams_device(port_parents, port_emitted, torch.from_numpy(lengths))
    assert got_device.dtype == torch.int32
    np.testing.assert_array_equal(got_device.numpy(), expected_device)
    got_host, got_scores = decode.backtrace_beams(np.asarray(parents), np.asarray(emitted), np.asarray(scores), lengths)
    np.testing.assert_array_equal(got_host, expected_host)
    np.testing.assert_array_equal(got_scores, np.asarray(scores))


def _assert_hypotheses_equal(expected, got, score_atol=1e-5, with_timesteps=True):
    assert len(got) == len(expected)
    for got_row, expected_row in zip(got, expected):
        assert len(got_row) == len(expected_row)
        for got_hypothesis, expected_hypothesis in zip(got_row, expected_row):
            np.testing.assert_array_equal(got_hypothesis.tokens, np.asarray(expected_hypothesis.tokens))
            if with_timesteps:
                np.testing.assert_array_equal(got_hypothesis.timesteps, np.asarray(expected_hypothesis.timesteps))
            assert got_hypothesis.score == pytest.approx(expected_hypothesis.score, abs=score_atol)


@pytest.mark.parametrize(
    "lengths, n_best",
    [([18, 12, 5, 2], 3), ([0, 18, 1, 7], 4)],
    ids=["ragged", "dead-slots"],
)
def test_device_beam_decoder_matches_jax(lengths, n_best):
    """n-best tokens and timesteps exact, scores within 1e-5; a zero-length
    row keeps only its one live (empty) hypothesis."""
    log_probs = _log_probs(4, 18, 6, seed=9, scale=1.0)
    tokens = [str(i) for i in range(6)]
    expected = jax_decode.DeviceBeamCTCDecoder(tokens, beam_width=4, n_best=n_best)(log_probs, np.asarray(lengths))
    got = decode.DeviceBeamCTCDecoder(tokens, beam_width=4, n_best=n_best, device="cpu")(log_probs, np.asarray(lengths))
    _assert_hypotheses_equal(expected, got)
    if lengths[0] == 0:
        assert len(got[0]) == 1 and got[0][0].tokens.size == 0 and got[0][0].score == pytest.approx(0.0)


def test_device_beam_collect_many_matches_jax():
    tokens = [str(i) for i in range(6)]
    lengths = np.array([18, 12, 5, 0])
    jax_decoders, port_decoders, jax_dispatched, port_dispatched = {}, {}, {}, {}
    for seed, name in enumerate(("alpha", "beta", "gamma")):
        log_probs = _log_probs(4, 18, 6, seed=20 + seed)
        jax_decoders[name] = jax_decode.DeviceBeamCTCDecoder(tokens, beam_width=4, n_best=3)
        port_decoders[name] = decode.DeviceBeamCTCDecoder(tokens, beam_width=4, n_best=3, device="cpu")
        jax_dispatched[name] = jax_decoders[name].dispatch(log_probs, lengths)
        port_dispatched[name] = port_decoders[name].dispatch(log_probs, lengths)
    expected = jax_decode.DeviceBeamCTCDecoder.collect_many(jax_dispatched, jax_decoders)
    got = decode.DeviceBeamCTCDecoder.collect_many(port_dispatched, port_decoders)
    assert list(got) == list(expected)
    for name in expected:
        _assert_hypotheses_equal(expected[name], got[name])


@pytest.mark.parametrize("with_timesteps", [True, False], ids=["with-timesteps", "packed-grid"])
def test_greedy_collect_many_matches_jax(with_timesteps):
    rng = np.random.default_rng(12)
    lengths = np.array([30, 17, 0])
    jax_decoder, port_decoder = jax_decode.GreedyCTCDecoder(), decode.GreedyCTCDecoder(device="cpu")
    jax_dispatched, port_dispatched = {}, {}
    for name in ("a", "b"):
        log_probs = np.asarray(jax.nn.log_softmax(rng.standard_normal((3, 30, 5)).astype(np.float32), axis=-1))
        jax_dispatched[name] = jax_decoder.dispatch(log_probs, lengths)
        port_dispatched[name] = port_decoder.dispatch(log_probs, lengths)
    expected = jax_decode.GreedyCTCDecoder.collect_many(jax_dispatched, with_timesteps)
    got = decode.GreedyCTCDecoder.collect_many(port_dispatched, with_timesteps)
    assert list(got) == list(expected)
    for name in expected:
        # Scores are row sums taken in another order by each framework; the
        # packed grid carries each score's f32 bits, so it adds no error.
        _assert_hypotheses_equal(expected[name], got[name], 1e-5, with_timesteps)
        if not with_timesteps:
            assert all(row[0].timesteps.size == 0 for row in got[name])


def test_host_beam_decoder_matches_jax():
    log_probs = _log_probs(3, 16, 5, seed=11, scale=0.5)
    lengths = np.array([16, 12, 4])
    tokens = [str(i) for i in range(5)]
    expected = jax_decode.BeamCTCDecoder(tokens, beam_width=8, n_best=3)(log_probs, lengths)
    got = decode.BeamCTCDecoder(tokens, beam_width=8, n_best=3)(log_probs, lengths)
    _assert_hypotheses_equal(expected, got)


def test_stacked_heads_equal_head_by_head_search():
    """Heads of equal class count are searched as one stacked batch: the
    result equals searching and backtracing each head alone."""
    lengths = torch.tensor([20, 13, 0], dtype=torch.int64)
    widths = (4, 6, 4, 4, 6, 9)
    heads = [torch.from_numpy(_log_probs(3, 20, width, seed=30 + index)) for index, width in enumerate(widths)]
    collected, scores = decode.beam_search_heads(heads, lengths, beam_width=4)
    assert collected.shape == (len(widths), 20, 3, 4) and collected.dtype == torch.int16
    assert scores.shape == (len(widths), 3, 4) and scores.dtype == torch.float32
    for index, log_probs in enumerate(heads):
        parents, emitted, head_scores = decode.beam_search_padded(log_probs, lengths, 4)
        expected = decode.backtrace_beams_device(parents, emitted, lengths)
        np.testing.assert_array_equal(collected[index].numpy(), expected.numpy().astype(np.int16))
        np.testing.assert_array_equal(scores[index].numpy(), head_scores.numpy())


@pytest.mark.parametrize("widths", [(4, 40, 4, 7, 40), (4, 4, 4, 40, 40), (6,)])
def test_stacked_heads_equal_the_search_grouped_by_class_count(widths):
    """``beam_search_heads`` on the grouping it shares with the greedy path
    is bit-equal to searching each class count's heads stacked, as it did
    before the grouping was shared, and counts one call of ``len(widths)``
    heads."""
    from allophant_tpu_torch import tracing

    lengths = torch.tensor([18, 1, 0], dtype=torch.int64)
    heads = [torch.from_numpy(_log_probs(3, 18, width, seed=50 + index, quantised=True)) for index, width in enumerate(widths)]
    with tracing.recording() as counts:
        collected, scores = decode.beam_search_heads(heads, lengths, beam_width=4, blank_index=1)
    assert counts == {"decode_calls": 1, "decode_heads": len(widths)}
    expected_collected = torch.empty(len(widths), 18, 3, 4, dtype=torch.int16)
    expected_scores = torch.empty(len(widths), 3, 4)
    for width in dict.fromkeys(widths):
        members = [index for index, other in enumerate(widths) if other == width]
        stacked_lengths = lengths.repeat(len(members))
        parents, emitted, group_scores = decode.beam_search_device(
            torch.cat([heads[index] for index in members]), stacked_lengths, 4, 1
        )
        group_collected = decode.backtrace_on_device(parents, emitted, stacked_lengths)
        index = torch.tensor(members)
        expected_collected[index] = group_collected.view(18, len(members), 3, 4).transpose(0, 1).to(torch.int16)
        expected_scores[index] = group_scores.view(len(members), 3, 4)
    assert torch.equal(collected, expected_collected)
    assert torch.equal(scores, expected_scores)

def test_cpu_tensors_take_the_plain_versions_and_other_devices_raise():
    log_probs = torch.from_numpy(_log_probs(2, 6, 5, seed=7))
    lengths = torch.tensor([6, 3])
    launches = (beam_search_cuda.launches, backtrace_cuda.launches)
    parents, emitted, scores = decode.beam_search_device(log_probs, lengths, 3)
    expected = decode.beam_search_padded(log_probs, lengths, 3)
    for got, want in zip((parents, emitted, scores), expected):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    decode.backtrace_on_device(parents, emitted, lengths)
    assert (beam_search_cuda.launches, backtrace_cuda.launches) == launches
    with pytest.raises(ValueError):
        decode.beam_search_device(log_probs.to("meta"), lengths.to("meta"), 3)
    with pytest.raises(ValueError):
        decode.backtrace_on_device(parents.to("meta"), emitted.to("meta"), lengths.to("meta"))
    with pytest.raises(ValueError, match="int16"):
        decode.beam_search_device(torch.zeros(1, 1, MAX_CLASSES + 1), torch.ones(1), 2)
    with pytest.raises(ValueError):
        beam_search_cuda(log_probs, lengths, 3)  # the kernel's wrapper takes CUDA tensors only
