"""The port's wav2vec2 encoder against the JAX Wav2Vec2Model on the CPU, at a
tiny width, in float32: the same seeded weights (carried over by the weight
bridge) and audio go through both, and every hidden state is compared on the
valid frames."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.models.wav2vec2 import Wav2Vec2Model as JaxWav2Vec2Model
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture, Wav2Vec2Model
from allophant_tpu_torch.weights import wav2vec2_state_from_jax
from torch_parity import exact_frame_encoder_erf, random_variables

TINY = dict(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=96,
    conv_dim=(32, 32, 32),
    conv_kernel=(10, 3, 2),
    conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
VARIANTS = {
    # XLS-R: per-layer LayerNorm extractor (fused first layer), pre-LN encoder.
    "xls-r": dict(feat_extract_norm="layer", do_stable_layer_norm=True),
    # Base wav2vec2: GroupNorm after the first conv, post-LN encoder.
    "base": dict(feat_extract_norm="group", do_stable_layer_norm=False),
    # XLS-R with 80-wide heads, as XLS-R 1B has them (1280 / 16).
    "xls-r-80-wide-heads": dict(feat_extract_norm="layer", do_stable_layer_norm=True, hidden_size=160, num_attention_heads=2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hidden_states_match_jax(variant):
    settings = {**TINY, **VARIANTS[variant]}
    jax_arch = JaxArchitecture(**settings)
    arch = Wav2Vec2Architecture(**settings)
    assert arch.fuses_first_layer == (settings["feat_extract_norm"] == "layer")

    rng = np.random.default_rng(0)
    samples = 3203
    audio = (0.5 * rng.standard_normal((3, samples))).astype(np.float32)
    lengths = np.array([samples, 2100, 0], dtype=np.int32)

    jax_model = JaxWav2Vec2Model(jax_arch, jnp.float32)
    variables = random_variables(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1600)), jnp.full((1,), 1600, jnp.int32)),
        seed=1,
    )
    with exact_frame_encoder_erf():
        expected_states, expected_lengths = jax_model.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))

    model = Wav2Vec2Model(arch, torch.float32)
    state = wav2vec2_state_from_jax(variables["params"], arch.num_hidden_layers)
    model.load_state_dict({key: torch.from_numpy(np.ascontiguousarray(value)) for key, value in state.items()})
    with torch.inference_mode():
        states, frame_lengths = model(torch.from_numpy(audio), torch.from_numpy(lengths).long())

    np.testing.assert_array_equal(frame_lengths.numpy(), np.asarray(expected_lengths))
    assert len(states) == len(expected_states) == arch.num_hidden_layers + 1
    valid = np.arange(states[0].shape[1])[None, :] < frame_lengths.numpy()[:, None]
    for index, (got, expected) in enumerate(zip(states, expected_states)):
        got, expected = got.numpy(), np.asarray(expected)
        assert got.shape == expected.shape, index
        assert np.isfinite(got).all(), index
        np.testing.assert_allclose(got[valid], expected[valid], atol=1e-4, err_msg=f"hidden state {index}")


def _hierarchical_plan(projection_module, dependency_blanks: bool):
    """A JAX plan that the flagship does not exercise: an attention classifier
    on an intermediate tap, and classifiers reading softmaxed posteriors of
    other classifiers next to a raw tap."""
    width = 32
    blank = 0 if dependency_blanks else 1
    dependency = projection_module.DependencyPlan
    node = projection_module.NodePlan
    a_size, b_size = 6 - blank, 4 - blank
    nodes = (
        node("a", width, 6, 6, (dependency("OUTPUT_1", width, True),), attention=(2, True)),
        node("b", width + a_size, 4, 4, (dependency("OUTPUT", width, True), dependency("a", a_size, False))),
        node("c", a_size + b_size, 6, 6, (dependency("a", a_size, False), dependency("b", b_size, False)), attention=(3, False)),
    )
    return projection_module.ProjectionPlan(nodes, 1, dependency_blanks, 0.0, ("OUTPUT", "OUTPUT_1"))


@pytest.mark.parametrize("dependency_blanks", [False, True], ids=["blanks-stripped", "blanks-kept"])
def test_hierarchical_projection_matches_jax(dependency_blanks):
    import dataclasses

    from allophant_tpu.models import projection as jax_projection
    from allophant_tpu_torch.models.projection import HierarchicalProjection, ProjectionPlan
    from allophant_tpu_torch.weights import projection_state_from_jax

    jax_plan = _hierarchical_plan(jax_projection, dependency_blanks)
    rng = np.random.default_rng(2)
    taps = [rng.standard_normal((2, 20, 32)).astype(np.float32) for _ in range(3)]
    lengths = np.array([20, 13], dtype=np.int32)
    language_ids = np.zeros(2, dtype=np.int32)
    jax_module = jax_projection.HierarchicalProjection(jax_plan, jnp.float32)
    variables = random_variables(
        lambda: jax_module.init(jax.random.PRNGKey(0), [jnp.asarray(tap) for tap in taps], lengths, language_ids), seed=3
    )
    expected = jax_module.apply(variables, [jnp.asarray(tap) for tap in taps], lengths, language_ids)

    module = HierarchicalProjection(ProjectionPlan.from_dict(dataclasses.asdict(jax_plan)), torch.float32)
    state = projection_state_from_jax(variables["params"], variables.get("buffers", {}))
    module.load_state_dict({key: torch.from_numpy(np.array(value)) for key, value in state.items()})
    with torch.inference_mode():
        got = module([torch.from_numpy(tap) for tap in taps], torch.from_numpy(lengths).long(), torch.zeros(2).long())
    assert set(got) == set(expected) == {"a", "b", "c"}
    valid = np.arange(20)[None, :] < lengths[:, None]
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy()[valid], np.asarray(expected[name])[valid], atol=1e-4, err_msg=name)
