"""The port's training step against the JAX package's ``make_train_step`` on
the CPU: the flagship head (36 attribute classifiers, 640-wide composition,
allophone layer with its L2 pull) over a tiny float32 wav2vec2 encoder, every
dropout rate at 0 on both sides, accumulation A = 2, the frozen feature
extractor, the flagship's Adam, warmup schedule and clipping. The JAX model's
seeded weights are carried over by the weight bridge; gradients and Adam's
moments come back through the inverse bridge. Also: the schedule and the clip
against optax's, and a dropout step that is a function of its seed."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.config import WarmupConfig as JaxWarmupConfig
from allophant_tpu.demo import build_flagship as jax_build_flagship
from allophant_tpu.models.allophant import inject_static_data
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.training import train_step as jax_train_step
from allophant_tpu_torch.config import WarmupConfig
from allophant_tpu_torch.demo import build_flagship_for_training, flagship_config
from allophant_tpu_torch.models.allophant import AllophantModel
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.models.projection import ProjectionPlan
from allophant_tpu_torch.training import train_step
from allophant_tpu_torch.weights import architecture_from_dict, jax_params_from_state, load_jax_variables
from torch_parity import exact_frame_encoder_erf, numpy_tree, random_variables

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
NO_DROPOUT = dict(hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0)
ACCUMULATION, BATCH, SAMPLES, LABELS = 2, 3, 4000, 4
# Metrics: f32 on two frameworks, summed in other orders (1e-5 relative).
# grad_norm follows the gradients themselves, which differ by more (see
# below): 3e-5.
METRIC_RTOL, GRAD_NORM_RTOL = 1e-5, 3e-5
# Gradients and Adam's first moment: per leaf, within 1e-3 of the leaf's
# largest magnitude. The allophone layer's max routes each phoneme's
# gradient to one allophone; where two products nearly tie, the two
# frameworks' f32 rounding can route it to different ones, and that
# difference flows back through the phoneme head into the shared encoder,
# where the 37 heads' contributions cancel and amplify it (the share
# measured, and the share by which reordering the batch rows moves the
# port's own gradients, are recorded by
# test_gradients_match_jax_through_the_inverse_bridge). The second moment holds squares, whose
# relative error doubles (2e-3). A leaf whose gradient is zero in exact
# arithmetic (the key projection's bias: softmax ignores a per-row shift) is
# held to 1e-6 of the largest gradient of all leaves instead.
GRAD_SHARE, SECOND_MOMENT_SHARE, ZERO_FLOOR = 1e-3, 2e-3, 1e-6


def _flatten(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _microbatches(indexer, plan_nodes):
    """[A, B, ...] arrays: 2.5 and 4000-sample rows and a zero-length filler
    row (row weight 0), 4 labels per head, the phoneme head's drawn from the
    row's language inventory (offset by the blank)."""
    rng = np.random.default_rng(11)
    audio = (0.5 * rng.standard_normal((ACCUMULATION, BATCH, SAMPLES))).astype(np.float32)
    lengths = np.tile(np.array([SAMPLES, 2500, 0], dtype=np.int32), (ACCUMULATION, 1))
    language_ids = np.tile(np.array([0, 1, 3], dtype=np.int32), (ACCUMULATION, 1))
    batch = {
        "audio": audio,
        "lengths": lengths,
        "language_ids": language_ids,
        "row_weights": np.tile(np.array([1.0, 1.0, 0.0], dtype=np.float32), (ACCUMULATION, 1)),
    }
    pools = {
        language: np.fromiter(mapping.keys(), dtype=np.int64) + 1
        for language, mapping in indexer.language_allophones.allophones.items()
    }
    for node in plan_nodes:
        if node.has_allophone:
            labels = np.stack(
                [np.stack([rng.choice(pools[int(language)], LABELS) for language in row]) for row in language_ids]
            )
        else:
            labels = rng.integers(1, node.output_size, (ACCUMULATION, BATCH, LABELS))
        batch[f"labels_{node.name}"] = labels.astype(np.int32)
        batch[f"label_lengths_{node.name}"] = np.full((ACCUMULATION, BATCH), LABELS, dtype=np.int32)
    return batch


@pytest.fixture(scope="module")
def both_steps():
    """Two steps of the JAX train step (compiled once) and of the port's on the
    same weights and microbatches: (JAX states, port states), each a list of
    (metrics, params tree, Adam first and second moment trees) per step, plus
    the port's gradients of step 1 and the starting parameters."""
    config, indexer, built = jax_build_flagship(wav2vec2_architecture=JaxArchitecture(**TINY, **NO_DROPOUT))
    jax_model = built.model.clone(plan=dataclasses.replace(built.model.plan, acoustic_model_dropout=0.0))
    variables = random_variables(
        lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1600)), jnp.full((1,), 1600, jnp.int32), jnp.zeros((1,), jnp.int32)
        ),
        seed=5,
    )
    variables = numpy_tree(inject_static_data(variables, built.static_data))
    # Pull the allophone matrices of languages 0 and 1 off their
    # initialization, so the L2 penalty and its gradient are not zero there
    # (languages 2 and 3 keep W == W0: the safe square root's zero gradient).
    allophone = variables["params"]["projection"]["allophone"]
    allophone["allophone_matrices"] = allophone["allophone_matrices"].copy()
    allophone["allophone_matrices"][:2] += np.random.default_rng(6).uniform(
        -0.2, 0.2, allophone["allophone_matrices"][:2].shape
    ).astype(np.float32)
    microbatches = _microbatches(indexer, jax_model.plan.nodes)

    optimizer = jax_train_step.create_optimizer(config.nn, built.d_model)
    loss_plan = jax_train_step.build_loss_plan(config.nn, has_allophone=True)
    freeze_plan = jax_train_step.build_freeze_plan(config.nn.acoustic_model)
    step = jax.jit(jax_train_step.make_train_step(jax_model, optimizer, loss_plan, freeze_plan))
    params = variables["params"]
    other = {key: value for key, value in variables.items() if key != "params"}
    opt_state = optimizer.init(params)
    jax_states = []
    with exact_frame_encoder_erf():
        for _ in range(2):
            params, opt_state, metrics = step(params, opt_state, other, microbatches, jax.random.PRNGKey(1))
            (adam,) = [
                state for state in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda node: isinstance(node, optax.ScaleByAdamState))
                if isinstance(state, optax.ScaleByAdamState)
            ]
            jax_states.append(({key: float(value) for key, value in metrics.items()}, numpy_tree(params), numpy_tree(adam.mu), numpy_tree(adam.nu)))

    architecture = architecture_from_dict(dataclasses.asdict(jax_model.acoustic_config))
    port_config = flagship_config()
    model = AllophantModel(
        architecture, ProjectionPlan.from_dict(dataclasses.asdict(jax_model.plan)), torch.float32, None, "cpu",
        param_dtype=torch.float32, frozen_prefix=jax_model.frozen_prefix,
    )
    load_jax_variables(model, variables)
    start = jax_params_from_state(dict(model.named_parameters()), architecture)
    port_optimizer = train_step.create_optimizer(port_config, architecture.hidden_size, model.parameters())
    port_step = train_step.make_train_step(
        model, port_optimizer,
        train_step.build_loss_plan(port_config, has_allophone=True),
        train_step.build_freeze_plan(port_config.acoustic_model),
    )
    torch_batch = {key: torch.from_numpy(np.asarray(value)) for key, value in microbatches.items()}
    # The port's own gradients for the same microbatches with their rows in
    # another order: the f32 noise floor the JAX comparison is judged by.
    orders = []
    for order in ([0, 1, 2], [2, 0, 1]):
        loss_plan = train_step.build_loss_plan(port_config, has_allophone=True)
        train_step.accumulate_gradients(model, {key: value[:, order] for key, value in torch_batch.items()}, loss_plan, None)
        orders.append(jax_params_from_state({name: p.grad for name, p in model.named_parameters()}, architecture))
    port_states, gradients = [], None
    for _ in range(2):
        metrics = port_step(torch_batch)
        if gradients is None:
            gradients = jax_params_from_state({name: p.grad for name, p in model.named_parameters()}, architecture)
        state = port_optimizer.optimizer.state
        moments = [
            jax_params_from_state({name: state[p][key] for name, p in model.named_parameters()}, architecture)
            for key in ("exp_avg", "exp_avg_sq")
        ]
        port_states.append((metrics, jax_params_from_state(dict(model.named_parameters()), architecture), *moments))
    return jax_states, port_states, gradients, start, orders


@pytest.mark.parametrize("step_index", [0, 1])
def test_metrics_match_jax(both_steps, step_index):
    jax_states, port_states, _gradients, _start, _orders = both_steps
    expected, got = jax_states[step_index][0], port_states[step_index][0]
    assert set(got) == set(expected)
    for key, value in expected.items():
        assert np.isfinite(got[key]), key
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(got[key], value, rtol=rtol, err_msg=key)
    assert expected["label_count"] == ACCUMULATION * BATCH * LABELS * 37


def _worst_share(got_tree, expected_tree) -> float:
    """The largest difference of any leaf as a share of the scale
    ``_assert_leaves_close`` holds it to at GRAD_SHARE: the leaf's largest
    magnitude, or ZERO_FLOOR / GRAD_SHARE times the largest of all leaves."""
    got, expected = _flatten(got_tree), _flatten(expected_tree)
    assert set(got) == set(expected)
    floor = ZERO_FLOOR / GRAD_SHARE * max(np.abs(value).max() for value in expected.values())
    return max(np.abs(got[key] - value).max() / max(np.abs(value).max(), floor) for key, value in expected.items())


def _assert_leaves_close(got_tree, expected_tree, share, label):
    """Per leaf: within ``share`` of the leaf's largest magnitude, or within
    ZERO_FLOOR of the largest of all leaves, whichever is larger."""
    got, expected = _flatten(got_tree), _flatten(expected_tree)
    assert set(got) == set(expected), label
    floor = ZERO_FLOOR * max(np.abs(value).max() for value in expected.values())
    for key, value in expected.items():
        atol = max(share * np.abs(value).max(), floor)
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=f"{label} {key}")


def test_gradients_match_jax_through_the_inverse_bridge(both_steps, record_property):
    """Step 1's clipped gradients: JAX's from Adam's first moment
    (mu_1 = (1 - beta_1) g), the port's as left in ``.grad``. Both the share
    by which they differ and the share by which the port's own unclipped
    gradients move when the batch rows are reordered are recorded."""
    jax_states, _port_states, gradients, _start, orders = both_steps
    expected = jax.tree_util.tree_map(lambda mu: mu / (1 - 0.9), jax_states[0][2])
    record_property("jax_vs_port_gradient_share", float(_worst_share(gradients, expected)))
    record_property("row_order_gradient_share", float(_worst_share(orders[1], orders[0])))
    _assert_leaves_close(gradients, expected, GRAD_SHARE, "gradient")
    frozen = _flatten(gradients["acoustic_model"]["feature_extractor"])
    assert all(not value.any() for value in frozen.values())


def test_adam_moments_after_two_steps_match_jax(both_steps):
    jax_states, port_states, _gradients, _start, _orders = both_steps
    _assert_leaves_close(port_states[1][2], jax_states[1][2], GRAD_SHARE, "first moment")
    _assert_leaves_close(port_states[1][3], jax_states[1][3], SECOND_MOMENT_SHARE, "second moment")


def test_first_update_matches_jax(both_steps):
    """Adam's first update is lr * g / (|g| + eps), eps = 1e-8: about
    lr * sign(g) where |g| >> eps, a function of the rounding of g where it
    is not. Every parameter after step 1 is held to two float32 spacings of
    the largest value it can round to (twice itself, or of the learning rate
    near 0), plus eight of the learning rate (optax and torch round the update
    by a few ulps), plus the gradient tolerance carried through the update,
    lr * eps * dg / (|g| - dg + eps)^2 with dg the gradient tolerance of
    ``_assert_leaves_close``: tight where |g| is large. Where |g| <= 2 dg the gradient's
    sign is within its tolerance, and so the update is only bounded by 2 lr,
    which is why the comparison bites only where |g| exceeds 2e-3 of the
    leaf's largest. The frozen
    feature extractor stays bit-unchanged on both sides and everything else
    moves."""
    jax_states, port_states, gradients, start, _orders = both_steps
    grads, before = _flatten(gradients), _flatten(start)
    learning_rate = np.float32(flagship_config().lr_schedule.schedule(TINY["hidden_size"])(0))
    expected, got = _flatten(jax_states[0][1]), _flatten(port_states[0][1])
    floor = ZERO_FLOOR * max(np.abs(value).max() for value in grads.values())
    moved = 0
    for key, value in expected.items():
        if "feature_extractor" in key:
            np.testing.assert_array_equal(got[key], before[key], err_msg=key)
            np.testing.assert_array_equal(value, before[key], err_msg=key)
            continue
        grad_error = max(GRAD_SHARE * np.abs(grads[key]).max(), floor)
        magnitude = np.abs(grads[key])
        carried = np.where(
            magnitude > 2 * grad_error,
            learning_rate * 1e-8 * grad_error / (magnitude - grad_error + 1e-8) ** 2,
            2 * learning_rate,
        )
        spacing = np.spacing(2 * np.maximum(np.abs(before[key]), learning_rate))
        limit = 2 * spacing + 8 * np.spacing(learning_rate) + carried
        np.testing.assert_array_less(np.abs(got[key] - value), limit, err_msg=key)
        moved += int((got[key] != before[key]).any())
    assert moved == sum("feature_extractor" not in key for key in expected)


@pytest.mark.parametrize("count", [0, 1, 99, 2498, 2499, 2500, 12498, 12499, 12500, 40000])
def test_schedule_matches_optax(count):
    expected = float(JaxWarmupConfig(2500, 10000, 2).schedule(1024)(jnp.asarray(count, jnp.int32)))
    assert WarmupConfig(2500, 10000, 2).schedule(1024)(count) == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(int(scale * 100))
    grads = [(scale * rng.standard_normal(shape)).astype(np.float32) for shape in ((5, 3), (7,), (2, 2, 2))]
    expected, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    tensors = [torch.from_numpy(g.copy()) for g in grads]
    norm = train_step.global_norm(tensors)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    train_step.clip_by_global_norm(tensors, norm, 1.0)
    for got, want in zip(tensors, expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _tiny_training_step(seed: int):
    """One dropout-on step (the flagship's rates: 0.1 in the encoder, 0.2 on
    the taps, attention dropout through the K5/K4 twins) of a tiny training
    flagship from fixed weights; returns (metrics, parameters)."""
    config, model = build_flagship_for_training(seed=3, architecture=architecture_from_dict(TINY), device="cpu")
    optimizer = train_step.create_optimizer(config, TINY["hidden_size"], model.parameters())
    step = train_step.make_train_step(
        model, optimizer, train_step.build_loss_plan(config, True), train_step.build_freeze_plan(config.acoustic_model)
    )
    rng = np.random.default_rng(12)
    batch = {
        "audio": torch.from_numpy((0.5 * rng.standard_normal((2, 2, 3000))).astype(np.float32)),
        "lengths": torch.tensor([[3000, 2000]] * 2),
        "language_ids": torch.tensor([[0, 2]] * 2),
    }
    # Phoneme labels the languages have (no hard-masked emission), class 1
    # elsewhere.
    phonemes = [int((model.projection.allophone.gather_indices[language, 1:] >= 0).any(-1).nonzero()[0]) + 1 for language in (0, 2)]
    for node in model.plan.nodes:
        labels = torch.tensor(phonemes)[None, :, None] if node.has_allophone else torch.ones(1, 1, 1, dtype=torch.long)
        batch[f"labels_{node.name}"] = labels.expand(2, 2, 3)
        batch[f"label_lengths_{node.name}"] = torch.full((2, 2), 3)
    metrics = step(batch, DropoutRng.from_seed(seed, "cpu"))
    return metrics, {name: parameter.detach().clone() for name, parameter in model.named_parameters()}


def test_dropout_step_is_a_function_of_its_seed():
    """Bit-identical under deterministic algorithms: otherwise the composition
    embeddings' gather backward accumulates in a thread-dependent order."""
    assert 0 < architecture_from_dict(TINY).attention_dropout < 1
    torch.use_deterministic_algorithms(True)
    try:
        first, first_params = _tiny_training_step(7)
        again, again_params = _tiny_training_step(7)
        other, other_params = _tiny_training_step(8)
    finally:
        torch.use_deterministic_algorithms(False)
    assert first == again
    assert all(torch.equal(first_params[name], again_params[name]) for name in first_params)
    assert first["loss_sum"] != other["loss_sum"]
    assert any(not torch.equal(first_params[name], other_params[name]) for name in first_params)
