"""The port's from-scratch transformer acoustic model
(allophant_tpu_torch/models/transformer.py) against the JAX package's
(allophant_tpu/models/transformer.py) at float32 on the CPU: the direct,
linear and sequential frontends' outputs and lengths (weights carried by
``weights.transformer_state_from_jax``), the reflect padding, the whole model
under the hierarchical head (log-probs and greedy grids) and one float32
training step against JAX's ``make_train_step``, the reference checkpoint
conversion against JAX's ``_convert_transformer_acoustic_state``, and
checkpoints written by either package restored by the other."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.config import TransformerAcousticModelConfig as JaxTransformerConfig
from allophant_tpu.models import transformer as jax_transformer
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_graph_from_config
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training import checkpoint as jax_checkpoint
from allophant_tpu.training import train_step as jax_train_step
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.config import TransformerAcousticModelConfig
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.models import transformer
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.training import checkpoint
from allophant_tpu_torch.training import train_step
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.weights import jax_params_from_state, load_jax_variables, transformer_state_from_jax

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

# float32 on two frameworks in other summation orders: outputs within 1e-5 of
# each layer's largest value; metrics 1e-5 relative; gradients within 1e-4
# of each leaf's largest (no allophone max here to route near-ties, unlike
# the flagship's 1e-3 in tests/test_torch_train_step.py); a leaf that is zero
# in exact arithmetic (the key projection's bias: softmax ignores a per-row
# shift) within 1e-6 of the largest gradient of all leaves.
OUTPUT_SHARE, METRIC_RTOL, GRAD_SHARE, ZERO_FLOOR = 1e-5, 1e-5, 1e-4, 1e-6


def _layers(activation="relu", dropout=0.0):
    return {
        "feedforward_neurons": 64, "heads": 2, "num_layers": 2, "dropout_rate": dropout,
        "activation": activation, "positional_embeddings": True,
    }


# (acoustic model config, feature size): the configurations of the JAX
# package's reference differential test (tests/test_reference_model_differential.py)
# and fixtures, and a sequential frontend with a max pool and two GLUs.
VARIANTS = {
    "direct": ({"type": "pre-ln-transformer", "transformer": _layers(), "frontend": {"architecture": "direct"}}, 32),
    "linear": (
        {"type": "pre-ln-transformer", "transformer": _layers("gelu"), "frontend": {"architecture": "linear", "neurons": 32}, "elementwise_affine": True},
        8,
    ),
    "sequential": (
        {
            "type": "pre-ln-transformer",
            "transformer": _layers(),
            "frontend": {"architecture": "linear", "neurons": 32},
            "sequential_frontend": {
                "layers": [
                    {"type": "glu1d", "out_channels": 24, "kernel": 3, "stride": 2},
                    {"type": "layer_norm", "affine": True},
                    {"type": "max_pool", "size": 2},
                    {"type": "glu1d", "out_channels": 16, "kernel": 5, "stride": 1},
                    {"type": "dropout", "rate": 0.0},
                ]
            },
            "elementwise_affine": True,
        },
        8,
    ),
}


def _jax_acoustic(variant):
    """(JAX module, perturbed params, features, lengths) of a variant."""
    data, features = VARIANTS[variant]
    module = jax_transformer.TransformerAcousticModel(JaxTransformerConfig.from_dict(data), features)
    rng = np.random.default_rng(0)
    inputs = rng.standard_normal((3, 37, features)).astype(np.float32)
    lengths = np.array([37, 20, 1])
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(inputs), jnp.asarray(lengths))["params"]
    noise = np.random.default_rng(2)
    # Norm scales and biases off their 1 and 0, so that every leaf matters.
    params = jax.tree_util.tree_map(lambda leaf: np.asarray(leaf) + 0.05 * noise.standard_normal(leaf.shape).astype(np.float32), params)
    return module, params, inputs, lengths


def _port_acoustic(variant, params):
    data, features = VARIANTS[variant]
    model = transformer.TransformerAcousticModel(transformer.TransformerArchitecture(TransformerAcousticModelConfig.from_dict(data), features))
    state = transformer_state_from_jax(params, data["transformer"]["num_layers"])
    model.load_state_dict({key: torch.from_numpy(np.asarray(value)) for key, value in state.items()}, strict=True)
    return model


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_acoustic_model_matches_jax(variant):
    module, params, inputs, lengths = _jax_acoustic(variant)
    expected, expected_lengths = module.apply({"params": params}, jnp.asarray(inputs), jnp.asarray(lengths))
    model = _port_acoustic(variant, params)
    outputs, output_lengths = model(torch.from_numpy(inputs), torch.from_numpy(lengths))
    expected_lengths = np.asarray(expected_lengths)
    np.testing.assert_array_equal(output_lengths.numpy(), expected_lengths)
    np.testing.assert_array_equal(model.arch.downsampled_lengths(lengths), expected_lengths)
    assert model.arch.hidden_size == module.d_model and len(outputs) == len(expected) == 2
    for got, want in zip(outputs, expected):
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        for row, length in enumerate(expected_lengths):
            # Rows past their length are padding, which only masks keys.
            scale = np.abs(want[row, :length]).max(initial=1.0)
            np.testing.assert_allclose(got[row, :length], want[row, :length], atol=OUTPUT_SHARE * scale, rtol=0)


@pytest.mark.parametrize("padding", [(1, 1), (2, 4), (0, 3)])
def test_variable_length_reflect_pad_matches_jax(padding):
    rng = np.random.default_rng(3)
    features = rng.standard_normal((4, 9, 3)).astype(np.float32)
    lengths = np.array([9, 5, 2, 1])
    expected = jax_transformer.variable_length_reflect_pad(jnp.asarray(features), jnp.asarray(lengths), padding)
    got = transformer.variable_length_reflect_pad(torch.from_numpy(features), torch.from_numpy(lengths), padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


def test_leaky_relu_takes_slope_one_at_zero():
    """flax's leaky_relu differentiates to 1 at 0; the linear frontend meets 0
    exactly (LayerNorm over one feature, a zero bias)."""
    values = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    transformer.leaky_relu(values).sum().backward()
    expected = jax.grad(lambda x: jax.nn.leaky_relu(x).sum())(jnp.array([-2.0, 0.0, 3.0]))
    np.testing.assert_array_equal(values.grad.numpy(), np.asarray(expected))


def _mini_config_dict():
    """The JAX fixtures' mini transformer (linear frontend, d_model 32, 2
    heads of 16, 2 layers) on 40 log-mel filterbanks, float32, SGD."""
    config = mini_config_dict()
    config["nn"].update(mixed_precision=False, optimizer={"algorithm": "sgd", "learning_rate": 0.01, "momentum": 0.9})
    config["preprocessing"] = {
        "feature_type": "FILTERBANKS", "window": {"frame_duration": 25, "frame_stride": 10}, "resample": 16000, "num_filters": 40,
    }
    return config


FEATURES, LANGUAGES = 40, ["es", "it", "de"]


@pytest.fixture(scope="module")
def mini():
    """(JAX estimator, port estimator) of the mini configuration on the same
    weights."""
    config_dict = _mini_config_dict()
    jax_config = JaxConfig.load(config_dict)
    jax_indexer = JaxIndexer.from_config(jax_config, mini_allophoible_csv())
    jax_estimator = JaxEstimator.from_config(
        jax_config, FEATURES, 16000, jax_graph_from_config(jax_config, jax_indexer), jax_indexer, seed=3, precision="float32",
    )
    config = Config.load(config_dict)
    indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv())
    estimator = Estimator.from_config(
        config, FEATURES, 16000, attribute_graph_from_config(config, indexer), indexer, precision="float32", device="cpu",
    )
    load_jax_variables(estimator.model, jax.tree_util.tree_map(np.asarray, jax_estimator.variables))
    return jax_estimator, estimator, indexer


def _batch():
    rng = np.random.default_rng(4)
    lengths = np.array([30, 17, 1])
    return Batch(rng.standard_normal((3, 30, FEATURES)).astype(np.float32), lengths, np.array([0, 1, 2]))


def test_model_predictions_match_jax(mini):
    jax_estimator, estimator, _indexer = mini
    batch = _batch()
    expected = jax_estimator.predict(batch, time_major=False)
    got = estimator.predict(batch, time_major=False)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(expected.lengths))
    assert sorted(got.outputs) == sorted(expected.outputs)
    for name, value in got.outputs.items():
        want = np.asarray(expected.outputs[name])
        for row, length in enumerate(batch.lengths):
            np.testing.assert_allclose(value[row, :length].numpy(), want[row, :length], atol=1e-4, rtol=0, err_msg=name)
    heads = tuple(sorted(got.outputs))
    grid, _ = estimator.predict_decoded(batch, heads=heads)
    jax_grid, _ = jax_estimator.predict_decoded(batch, heads=heads)
    np.testing.assert_array_equal(grid.numpy().astype(np.int64), np.asarray(jax_grid).astype(np.int64))


def _microbatches(plan_nodes):
    rng = np.random.default_rng(5)
    arrays = {
        "audio": rng.standard_normal((2, 3, 24, FEATURES)).astype(np.float32),
        "lengths": np.array([[24, 13, 9], [20, 24, 6]], dtype=np.int32),
        "language_ids": np.array([[0, 1, 2], [2, 1, 0]], dtype=np.int32),
        "row_weights": np.ones((2, 3), dtype=np.float32),
    }
    for node in plan_nodes:
        arrays[f"labels_{node.name}"] = rng.integers(1, node.output_size, (2, 3, 4)).astype(np.int32)
        arrays[f"label_lengths_{node.name}"] = np.array([[4, 3, 2], [4, 4, 1]], dtype=np.int32)
    return arrays


def test_train_step_matches_jax(mini):
    jax_estimator, estimator, _indexer = mini
    config = estimator.config.nn
    jax_model = jax_estimator.built.model
    microbatches = _microbatches(estimator.model.plan.nodes)
    variables = jax.tree_util.tree_map(np.asarray, jax_estimator.variables)
    params = variables["params"]
    other = {key: value for key, value in variables.items() if key != "params"}
    optimizer = jax_train_step.create_optimizer(jax_estimator.config.nn, jax_estimator.built.d_model)
    step = jax.jit(
        jax_train_step.make_train_step(
            jax_model, optimizer, jax_train_step.build_loss_plan(jax_estimator.config.nn, has_allophone=False),
            jax_train_step.build_freeze_plan(jax_estimator.config.nn.acoustic_model),
        )
    )
    new_params, state, metrics = step(params, optimizer.init(params), other, microbatches, jax.random.PRNGKey(0))
    # SGD with momentum: after the first step the trace is the gradient.
    (trace,) = [node for node in jax.tree_util.tree_leaves(state, is_leaf=lambda node: isinstance(node, optax.TraceState)) if isinstance(node, optax.TraceState)]
    gradients = trace.trace

    model = estimator.model
    port_optimizer = train_step.create_optimizer(config, model.architecture.hidden_size, model.parameters())
    port_step = train_step.make_train_step(model, port_optimizer, train_step.build_loss_plan(config, False), train_step.build_freeze_plan(config.acoustic_model))
    port_metrics = port_step({key: torch.from_numpy(value) for key, value in microbatches.items()})
    for key in ("loss_sum", "label_count", "mean_loss", "grad_norm"):
        np.testing.assert_allclose(port_metrics[key], float(metrics[key]), rtol=METRIC_RTOL, err_msg=key)
    port_gradients = jax_params_from_state({name: p.grad for name, p in model.named_parameters()}, model.architecture)
    port_params = jax_params_from_state(dict(model.named_parameters()), model.architecture)
    floor = ZERO_FLOOR * max(np.abs(np.asarray(leaf)).max() for leaf in jax.tree_util.tree_leaves(gradients)) / GRAD_SHARE
    for (path, want), (_path, got), (_p, new), (_q, got_new) in zip(
        jax.tree_util.tree_flatten_with_path(gradients)[0],
        jax.tree_util.tree_flatten_with_path(port_gradients)[0],
        jax.tree_util.tree_flatten_with_path(new_params)[0],
        jax.tree_util.tree_flatten_with_path(port_params)[0],
    ):
        label = jax.tree_util.keystr(path)
        scale = max(np.abs(np.asarray(want)).max(), floor)
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_SHARE * scale, rtol=0, err_msg=label)
        # SGD's first update is -lr * g: the gradient limit times the
        # learning rate, plus an f32 spacing of the parameter.
        learning_rate = config.optimizer.learning_rate
        atol = learning_rate * GRAD_SHARE * scale + np.spacing(np.abs(np.asarray(new)).max())
        np.testing.assert_allclose(got_new, np.asarray(new), atol=atol, rtol=0, err_msg=label)


def _reference_state(config: JaxTransformerConfig, params) -> dict:
    """The reference's torch state-dict names of a JAX transformer parameter
    tree (the inverse of ``_convert_transformer_acoustic_state``), values
    from ``params``."""
    prefix = "_acoustic_model."
    state = {}

    def linear(name, tree):
        state[f"{name}.weight"] = np.ascontiguousarray(np.asarray(tree["kernel"]).T)
        state[f"{name}.bias"] = np.asarray(tree["bias"])

    def norm(name, tree):
        state[f"{name}.weight"], state[f"{name}.bias"] = np.asarray(tree["scale"]), np.asarray(tree["bias"])

    offset = 1 if getattr(config.frontend, "input_dropout", 0) > 0 else 0
    if "frontend_norm" in params:
        norm(f"{prefix}_frontend._layer.{offset}", params["frontend_norm"])
    if "frontend_linear" in params:
        linear(f"{prefix}_frontend._layer.{offset + 1}", params["frontend_linear"])
    for name, tree in params.get("sequential_frontend", {}).items():
        base = f"{prefix}_sequential_frontend._layers.layers.{name.split('_')[1]}.module"
        if name.startswith("glu_"):
            state[f"{base}._weights.weight"] = np.ascontiguousarray(np.asarray(tree["weights"]["kernel"]).transpose(2, 1, 0))
            state[f"{base}._weights.bias"] = np.asarray(tree["weights"]["bias"])
        else:
            norm(f"{base}.1", tree)
    layers = params["layers"]
    for index in range(config.transformer.num_layers):
        base = f"{prefix}_transformer.layers.{index}"
        pick = lambda name, leaf: np.asarray(layers[name][leaf])[index]
        state[f"{base}.self_attn.in_proj_weight"] = np.concatenate([pick(name, "kernel").T for name in ("q_proj", "k_proj", "v_proj")])
        state[f"{base}.self_attn.in_proj_bias"] = np.concatenate([pick(name, "bias") for name in ("q_proj", "k_proj", "v_proj")])
        for name, target in (("out_proj", "self_attn.out_proj"), ("linear1", "linear1"), ("linear2", "linear2")):
            state[f"{base}.{target}.weight"] = np.ascontiguousarray(pick(name, "kernel").T)
            state[f"{base}.{target}.bias"] = pick(name, "bias")
        for name in ("norm1", "norm2"):
            if name in layers:
                state[f"{base}.{name}.weight"], state[f"{base}.{name}.bias"] = pick(name, "scale"), pick(name, "bias")
    if "final_norm" in params:
        norm(f"{prefix}_final_layer_norm", params["final_norm"])
    return state


@pytest.mark.parametrize("variant", ["direct", "sequential"])
def test_reference_conversion_matches_jax(variant):
    data, _features = VARIANTS[variant]
    _module, params, inputs, lengths = _jax_acoustic(variant)
    jax_config = JaxTransformerConfig.from_dict(data)
    state = _reference_state(jax_config, params)
    expected = jax_checkpoint._convert_transformer_acoustic_state(state, jax_config)
    got = checkpoint._convert_transformer_acoustic_state(state, TransformerAcousticModelConfig.from_dict(data))
    flat_expected = dict(jax.tree_util.tree_flatten_with_path(expected)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_expected.keys()
    for key, value in flat_expected.items():
        np.testing.assert_array_equal(flat_got[key], np.asarray(value), err_msg=jax.tree_util.keystr(key))
    # The converted tree is the model's: it loads and reproduces the outputs.
    model = _port_acoustic(variant, got)
    reference = _port_acoustic(variant, params)
    for a, b in zip(model(torch.from_numpy(inputs), torch.from_numpy(lengths))[0], reference(torch.from_numpy(inputs), torch.from_numpy(lengths))[0]):
        assert torch.equal(a, b)


def test_checkpoints_restore_across_packages(mini, tmp_path):
    """A port-written transformer checkpoint restores in JAX (``load_native``,
    ``Estimator.restore``) and a JAX-written one in the port, each predicting
    as the writer does."""
    jax_estimator, estimator, indexer = mini
    batch = _batch()
    port_path, jax_path = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    estimator.save(str(port_path), phonetic_indexer_state=indexer.state())
    jax_estimator.save(str(jax_path), phonetic_indexer_state=JaxIndexer.from_config(JaxConfig.load(_mini_config_dict()), mini_allophoible_csv()).state())
    from_port, _ = JaxEstimator.restore(str(port_path), precision="float32")
    from_jax, _ = Estimator.restore(str(jax_path), precision="float32", device="cpu")
    for restored, writer in ((from_port, estimator), (from_jax, jax_estimator)):
        got, want = restored.predict(batch, time_major=False), writer.predict(batch, time_major=False)
        for name in got.outputs:
            np.testing.assert_allclose(np.asarray(got.outputs[name])[0], np.asarray(want.outputs[name])[0], atol=1e-4, rtol=0, err_msg=name)
