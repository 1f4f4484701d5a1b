"""The port's serving path against the JAX package's, end to end on the CPU: the
flagship head (36 attribute classifiers, 640-wide embedding composition,
allophone layer) over a tiny wav2vec2 encoder, with the JAX model's seeded
weights carried over by the weight bridge.

At "float32" the log-probs of every head agree within 1e-4, the fused greedy
grids of ``predict_decoded`` are integer-exact, with and without the allophone
map and with zero-shot inventories, and so are the beam grids of
``predict_beam_decoded`` (scores within 1e-4). At "mixed" (bf16 encoder, f32 head) the two
frameworks round bf16 at different places, so log-probs agree within a looser
stated tolerance and the token flip rate is recorded. The frozen flagship plan
shipped with the port is checked against the JAX ``build_flagship()``."""

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allophant_tpu.data.batch import Batch as JaxBatch
from allophant_tpu.demo import build_flagship as jax_build_flagship
from allophant_tpu.models.allophant import attribute_graph_from_config, inject_static_data
from allophant_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.demo import PACKAGE_DATA, build_flagship, flagship_data, flagship_zero_shot_table
from allophant_tpu_torch.models.allophant import AllophantModel
from allophant_tpu_torch.models.projection import ProjectionPlan
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.weights import estimator_from_jax
from torch_parity import exact_frame_encoder_erf, numpy_tree, random_variables

ROOT = Path(__file__).resolve().parent.parent
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
# Log-prob tolerance at "mixed": XLA's and PyTorch's CPU kernels round the bf16
# encoder activations at different places, from the first bf16 convolution on,
# so the gap is of the size of each framework's own mixed-vs-float32 gap,
# largest on the phone head whose 640-wide composition logits amplify it
# (measured: port vs JAX 0.28, JAX mixed vs JAX float32 0.28, port mixed vs
# port float32 0.34). This bounds the size of the difference only: an encoder
# run in f32 would pass it too. Where the port casts is checked by
# test_mixed_casts_where_flax_does.
MIXED_LOG_PROB_ATOL = 0.5
# Flax modules with no module counterpart in the port (its dropout is a function).
JAX_ONLY_MODULES = ("Dropout", "acoustic_dropout")
# Flax module name -> the port's, applied in order.
PORT_MODULE_NAMES = (
    (r"conv_(\d+)", r"convs.\1"),
    (r"layer_norm_(\d+)", r"norms.\1"),
    (r"group_norm", "norms.0"),
    (r"classifiers_", "classifiers."),
    (r"\b[qkv]_proj\b", "qkv_proj"),
    (r"/", "."),
)


def _jax_flagship(dtype, head_dtype):
    config, indexer, built = jax_build_flagship(
        wav2vec2_architecture=JaxArchitecture(**TINY), dtype=dtype, head_dtype=head_dtype
    )
    variables = random_variables(
        lambda: built.model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1600)), jnp.full((1,), 1600, jnp.int32), jnp.zeros((1,), jnp.int32)
        ),
        seed=5,
    )
    variables = numpy_tree(inject_static_data(variables, built.static_data))
    # Move the allophone matrices off their 0/1 initialization, so mapping
    # log-probs and mapping raw logits decode differently.
    allophone = variables["params"]["projection"]["allophone"]
    allophone["allophone_matrices"] = allophone["allophone_matrices"] + np.random.default_rng(6).uniform(
        0.2, 2.0, allophone["allophone_matrices"].shape
    ).astype(np.float32)
    estimator = JaxEstimator(config, 1, 16_000, attribute_graph_from_config(config, indexer), built, variables)
    return estimator, indexer, built


def _batch_arrays():
    rng = np.random.default_rng(8)
    audio = (0.5 * rng.standard_normal((3, 4000))).astype(np.float32)
    lengths = np.array([4000, 2500, 0], dtype=np.int32)  # with a zero-length filler row
    return audio, lengths, np.array([0, 1, 3], dtype=np.int32)


def _cases(indexer):
    """(name, target_feature_indices, map_allophones) of the decoded requests."""
    zero_shot = indexer.composition_feature_matrix(indexer.phoneme_inventory("pt"))
    return [
        ("plain", None, False),
        ("allophone-map", None, True),
        ("zero-shot", zero_shot, False),
        ("zero-shot-allophone-map", flagship_zero_shot_table(), True),
    ]


def _both_estimators(precision, dtype, head_dtype):
    """The JAX estimator at one preset and the port's, carrying its weights."""
    jax_estimator, indexer, built = _jax_flagship(dtype, head_dtype)
    port = estimator_from_jax(
        dataclasses.asdict(built.model.acoustic_config),
        dataclasses.asdict(built.model.plan),
        jax_estimator.variables,
        precision,
        device="cpu",
    )
    return jax_estimator, indexer, built, port


def _run_both(estimators):
    """JAX and port results for the same weights and batch."""
    jax_estimator, indexer, _built, port = estimators
    with exact_frame_encoder_erf():
        audio, lengths, language_ids = _batch_arrays()
        jax_batch, batch = JaxBatch(audio, lengths, language_ids), Batch(audio, lengths, language_ids)
        expected = jax_estimator.predict(jax_batch, time_major=False)
        got = port.predict(batch, time_major=False)
        heads = tuple(sorted(expected.outputs))
        # The public allophone map, time-first as the reference predict flow calls it.
        phone = np.asarray(expected.outputs["phone"]).transpose(1, 0, 2)
        mapped = (
            np.asarray(jax_estimator.map_allophones(phone, language_ids)),
            port.map_allophones(phone, language_ids).numpy(),
        )
        grids = {"allophone-map-public": mapped}
        for name, table, map_allophones in _cases(indexer):
            expected_grid, _ = jax_estimator.predict_decoded(jax_batch, table, heads=heads, map_allophones=map_allophones)
            grid, _ = port.predict_decoded(batch, table, heads=heads, map_allophones=map_allophones)
            grids[name] = (np.asarray(expected_grid), grid.to(torch.int32).numpy())
    return expected, got, heads, grids


@pytest.fixture(scope="module")
def float32_estimators():
    return _both_estimators("float32", jnp.float32, None)


@pytest.fixture(scope="module")
def float32_results(float32_estimators):
    return _run_both(float32_estimators)


def _beam_heads(heads):
    """Three four-class attribute heads (one stacked search in the port), the
    phone and the phoneme head: each JAX search compiles a scan of its own,
    so the end-to-end beam tests take a subset. Stacking heads of equal
    class count is held to the head-by-head search in test_torch_beam.py."""
    attributes = [name for name in heads if name not in ("phone", "phoneme")]
    return (*attributes[:3], "phone", "phoneme")


@pytest.fixture(scope="module")
def float32_beam_results(float32_estimators, float32_results):
    """Case name -> ((JAX collected, scores, lengths), (the port's)) of
    ``predict_beam_decoded`` over the heads of ``_beam_heads`` at beam width 4."""
    jax_estimator, indexer, _built, port = float32_estimators
    heads = _beam_heads(float32_results[2])
    audio, lengths, language_ids = _batch_arrays()
    jax_batch, batch = JaxBatch(audio, lengths, language_ids), Batch(audio, lengths, language_ids)
    results = {}
    with exact_frame_encoder_erf():
        for name, table, map_allophones in _cases(indexer):
            expected = jax_estimator.predict_beam_decoded(jax_batch, table, heads=heads, beam_width=4, map_allophones=map_allophones)
            got = port.predict_beam_decoded(batch, table, heads=heads, beam_width=4, map_allophones=map_allophones)
            results[name] = (
                (np.asarray(expected[0]), np.asarray(expected[1]), np.asarray(expected[2])),
                (got[0].numpy(), got[1].numpy(), got[2].numpy()),
            )
    return results


@pytest.fixture(scope="module")
def mixed_estimators():
    return _both_estimators("mixed", jnp.bfloat16, jnp.float32)


def test_float32_log_probs_match_every_head(float32_results):
    expected, got, heads, _ = float32_results
    assert len(heads) == 38  # 36 attributes + phone + phoneme
    assert set(got.outputs) == set(heads)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(expected.lengths))
    valid = np.arange(got.outputs[heads[0]].shape[1])[None, :] < got.lengths.numpy()[:, None]
    for name in heads:
        port_values, jax_values = got.outputs[name].numpy(), np.asarray(expected.outputs[name])
        assert port_values.shape == jax_values.shape, name
        np.testing.assert_allclose(port_values[valid], jax_values[valid], atol=1e-4, err_msg=name)


def test_float32_public_allophone_map_matches(float32_results):
    expected, got = float32_results[3]["allophone-map-public"]
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "allophone-map", "zero-shot", "zero-shot-allophone-map"])
def test_float32_decoded_grids_are_exact(float32_results, case):
    expected_grid, grid = float32_results[3][case]
    assert grid.shape == expected_grid.shape
    assert grid.min() >= 0
    np.testing.assert_array_equal(grid, expected_grid.astype(np.int32))


@pytest.mark.parametrize("case", ["plain", "allophone-map", "zero-shot", "zero-shot-allophone-map"])
def test_float32_beam_grids_are_exact(float32_beam_results, case):
    (expected_collected, expected_scores, expected_lengths), (collected, scores, lengths) = float32_beam_results[case]
    assert collected.dtype == np.int16 and collected.shape == expected_collected.shape
    assert collected.shape[0] == 5 and collected.shape[-1] == 4
    np.testing.assert_array_equal(lengths, expected_lengths)
    np.testing.assert_array_equal(collected, expected_collected)
    assert scores.dtype == np.float32 and scores.shape == expected_scores.shape
    np.testing.assert_allclose(scores, expected_scores, atol=1e-4)


def test_downsampled_lengths_match(float32_estimators):
    jax_estimator, _indexer, _built, port = float32_estimators
    lengths = np.array([0, 400, 4000, 16_000, 163_840])
    np.testing.assert_array_equal(port.downsampled_lengths(lengths), np.asarray(jax_estimator.downsampled_lengths(lengths)))


def test_mixed_log_probs_within_stated_tolerance(mixed_estimators, record_property):
    expected, got, heads, grids = _run_both(mixed_estimators)
    valid = np.arange(got.outputs[heads[0]].shape[1])[None, :] < got.lengths.numpy()[:, None]
    worst = max(
        np.abs(got.outputs[name].numpy()[valid] - np.asarray(expected.outputs[name])[valid]).max() for name in heads
    )
    expected_grid, grid = grids["plain"]
    flips = float((expected_grid.astype(np.int32) != grid).mean())
    record_property("mixed_log_prob_max_abs_err", float(worst))
    record_property("mixed_grid_mismatch_rate", flips)
    assert worst <= MIXED_LOG_PROB_ATOL, worst
    assert np.isfinite(worst)


def _jax_module_dtypes(intermediates, batch: int, prefix: str = "") -> dict:
    """Port module name -> dtypes of the batch-shaped float arrays its flax
    counterpart returned (``capture_intermediates``; parameter-only modules
    return none), for the flax modules the port has."""
    found = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(intermediates)[0]:
        keys = [str(getattr(entry, "key", "")) for entry in path]
        module = keys[: keys.index("__call__")]
        if any(key.startswith(JAX_ONLY_MODULES) for key in module):
            continue
        if leaf.ndim >= 2 and leaf.shape[0] == batch and jnp.issubdtype(leaf.dtype, jnp.floating):
            name = ".".join(filter(None, (prefix, _port_name("/".join(module)))))
            found.setdefault(name, set()).add(str(leaf.dtype))
    return found


def _torch_dtypes(value, batch: int) -> set:
    if isinstance(value, torch.Tensor):
        batched = value.ndim >= 2 and value.shape[0] == batch and value.is_floating_point()
        return {str(value.dtype).removeprefix("torch.")} if batched else set()
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_torch_dtypes(item, batch) for item in value))
    return set()


def _port_module_dtypes(model, run, batch: int) -> dict:
    """Port module name -> dtypes of the batch-shaped float tensors it returned
    while ``run()`` drives the model."""
    found = {}

    def recorder(name):
        return lambda _module, _inputs, output: found.setdefault(name, set()).update(_torch_dtypes(output, batch))

    handles = [module.register_forward_hook(recorder(name)) for name, module in model.named_modules()]
    try:
        run()
    finally:
        for handle in handles:
            handle.remove()
    return found


def _port_name(module: str) -> str:
    for pattern, replacement in PORT_MODULE_NAMES:
        module = re.sub(pattern, replacement, module)
    return module


def test_mixed_casts_where_flax_does(mixed_estimators):
    """At "mixed", every port module returns the dtype its flax counterpart
    returns (bf16 encoder, f32 head): the casts sit where flax's ``dtype=``
    puts them. The encoder layers, whose intermediates ``nn.scan`` does not
    keep, are held to a flax EncoderLayer applied on its own. The training
    form of the same model keeps every parameter in f32 (flax's
    ``param_dtype``), casts at the same places and computes the same outputs
    as the serving form, whose weights are stored in the compute dtypes."""
    jax_estimator, _indexer, built, port = mixed_estimators
    audio, lengths, language_ids = _batch_arrays()
    batch = len(audio)
    _, state = built.model.apply(
        jax_estimator.variables, *map(jnp.asarray, (audio, lengths, language_ids)),
        capture_intermediates=True, mutable=["intermediates"],
    )
    expected = _jax_module_dtypes(state["intermediates"], batch)
    stacked = jax_estimator.variables["params"]["acoustic_model"]["encoder"]["layers"]
    frames = 128
    hidden = jnp.asarray(np.random.default_rng(9).standard_normal((batch, frames, TINY["hidden_size"])), jnp.bfloat16)
    _, layer_state = JaxEncoderLayer(built.model.acoustic_config, jnp.bfloat16).apply(
        {"params": jax.tree_util.tree_map(lambda leaf: leaf[0], stacked)},
        hidden, jnp.arange(frames)[None, :] < jnp.asarray([frames, 50, 1])[:, None],
        capture_intermediates=True, mutable=["intermediates"],
    )
    for index in range(TINY["num_hidden_layers"]):
        expected.update(_jax_module_dtypes(layer_state["intermediates"], batch, f"acoustic_model.encoder.layers.{index}"))

    got = _port_module_dtypes(port.model, lambda: port.predict(Batch(audio, lengths, language_ids)), batch)
    assert {name: got.get(name) for name in expected} == expected
    assert expected["acoustic_model.encoder.layers.0.attention.qkv_proj"] == {"bfloat16"}
    assert expected["projection.classifiers.phoneme"] == {"float32"}

    serving = port.model
    training = AllophantModel(
        serving.architecture, serving.plan, torch.bfloat16, torch.float32, device="cpu", param_dtype=torch.float32
    )
    training.load_state_dict(estimator_from_jax(
        dataclasses.asdict(built.model.acoustic_config), dataclasses.asdict(built.model.plan),
        jax_estimator.variables, "float32", device="cpu",
    ).model.state_dict())
    assert {parameter.dtype for parameter in training.parameters()} == {torch.float32}
    assert torch.bfloat16 in {parameter.dtype for parameter in serving.parameters()}
    inputs = (torch.from_numpy(audio), torch.from_numpy(lengths).long(), torch.from_numpy(language_ids).long())
    with torch.no_grad():
        trained = _port_module_dtypes(training, lambda: training(*inputs), batch)
        training_outputs = training(*inputs).outputs
        serving_outputs = serving(*inputs).outputs
    assert {name: trained.get(name) for name in expected} == expected
    for name, value in serving_outputs.items():
        assert torch.equal(training_outputs[name], value), name


def _export_tool():
    spec = importlib.util.spec_from_file_location("export_torch_flagship_plan", ROOT / "tools" / "export_torch_flagship_plan.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_frozen_flagship_plan_matches_jax_build_flagship():
    document, static = _export_tool().flagship_plan_data()
    frozen_document, frozen_static = flagship_data()
    assert json.loads((PACKAGE_DATA / "flagship_plan.json").read_text()) == document
    assert frozen_document == document
    assert set(frozen_static) == set(static)
    for key, value in static.items():
        np.testing.assert_array_equal(frozen_static[key], value, err_msg=key)


def test_port_flagship_plan_follows_the_encoder_width():
    _config, _indexer, built = jax_build_flagship(wav2vec2_architecture=JaxArchitecture(**TINY))
    estimator = build_flagship(seed=0, architecture=Wav2Vec2Architecture(**TINY), precision="float32", device="cpu")
    assert estimator.model.plan == ProjectionPlan.from_dict(dataclasses.asdict(built.model.plan))
