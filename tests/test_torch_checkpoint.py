"""Checkpoint restore in the port (allophant_tpu_torch/training/checkpoint.py
and ``Estimator.restore``) against the JAX package: a native checkpoint written
by JAX's ``Estimator.save`` restores with every parameter and table bit-equal,
the port's own save/restore round trip is bit-equal, a reference-format torch
checkpoint (made as tests/test_estimator.py makes one) gives JAX's parameters,
and what does not fit raises. Also the flax layout of arrays above its chunk
size, the local hub cache, and the lossless int16 audio upload."""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_attribute_graph
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.phonetics.features import LanguageInventories as JaxInventories
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training.checkpoint import EpochPosition as JaxEpochPosition
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu.training.estimator import infer_wav2vec2_architecture as jax_infer_architecture
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.training import checkpoint as checkpoint_module
from allophant_tpu_torch.training import msgpack_codec
from allophant_tpu_torch.training.estimator import Estimator, _pack_audio_for_upload, infer_wav2vec2_architecture
from allophant_tpu_torch.weights import jax_params_from_state

from fixtures import mini_allophoible_csv, mini_config_dict
from test_estimator import _make_reference_checkpoint

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

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
INVENTORIES = ({0: ["a", "b", "d", "t"], 1: ["a", "t", "s"]}, ["es", "it"])


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), np.asarray(value)


def _assert_trees_bit_equal(got, expected):
    got, expected = dict(_leaves(got)), dict(_leaves(expected))
    assert got.keys() == expected.keys()
    for path, value in expected.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(path, JAX variables as numpy) of a native checkpoint written by JAX's
    ``Estimator.save``: the mini config with a tiny wav2vec2 encoder, the
    allophone layer and the embedding composition (so both static tables are
    in ``buffers``), a non-zero epoch position and a history."""
    config = JaxConfig.load(mini_config_dict("allophones", True, "wav2vec2-pretrained"))
    indexer = JaxIndexer.from_config(config, mini_allophoible_csv(), JaxInventories(*INVENTORIES))
    estimator = JaxEstimator.from_config(
        config, 1, 16_000, jax_attribute_graph(config, indexer), indexer,
        wav2vec2_architecture=JaxArchitecture(**TINY), load_pretrained_weights=False, seed=4, precision="float32",
    )
    estimator.epoch = JaxEpochPosition(3, 100, 10)
    estimator.history = [{"validation_loss": 1.5}]
    path = str(tmp_path_factory.mktemp("jax") / "model.ckpt")
    estimator.save(path, optimizer_state=b"jax-optimizer", phonetic_indexer_state=indexer.state())
    return path, jax.tree_util.tree_map(np.asarray, estimator.variables), indexer.state().to_dict()


def _restore(path, **kwargs):
    kwargs.setdefault("wav2vec2_architecture", Wav2Vec2Architecture(**TINY))
    return Estimator.restore(path, precision="float32", device="cpu", **kwargs)


def test_jax_native_checkpoint_restores_bit_equal(jax_checkpoint):
    path, variables, indexer_state = jax_checkpoint
    estimator, indexer = _restore(path)
    _assert_trees_bit_equal(checkpoint_module.variables_from_model(estimator.model), variables)
    assert all(parameter.dtype == torch.float32 for parameter in estimator.model.parameters())
    assert indexer.state().to_dict() == indexer_state
    assert (estimator.epoch.epoch, estimator.epoch.global_step, estimator.epoch.step) == (3, 100, 10)
    assert estimator.history == [{"validation_loss": 1.5}]
    assert estimator.training_state == b"jax-optimizer"
    assert estimator.precision == "float32" and estimator.device == torch.device("cpu")


def test_port_save_restore_round_trip_is_bit_equal(jax_checkpoint, tmp_path):
    estimator, indexer = _restore(jax_checkpoint[0])
    with torch.no_grad():
        for parameter in estimator.model.parameters():
            parameter.add_(0.25)
    path = str(tmp_path / "port.ckpt")
    estimator.save(path, optimizer_state=b"port", phonetic_indexer_state=indexer.state())
    restored, restored_indexer = _restore(path)
    _assert_trees_bit_equal(
        checkpoint_module.variables_from_model(restored.model), checkpoint_module.variables_from_model(estimator.model)
    )
    assert restored_indexer.state().to_dict() == indexer.state().to_dict()
    assert restored.training_state == b"port" and restored.epoch == estimator.epoch


@pytest.mark.parametrize(
    "layer, options",
    [("allophones", {}), ("shared", {"composition": True, "attention_heads": {"nasal": 3}})],
    ids=["allophones", "composition-attention"],
)
def test_reference_checkpoint_restores_to_jax_parameters(tmp_path, layer, options):
    """Neither side is given the encoder's architecture: both infer it from
    the tensors, and both convert the reference names to the same tree."""
    path, *_ = _make_reference_checkpoint(tmp_path, phoneme_layer=layer, **options)
    jax_estimator, _jax_indexer = JaxEstimator.restore(path, precision="float32")
    estimator, indexer = Estimator.restore(path, precision="float32", device="cpu")
    expected = jax.tree_util.tree_map(np.asarray, jax_estimator.variables)
    state = {name: parameter.detach() for name, parameter in estimator.model.named_parameters()}
    _assert_trees_bit_equal(jax_params_from_state(state, estimator.model.architecture), expected["params"])
    _assert_trees_bit_equal(checkpoint_module.variables_from_model(estimator.model)["buffers"], expected["buffers"])
    assert (estimator.epoch.epoch, estimator.epoch.global_step, estimator.epoch.step) == (3, 100, 10)
    assert indexer.phonemes.tolist() == list(_jax_indexer.phonemes)


def test_inferred_architecture_equals_jax(tmp_path):
    path, *_ = _make_reference_checkpoint(tmp_path)
    state = checkpoint_module.load_reference_checkpoint(path).reference_model_state
    ours = dataclasses.asdict(infer_wav2vec2_architecture(state))
    theirs = dataclasses.asdict(jax_infer_architecture(state))
    assert ours == {key: theirs[key] for key in ours}


def test_mismatches_and_missing_paths_raise(jax_checkpoint, tmp_path):
    path = jax_checkpoint[0]
    wider = Wav2Vec2Architecture(**{**TINY, "intermediate_size": 80})
    with pytest.raises(ValueError, match="Shape mismatch for params/acoustic_model/encoder/layers/feed_forward"):
        _restore(path, wav2vec2_architecture=wider)
    checkpoint = checkpoint_module.load_native(path)
    del checkpoint.variables["params"]["projection"]["classifiers_nasal"]["bias"]
    checkpoint.variables["params"]["projection"]["extra"] = {"kernel": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match=r"Missing: \['params/projection/classifiers_nasal/bias'\]; extra: \['params/projection/extra/kernel'\]"):
        _restore(checkpoint)
    with pytest.raises(FileNotFoundError):
        _restore(str(tmp_path / "missing.ckpt"))
    # An Orbax directory is no longer refused: it restores bit-equal.
    orbax = str(tmp_path / "orbax")
    checkpoint_module.save_orbax(checkpoint_module.load_native(path), orbax)
    estimator, _indexer = _restore(orbax)
    _assert_trees_bit_equal(checkpoint_module.variables_from_model(estimator.model), jax_checkpoint[1])
    assert estimator.training_state == b"jax-optimizer"


def test_restore_takes_a_model_id_from_the_local_hub_cache(jax_checkpoint, tmp_path, monkeypatch):
    snapshot = tmp_path / "hub" / "models--org--model" / "snapshots" / "abc123"
    snapshot.mkdir(parents=True)
    shutil.copyfile(jax_checkpoint[0], snapshot / "allophant.pt")
    (tmp_path / "hub" / "models--org--model" / "refs").mkdir()
    (tmp_path / "hub" / "models--org--model" / "refs" / "main").write_text("abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    estimator, _indexer = _restore("org/model")
    _assert_trees_bit_equal(checkpoint_module.variables_from_model(estimator.model), jax_checkpoint[1])
    with pytest.raises(FileNotFoundError):
        _restore("org/other")


def test_flax_chunked_arrays_are_rebuilt(monkeypatch):
    """flax splits an array above its chunk size into a chunked record; the
    port's codec reads such a file back into the array."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": np.arange(60, dtype=np.float32).reshape(3, 20), "small": np.ones(3, np.int32)}}
    decoded = msgpack_codec.unchunk(msgpack_codec.unpackb(serialization.msgpack_serialize(tree)))
    _assert_trees_bit_equal(decoded, tree)


def test_audio_upload_is_int16_when_lossless(jax_checkpoint):
    estimator, _indexer = _restore(jax_checkpoint[0])
    rng = np.random.default_rng(2)
    quantised = (rng.integers(-32768, 32768, (2, 3000)) / 32768.0).astype(np.float32)
    assert _pack_audio_for_upload(quantised).dtype == np.int16
    resampled = quantised + np.float32(1e-6)
    assert _pack_audio_for_upload(resampled) is resampled
    for audio in (quantised, resampled):
        batch = Batch(audio, np.array([3000, 2000]), np.array([0, 1]))
        (uploaded, _lengths, _languages), _ = estimator._inputs(batch, None)
        assert uploaded.dtype == torch.float32
        np.testing.assert_array_equal(uploaded[:, :3000].numpy(), audio)
