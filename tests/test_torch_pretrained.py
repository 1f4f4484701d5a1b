"""Pretrained encoder weights in the port (``models/pretrained.py``,
``Estimator.from_config(load_pretrained_weights=True)``) against the JAX
package, which loads them through ``transformers`` from the local hub cache
only: a tiny ``transformers`` wav2vec2 model's ``save_pretrained`` files
(safetensors in float32 and float16, a ``.bin``, and a
``Wav2Vec2ForPreTraining`` checkpoint whose encoder sits under
``wav2vec2.`` beside its quantizer) are put into a temporary hub cache, and
the port's initial encoder must equal JAX's bit for bit. With no cache, or a
``config.json`` that does not match the weights, both keep their seeded
weights. Nothing is downloaded: both sides read the cache only."""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch
import transformers
from transformers.utils import hub as transformers_hub

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_attribute_graph
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.phonetics.features import LanguageInventories as JaxInventories
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.models import pretrained
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.phonetics.features import LanguageInventories, PhoneticAttributeIndexer
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.weights import wav2vec2_state_from_jax

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

MODEL_ID = "tests/tiny-wav2vec2"
REVISION = "0123456789abcdef"
TINY = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=2,
    intermediate_size=48,
    conv_dim=(16, 16),
    conv_kernel=(10, 3),
    conv_stride=(5, 2),
    num_conv_pos_embeddings=8,
    num_conv_pos_embedding_groups=4,
)
INVENTORIES = ({0: ["a", "b", "d", "t"], 1: ["a", "t", "s"]}, ["es", "it"])


def _hf_config(**changes):
    return transformers.Wav2Vec2Config(
        **{**TINY, **changes}, feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        codevector_dim=16, proj_codevector_dim=16, num_codevectors_per_group=8,
    )


def _write_cache(root, kind: str):
    """A hub cache under ``root`` holding ``MODEL_ID`` as ``kind`` writes it;
    returns the cache directory."""
    torch.manual_seed(5)
    snapshot = root / f"models--{MODEL_ID.replace('/', '--')}" / "snapshots" / REVISION
    if kind == "pretraining":
        model = transformers.Wav2Vec2ForPreTraining(_hf_config())
    else:
        model = transformers.Wav2Vec2Model(_hf_config())
    if kind == "float16":
        model = model.half()
    model.save_pretrained(str(snapshot), safe_serialization=kind in ("safetensors", "float16"))
    if kind == "mismatched":
        # config.json describes a wider encoder than the weights hold.
        with open(snapshot / "config.json", "w", encoding="utf-8") as file:
            json.dump(_hf_config(hidden_size=64, intermediate_size=96).to_dict(), file)
    (snapshot.parent.parent / "refs").mkdir()
    (snapshot.parent.parent / "refs" / "main").write_text(REVISION)
    return root


def _configs():
    data = mini_config_dict("allophones", False, "wav2vec2-pretrained")
    data["nn"]["acoustic_model"]["model_id"] = MODEL_ID
    return Config.load(data), JaxConfig.load(data)


def _jax_encoder(load: bool):
    _config, config = _configs()
    indexer = JaxIndexer.from_config(config, mini_allophoible_csv(), JaxInventories(*INVENTORIES))
    estimator = JaxEstimator.from_config(
        config, 1, 16_000, jax_attribute_graph(config, indexer), indexer,
        wav2vec2_architecture=JaxArchitecture(**TINY), load_pretrained_weights=load, seed=4, precision="float32",
    )
    acoustic = jax.tree_util.tree_map(np.asarray, estimator.variables["params"]["acoustic_model"])
    return wav2vec2_state_from_jax(acoustic, TINY["num_hidden_layers"])


def _port_encoder(load: bool):
    config, _jax_config = _configs()
    indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv(), LanguageInventories(*INVENTORIES))
    estimator = Estimator.from_config(
        config, 1, 16_000, attribute_graph_from_config(config, indexer), indexer,
        wav2vec2_architecture=Wav2Vec2Architecture(**TINY), load_pretrained_weights=load, seed=4,
        precision="float32", device="cpu",
    )
    return {name: value.numpy() for name, value in estimator.model.acoustic_model.state_dict().items()}


def _assert_equal(got, expected):
    assert set(got) == set(expected)
    for name, value in expected.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.fixture
def hub_cache(tmp_path, monkeypatch):
    """Points both packages at an empty hub cache under ``tmp_path`` and
    returns a function that fills it."""
    cache = tmp_path / "hub"
    cache.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(transformers_hub, "TRANSFORMERS_CACHE", str(cache))
    return lambda kind: _write_cache(cache, kind)


@pytest.mark.parametrize("kind", ["safetensors", "float16", "bin", "pretraining"])
def test_initial_encoder_equals_jax_from_the_cache(hub_cache, kind):
    hub_cache(kind)
    ours, theirs = _port_encoder(True), _jax_encoder(True)
    _assert_equal(ours, theirs)
    # The weights did come from the cache, not from the seed.
    seeded = _port_encoder(False)
    assert not np.array_equal(ours["feature_projection.projection.weight"], seeded["feature_projection.projection.weight"])


@pytest.mark.parametrize("kind", [None, "mismatched"], ids=["no-cache", "mismatched-config"])
def test_without_usable_weights_both_keep_their_seeded_encoders(hub_cache, kind, caplog):
    if kind is not None:
        hub_cache(kind)
    with caplog.at_level(logging.WARNING, logger=pretrained.__name__):
        ours = _port_encoder(True)
    _assert_equal(ours, _port_encoder(False))
    _assert_equal(_jax_encoder(True), _jax_encoder(False))
    (record,) = [record for record in caplog.records if record.name == pretrained.__name__]
    assert MODEL_ID in record.getMessage() and "keeping the seeded encoder" in record.getMessage()


def test_safetensors_reader_matches_the_library(tmp_path):
    """F32, F16 and BF16 tensors (and a header with metadata) read as the
    ``safetensors`` package writes them, upcast to float32."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch_file

    rng = np.random.default_rng(3)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float16)}
    save_file(arrays, str(tmp_path / "numpy.safetensors"), metadata={"format": "np"})
    read = pretrained.read_safetensors(str(tmp_path / "numpy.safetensors"))
    for name, value in arrays.items():
        assert read[name].dtype == np.float32
        np.testing.assert_array_equal(read[name], value.astype(np.float32))
    bf16 = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).bfloat16()
    save_torch_file({"c": bf16}, str(tmp_path / "torch.safetensors"))
    np.testing.assert_array_equal(pretrained.read_safetensors(str(tmp_path / "torch.safetensors"))["c"], bf16.float().numpy())


def test_hub_config_gives_the_architecture():
    config = _hf_config().to_dict()
    expected = Wav2Vec2Architecture(**TINY)
    got = pretrained.architecture_from_hf_config(config)
    for field in dataclasses.fields(Wav2Vec2Architecture):
        if field.name in pretrained.HF_DEFAULTS:
            assert getattr(got, field.name) == getattr(expected, field.name), field.name
