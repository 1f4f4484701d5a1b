"""The port's configuration schema (allophant_tpu_torch/config.py) against the
JAX package's: the same dicts and TOML load to configs whose dumps are
JSON-equal, for the bundled default TOML, the demo flagship config and the
mini test configs."""

import json

import numpy as np
import pytest

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.demo import demo_config_dict as jax_demo_config_dict
from allophant_tpu.package_data import DEFAULT_CONFIG_PATH as JAX_DEFAULT_CONFIG_PATH
from allophant_tpu_torch.config import BatchingMode, Config, WarmupConfig, whole_run_frozen_prefix
from allophant_tpu_torch.demo import demo_config_dict
from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH

from fixtures import mini_config_dict


def _dump(config) -> str:
    return json.dumps(config.dump(), sort_keys=True)


def test_default_toml_is_the_jax_packages():
    with open(DEFAULT_CONFIG_PATH, "rb") as ours, open(JAX_DEFAULT_CONFIG_PATH, "rb") as theirs:
        assert ours.read() == theirs.read()
    assert _dump(Config.default()) == _dump(JaxConfig.from_toml(JAX_DEFAULT_CONFIG_PATH))


@pytest.mark.parametrize(
    "make",
    [
        lambda: demo_config_dict(),
        lambda: demo_config_dict(phoneme_layer="shared", embedding_size=32, languages=["es", "de"]),
        lambda: mini_config_dict(),
        lambda: mini_config_dict(phoneme_layer="allophones", embedding_composition=True, model_type="wav2vec2-pretrained"),
    ],
    ids=["demo", "demo-shared", "mini-transformer", "mini-wav2vec2"],
)
def test_dump_equals_jax(make):
    assert _dump(Config.load(make())) == _dump(JaxConfig.load(make()))
    # A dump loads back to the same config.
    assert _dump(Config.load(Config.load(make()).dump())) == _dump(Config.load(make()))


def test_demo_config_dict_equals_jax():
    assert demo_config_dict() == jax_demo_config_dict()
    assert demo_config_dict("shared", 16, ["fr"]) == jax_demo_config_dict("shared", 16, ["fr"])


def test_toml_string_and_enums():
    text = open(DEFAULT_CONFIG_PATH, encoding="utf-8").read()
    config = Config.from_toml_string(text)
    assert _dump(config) == _dump(JaxConfig.from_toml_string(text))
    assert isinstance(config.nn.batching_mode, BatchingMode)
    assert config.dumps() == json.dumps(config.dump())


def test_warmup_schedule_matches_jax_in_f32():
    """The port's schedule is numpy f32 arithmetic; JAX's (optax) the same
    in jnp f32: equal at every phase."""
    schedule = WarmupConfig(25, 10, 2)
    jax_schedule = JaxConfig.load(demo_config_dict()).nn.lr_schedule.__class__(25, 10, 2).schedule(64)
    ours = schedule.schedule(64)
    for count in (0, 1, 23, 24, 25, 33, 34, 35, 100):
        assert np.float32(ours(count)) == np.float32(jax_schedule(count)), count


def test_whole_run_frozen_prefix():
    config = Config.load(demo_config_dict())
    assert whole_run_frozen_prefix(config.nn.acoustic_model) == 1
    assert whole_run_frozen_prefix(Config.load(mini_config_dict()).nn.acoustic_model) == 0
    acoustic = config.nn.acoustic_model
    acoustic.freeze_feature_projection = True
    assert whole_run_frozen_prefix(acoustic) == 2
