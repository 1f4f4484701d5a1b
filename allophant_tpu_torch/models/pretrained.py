"""Pretrained wav2vec2 encoder weights from the local HuggingFace hub cache
(the port's counterpart of ``allophant_tpu/training/estimator.py:
_try_load_pretrained_encoder``, which reads them through
``transformers.Wav2Vec2Model.from_pretrained(model_id, local_files_only=True)``).

The port reads the hub's files itself, with neither ``transformers`` nor
``safetensors``: ``config.json`` and the weights of ``model_id`` at the
revision ``refs/main`` names, in the cache that
``training/checkpoint.py:_resolve_hub_file`` searches. Nothing is
downloaded. ``model.safetensors`` is preferred to ``pytorch_model.bin``, as
``transformers`` prefers it; either is read as float32, as ``from_pretrained``
loads it. A ``Wav2Vec2ForPreTraining`` checkpoint (the hub's XLS-R) keeps the
encoder under a ``wav2vec2.`` prefix, which is stripped, and its
pre-training heads (``quantizer``, ``project_q``, ``project_hid``) are not
read. As ``from_pretrained`` does, the weights are checked against the
shapes that ``config.json`` gives; then they are converted
(``hf_conversion.convert_wav2vec2_state``) onto the built encoder, cut to its
depth, and loaded over its seeded weights."""

from __future__ import annotations

import json
import logging
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture, Wav2Vec2Model

LOGGER = logging.getLogger(__name__)

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
BASE_MODEL_PREFIX = "wav2vec2."
PRETRAINING_ONLY = ("quantizer.", "project_q.", "project_hid.")
# transformers' Wav2Vec2Config defaults for the architecture fields a
# config.json may leave out.
HF_DEFAULTS = {
    "hidden_size": 768,
    "num_hidden_layers": 12,
    "num_attention_heads": 12,
    "intermediate_size": 3072,
    "conv_dim": (512, 512, 512, 512, 512, 512, 512),
    "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
    "conv_stride": (5, 2, 2, 2, 2, 2, 2),
    "conv_bias": False,
    "feat_extract_norm": "group",
    "do_stable_layer_norm": False,
    "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16,
    "layer_norm_eps": 1e-5,
}


def _safetensors_values(raw: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "F32":
        return raw.view(np.float32).copy()
    if dtype == "F16":
        return raw.view(np.float16).astype(np.float32)
    if dtype == "BF16":
        return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    raise ValueError(f"unsupported safetensors dtype {dtype!r}")


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file as float32 numpy arrays: an
    8-byte little-endian header length, a JSON header of each tensor's
    ``dtype`` (F32, F16 or BF16), ``shape`` and ``data_offsets`` into the raw
    buffer that follows."""
    with open(path, "rb") as file:
        (length,) = struct.unpack("<Q", file.read(8))
        header = json.loads(file.read(length))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + length)
    tensors = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        tensors[name] = _safetensors_values(data[begin:end], entry["dtype"]).reshape(entry["shape"])
    del data
    return tensors


def read_weights(path: str) -> Dict[str, np.ndarray]:
    """A hub weights file (safetensors or a torch ``.bin``) as float32 arrays."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {name: value.float().numpy() for name, value in state.items()}


def architecture_from_hf_config(config: Mapping) -> Wav2Vec2Architecture:
    """The encoder architecture that a hub ``config.json`` describes."""
    values = {
        name: tuple(config.get(name, default)) if isinstance(default, tuple) else config.get(name, default)
        for name, default in HF_DEFAULTS.items()
    }
    return Wav2Vec2Architecture(**values)


def encoder_state(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A hub state dict's encoder entries: the ``wav2vec2.`` prefix of a
    pre-training checkpoint stripped, its pre-training heads left out."""
    if any(name.startswith(BASE_MODEL_PREFIX) for name in state):
        state = {name[len(BASE_MODEL_PREFIX) :]: value for name, value in state.items() if name.startswith(BASE_MODEL_PREFIX)}
    return {name: value for name, value in state.items() if not name.startswith(PRETRAINING_ONLY)}


def _check_shapes(state: Mapping[str, np.ndarray], expected: Mapping[str, torch.Size], what: str) -> None:
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"{what}: missing {missing[:4]}")
    for name, shape in expected.items():
        if tuple(state[name].shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(state[name].shape)}, expected {tuple(shape)}")


def pretrained_encoder_state(model_id: str, architecture: Wav2Vec2Architecture) -> Dict[str, np.ndarray]:
    """The port ``Wav2Vec2Model``'s state entries of ``architecture`` from the
    cached hub model ``model_id``; raises when the cache lacks it or its
    files do not make the encoder."""
    from allophant_tpu_torch.models.hf_conversion import convert_wav2vec2_state
    from allophant_tpu_torch.training.checkpoint import _resolve_hub_file
    from allophant_tpu_torch.weights import wav2vec2_state_from_jax

    config_path = _resolve_hub_file(model_id, "config.json")
    if config_path is None:
        raise FileNotFoundError(f"{model_id} is not in the local HuggingFace cache")
    weights_path = next(filter(None, (_resolve_hub_file(model_id, name) for name in WEIGHT_FILES)), None)
    if weights_path is None:
        raise FileNotFoundError(f"the cached {model_id} has none of {', '.join(WEIGHT_FILES)}")
    with open(config_path, "r", encoding="utf-8") as file:
        hub_architecture = architecture_from_hf_config(json.load(file))
    hub = encoder_state(read_weights(weights_path))
    whole = wav2vec2_state_from_jax(convert_wav2vec2_state(hub, hub_architecture), hub_architecture.num_hidden_layers)
    template = Wav2Vec2Model(hub_architecture, device="meta")
    _check_shapes(whole, {name: value.shape for name, value in template.state_dict().items()}, f"{weights_path} against config.json")
    ours = Wav2Vec2Model(architecture, device="meta").state_dict()
    state = {name: whole[name] for name in ours if name in whole}
    _check_shapes(state, {name: value.shape for name, value in ours.items()}, f"{model_id} against the built encoder")
    return state


def load_pretrained_encoder(model, model_id: str, mesh=None) -> bool:
    """Loads the cached hub model ``model_id`` into ``model.acoustic_model``
    (this rank's shard over ``mesh``'s model axis); True when it did. On any
    failure the model keeps its weights and one line says why, as the JAX
    package falls back to its random ones."""
    from allophant_tpu_torch.parallel.sharding import shard_state

    try:
        state = pretrained_encoder_state(model_id, model.architecture)
    except Exception as error:  # noqa: BLE001 - any failure falls back, as in JAX
        LOGGER.warning("Pretrained weights of %s not loaded, keeping the seeded encoder: %s", model_id, error)
        return False
    named = {f"acoustic_model.{name}": value for name, value in state.items()}
    if mesh is not None and mesh.model_parallel > 1:
        named = shard_state(named, mesh.model_rank, mesh.model_parallel)
    targets = model.state_dict()
    with torch.no_grad():
        for name, value in named.items():
            targets[name].copy_(torch.as_tensor(np.asarray(value)))
    LOGGER.info("Loaded the pretrained encoder of %s", model_id)
    return True
