"""Conversion of HuggingFace wav2vec2 weights to the JAX package's parameter
tree layout (counterpart of ``allophant_tpu/models/hf_conversion.py``).

Used to read released reference checkpoints, whose ``model_state`` embeds the
whole wav2vec2 encoder under an ``_acoustic_model._model.`` prefix. Works on
plain numpy arrays; the port loads the resulting tree through
``weights.load_jax_variables`` like any native checkpoint."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture


def _linear(params: Dict, prefix: str, state: Mapping[str, np.ndarray], name: str) -> None:
    params[name] = {
        "kernel": np.ascontiguousarray(np.asarray(state[f"{prefix}.weight"]).T),
        "bias": np.asarray(state[f"{prefix}.bias"]),
    }


def _layer_norm(params: Dict, prefix: str, state: Mapping[str, np.ndarray], name: str) -> None:
    params[name] = {
        "scale": np.asarray(state[f"{prefix}.weight"]),
        "bias": np.asarray(state[f"{prefix}.bias"]),
    }


def _conv1d(params: Dict, prefix: str, state: Mapping[str, np.ndarray], name: str) -> None:
    # torch Conv1d weight [out, in/groups, k] -> flax Conv kernel [k, in/groups, out]
    entry = {"kernel": np.ascontiguousarray(np.asarray(state[f"{prefix}.weight"]).transpose(2, 1, 0))}
    bias_key = f"{prefix}.bias"
    if bias_key in state:
        entry["bias"] = np.asarray(state[bias_key])
    params[name] = entry


def _folded_weight_norm_conv(state: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """Folds torch weight-norm (dim=2) parameters g, v into a plain Conv1d weight."""
    if f"{prefix}.parametrizations.weight.original0" in state:
        weight_g = np.asarray(state[f"{prefix}.parametrizations.weight.original0"])
        weight_v = np.asarray(state[f"{prefix}.parametrizations.weight.original1"])
    elif f"{prefix}.weight_g" in state:
        weight_g = np.asarray(state[f"{prefix}.weight_g"])
        weight_v = np.asarray(state[f"{prefix}.weight_v"])
    else:
        return np.asarray(state[f"{prefix}.weight"])
    # dim=2: per-kernel-position norm over (out, in) slices.
    norms = np.sqrt((weight_v**2).sum(axis=(0, 1), keepdims=True))
    return weight_g * weight_v / norms


def _stack_layers(layers):
    """Stacks per-layer trees leaf by leaf on a leading [L] axis, as the JAX
    encoder's ``nn.scan`` stores them."""
    first = layers[0]
    if isinstance(first, dict):
        return {key: _stack_layers([layer[key] for layer in layers]) for key in first}
    return np.stack(layers)


def convert_wav2vec2_state(
    state: Mapping[str, np.ndarray], architecture: Wav2Vec2Architecture, prefix: str = ""
) -> Dict:
    """Converts a HF ``Wav2Vec2Model`` state dict (optionally under ``prefix``) to
    the JAX package's ``Wav2Vec2Model`` parameter tree."""
    if prefix:
        state = {key[len(prefix) :]: value for key, value in state.items() if key.startswith(prefix)}

    feature_extractor: Dict = {}
    for layer_id in range(len(architecture.conv_dim)):
        conv_prefix = f"feature_extractor.conv_layers.{layer_id}"
        _conv1d(feature_extractor, f"{conv_prefix}.conv", state, f"conv_{layer_id}")
        if architecture.feat_extract_norm == "layer":
            _layer_norm(feature_extractor, f"{conv_prefix}.layer_norm", state, f"layer_norm_{layer_id}")
        elif layer_id == 0:
            _layer_norm(feature_extractor, f"{conv_prefix}.layer_norm", state, "group_norm")

    feature_projection: Dict = {}
    _layer_norm(feature_projection, "feature_projection.layer_norm", state, "layer_norm")
    _linear(feature_projection, "feature_projection.projection", state, "projection")

    encoder: Dict = {}
    pos_conv_weight = _folded_weight_norm_conv(state, "encoder.pos_conv_embed.conv")
    encoder["pos_conv_embed"] = {
        "conv": {
            "kernel": np.ascontiguousarray(pos_conv_weight.transpose(2, 1, 0)),
            "bias": np.asarray(state["encoder.pos_conv_embed.conv.bias"]),
        }
    }
    _layer_norm(encoder, "encoder.layer_norm", state, "layer_norm")
    layers = []
    for layer_id in range(architecture.num_hidden_layers):
        layer_prefix = f"encoder.layers.{layer_id}"
        attention: Dict = {}
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(attention, f"{layer_prefix}.attention.{proj}", state, proj)
        layer: Dict = {"attention": attention}
        _layer_norm(layer, f"{layer_prefix}.layer_norm", state, "layer_norm")
        _layer_norm(layer, f"{layer_prefix}.final_layer_norm", state, "final_layer_norm")
        feed_forward: Dict = {}
        _linear(feed_forward, f"{layer_prefix}.feed_forward.intermediate_dense", state, "intermediate_dense")
        _linear(feed_forward, f"{layer_prefix}.feed_forward.output_dense", state, "output_dense")
        layer["feed_forward"] = feed_forward
        layers.append(layer)
    encoder["layers"] = _stack_layers(layers)

    return {
        "feature_extractor": feature_extractor,
        "feature_projection": feature_projection,
        "encoder": encoder,
    }
