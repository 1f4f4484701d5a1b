"""Carries the JAX package's model into the port: its variable tree, its
projection plan and its static tables arrive as plain data (nested dicts of
numpy arrays, ``dataclasses.asdict`` output or JSON), never as imported JAX
objects.

Layout changes made on the way:
- the ``nn.scan`` encoder layers ([L, ...] leaves under ``encoder/layers``) are
  unstacked into one module per layer;
- Dense kernels [in, out] become torch Linear weights [out, in], and the q/k/v
  projections are concatenated into the fused [3D, D] projection;
- conv kernels [K, Cin/groups, Cout] become torch Conv1d weights [Cout, Cin/groups, K];
- ``classifiers_<name>`` becomes ``classifiers[<name>]``;
- the allophone matrices, their initialization, the gather table and the
  composition feature table are carried over as they are.

``jax_params_from_state`` is the inverse bridge, for parameters and for
anything shaped like them (gradients, optimizer moments): the port's named
tensors back to the JAX ``params`` tree layout, with the fused ``qkv_proj``
split into q, k and v and the encoder layers stacked."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from allophant_tpu_torch.models.allophant import AllophantModel
from allophant_tpu_torch.models.projection import ProjectionPlan
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.training.estimator import Estimator, resolve_precision

_CLASSIFIER_PREFIX = "classifiers_"


def architecture_from_dict(data: Mapping[str, Any]) -> Wav2Vec2Architecture:
    """A port architecture from ``dataclasses.asdict`` of the JAX one (or JSON)."""
    fields = {field.name for field in dataclasses.fields(Wav2Vec2Architecture)}
    values = {key: tuple(value) if isinstance(value, list) else value for key, value in data.items() if key in fields}
    return Wav2Vec2Architecture(**values)


def _dense(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(tree["kernel"]).T, f"{prefix}.bias": np.asarray(tree["bias"])}


def _conv(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    state = {f"{prefix}.weight": np.asarray(tree["kernel"]).transpose(2, 1, 0)}
    if "bias" in tree:
        state[f"{prefix}.bias"] = np.asarray(tree["bias"])
    return state


def _norm(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(tree["scale"]), f"{prefix}.bias": np.asarray(tree["bias"])}


def wav2vec2_state_from_jax(tree: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """The port Wav2Vec2Model's state entries from the JAX ``Wav2Vec2Model``
    parameter subtree."""
    state: Dict[str, np.ndarray] = {}
    extractor = tree["feature_extractor"]
    for name, value in extractor.items():
        kind, _, index = name.rpartition("_")
        if kind == "conv":
            state.update(_conv(value, f"feature_extractor.convs.{index}"))
        elif kind == "layer_norm":
            state.update(_norm(value, f"feature_extractor.norms.{index}"))
        elif name == "group_norm":
            state.update(_norm(value, "feature_extractor.norms.0"))
        else:
            raise ValueError(f"Unexpected feature extractor entry {name!r}")
    projection = tree["feature_projection"]
    state.update(_norm(projection["layer_norm"], "feature_projection.layer_norm"))
    state.update(_dense(projection["projection"], "feature_projection.projection"))
    encoder = tree["encoder"]
    state.update(_conv(encoder["pos_conv_embed"]["conv"], "encoder.pos_conv_embed.conv"))
    state.update(_norm(encoder["layer_norm"], "encoder.layer_norm"))
    layers = encoder["layers"]
    for index in range(num_layers):
        def leaf(*path):
            node = layers
            for key in path:
                node = node[key]
            return np.asarray(node)[index]

        base = f"encoder.layers.{index}"
        attention = f"{base}.attention"
        state[f"{attention}.qkv_proj.weight"] = np.concatenate(
            [leaf("attention", name, "kernel").T for name in ("q_proj", "k_proj", "v_proj")]
        )
        state[f"{attention}.qkv_proj.bias"] = np.concatenate(
            [leaf("attention", name, "bias") for name in ("q_proj", "k_proj", "v_proj")]
        )
        state[f"{attention}.out_proj.weight"] = leaf("attention", "out_proj", "kernel").T
        state[f"{attention}.out_proj.bias"] = leaf("attention", "out_proj", "bias")
        for name in ("intermediate_dense", "output_dense"):
            state[f"{base}.feed_forward.{name}.weight"] = leaf("feed_forward", name, "kernel").T
            state[f"{base}.feed_forward.{name}.bias"] = leaf("feed_forward", name, "bias")
        for name in ("layer_norm", "final_layer_norm"):
            state[f"{base}.{name}.weight"] = leaf(name, "scale")
            state[f"{base}.{name}.bias"] = leaf(name, "bias")
    return state


def projection_state_from_jax(params: Mapping, buffers: Mapping) -> Dict[str, np.ndarray]:
    """The port HierarchicalProjection's state entries from the JAX
    ``HierarchicalProjection`` parameter and buffer subtrees."""
    state: Dict[str, np.ndarray] = {}
    for name, value in params.items():
        if name.startswith(_CLASSIFIER_PREFIX):
            classifier = f"classifiers.{name[len(_CLASSIFIER_PREFIX):]}"
            if "kernel" in value:
                state.update(_dense(value, classifier))
                continue
            for part, subtree in value.items():
                converter = _norm if part == "layer_norm" else _dense
                state.update(converter(subtree, f"{classifier}.{part}"))
        elif name == "composition":
            state["composition.attribute_embeddings"] = np.asarray(value["attribute_embeddings"])
        elif name == "allophone":
            state["allophone.allophone_matrices"] = np.asarray(value["allophone_matrices"])
        else:
            raise ValueError(f"Unexpected projection entry {name!r}")
    if "composition_feature_table" in buffers:
        state["composition_feature_table"] = np.asarray(buffers["composition_feature_table"])
    allophone = buffers.get("allophone")
    if allophone is not None:
        state["allophone.initialization"] = np.asarray(allophone["initialization"])
        state["allophone.gather_indices"] = np.asarray(allophone["gather_indices"])
    return state


def state_dict_from_jax(variables: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX variable tree (``params`` and
    ``buffers`` as nested dicts of arrays)."""
    params = variables["params"]
    buffers = variables.get("buffers", {}).get("projection", {})
    state = {
        **{f"acoustic_model.{key}": value for key, value in wav2vec2_state_from_jax(params["acoustic_model"], num_layers).items()},
        **{f"projection.{key}": value for key, value in projection_state_from_jax(params["projection"], buffers).items()},
    }
    return {key: torch.tensor(np.asarray(value)) for key, value in state.items()}


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _jax_leaf(module: str, leaf: str, value: np.ndarray):
    """(JAX leaf name, value) of a port ``weight`` or ``bias`` of the JAX
    module named ``module``: norms have a ``scale``, convolutions a [K, Cin, Cout]
    ``kernel``, dense layers an [in, out] ``kernel``."""
    if leaf == "bias":
        return "bias", value
    if "norm" in module:
        return "scale", value
    return "kernel", value.transpose(2, 1, 0) if module.startswith("conv") else value.T


def _jax_module_path(path, architecture: Wav2Vec2Architecture):
    if path[:2] == ["acoustic_model", "feature_extractor"]:
        kind, index = path[2], path[3]
        if kind == "convs":
            return [*path[:2], f"conv_{index}"]
        return [*path[:2], "group_norm" if architecture.feat_extract_norm == "group" else f"layer_norm_{index}"]
    if path[:2] == ["projection", "classifiers"]:
        return ["projection", f"classifiers_{path[2]}", *path[3:]]
    return path


def jax_params_from_state(state: Mapping[str, Any], architecture: Wav2Vec2Architecture) -> Dict:
    """The JAX ``params`` tree (nested dicts of numpy arrays) from the port's
    parameter names -> tensors or arrays: the inverse of
    ``state_dict_from_jax`` for parameters and anything shaped like them."""
    tree: Dict = {}
    layers: Dict[tuple, list] = {}

    def stack(path, leaf, value, index):
        key, converted = _jax_leaf(path[-1], leaf, value)
        layers.setdefault((*path, key), [None] * architecture.num_hidden_layers)[index] = converted

    for name, value in state.items():
        value = np.array(value.detach().cpu() if isinstance(value, torch.Tensor) else value)  # a copy
        *path, leaf = name.split(".")
        layer = re.fullmatch(r"acoustic_model\.encoder\.layers\.(\d+)", ".".join(path[:4]))
        if layer is not None:
            index, path = int(layer.group(1)), path[4:]
            if path[-1] == "qkv_proj":
                for part, projection in zip(np.split(value, 3), ("q_proj", "k_proj", "v_proj")):
                    stack((*path[:-1], projection), leaf, part, index)
            else:
                stack(path, leaf, value, index)
            continue
        path = _jax_module_path(path, architecture)
        if path[-1] in ("composition", "allophone"):
            _put(tree, (*path, leaf), value)
        else:
            key, converted = _jax_leaf(path[-1], leaf, value)
            _put(tree, (*path, key), converted)
    for path, values in layers.items():
        _put(tree, ("acoustic_model", "encoder", "layers", *path), np.stack(values))
    return tree


def load_jax_variables(model: AllophantModel, variables: Mapping) -> AllophantModel:
    """Fills every parameter and buffer of ``model`` from the JAX variable tree;
    raises on a missing, extra or misshapen entry."""
    state = state_dict_from_jax(variables, model.architecture.num_hidden_layers)
    model.load_state_dict(state, strict=True)
    return model


def load_static_data(model: AllophantModel, static_data: Mapping[str, np.ndarray]) -> AllophantModel:
    """Writes the plan's static tables into the model, as the JAX package's
    ``inject_static_data`` does: the composition feature table, and the
    allophone matrices (as the parameter's value and as its initialization)
    with their gather table."""
    projection = model.projection
    with torch.no_grad():
        if "composition_feature_table" in static_data:
            projection.composition_feature_table.copy_(torch.from_numpy(np.asarray(static_data["composition_feature_table"])))
        if "allophone_matrices" in static_data:
            matrices = torch.from_numpy(np.asarray(static_data["allophone_matrices"]))
            projection.allophone.allophone_matrices.copy_(matrices)
            projection.allophone.initialization.copy_(matrices)
            projection.allophone.gather_indices.copy_(torch.from_numpy(np.asarray(static_data["allophone_gather"])))
    return model


def estimator_from_jax(
    architecture: Mapping[str, Any],
    plan: Mapping[str, Any],
    variables: Mapping,
    precision: str,
    device=None,
) -> Estimator:
    """An Estimator over the JAX package's model: ``architecture`` and ``plan``
    are ``dataclasses.asdict`` of its Wav2Vec2Architecture and ProjectionPlan,
    ``variables`` its variable tree as nested dicts of numpy arrays."""
    dtype, head_dtype, _ = resolve_precision(precision)
    arch = architecture_from_dict(architecture)
    model = AllophantModel(arch, ProjectionPlan.from_dict(plan), dtype, head_dtype, device="cpu")
    load_jax_variables(model, variables)
    return Estimator(model, precision, device)


def seeded_initialization(model: AllophantModel, seed: int) -> AllophantModel:
    """Random weights from a seed, drawn on the model's device (for serving
    tests and benchmarks without a checkpoint): normal weights scaled by
    1/sqrt(fan_in), small normal biases, norm scales near 1, N(0, 1)
    composition embeddings with the unused category rows zeroed. The allophone
    matrices come from the plan's static tables (``load_static_data``)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, parameter in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "allophone_matrices":
                continue
            noise = torch.randn(parameter.shape, generator=generator, device=device, dtype=torch.float32)
            if leaf == "attribute_embeddings":
                value = noise
                unused_rows = list(model.plan.composition[3])
                if unused_rows:
                    value[unused_rows] = 0.0
            elif parameter.ndim == 1:
                is_norm_scale = name.endswith("weight") and "norm" in name
                value = 1.0 + 0.1 * noise if is_norm_scale else 0.02 * noise
            else:
                fan_in = parameter[0].numel()
                value = noise / fan_in**0.5
            parameter.copy_(value)
    return model
