"""Checkpoints (counterpart of ``allophant_tpu/training/checkpoint.py``): the
native format, written and restored, and a reader for the reference's torch
checkpoints.

The native file is msgpack: JSON metadata and the model's variables in one
file, readable by the JAX package's ``load_native`` and written by its
``save_native``. The ``variables`` field holds the JAX package's variable tree
(``params`` and ``buffers``) in flax's msgpack layout; the port builds it from
its float32 master parameters by the inverse weight bridge
(``weights.jax_params_from_state``) and loads it through
``weights.load_jax_variables``. ``optimizer_state`` holds the writer's own
bytes (the port's ``TrainingRun.serialized_training_state``). The codec is the
port's (``msgpack_codec``).

A reference checkpoint is one ``torch.save`` file of the reference's
marshmallow-dumped ``Checkpoint`` (config, attribute graph, indexer state,
``model_state`` under the reference's tensor names, ...);
``load_reference_checkpoint`` reads it with ``weights_only=True`` and
``convert_reference_model_state`` maps its tensor names onto the JAX
package's parameter tree.

An Orbax directory is what the JAX package's ``save_orbax`` writes: the
metadata as ``allophant_meta.json``, the writer's optimizer bytes as
``optimizer_state.bin``, and the variables under ``variables/`` as
``orbax.checkpoint.StandardCheckpointer`` lays them out (zarr arrays in
tensorstore's OCDBT store). ``save_orbax`` and ``load_orbax`` read and write
it with the port's own code (``training/orbax_arrays.py``,
``training/ocdbt.py`` and the zstd decoder in ``native/``)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from allophant_tpu_torch.config import Config, Glu1dConfig, LayerNormConfig, LinearFrontendConfig, TransformerAcousticModelConfig
from allophant_tpu_torch.models.hf_conversion import convert_wav2vec2_state
from allophant_tpu_torch.models.projection import ProjectionPlan
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.phonetics.attribute_graph import AttributeGraph
from allophant_tpu_torch.phonetics.features import PhoneticIndexerState
from allophant_tpu_torch.training import msgpack_codec

#: The version the port writes into a checkpoint's metadata.
VERSION = "0.1.0"
NATIVE_MAGIC = b"ALLOPHANT_TPU_CKPT1"


@dataclasses.dataclass
class EpochPosition:
    epoch: int = 0
    global_step: int = 0
    step: int = 0

    def next_step(self) -> None:
        self.global_step += 1
        self.step += 1

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any] | None) -> "EpochPosition":
        if data is None:
            return cls()
        return cls(int(data.get("epoch", 0)), int(data.get("global_step", 0)), int(data.get("step", 0)))

    def __str__(self) -> str:
        return f"Epoch {self.epoch}, Step {self.step} | Global Step: {self.global_step}"


@dataclasses.dataclass
class Checkpoint:
    """Checkpoint contents, independent of the file format. ``variables`` is
    the JAX package's variable tree as nested dicts of numpy arrays (native
    checkpoints); ``reference_model_state`` the reference's tensors by their
    torch names (reference checkpoints)."""

    config: Config
    feature_size: int
    sample_rate: int
    attribute_graph: AttributeGraph
    epoch: EpochPosition
    phonetic_indexer_state: Optional[PhoneticIndexerState]
    variables: Optional[Dict] = None
    reference_model_state: Optional[Dict[str, np.ndarray]] = None
    optimizer_state: Optional[bytes] = None
    history: List[Any] = dataclasses.field(default_factory=list)
    dataset_meta_data: List[Any] = dataclasses.field(default_factory=list)
    additional: Optional[Dict[str, Any]] = None
    version: str = VERSION


def checkpoint_metadata(checkpoint: Checkpoint) -> Dict[str, Any]:
    return {
        "config": checkpoint.config.dump(),
        "feature_size": checkpoint.feature_size,
        "sample_rate": checkpoint.sample_rate,
        "attribute_graph": checkpoint.attribute_graph.to_dict(),
        "epoch": checkpoint.epoch.to_dict(),
        "phonetic_indexer_state": (
            None if checkpoint.phonetic_indexer_state is None else checkpoint.phonetic_indexer_state.to_dict()
        ),
        "history": checkpoint.history,
        "dataset_meta_data": checkpoint.dataset_meta_data,
        "additional": checkpoint.additional,
        "version": checkpoint.version,
    }


def save_native(checkpoint: Checkpoint, file_path: str) -> None:
    """Writes the native msgpack checkpoint (metadata JSON + flax-layout
    variable bytes) through a temporary file renamed into place."""
    payload = {
        "magic": NATIVE_MAGIC,
        "metadata": json.dumps(checkpoint_metadata(checkpoint)),
        "variables": msgpack_codec.packb(checkpoint.variables),
        "optimizer_state": checkpoint.optimizer_state,
    }
    temporary = file_path + ".tmp"
    with open(temporary, "wb") as file:
        file.write(msgpack_codec.packb(payload))
    os.replace(temporary, file_path)


def _is_native(file_path: str) -> bool:
    with open(file_path, "rb") as file:
        head = file.read(64)
    return NATIVE_MAGIC in head


def load_native(file_path: str) -> Checkpoint:
    """Reads a native checkpoint, whichever package wrote it; flax's chunked
    arrays are rebuilt (``msgpack_codec.unchunk``)."""
    with open(file_path, "rb") as file:
        payload = msgpack_codec.unpackb(file.read())
    if payload.get("magic") != NATIVE_MAGIC:
        raise ValueError(f"{file_path} is not a native checkpoint")
    metadata = json.loads(payload["metadata"])
    indexer_state = metadata.get("phonetic_indexer_state")
    return Checkpoint(
        config=Config.load(metadata["config"]),
        feature_size=int(metadata["feature_size"]),
        sample_rate=int(metadata["sample_rate"]),
        attribute_graph=AttributeGraph.from_dict(metadata["attribute_graph"]),
        epoch=EpochPosition.from_dict(metadata.get("epoch")),
        phonetic_indexer_state=None if indexer_state is None else PhoneticIndexerState.from_dict(indexer_state),
        variables=msgpack_codec.unchunk(msgpack_codec.unpackb(payload["variables"])),
        optimizer_state=payload.get("optimizer_state"),
        history=metadata.get("history", []),
        dataset_meta_data=metadata.get("dataset_meta_data", []),
        additional=metadata.get("additional"),
        version=metadata.get("version", "unknown"),
    )


def load_reference_checkpoint(file_path: str) -> Checkpoint:
    """Loads a reference (torch) checkpoint file: the marshmallow-dumped dict
    saved by the reference's ``Checkpoint.save``, read with
    ``weights_only=True`` (no pickled code runs)."""
    import torch

    data = torch.load(file_path, map_location="cpu", weights_only=True)
    model_state = {
        key: value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        for key, value in data["model_state"].items()
    }
    return Checkpoint(
        config=Config.load(data["config"]),
        feature_size=int(data["feature_size"]),
        sample_rate=int(data["sample_rate"]),
        attribute_graph=AttributeGraph.from_dict(data["attribute_graph"]),
        epoch=EpochPosition.from_dict(data.get("epoch")),
        phonetic_indexer_state=PhoneticIndexerState.from_dict(data["phonetic_indexer_state"]),
        reference_model_state=model_state,
        history=[],
        dataset_meta_data=data.get("dataset_meta_data", []),
        additional=data.get("additional"),
        version=str(data.get("allophant_version", "reference")),
    )


def load_checkpoint(file_path: str) -> Checkpoint:
    """Dispatches between the native msgpack format, Orbax directories and
    reference torch checkpoints. Accepts a local path or a HuggingFace model
    id, whose ``allophant.pt`` is looked up in the local HuggingFace cache
    only."""
    if is_orbax_directory(file_path):
        return load_orbax(file_path)
    if not os.path.isfile(file_path):
        resolved = _resolve_hub_file(file_path)
        if resolved is None:
            raise FileNotFoundError(f"No checkpoint found at {file_path!r}")
        file_path = resolved
    if _is_native(file_path):
        return load_native(file_path)
    return load_reference_checkpoint(file_path)


# ---------------------------------------------------------------------------
# Orbax directories
# ---------------------------------------------------------------------------

#: The file of an Orbax checkpoint directory that marks it as one.
ORBAX_METADATA_FILE = "allophant_meta.json"
_ORBAX_OPTIMIZER_FILE = "optimizer_state.bin"


def is_orbax_directory(file_path: str) -> bool:
    return os.path.isdir(file_path) and os.path.isfile(os.path.join(file_path, ORBAX_METADATA_FILE))


def save_orbax(checkpoint: Checkpoint, directory: str) -> None:
    """Writes an Orbax checkpoint directory that the JAX package's
    ``load_orbax`` reads: the metadata, the optimizer bytes and the variables
    (``orbax_arrays.write_tree``; an existing ``variables/`` is replaced).

    Under several ranks of a ``torch.distributed`` group every rank calls
    it with the whole variables: rank 0 writes and the others wait for it at
    a barrier, as with the native file."""
    import shutil

    import torch.distributed as dist

    from allophant_tpu_torch.training.orbax_arrays import write_tree

    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, ORBAX_METADATA_FILE), "w", encoding="utf-8") as file:
            json.dump(checkpoint_metadata(checkpoint), file)
        optimizer_path = os.path.join(directory, _ORBAX_OPTIMIZER_FILE)
        if checkpoint.optimizer_state is not None:
            with open(optimizer_path, "wb") as file:
                file.write(checkpoint.optimizer_state)
        elif os.path.exists(optimizer_path):
            os.unlink(optimizer_path)
        variables_path = os.path.join(directory, "variables")
        if os.path.exists(variables_path):
            shutil.rmtree(variables_path)
        write_tree(variables_path, checkpoint.variables)
    if distributed:
        dist.barrier()


def load_orbax(directory: str) -> Checkpoint:
    """Reads an Orbax checkpoint directory, whichever package wrote it; the
    variables come back as nested dicts of numpy arrays
    (``orbax_arrays.read_tree``)."""
    from allophant_tpu_torch.training.orbax_arrays import read_tree

    directory = os.path.abspath(directory)
    with open(os.path.join(directory, ORBAX_METADATA_FILE), "r", encoding="utf-8") as file:
        metadata = json.load(file)
    variables = read_tree(os.path.join(directory, "variables"))
    optimizer_state = None
    optimizer_path = os.path.join(directory, _ORBAX_OPTIMIZER_FILE)
    if os.path.isfile(optimizer_path):
        with open(optimizer_path, "rb") as file:
            optimizer_state = file.read()
    indexer_state = metadata.get("phonetic_indexer_state")
    return Checkpoint(
        config=Config.load(metadata["config"]),
        feature_size=int(metadata["feature_size"]),
        sample_rate=int(metadata["sample_rate"]),
        attribute_graph=AttributeGraph.from_dict(metadata["attribute_graph"]),
        epoch=EpochPosition.from_dict(metadata.get("epoch")),
        phonetic_indexer_state=None if indexer_state is None else PhoneticIndexerState.from_dict(indexer_state),
        variables=variables,
        optimizer_state=optimizer_state,
        history=metadata.get("history", []),
        dataset_meta_data=metadata.get("dataset_meta_data", []),
        additional=metadata.get("additional"),
        version=metadata.get("version", "unknown"),
    )


def _resolve_hub_file(model_id: str, file_name: str = "allophant.pt") -> Optional[str]:
    """``file_name`` of ``model_id`` in the local HuggingFace hub cache
    (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``) at the revision ``refs/main`` names, or None.
    Nothing is downloaded."""
    if model_id.count("/") != 1:
        return None
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface"), "hub"
    )
    repository = os.path.join(cache, "models--" + model_id.replace("/", "--"))
    try:
        with open(os.path.join(repository, "refs", "main"), "r", encoding="utf-8") as file:
            revision = file.read().strip()
    except OSError:
        return None
    candidate = os.path.join(repository, "snapshots", revision, file_name)
    return candidate if os.path.isfile(candidate) else None


def _linear(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": np.ascontiguousarray(state[f"{prefix}.weight"].T),
        "bias": state[f"{prefix}.bias"],
    }


def _layer_norm(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": state[f"{prefix}.weight"], "bias": state[f"{prefix}.bias"]}


def _convert_transformer_acoustic_state(state: Dict[str, np.ndarray], config) -> Dict:
    """Maps the reference's from-scratch ``TransformerAcousticModel.state_dict()``
    (acoustic_model.py:665-759, frontend.py:154-265) onto the JAX
    package's ``models.transformer.TransformerAcousticModel`` tree, which
    ``weights.transformer_state_from_jax`` carries into the port.

    Reference naming: ``_acoustic_model._frontend._layer.<i>`` (Linear frontend
    Sequential: optional Dropout, LayerNorm, Linear, LeakyReLU),
    ``_acoustic_model._sequential_frontend._layers.layers.<i>.module`` per
    LengthWrapper (GLU conv under ``._weights``, affine LayerNorm at Sequential
    slot 1 between two Transposes), ``_acoustic_model._transformer.layers.<i>``
    torch encoder layers (packed ``self_attn.in_proj_*``), and
    ``_acoustic_model._final_layer_norm``. The JAX tree's encoder layers run
    under ``nn.scan``, so per-layer tensors stack into leading-[L] arrays."""
    prefix = "_acoustic_model."
    params: Dict[str, Any] = {}
    affine = config.elementwise_affine

    frontend = config.frontend
    if isinstance(frontend, LinearFrontendConfig):
        # Sequential indices shift by one when an input-dropout module leads.
        offset = 1 if frontend.input_dropout > 0 else 0
        if affine:
            params["frontend_norm"] = _layer_norm(state, f"{prefix}_frontend._layer.{offset}")
        params["frontend_linear"] = _linear(state, f"{prefix}_frontend._layer.{offset + 1}")

    if config.sequential_frontend is not None:
        sequential: Dict[str, Any] = {}
        for index, layer in enumerate(config.sequential_frontend.layers):
            base = f"{prefix}_sequential_frontend._layers.layers.{index}.module"
            if isinstance(layer, Glu1dConfig):
                weight = state[f"{base}._weights.weight"]  # torch Conv1d [2C, in, K]
                sequential[f"glu_{index}"] = {
                    "weights": {
                        "kernel": np.ascontiguousarray(weight.transpose(2, 1, 0)),
                        "bias": state[f"{base}._weights.bias"],
                    }
                }
            elif isinstance(layer, LayerNormConfig) and layer.affine:
                sequential[f"norm_{index}"] = _layer_norm(state, f"{base}.1")
        if sequential:
            params["sequential_frontend"] = sequential

    stacked: Dict[str, Dict[str, List[np.ndarray]]] = {}

    def push(module: str, leaf: str, value: np.ndarray) -> None:
        stacked.setdefault(module, {}).setdefault(leaf, []).append(value)

    for index in range(config.transformer.num_layers):
        base = f"{prefix}_transformer.layers.{index}"
        in_proj_weight = state[f"{base}.self_attn.in_proj_weight"]
        in_proj_bias = state[f"{base}.self_attn.in_proj_bias"]
        hidden = in_proj_weight.shape[0] // 3
        for part, name in enumerate(("q_proj", "k_proj", "v_proj")):
            push(name, "kernel", np.ascontiguousarray(
                in_proj_weight[part * hidden : (part + 1) * hidden].T
            ))
            push(name, "bias", in_proj_bias[part * hidden : (part + 1) * hidden])
        out_proj = _linear(state, f"{base}.self_attn.out_proj")
        push("out_proj", "kernel", out_proj["kernel"])
        push("out_proj", "bias", out_proj["bias"])
        for linear_name in ("linear1", "linear2"):
            linear = _linear(state, f"{base}.{linear_name}")
            push(linear_name, "kernel", linear["kernel"])
            push(linear_name, "bias", linear["bias"])
        if affine:
            for norm_name in ("norm1", "norm2"):
                norm = _layer_norm(state, f"{base}.{norm_name}")
                push(norm_name, "scale", norm["scale"])
                push(norm_name, "bias", norm["bias"])

    params["layers"] = {
        module: {leaf: np.stack(values) for leaf, values in leaves.items()}
        for module, leaves in stacked.items()
    }
    if affine:
        params["final_norm"] = _layer_norm(state, f"{prefix}_final_layer_norm")
    return params


def convert_reference_model_state(
    state: Dict[str, np.ndarray],
    plan: ProjectionPlan,
    wav2vec2_architecture: Optional[Wav2Vec2Architecture],
    acoustic_config=None,
) -> Dict:
    """Maps the reference's ``Allophant.state_dict()`` names onto the JAX
    package's parameter tree: ``_acoustic_model._model.<hf>`` for the wrapped
    wav2vec2, ``_projection._layers.<node>._time_distributed_layer`` for the
    classifiers, ``..._composition_layer._attribute_embeddings.weight`` and
    ``..._allophone_layer._allophone_matrices``."""
    params: Dict[str, Any] = {}
    if wav2vec2_architecture is not None:
        params["acoustic_model"] = convert_wav2vec2_state(state, wav2vec2_architecture, prefix="_acoustic_model._model.")
    elif isinstance(acoustic_config, TransformerAcousticModelConfig):
        params["acoustic_model"] = _convert_transformer_acoustic_state(state, acoustic_config)
    else:
        raise NotImplementedError(
            f"Reference checkpoints with this acoustic model type are not supported (got {type(acoustic_config).__name__})"
        )

    projection: Dict[str, Any] = {}
    for node in plan.nodes:
        base = f"_projection._layers.{node.name}._time_distributed_layer"
        if node.attention is not None:
            # torch nn.MultiheadAttention packs q/k/v into in_proj_weight [3E, E].
            in_proj_weight = state[f"{base}.attention.in_proj_weight"]
            in_proj_bias = state[f"{base}.attention.in_proj_bias"]
            hidden = in_proj_weight.shape[0] // 3
            attention = {
                name: {
                    "kernel": np.ascontiguousarray(in_proj_weight[index * hidden : (index + 1) * hidden].T),
                    "bias": in_proj_bias[index * hidden : (index + 1) * hidden],
                }
                for index, name in enumerate(("q_proj", "k_proj", "v_proj"))
            }
            attention["out_proj"] = _linear(state, f"{base}.attention.out_proj")
            projection[f"classifiers_{node.name}"] = {
                "input_projection": _linear(state, f"{base}.input_projection"),
                "layer_norm": _layer_norm(state, f"{base}.layer_norm"),
                **attention,
            }
        else:
            projection[f"classifiers_{node.name}"] = _linear(state, base)
        if node.has_composition:
            projection["composition"] = {
                "attribute_embeddings": state[
                    f"_projection._layers.{node.name}._composition_layer._attribute_embeddings.weight"
                ]
            }
        if node.has_allophone:
            projection["allophone"] = {
                "allophone_matrices": state[f"_projection._layers.{node.name}._allophone_layer._allophone_matrices"]
            }
    params["projection"] = projection
    return params


def variables_from_model(model, parameters=None) -> Dict[str, Dict]:
    """The JAX package's variable tree of an ``AllophantModel``: its
    parameters (or ``parameters``, the whole ones by name of a model sharded
    over a mesh) as float32 ``params`` (the master weights) and the plan's
    static tables as ``buffers`` (an empty ``projection`` entry when the plan
    has none, as flax's tree has)."""
    from allophant_tpu_torch.weights import jax_params_from_state

    if parameters is None:
        parameters = dict(model.named_parameters())
    state = {name: parameter.detach().float() for name, parameter in parameters.items()}
    params = jax_params_from_state(state, model.architecture)
    projection = model.projection
    buffers: Dict[str, Any] = {}
    if model.plan.composition is not None:
        buffers["composition_feature_table"] = projection.composition_feature_table.cpu().numpy().astype(np.int32)
    if model.plan.allophone_shape is not None:
        buffers["allophone"] = {
            "initialization": projection.allophone.initialization.cpu().numpy().astype(np.float32),
            "gather_indices": projection.allophone.gather_indices.cpu().numpy().astype(np.int32),
        }
    return {"params": params, "buffers": {"projection": buffers}}
