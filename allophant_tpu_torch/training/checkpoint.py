"""The native checkpoint, written (counterpart of the save half of
``allophant_tpu/training/checkpoint.py``): JSON metadata and the model's
variables in one msgpack file that the JAX package's ``load_native`` reads.

The ``variables`` field holds the JAX package's variable tree (``params`` and
``buffers``) in flax's msgpack layout, built from the port's float32 master
parameters by the inverse weight bridge (``weights.jax_params_from_state``);
``optimizer_state`` holds the port's own bytes
(``TrainingRun.serialized_training_state``). The codec is the port's
(``msgpack_codec``)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from allophant_tpu_torch.config import Config
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
    the JAX package's variable tree as nested dicts of numpy arrays."""

    config: Config
    feature_size: int
    sample_rate: int
    attribute_graph: AttributeGraph
    epoch: EpochPosition
    phonetic_indexer_state: Optional[PhoneticIndexerState]
    variables: Optional[Dict] = None
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


def read_native(file_path: str) -> Dict[str, Any]:
    """The raw contents of a native checkpoint: ``metadata`` (decoded JSON),
    ``variables`` (the variable tree, arrays as numpy) and
    ``optimizer_state`` (bytes or None). Restoring an Estimator from them is
    not ported yet."""
    with open(file_path, "rb") as file:
        payload = msgpack_codec.unpackb(file.read())
    if payload.get("magic") != NATIVE_MAGIC:
        raise ValueError(f"{file_path} is not a native checkpoint")
    return {
        "metadata": json.loads(payload["metadata"]),
        "variables": msgpack_codec.unpackb(payload["variables"]),
        "optimizer_state": payload.get("optimizer_state"),
    }


def variables_from_model(model) -> Dict[str, Dict]:
    """The JAX package's variable tree of an ``AllophantModel``: its
    parameters as float32 ``params`` (the master weights) and the plan's
    static tables as ``buffers``."""
    from allophant_tpu_torch.weights import jax_params_from_state

    state = {name: parameter.detach().float() for name, parameter in model.named_parameters()}
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
    return {"params": params, "buffers": {"projection": buffers}} if buffers else {"params": params}
