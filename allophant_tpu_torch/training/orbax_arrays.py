"""The variable trees of Orbax checkpoints, read and written without orbax or
tensorstore: what ``orbax.checkpoint.StandardCheckpointer`` keeps in a
checkpoint's ``variables/`` directory.

- ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf's path (the repr of
  its key tuple) to ``key_metadata`` (the nesting, one dict key each) and
  ``value_metadata`` (``value_type``: ``jax.Array`` or ``np.ndarray`` for an
  array, ``Dict`` with ``skip_deserialize`` for an empty dict), and says
  whether the arrays are in an OCDBT store (``use_ocdbt``) and whether they
  are zarr v3 (``use_zarr3``, not supported).
- Each array is a zarr v2 array named by its path joined with ``.``: a
  ``.zarray`` and its chunks, keys of the OCDBT store (``training/ocdbt.py``)
  or files under ``variables/<name>/`` without OCDBT
  (``data/zarr_store.py:read_chunked_array`` assembles both).
- ``_CHECKPOINT_METADATA`` names the handler and the save's times.

The writer makes one OCDBT database with every array as one uncompressed
chunk, and ``_sharding`` for the ``jax.Array`` leaves (see
``write_tree``)."""

from __future__ import annotations

import base64
import json
import os
import time
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from allophant_tpu_torch.data.zarr_store import (
    ArrayMetadata,
    parse_array_metadata,
    read_chunked_array,
    read_file_into,
    zarr_dtype,
)
from allophant_tpu_torch.training.ocdbt import OcdbtReader, OcdbtWriter

__all__ = ["read_tree", "write_tree", "METADATA_FILE"]

METADATA_FILE = "_METADATA"
CHECKPOINT_METADATA_FILE = "_CHECKPOINT_METADATA"
SHARDING_FILE = "_sharding"
_DICT_KEY = 2  # orbax's KeyType.DICT
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def _read_json(file_path: str) -> dict:
    with open(file_path, "r", encoding="utf-8") as file:
        return json.load(file)


def _leaf_path(entry_key: str, entry: dict) -> Tuple[str, ...]:
    keys = entry["key_metadata"]
    for key in keys:
        if key.get("key_type", _DICT_KEY) != _DICT_KEY:
            raise ValueError(f"Orbax tree: only dict keys are supported, {entry_key} has {key}")
    return tuple(str(key["key"]) for key in keys)


def _insert(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def read_tree(variables_dir: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that ``StandardCheckpointer.save``
    wrote to ``variables_dir`` (bfloat16 leaves as float32, empty dicts
    kept)."""
    metadata = _read_json(os.path.join(variables_dir, METADATA_FILE))
    if metadata.get("use_zarr3"):
        raise ValueError(f"{variables_dir}: \"use_zarr3\": true in {METADATA_FILE}; zarr v3 arrays are not supported")
    if metadata.get("use_ocdbt", False):
        store = OcdbtReader(variables_dir)

        def fetch(key: str):
            return store.read(key) if key in store else None

        def read_into(key: str, buffer: np.ndarray) -> bool:
            if key not in store:
                return False
            store.read_into(key, buffer)
            return True

    else:

        def fetch(key: str):
            file_path = os.path.join(variables_dir, key)
            if not os.path.isfile(file_path):
                return None
            with open(file_path, "rb") as file:
                return file.read()

        def read_into(key: str, buffer: np.ndarray) -> bool:
            file_path = os.path.join(variables_dir, key)
            if not os.path.isfile(file_path):
                return False
            size = os.path.getsize(file_path)
            if size != buffer.nbytes:
                raise ValueError(f"{file_path} holds {size} bytes, the chunk {buffer.nbytes}")
            read_file_into(file_path, 0, buffer)
            return True

    tree: Dict[str, Any] = {}
    for entry_key, entry in metadata["tree_metadata"].items():
        path = _leaf_path(entry_key, entry)
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize") and value.get("value_type") == "Dict":
            _insert(tree, path, {})
            continue
        if value.get("skip_deserialize") or value.get("value_type") not in ("jax.Array", "np.ndarray"):
            raise ValueError(f"Orbax tree: cannot restore {entry_key}, a {value.get('value_type')!r}")
        name = ".".join(path)
        zarray = fetch(f"{name}/.zarray")
        if zarray is None:
            raise KeyError(f"{variables_dir}: no zarr array {name!r}")
        array = read_chunked_array(
            parse_array_metadata(json.loads(zarray), name),
            lambda key: fetch(f"{name}/{key}"),
            lambda key, buffer: read_into(f"{name}/{key}", buffer),
            name,
        )
        _insert(tree, path, array)
    return tree


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, dict) and value:
            yield from _flatten(value, path)
        else:
            yield path, value


def write_tree(variables_dir: str, tree: Dict[str, Any]) -> None:
    """Writes ``tree`` (nested dicts of numpy arrays) as
    ``StandardCheckpointer.save`` would, with every array as one
    uncompressed chunk in one OCDBT database. ``variables_dir`` must not
    exist.

    Leaves are recorded as ``jax.Array``, as JAX's save records its
    parameters. ``StandardCheckpointer.restore`` without a target does not
    need ``_sharding``: without it such leaves come back as numpy arrays.
    With it they come back as ``jax.Array``s on the first device, as after
    JAX's own single-device save, so the file names a
    ``SingleDeviceSharding`` on ``TFRT_CPU_0`` for each (keyed, as orbax
    keys it, by the URL-safe base64 of the array's name)."""
    os.makedirs(variables_dir)
    started = time.time_ns()
    tree_metadata: Dict[str, Any] = {}
    shardings: Dict[str, str] = {}
    with OcdbtWriter(variables_dir) as store:
        for path, value in _flatten(tree):
            key_metadata = [{"key": key, "key_type": _DICT_KEY} for key in path]
            if isinstance(value, dict):
                tree_metadata[repr(path)] = {
                    "key_metadata": key_metadata,
                    "value_metadata": {"value_type": "Dict", "skip_deserialize": True},
                }
                continue
            array = np.asarray(value)
            if not array.flags.c_contiguous:  # np.ascontiguousarray would make a 0-d array 1-d
                array = array.copy(order="C")
            name = ".".join(path)
            metadata = ArrayMetadata(array.shape, array.shape, zarr_dtype(array.dtype, name), None)
            store.put(f"{name}/.zarray", json.dumps(metadata.to_json(), separators=(",", ":")).encode())
            store.put(f"{name}/{metadata.chunk_keys()[0][0]}", array.reshape(-1).view(np.uint8))
            tree_metadata[repr(path)] = {
                "key_metadata": key_metadata,
                "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": list(array.shape)},
            }
            shardings[base64.urlsafe_b64encode(name.encode()).decode()] = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
    with open(os.path.join(variables_dir, METADATA_FILE), "w", encoding="utf-8") as file:
        json.dump(
            {
                "tree_metadata": tree_metadata,
                "use_ocdbt": True,
                "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True,
                "custom_metadata": None,
            },
            file,
        )
    with open(os.path.join(variables_dir, SHARDING_FILE), "w", encoding="utf-8") as file:
        json.dump(shardings, file)
    with open(os.path.join(variables_dir, CHECKPOINT_METADATA_FILE), "w", encoding="utf-8") as file:
        json.dump(
            {
                "item_handlers": _HANDLER,
                "metrics": {},
                "performance_metrics": {},
                "init_timestamp_nsecs": started,
                "commit_timestamp_nsecs": time.time_ns(),
                "custom_metadata": {},
            },
            file,
        )
