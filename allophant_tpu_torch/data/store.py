"""Ragged array store for precomputed features and length tables (the port's
copy of ``allophant_tpu/data/store.py``, same layout and semantics):

    root/meta.json                          {"feature_size": F}
    root/<split>/<language>/lengths.npy     int32 [N]
    root/<split>/<language>/features.npy    float32 flat values (optional)
    root/<split>/<language>/offsets.npy     int64 [N+1] ragged offsets (optional)

Features are memory-mapped on read, so large corpora never fully materialize.
A zarr cache (the reference's layout, marked by ``.zgroup``) is read through
:mod:`allophant_tpu_torch.data.zarr_store`."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from os import path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

META_FILE = "meta.json"


@dataclass
class PreprocessedSplitData:
    lengths: np.ndarray
    features: Optional[List[np.ndarray]] = None


class RaggedFeatureWriter:
    """Streams per-utterance feature arrays for one (split, language) group."""

    def __init__(self, root: str, split: str, language: str, feature_size: int = 1):
        self._directory = path.join(root, split, language)
        os.makedirs(self._directory, exist_ok=True)
        self._feature_size = feature_size
        self._lengths: List[int] = []
        self._offsets: List[int] = [0]
        self._features_file = open(path.join(self._directory, "features.npy.raw"), "wb")
        self._total = 0

    def append(self, features: np.ndarray) -> None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        frames = features.shape[0]
        self._lengths.append(frames)
        self._total += features.size
        self._offsets.append(self._total)
        self._features_file.write(features.tobytes())

    def append_length(self, length: int) -> None:
        self._lengths.append(int(length))

    # Chunk size (in float32 elements) for the raw -> .npy copy: 64 MB per chunk
    # keeps memory flat while finalizing multi-GB language groups.
    _COPY_CHUNK = 16 * 1024 * 1024

    def close(self) -> None:
        self._features_file.close()
        raw_path = path.join(self._directory, "features.npy.raw")
        if self._total:
            source = np.memmap(raw_path, dtype=np.float32, mode="r", shape=(self._total,))
            target = np.lib.format.open_memmap(
                path.join(self._directory, "features.npy"),
                mode="w+",
                dtype=np.float32,
                shape=(self._total,),
            )
            for start in range(0, self._total, self._COPY_CHUNK):
                end = min(start + self._COPY_CHUNK, self._total)
                target[start:end] = source[start:end]
            target.flush()
            del source, target
            np.save(
                path.join(self._directory, "offsets.npy"), np.asarray(self._offsets, dtype=np.int64)
            )
        os.remove(raw_path)
        np.save(path.join(self._directory, "lengths.npy"), np.asarray(self._lengths, dtype=np.int32))


def write_lengths(root: str, split: str, language: str, lengths: Iterable[int]) -> None:
    directory = path.join(root, split, language)
    os.makedirs(directory, exist_ok=True)
    np.save(path.join(directory, "lengths.npy"), np.fromiter(lengths, dtype=np.int32))


def write_meta(root: str, feature_size: int) -> None:
    os.makedirs(root, exist_ok=True)
    with open(path.join(root, META_FILE), "w", encoding="utf-8") as file:
        json.dump({"feature_size": feature_size}, file)


def _load_language(directory: str, feature_size: Optional[int]) -> PreprocessedSplitData:
    lengths = np.load(path.join(directory, "lengths.npy"))
    if feature_size is None:
        return PreprocessedSplitData(lengths)
    flat = np.load(path.join(directory, "features.npy"), mmap_mode="r")
    offsets = np.load(path.join(directory, "offsets.npy"))
    features = [
        np.asarray(flat[offsets[index] : offsets[index + 1]]).reshape(-1, feature_size)
        for index in range(len(lengths))
    ]
    return PreprocessedSplitData(lengths, features)


def preprocessed_features_or_lengths(
    data_path: str, split_languages: Dict[str, Sequence[str]], lengths_only: bool = True
) -> Dict[str, PreprocessedSplitData]:
    """Loads (concatenated, language-ordered) lengths and optionally ragged features
    per split — the drop-in equivalent of the reference's zarr reader. A cache
    written by the reference itself (zarr v2 directory store, detected by its
    ``.zgroup`` marker) is read through the interop layer in
    :mod:`allophant_tpu_torch.data.zarr_store`."""
    from allophant_tpu_torch.data import zarr_store

    if zarr_store.is_zarr_store(data_path):
        return zarr_store.read_preprocessed_zarr(data_path, split_languages, lengths_only)

    meta_path = path.join(data_path, META_FILE)
    feature_size = None
    if not lengths_only:
        with open(meta_path, "r", encoding="utf-8") as file:
            feature_size = int(json.load(file)["feature_size"])

    split_data: Dict[str, PreprocessedSplitData] = {}
    for split, languages in split_languages.items():
        lengths = []
        features: Optional[List[np.ndarray]] = [] if feature_size is not None else None
        for language in languages:
            group = _load_language(path.join(data_path, split, language), feature_size)
            lengths.append(group.lengths)
            if features is not None:
                features.extend(group.features or [])
        split_data[split] = PreprocessedSplitData(np.concatenate(lengths), features)
    return split_data
