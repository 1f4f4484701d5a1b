"""Corpus loading (counterpart of ``allophant_tpu/data/corpus_loading.py``):
dispatch on the dataset type. "ucla-phonetic" loads a corpus directory as a
test split. Common Voice and precomputed features are not ported; the
precomputed per-utterance lengths of ``--lengths`` are read from the JAX
package's ragged store layout (``root/<split>/<language>/lengths.npy``)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus


@dataclass
class PreprocessedSplitData:
    lengths: np.ndarray
    features: Optional[List[np.ndarray]] = None


def load_corpus(
    path: str,
    dataset_type: str,
    resample: int | None = None,
    languages: Sequence[str] | None = None,
    validation_limits: Dict[str, int] | int | None = None,
    only_primary_script: bool = False,
    progress_bar: bool = False,
) -> MultilingualSplits:
    if dataset_type == "common-voice":
        raise NotImplementedError("Common Voice corpora are not ported yet (ROADMAP Queue 1, item 3)")
    if dataset_type == "ucla-phonetic":
        # Loaded as a test split only.
        return MultilingualSplits.single(UCLAPhoneticCorpus.load(path, resample, languages, progress_bar))
    raise ValueError(f"Corpus of type {dataset_type} is not supported")


def preprocessed_features_or_lengths(
    data_path: str, split_languages: Dict[str, Sequence[str]], lengths_only: bool = True
) -> Dict[str, PreprocessedSplitData]:
    """The precomputed lengths of each split, concatenated in language order,
    from the JAX package's ragged store. Features, and reference caches in
    zarr, are not ported."""
    if not lengths_only or os.path.isfile(os.path.join(data_path, ".zgroup")):
        raise NotImplementedError(
            "Precomputed features and zarr caches are not ported yet (ROADMAP Queue 1, item 7: data/store.py)"
        )
    return {
        split: PreprocessedSplitData(
            np.concatenate([np.load(os.path.join(data_path, split, language, "lengths.npy")) for language in languages])
        )
        for split, languages in split_languages.items()
    }
