"""Corpus loading (counterpart of ``allophant_tpu/data/corpus_loading.py``):
dispatch on the dataset type and path shape. For "common-voice" a directory
loads the train, dev and test splits, a ``{split}_transcriptions.bin`` path
that split alone; "ucla-phonetic" loads a corpus directory as a test split.
Precomputed features are not ported; the precomputed per-utterance lengths of
``--lengths`` are read from the JAX package's ragged store layout
(``root/<split>/<language>/lengths.npy``)."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from allophant_tpu_torch.data.common_voice import CommonVoiceCorpus, CommonVoiceSplits
from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus
from allophant_tpu_torch.phonetics.language_codes import LanguageCodeMap

_TRANSCRIPTION_RE = re.compile(r"^(?P<split>.*)_transcriptions\.bin$")


@dataclass
class PreprocessedSplitData:
    lengths: np.ndarray
    features: Optional[List[np.ndarray]] = None


def _map_languages(directory: str, languages: Sequence[str]) -> Sequence[str]:
    try:
        corpus_codes = CommonVoiceCorpus.language_codes_from_meta(directory)
    except FileNotFoundError:
        return languages
    language_map = LanguageCodeMap(corpus_codes)
    return [language_map[code] for code in languages]


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
        if os.path.isdir(path):
            if languages is not None:
                languages = _map_languages(path, languages)
            return CommonVoiceSplits.from_file(
                path,
                resample,
                languages,
                validation_limits=validation_limits,
                only_primary_script=only_primary_script,
                progress_bar=progress_bar,
            )

        data_directory = os.path.dirname(path)
        if languages is not None:
            languages = _map_languages(data_directory, languages)
        match = _TRANSCRIPTION_RE.match(os.path.basename(path))
        if match is None:
            raise ValueError(f"Path is not a valid transcription path: {path!r}")
        split = match.group("split")
        if split not in MultilingualSplits.SPLIT_NAMES:
            raise ValueError(f"{split} is not a valid Split, must be one of {MultilingualSplits.SPLIT_NAMES}")
        return MultilingualSplits.single(
            CommonVoiceCorpus.from_file(
                data_directory,
                split,
                resample,
                languages,
                only_primary_script=only_primary_script,
                progress_bar=progress_bar,
            ),
            split,
        )
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
            "Precomputed features and zarr caches are not ported yet (ROADMAP Queue 1, item 2: data/store.py)"
        )
    return {
        split: PreprocessedSplitData(
            np.concatenate([np.load(os.path.join(data_path, split, language, "lengths.npy")) for language in languages])
        )
        for split, languages in split_languages.items()
    }
