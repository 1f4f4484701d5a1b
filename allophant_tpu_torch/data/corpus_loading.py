"""Corpus loading (counterpart of ``allophant_tpu/data/corpus_loading.py``):
dispatch on the dataset type and path shape. For "common-voice" a directory
loads the train, dev and test splits, a ``{split}_transcriptions.bin`` path
that split alone; "ucla-phonetic" loads a corpus directory as a test split.
Precomputed features and lengths come from ``data/store.py`` (the ragged
store, or a zarr cache)."""

from __future__ import annotations

import os
import re
from typing import Dict, Sequence

from allophant_tpu_torch.data.common_voice import CommonVoiceCorpus, CommonVoiceSplits
from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
from allophant_tpu_torch.data.store import PreprocessedSplitData, preprocessed_features_or_lengths
from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus
from allophant_tpu_torch.phonetics.language_codes import LanguageCodeMap

_TRANSCRIPTION_RE = re.compile(r"^(?P<split>.*)_transcriptions\.bin$")


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

