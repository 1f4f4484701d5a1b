"""Multilingual speech corpus abstractions.

The port's copy of ``allophant_tpu/data/speech_corpus.py``.

Counterpart of the reference's allophant/datasets/speech_corpus.py: per-language
contiguous utterance ranges with language-id mapping, audio loading with cached
resampling, inventory access, and duration-based length estimation. Audio goes
through :mod:`allophant_tpu_torch.data.audio` (no torchaudio/mutagen)."""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from os import path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from allophant_tpu_torch.data import audio as audio_io
from allophant_tpu_torch.phonetics.features import LanguageInventories


@dataclass
class LanguageInfo:
    """ISO 639-3 code, phoneme inventory and G2P inventory mappings for a language."""

    code: str
    phoneme_inventory: List[str]
    phoneme_mappings: List[Dict[str, List[str]]]


@dataclass
class LanguageData:
    """Metadata and transcribed utterances for a monolingual subset."""

    info: LanguageInfo
    transcribed_samples: List[Any]

    def __getitem__(self, index: int):
        return self.transcribed_samples[index]

    def __len__(self) -> int:
        return len(self.transcribed_samples)


@dataclass
class _LanguageEntry:
    info: LanguageInfo
    offset: int
    num_utterances: int


@dataclass
class IndexedEntry:
    language_id: int
    entry: Any


@dataclass
class AudioInfo:
    sample_rate: int = 16_000
    bits_per_sample: int = 16
    num_channels: int = 1

    @classmethod
    def none(cls) -> "AudioInfo":
        return cls(0, 0, 0)


def _global_or_local_limit(limits: Dict[str, int] | int | None, key: str) -> Optional[int]:
    return limits if limits is None or isinstance(limits, int) else limits.get(key)


class MultilingualCorpus:
    """Random access to utterances across languages plus monolingual subset views."""

    UTTERANCE_TYPE = "transcribed"

    def __init__(
        self,
        base_directory: str,
        language_data: Iterable[LanguageData],
        audio_subdirectory: str,
        audio_extension: str,
        limits: Dict[str, int] | int | None = None,
        resample: int | None = None,
        phoneme_sources: Sequence[str] | None = None,
        meta_data: Dict[str, Any] | None = None,
    ) -> None:
        self._meta_data = meta_data
        self._base_directory = path.abspath(path.expanduser(base_directory)) if base_directory else ""
        self._audio_extension = audio_extension
        self._audio_subdirectory = audio_subdirectory
        self._phoneme_sources = ["manual"] if phoneme_sources is None else list(phoneme_sources)
        self._languages: Dict[str, _LanguageEntry] = {}
        self._language_ids: Dict[str, int] = {}
        self._language_list: List[str] = []
        self._utterances: List[IndexedEntry] = []
        self._num_utterances = 0
        self._resample = resample

        for index, language in enumerate(language_data):
            language_code = language.info.code
            limit = _global_or_local_limit(limits, language_code)
            num_utterances = len(language.transcribed_samples)
            if limit is not None:
                num_utterances = min(num_utterances, limit)
            if language_code in self._language_ids:
                raise ValueError(f"Duplicate language data for code: {language_code}")
            self._languages[language_code] = _LanguageEntry(language.info, self._num_utterances, num_utterances)
            self._language_ids[language_code] = index
            self._language_list.append(language_code)
            self._utterances.extend(
                IndexedEntry(index, transcription)
                for transcription in language.transcribed_samples[: num_utterances]
            )
            self._num_utterances += num_utterances

        self._audio_info = AudioInfo.none()
        if resample is not None:
            self._audio_info.sample_rate = resample

    @property
    def meta_data(self) -> Dict[str, Any] | None:
        return self._meta_data

    @property
    def audio_info(self) -> AudioInfo:
        return self._audio_info

    @property
    def phoneme_sources(self) -> Sequence[str]:
        return self._phoneme_sources

    @staticmethod
    def empty() -> "MultilingualCorpus":
        return MultilingualCorpus("", [], "", "")

    def path_from_utterance(self, language: str, utterance_id: str) -> str:
        return path.join(
            self._base_directory, language, self._audio_subdirectory, f"{utterance_id}.{self._audio_extension}"
        )

    def path_for(self, indexed_transcription: IndexedEntry) -> str:
        return self.path_from_utterance(
            self._language_list[indexed_transcription.language_id], indexed_transcription.entry.utterance_id
        )

    def path(self, index: int) -> str:
        return self.path_for(self._utterances[index])

    def audio_from_utterance(self, language: str, utterance_id: str) -> Tuple[np.ndarray, int]:
        """(possibly resampled audio [channels, samples], original sample rate)."""
        return audio_io.load_audio(self.path_from_utterance(language, utterance_id), self._resample)

    def audio_for(self, indexed_transcription: IndexedEntry) -> Tuple[np.ndarray, int]:
        return self.audio_from_utterance(
            self._language_list[indexed_transcription.language_id], indexed_transcription.entry.utterance_id
        )

    def audio(self, index: int) -> Tuple[np.ndarray, int]:
        return self.audio_for(self._utterances[index])

    @property
    def languages(self) -> List[str]:
        return self._language_list

    def utterance_languages(self) -> Iterator[str]:
        for code, language_entry in self._languages.items():
            for _ in range(language_entry.num_utterances):
                yield code

    def monolingual_index_range(self, language_code: str) -> range:
        entry = self._languages[language_code]
        return range(entry.offset, entry.offset + entry.num_utterances)

    def _monolingual_islice(self, entry: _LanguageEntry) -> Iterator[IndexedEntry]:
        return itertools.islice(self._utterances, entry.offset, entry.offset + entry.num_utterances)

    def monolingual_subset(self, language_code: str) -> LanguageData:
        entry = self._languages[language_code]
        return LanguageData(entry.info, [utterance.entry for utterance in self._monolingual_islice(entry)])

    def subset(self, language_codes: Iterable[str]) -> "MultilingualCorpus":
        # Limits were already applied when this corpus was built, so the subset
        # inherits them through the trimmed utterance lists; the audio settings
        # and metadata must carry over explicitly.
        return MultilingualCorpus(
            self._base_directory,
            (self.monolingual_subset(code) for code in language_codes),
            self._audio_subdirectory,
            self._audio_extension,
            resample=self._resample,
            phoneme_sources=self._phoneme_sources,
            meta_data=self._meta_data,
        )

    def shared_inventory(self) -> List[str]:
        return sorted(
            {
                phoneme
                for entry in self._languages.values()
                for phoneme in entry.info.phoneme_inventory
            }
        )

    def language_id_inventories(self) -> LanguageInventories:
        return LanguageInventories(
            {
                self.language_id(entry.info.code): entry.info.phoneme_inventory
                for entry in self._languages.values()
            },
            self.languages,
        )

    def language_id(self, language: str) -> int:
        return self._language_ids[language]

    def language(self, language_id: int) -> str:
        return self._language_list[language_id]

    def inventory(self, language: str) -> List[str]:
        return self._languages[language].info.phoneme_inventory

    def _language_lengths(self, entry: _LanguageEntry) -> Iterator[int]:
        sample_rate = self._audio_info.sample_rate
        for utterance in self._monolingual_islice(entry):
            duration, file_rate = audio_io.probe_duration(self.path_for(utterance))
            yield audio_io.estimated_resampled_length(duration, file_rate, sample_rate)

    def read_lengths(self) -> Iterator[Tuple[str, Iterator[int]]]:
        """Per-language sample counts after resampling, from headers only."""
        return ((code, self._language_lengths(entry)) for code, entry in self._languages.items())

    def __getitem__(self, index: int) -> IndexedEntry:
        return self._utterances[index]

    def __iter__(self) -> Iterator[LanguageData]:
        for language in self._language_list:
            yield self.monolingual_subset(language)

    def __len__(self) -> int:
        return self._num_utterances

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self._base_directory!r}, {list(self._languages)!r})"


@dataclass
class SplitMetaData:
    train: Dict[str, Any] | None
    dev: Dict[str, Any] | None
    test: Dict[str, Any] | None

    def to_dict(self) -> Dict[str, Any]:
        return {"train": self.train, "dev": self.dev, "test": self.test}


@dataclass
class MultilingualSplits:
    """Train/dev/test container."""

    SPLIT_NAMES = ("train", "dev", "test")

    train: MultilingualCorpus
    dev: MultilingualCorpus
    test: MultilingualCorpus

    def audio_info(self) -> AudioInfo:
        no_info = AudioInfo.none()
        return next(
            (split.audio_info for split in (self.train, self.dev, self.test) if split.audio_info != no_info),
            no_info,
        )

    def meta_data(self) -> SplitMetaData:
        return SplitMetaData(self.train.meta_data, self.dev.meta_data, self.test.meta_data)

    @classmethod
    def single(cls, corpus: MultilingualCorpus, split: str = "test") -> "MultilingualSplits":
        splits = {split: corpus}
        corpus_type = corpus.__class__
        for name in cls.SPLIT_NAMES:
            if name not in splits:
                splits[name] = corpus_type.empty()
        return cls(**splits)

    def __iter__(self) -> Iterator[MultilingualCorpus]:
        yield self.train
        yield self.dev
        yield self.test
