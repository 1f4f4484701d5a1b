"""UCLA Phonetic Corpus loader (the zero-shot test set).

The port's copy of ``allophant_tpu/data/ucla.py``.

Counterpart of the reference's allophant/datasets/ucla_phonetic_corpus.py: per-language
directories with ``inventory``/``raw``/``text`` files and wav audio under ``audio/``."""

from __future__ import annotations

import os
from dataclasses import dataclass
from os import path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from allophant_tpu_torch import utils
from allophant_tpu_torch.phonetics import language_codes
from allophant_tpu_torch.data.speech_corpus import LanguageData, LanguageInfo, MultilingualCorpus

_INVENTORY_FILE = "inventory"
_RAW_FILE = "raw"
_TEXT_FILE = "text"


@dataclass
class Transcription:
    """A phonetically segmented utterance: id, narrow annotation and phone list."""

    utterance_id: str
    raw: str
    phonemes: List[str]


@dataclass
class UCLALanguageData(LanguageData):
    id_map: Dict[str, int] = None  # type: ignore[assignment]


def _load_languages(
    directory: str, languages: Optional[Sequence[str]] = None, progress_bar: bool = False
) -> Iterator[UCLALanguageData]:
    if languages is None:
        language_list: Iterable[str] = sorted(os.listdir(directory))
    else:
        language_list = [language_codes.to_language_code(code).alpha3 for code in languages]

    iterator = utils.progress_bar(
        language_list, enabled=progress_bar, unit=" languages", desc="Loading transcriptions"
    )

    for language in iterator:
        language_directory = path.join(directory, language)

        with open(path.join(language_directory, _INVENTORY_FILE), "r", encoding="utf-8") as file:
            # Inventory lines are "<phoneme> <count>"; sorted for determinism.
            info = LanguageInfo(language, sorted(phoneme for phoneme, *_ in map(str.split, file)), [])

        with (
            open(path.join(language_directory, _RAW_FILE), "r", encoding="utf-8") as raw_file,
            open(path.join(language_directory, _TEXT_FILE), "r", encoding="utf-8") as text_file,
        ):
            transcriptions = []
            id_map = {}
            for index, (raw_line, text_line) in enumerate(zip(raw_file, text_file)):
                raw_id, raw = raw_line.split(maxsplit=1)
                text_columns = text_line.split()
                assert raw_id == text_columns[0], "Mismatch between raw and text file IDs"
                transcriptions.append(Transcription(raw_id, raw.strip(), text_columns[1:]))
                id_map[raw_id] = index

        yield UCLALanguageData(info, transcriptions, id_map)


class UCLAPhoneticCorpus(MultilingualCorpus):
    """UCLA Phonetic Corpus (Li et al., 2021): 90+ low-resource languages with
    phone-segmented transcriptions; used as the zero-shot test set."""

    UTTERANCE_TYPE = "phonetically-segmented"

    _AUDIO_DIRECTORY = "audio"

    def __init__(self, base_directory: str, languages: Iterable[LanguageData], resample: int | None = None):
        super().__init__(base_directory, languages, self._AUDIO_DIRECTORY, "wav", resample=resample)

    @classmethod
    def load(
        cls,
        directory: str,
        resample: int | None = None,
        languages: Optional[Sequence[str]] = None,
        progress_bar: bool = False,
    ) -> "UCLAPhoneticCorpus":
        return cls(directory, _load_languages(directory, languages, progress_bar), resample)

    def __str__(self) -> str:
        return (
            f"UCLA Phonetic Corpus containing {len(self._languages)} languages with"
            f" {self._num_utterances} utterances"
        )
