"""Phoneme transcription types (the port's copy of the data model of
``allophant_tpu/data/g2p.py``): per-word transcriptions with
language-switch-tagged subsegments, one list per G2P engine, as a Common
Voice corpus file stores them.

The G2P engines themselves (Epitran, eSpeak NG, the stanza tokenizer) need
packages the port does not depend on; they arrive with the data-preparation
CLI."""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Iterator, List, Optional, Sequence

TIE = "͡"


@dataclass
class TaggedTranscription:
    """A phoneme subsequence, tagged with a language code when it came from a
    language-switched span (None for the primary language)."""

    transcription: List[str]
    language: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return {"transcription": self.transcription, "language": self.language}

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "TaggedTranscription":
        return cls(list(data["transcription"]), data.get("language"))


@dataclass
class PhonemeTranscription:
    """Per-utterance transcription: tokenized words (when a tokenizer ran) and one
    list of tagged subsegments per G2P engine."""

    words: Optional[List[str]]
    phonemes: List[List[TaggedTranscription]]

    def only_primary_script(self) -> bool:
        return all(
            len(transcription) == 1 and transcription[0].language is None
            for transcription in self.phonemes
        )

    def flattened_transcriptions(self) -> Iterator[List[str]]:
        for transcription in self.phonemes:
            yield [phoneme for subsequence in transcription for phoneme in subsequence.transcription]

    def flattened_primary_transcriptions(self) -> Iterator[List[str]]:
        for transcription in self.phonemes:
            yield [
                phoneme
                for subsequence in transcription
                for phoneme in subsequence.transcription
                if subsequence.language is None
            ]

    def to_json(self) -> Dict[str, Any]:
        return {
            "words": self.words,
            "phonemes": [[segment.to_json() for segment in engine] for engine in self.phonemes],
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "PhonemeTranscription":
        return cls(
            data.get("words"),
            [[TaggedTranscription.from_json(segment) for segment in engine] for engine in data["phonemes"]],
        )


@dataclass
class PhonemeTranscriptionBatch:
    words: Sequence[List[str]]
    phonemes: List[Sequence[List[TaggedTranscription]]]

    def __iter__(self) -> Iterator[PhonemeTranscription]:
        for transcribed in itertools.zip_longest(self.words, *self.phonemes):
            yield PhonemeTranscription(transcribed[0], list(transcribed[1:]))


class PhonemeSource(Enum):
    MANUAL = "manual"
    EPITRAN = "epitran"
    ESPEAK_NG = "espeak-ng"
