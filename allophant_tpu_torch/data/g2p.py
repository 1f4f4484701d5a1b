"""Grapheme-to-phoneme transcription types and engines (the port's copy of
``allophant_tpu/data/g2p.py``): the ``PhonemeTranscription`` data model
(per-word transcriptions with language-switch tagged subsegments), the
extractor and batching machinery, and the eSpeak NG and Epitran engines.
The external engines (phonemizer with espeak-ng, epitran, stanza) are
optional packages imported where the engines need them, as in the JAX
package; the data model and offline corpora work without them."""

from __future__ import annotations

import itertools
import json
import logging
import re
import unicodedata
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Type

from allophant_tpu_torch.package_data import PHONEME_REPLACEMENTS_PATH
from allophant_tpu_torch.phonetics import language_codes
from allophant_tpu_torch.phonetics.language_codes import LanguageCode, LanguageCodeAny, LanguageCodeMap
from allophant_tpu_torch.phonetics.segmentation import IpaSentenceSegmenter, SegmentationProcessor

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


class GraphemeToPhonemeModel(metaclass=ABCMeta):
    REQUIRES_TOKENIZER: bool = False
    _PHONEME_SOURCE: PhonemeSource = PhonemeSource.MANUAL

    def __init__(self, language_code: LanguageCodeAny, segment_inventory: List[str]) -> None:
        self._language_code = language_codes.to_language_code(language_code)
        self._segment_inventory = segment_inventory

    @abstractmethod
    def _process_batch(self, sentences) -> Sequence[List[TaggedTranscription]]: ...

    def __call__(self, words) -> Sequence[List[TaggedTranscription]]:
        return self._process_batch(words)

    @classmethod
    def _initialize(cls):
        return None

    @staticmethod
    @abstractmethod
    def supports(_language_code: LanguageCodeAny) -> bool:
        return False


class PhonemeExtractor:
    """Batches sentences through an optional tokenizer plus one or more G2P models."""

    def __init__(
        self,
        language_code: LanguageCodeAny,
        g2p_models: List[GraphemeToPhonemeModel],
        token_batch_size: int = 512,
    ) -> None:
        self._language_code = language_codes.to_language_code(language_code)
        if any(model.REQUIRES_TOKENIZER for model in g2p_models):
            self._pipeline = _make_stanza_pipeline(self._language_code, token_batch_size)
        else:
            self._pipeline = None
        self._g2p_models = g2p_models

    def sentences_to_phoneme(self, sentences: List[str]) -> PhonemeTranscriptionBatch:
        if self._pipeline is None:
            words: Sequence[List[str]] = []
        else:
            words = [
                [
                    word.text
                    for word in tokenized.words
                    if not all(unicodedata.category(character)[0] == "P" for character in word.text)
                ]
                for tokenized in self._pipeline(sentences).sentences
            ]
        return PhonemeTranscriptionBatch(
            words,
            [model(words) if model.REQUIRES_TOKENIZER else model(sentences) for model in self._g2p_models],
        )

    def auto_batch_g2p(self, sentences: Iterable[str], batch_size: int) -> Iterator[PhonemeTranscriptionBatch]:
        batch: List[str] = []
        for sentence in sentences:
            batch.append(sentence)
            if len(batch) == batch_size:
                yield self.sentences_to_phoneme(batch)
                batch = []
        if batch:
            yield self.sentences_to_phoneme(batch)

    def auto_batch_g2p_transcribe(self, entries: Iterable, batch_size: int):
        batch: List = []
        for entry in entries:
            batch.append(entry)
            if len(batch) == batch_size:
                yield batch, self.sentences_to_phoneme([item.sentence for item in batch])
                batch = []
        if batch:
            yield batch, self.sentences_to_phoneme([item.sentence for item in batch])


def _make_stanza_pipeline(language_code: LanguageCode, token_batch_size: int):
    try:
        from stanza import Pipeline
        from stanza.resources import common
    except ImportError as error:
        raise ImportError(
            "Tokenization for this G2P engine requires the stanza package, which is not"
            " installed in this environment"
        ) from error
    tokenizer_languages = {
        LanguageCode.from_str(code).language: code
        for code in common.list_available_languages()
        if code != "multilingual"
    }
    return Pipeline(
        tokenizer_languages[language_code.language],
        processors=["tokenize"],
        tokenize_no_ssplit=True,
        token_batch_size=token_batch_size,
        logging_level="ERROR",
    )


class PhonemeTranscriber(metaclass=ABCMeta):
    _phoneme_sources: List[PhonemeSource]
    _requires_tokenization: bool

    def supports_tokenization(self, language_code: LanguageCodeAny) -> bool:
        if not self._requires_tokenization:
            return True
        try:
            from stanza.resources import common

            available = {
                LanguageCode.from_str(code).language
                for code in common.list_available_languages()
                if code != "multilingual"
            }
        except ImportError:
            return False
        return language_codes.to_language_code(language_code).language in available

    @abstractmethod
    def extractor(self, _language_code: LanguageCodeAny) -> PhonemeExtractor: ...

    @abstractmethod
    def supports(self, _language_code: LanguageCodeAny) -> bool: ...

    @property
    def phoneme_sources(self) -> List[PhonemeSource]:
        return self._phoneme_sources

    @property
    def num_engines(self) -> int:
        return 0


class GraphemeToPhonemeEngine(PhonemeTranscriber):
    def __init__(self, g2p_model: Type[GraphemeToPhonemeModel], segment_inventory: List[str], token_batch_size: int = 512):
        self._g2p_type = g2p_model
        self._phoneme_sources = [g2p_model._PHONEME_SOURCE]
        self._g2p_model = g2p_model._initialize()
        self._token_batch_size = token_batch_size
        self._segment_inventory = segment_inventory
        self._requires_tokenization = g2p_model.REQUIRES_TOKENIZER

    def extractor(self, language_code: LanguageCodeAny) -> PhonemeExtractor:
        return PhonemeExtractor(
            language_code,
            [self._g2p_type(language_code, self._segment_inventory) if self._g2p_model is None else self._g2p_model],
            self._token_batch_size,
        )

    def supports(self, language_code: LanguageCodeAny) -> bool:
        return self._g2p_type.supports(language_code)

    @property
    def num_engines(self) -> int:
        return 1


class GraphemeToPhonemeEnsemble(PhonemeTranscriber):
    def __init__(
        self,
        g2p_models: Sequence[Type[GraphemeToPhonemeModel]],
        segment_inventory: List[str],
        token_batch_size: int = 512,
    ) -> None:
        self._g2p_types = g2p_models
        self._phoneme_sources = [model._PHONEME_SOURCE for model in g2p_models]
        self._g2p_models = [model._initialize() for model in g2p_models]
        self._token_batch_size = token_batch_size
        self._segment_inventory = segment_inventory
        self._requires_tokenization = any(model.REQUIRES_TOKENIZER for model in g2p_models)

    def extractor(self, language_code: LanguageCodeAny) -> PhonemeExtractor:
        return PhonemeExtractor(
            language_code,
            [
                g2p_type(language_code, self._segment_inventory) if g2p_model is None else g2p_model
                for g2p_model, g2p_type in zip(self._g2p_models, self._g2p_types)
            ],
            self._token_batch_size,
        )

    def supports(self, language_code: LanguageCodeAny) -> bool:
        return all(g2p_type.supports(language_code) for g2p_type in self._g2p_types)

    @property
    def num_engines(self) -> int:
        return len(self._g2p_types)


def _tone_backoff(lang_script_codes: List[str], tones: bool = False, cedict_file=None):
    """An ``epitran.Backoff`` whose per-language transliterators have tone
    support enabled (the stock class never passes a tones flag through).
    Initialized normally for forward compatibility with epitran internals, then
    the transliterators are rebuilt with ``tones`` forwarded."""
    from epitran import Epitran
    from epitran.backoff import Backoff

    backoff = Backoff(lang_script_codes, cedict_file=cedict_file)
    backoff.langs = [
        Epitran(code, cedict_file=cedict_file, tones=tones) for code in lang_script_codes
    ]
    return backoff


class EpitranG2P(GraphemeToPhonemeModel):
    """Epitran-based G2P (requires the optional ``epitran`` + ``stanza`` packages)."""

    REQUIRES_TOKENIZER = True
    _PHONEME_SOURCE = PhonemeSource.EPITRAN
    _ENGLISH = "eng-Latn"

    def __init__(self, language_code: LanguageCodeAny, segment_inventory: List[str], tones: bool = False) -> None:
        super().__init__(language_code, segment_inventory)
        try:
            from epitran import Epitran, meta
        except ImportError as error:
            raise ImportError("EpitranG2P requires the epitran package") from error
        code = self._language_code.alpha3
        mode = self._ENGLISH if code == "eng" else meta.get_default_mode(code)
        if mode is None:
            raise ValueError(f"Language {code!r} not supported")
        if not tones or mode.split("-")[1] == "Latn":
            self._epitran = Epitran(mode, tones=tones)
        else:
            # Non-Latin script with tones: back off to English G2P for embedded
            # Latin-script words (reference datasets/phonemes.py:362-366); stock
            # epitran.Backoff has no tones flag, so its transliterators are
            # rebuilt with tones enabled.
            self._epitran = _tone_backoff([mode, self._ENGLISH], tones=tones)
        self._segmenter = IpaSentenceSegmenter(self._segment_inventory)

    def _process_batch(self, words) -> Sequence[List[TaggedTranscription]]:
        return [
            [TaggedTranscription(transcription)]
            for transcription in self._segmenter.lossy_segment(
                [phoneme for word in sentence for phoneme in self._epitran.trans_list(word) if word]
                for sentence in words
            )
        ]

    @staticmethod
    def supports(language_code: LanguageCodeAny) -> bool:
        try:
            from epitran import meta
        except ImportError:
            return False
        code = language_codes.to_language_code(language_code).alpha3
        return code == "eng" or meta.supported_lang(code)


class _EspeakProcessor(SegmentationProcessor):
    _REPLACEMENT_STORAGE: Optional[Dict[str, str]] = None

    @classmethod
    def _replacements(cls) -> Dict[str, str]:
        if cls._REPLACEMENT_STORAGE is None:
            with open(PHONEME_REPLACEMENTS_PATH, "r", encoding="utf-8") as file:
                cls._REPLACEMENT_STORAGE = json.load(file)
        return cls._REPLACEMENT_STORAGE

    def pre_process(self, phoneme: str, phoneme_iterator: Iterator[str]) -> str:
        # Palatalized vowel segments are incorrectly split by phonemizer: re-join.
        if phoneme == "ʲ":
            return phoneme + next(phoneme_iterator)
        phoneme = self._replacements().get(phoneme, phoneme)
        # Remove ties for maximal compatibility with the selected espeak settings.
        return phoneme.replace(TIE, "")


# espeak's keep-flags mode marks language switches inline as "(lang)".
_LANGUAGE_FLAG = re.compile(r"\s*\((\w+)\)\s*")


def _split_language_flags(phoneme_string: str, main_language: str) -> Iterator[Tuple[Optional[str], str]]:
    """Yields ``(language tag, span)`` pairs from an espeak ``keep-flags``
    phonemization. Spans in the main language carry tag ``None``; empty spans
    (e.g. a flag at the very start) are dropped."""
    current: Optional[str] = None
    cursor = 0
    for match in _LANGUAGE_FLAG.finditer(phoneme_string):
        span = phoneme_string[cursor : match.start()]
        if span:
            yield current, span
        switched = match.group(1)
        current = None if switched == main_language else switched
        cursor = match.end()
    tail = phoneme_string[cursor:]
    if tail:
        yield current, tail


class EspeakNg(GraphemeToPhonemeModel):
    """eSpeak NG G2P via phonemizer (requires the optional ``phonemizer`` package and
    a system espeak-ng install)."""

    REQUIRES_TOKENIZER = False
    _PHONEME_SOURCE = PhonemeSource.ESPEAK_NG
    _SUPPORTED_STORAGE: Optional[LanguageCodeMap] = None

    @classmethod
    def _supported(cls) -> LanguageCodeMap:
        if cls._SUPPORTED_STORAGE is None:
            from phonemizer.backend import EspeakBackend

            fixed_tags = {"chr-US-Qaaa-x-west": "chr-Qaaa-US-x-west", "en-us-nyc": "en-us-x-nyc"}
            cls._SUPPORTED_STORAGE = LanguageCodeMap(
                [fixed_tags.get(code, code) for code in EspeakBackend.supported_languages().keys()],
                {"fr": "fr-fr", "en": "en-us"},
            )
        return cls._SUPPORTED_STORAGE

    def __init__(
        self, language_code: LanguageCodeAny, segment_inventory: List[str], with_stress: bool = False
    ) -> None:
        super().__init__(language_code, segment_inventory)
        from phonemizer.backend import EspeakBackend

        language = self._supported()[language_codes.to_language_code(language_code).language]
        null_logger = logging.getLogger("espeak-null")
        null_logger.addHandler(logging.NullHandler())
        self._espeak_main_language = language
        self._backend = EspeakBackend(
            language, language_switch="keep-flags", with_stress=with_stress, logger=null_logger
        )
        self._segmenter = IpaSentenceSegmenter(self._segment_inventory, _EspeakProcessor())

    def _process_phonemes(self, sentences: List[str]) -> Iterator[List[TaggedTranscription]]:
        from phonemizer.separator import Separator

        for phonemes in self._backend.phonemize(sentences, Separator(word="", phone=" ")):
            yield [
                TaggedTranscription(
                    list(self._segmenter.lossy_segment([span.split()]))[0], language_tag
                )
                for language_tag, span in _split_language_flags(
                    phonemes, self._espeak_main_language
                )
            ]

    def _process_batch(self, sentences: List[str]) -> Sequence[List[TaggedTranscription]]:
        return list(self._process_phonemes(sentences))

    @classmethod
    def supports(cls, language_code: LanguageCodeAny) -> bool:
        try:
            return language_code in cls._supported()
        except ImportError:
            return False


class G2PEngineType(Enum):
    EPITRAN = "epitran"
    ESPEAK_NG = "espeak-ng"

    def model(self) -> Type[GraphemeToPhonemeModel]:
        if self == G2PEngineType.EPITRAN:
            return EpitranG2P
        if self == G2PEngineType.ESPEAK_NG:
            return EspeakNg
        raise NotImplementedError(f"Unsupported Engine Type: {self}")
