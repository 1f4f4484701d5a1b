"""IPA sentence segmentation and complex-segment utilities (the port's copy of
``allophant_tpu/phonetics/segmentation.py``; grapheme clusters come from
``grapheme_clusters`` here instead of the third-party ``regex`` module).

Behavioral counterpart of the reference's allophant/phoneme_segmentation.py. Unicode
mark classification, grapheme-cluster splitting and the dedup'ing missing-phoneme
warning logger all follow the reference semantics since they directly influence PER.
"""

from __future__ import annotations

import itertools
import logging
import unicodedata
from typing import Iterable, Iterator, List, Sequence

from allophant_tpu_torch.phonemes import IpaSegmenter

# IPA tone letters (U+A700 block) used by PHOIBLE tone contours.
TONES = [chr(code) for code in range(0xA700, 0xA720)]
_TONE_SET = frozenset(TONES)

VOWELS = frozenset("aeiouyæøœɐɑɒɔɘəɚɛɜɝɞɤɨɪɯɵɶʉʊʌʏ")

_UNKNOWN_LANGUAGE = "unknown"


def filter_tones(inventory: Iterable[str]) -> Iterator[str]:
    """Yields phonemes that contain no IPA tone letters.

    (The reference's implementation at phoneme_segmentation.py:54-57 swaps the
    ``re.search`` argument order; for the single-character tone symbols it filters in
    practice both behaviors agree, and this spelling implements the documented intent.)
    """
    return (
        phoneme for phoneme in inventory if _TONE_SET.isdisjoint(phoneme)
    )


class SegmentationLogger:
    """Warning logger for phonemes missing from the segmentation vocabulary.

    Reports are deduplicated per (language context, phoneme) so long corpora don't
    flood the log (reference phoneme_segmentation.py:94-143); ``reset`` clears the
    dedup state between corpus passes unless suppressed."""

    def __init__(self) -> None:
        self._logger = logging.getLogger("allophant_tpu_torch.phonetics.segmentation")
        self._logger.setLevel(logging.WARNING)
        self._reported: set = set()
        self._language = _UNKNOWN_LANGUAGE
        self._pending_suppressions = 0

    @property
    def log(self) -> "SegmentationLogger":
        # The logger doubles as its own `.log` facade so call sites read
        # `SEGMENTATION_LOGGER.log.warning(...)`.
        return self

    def warning(self, phoneme: str) -> None:
        key = (self._language, phoneme)
        if key in self._reported:
            return
        self._reported.add(key)
        self._logger.warning("Missing phoneme segment: (%s) %r", self._language, phoneme)

    def context_language(self, language: str) -> None:
        self._language = language

    def add_file_handler(self, log_path) -> None:
        self._logger.addHandler(logging.FileHandler(log_path, mode="w", encoding="utf-8"))

    def reset(self) -> None:
        if self._pending_suppressions:
            self._pending_suppressions -= 1
            return
        self._reported.clear()
        self._language = _UNKNOWN_LANGUAGE

    def suppress_resets(self, count: int = 1) -> None:
        self._pending_suppressions += count


SEGMENTATION_LOGGER = SegmentationLogger()


class SegmentationProcessor:
    """Hook points for pre/post-processing phonemes during lossy segmentation
    (espeak's language-switch flags and replacement tables plug in here)."""

    def pre_process(self, phoneme: str, _phoneme_iterator: Iterator[str]) -> str:
        return phoneme

    def post_process(self, sub_segments: List[str], _phoneme_iterator: Iterator[str]) -> Sequence[str]:
        return sub_segments


class IpaSentenceSegmenter:
    """Segments per-word phoneme sequences against a vocabulary.

    ``__call__`` is strict (raises on unknown spans); ``lossy_segment`` drops unknown
    spans while logging them once per (language, phoneme)."""

    def __init__(self, dictionary: List[str], processor: SegmentationProcessor | None = None) -> None:
        self._segmenter = IpaSegmenter(dictionary)
        self._processor = processor or SegmentationProcessor()

    @property
    def word_segmenter(self) -> IpaSegmenter:
        return self._segmenter

    def __call__(self, phonetic_sentences: Iterable[List[str]]) -> Iterator[List[str]]:
        return map(self._segmenter.segment_words_checked, phonetic_sentences)

    def _lossy_one(self, sentence: List[str]) -> List[str]:
        segmented: List[str] = []
        cursor = iter(sentence)
        for raw_phoneme in cursor:
            phoneme = self._processor.pre_process(raw_phoneme, cursor)
            pieces = self._processor.post_process(self._segmenter.segment(phoneme), cursor)
            segmented.extend(pieces)
            if len(pieces) == 1:
                continue
            # Splits (or empty results) mean the vocabulary lacked the phoneme —
            # report it, flagging lossy splits that dropped characters.
            dropped = "".join(pieces) != phoneme
            SEGMENTATION_LOGGER.log.warning(
                phoneme + " (Missing sub-segment when split)" if dropped else phoneme
            )
        return segmented

    def lossy_segment(self, phonetic_sentences: Iterable[List[str]]) -> Iterator[List[str]]:
        return map(self._lossy_one, phonetic_sentences)


def _is_mark(character: str) -> bool:
    category = unicodedata.category(character)
    return category.startswith("M") or category.endswith("m") or category == "Sk"


def base_phonemes(segment: str) -> Iterator[str]:
    """Characters that are not marks or diacritics — the phoneme base characters."""
    return itertools.filterfalse(_is_mark, segment)


def is_vowel_only_segment(segment: str) -> bool:
    return all(character in VOWELS for character in base_phonemes(segment))


def complex_with_vowel(base_characters: Iterable[str]) -> bool:
    """True for multi-character segments containing at least one vowel."""
    characters = list(base_characters)
    return len(characters) > 1 and any(character in VOWELS for character in characters)


def is_multi_vowel(base_characters: Iterable[str]) -> bool:
    """True for segments of two or more characters that are all vowels."""
    characters = list(base_characters)
    return len(characters) > 1 and all(character in VOWELS for character in characters)


# Characters that extend the grapheme cluster before them (UAX #29 rules GB9,
# GB9a: Extend, ZWJ and SpacingMark): combining marks of every kind, the zero
# width joiner and non-joiner.
_EXTENDING_CATEGORIES = frozenset(("Mn", "Me", "Mc"))
_JOINERS = frozenset(("\u200c", "\u200d"))


def grapheme_clusters(text: str) -> List[str]:
    """Extended grapheme clusters of ``text`` as ``regex.findall(r"\\X", text)``
    splits IPA strings: each base character with the combining marks and
    joiners that follow it (the Hangul, emoji and regional-indicator rules of
    UAX #29 are not implemented)."""
    clusters: List[str] = []
    for character in text:
        if clusters and (unicodedata.category(character) in _EXTENDING_CATEGORIES or character in _JOINERS):
            clusters[-1] += character
        else:
            clusters.append(character)
    return clusters


def split_complex_segment(segment: str) -> List[str]:
    """Splits a complex segment into per-base grapheme clusters, attaching leading
    marks to the following cluster and trailing marks to the preceding one."""
    clusters: List[str] = []
    carried_marks = ""
    for grapheme in grapheme_clusters(segment):
        if len(grapheme) == 1 and _is_mark(grapheme):
            if clusters:
                clusters[-1] += grapheme
            else:
                carried_marks += grapheme
        else:
            clusters.append(carried_marks + grapheme)
            carried_marks = ""
    if carried_marks:
        # Mark-only segments (e.g. tone contours) stay together.
        clusters.append(carried_marks)
    return clusters


def split_all_complex_segments(segments: Iterable[str]) -> Iterator[str]:
    return itertools.chain.from_iterable(map(split_complex_segment, segments))


def split_phoneme_segment(segment: str) -> List[List[str]]:
    return [split_complex_segment(piece) for piece in segment.split("|")]


def iterator_length(iterator: Iterator) -> int:
    return sum(1 for _ in iterator)
