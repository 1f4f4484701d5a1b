"""Evaluation pipeline (counterpart of ``allophant_tpu/evaluation_runner.py``):
prediction files -> per-language, per-classifier edit statistics and
alignment dumps. n-best candidates score by minimum WER, IPA layers optionally
remap through the "tr2tgt" scheme, fix unicode-normalization mismatches, and
split complex segments; the attribute labels of non-IPA classifiers are
derived from the reference phoneme sequence through the full feature table."""

from __future__ import annotations

import math
import warnings
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from allophant_tpu_torch import phonemes as native
from allophant_tpu_torch.config import ProjectionEntryConfig
from allophant_tpu_torch.device import resolve_device, to_device
from allophant_tpu_torch.evaluation import EvaluationResults, MultilingualEvaluationResults
from allophant_tpu_torch.ops.levenshtein import batched_edit_statistics, batched_levenshtein_distances, encode_token_batches
from allophant_tpu_torch.phonemes import EditStatistics
from allophant_tpu_torch.phonetics import segmentation
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.utils import progress_bar
from allophant_tpu_torch.predictions import (
    PredictionMetaData,
    PredictionReader,
    UtteranceEdits,
    UtterancePrediction,
    levensthein_substitutions,
)

IPA_LAYERS = {ProjectionEntryConfig.PHONEME_LAYER, ProjectionEntryConfig.PHONE}


class MissingFeatureWarning(UserWarning):
    """A feature has prediction outputs but no labels during evaluation."""


warnings.simplefilter("once", MissingFeatureWarning)


def _fix_inventories(
    target_inventories: Dict[str, List[str]], missing_mappings: Dict[str, str]
) -> Dict[str, List[str]]:
    return {
        language: sorted({missing_mappings.get(phoneme, phoneme) for phoneme in raw_inventory})
        for language, raw_inventory in target_inventories.items()
    }


def _missing_mappings(
    attribute_indexer: PhoneticAttributeIndexer, target_inventories: Dict[str, List[str]]
) -> Dict[str, str]:
    return attribute_indexer.full_attributes.missing_inventory_mappings(
        sorted({phoneme for inventory in target_inventories.values() for phoneme in inventory})
    )


@dataclass
class _EvaluationMappings:
    source_maps: Dict[str, Dict[str, str]]
    missing_mappings: Dict[str, str] | None = None


class EvaluationProcessor:
    """Prepares label/candidate sequences for scoring: remapping (tr2tgt), unicode
    fixes and complex-segment splitting."""

    def __init__(
        self,
        predictions_meta: PredictionMetaData,
        map_phonemes: bool = False,
        fix_unicode: bool = False,
        split_complex: bool = False,
    ) -> None:
        self.attribute_indexer = PhoneticAttributeIndexer.from_state(
            predictions_meta.feature_set, predictions_meta.indexer_state
        )
        self.full_attributes = self.attribute_indexer.full_attributes

        target_inventories = predictions_meta.label_inventories
        if map_phonemes or fix_unicode:
            if target_inventories is None:
                raise ValueError("Target inventories are required for phoneme remapping but none were given")
            missing = _missing_mappings(self.attribute_indexer, target_inventories) if fix_unicode else None
            source_maps = (
                {
                    language: self.attribute_indexer.map_target_inventory(inventory)
                    for language, inventory in target_inventories.items()
                }
                if map_phonemes
                else {}
            )
            self.evaluation_mappings = _EvaluationMappings(source_maps, missing)
        else:
            self.evaluation_mappings = _EvaluationMappings({}, None)

        self._map_phonemes = map_phonemes
        self._split_complex = split_complex

    @property
    def split_complex(self) -> bool:
        return self._split_complex

    def language_mapper(self, language: str) -> Dict[str, str] | None:
        return self.evaluation_mappings.source_maps[language] if self._map_phonemes else None

    def attribute_indices(self, reference_phonemes: List[str]):
        missing = self.evaluation_mappings.missing_mappings
        if missing is not None:
            reference_phonemes = [missing.get(phoneme, phoneme) for phoneme in reference_phonemes]
        return self.full_attributes.get_named(reference_phonemes)


def _process_prediction(
    prediction: UtterancePrediction,
    references: List[List[str]],
    processor: EvaluationProcessor,
) -> Iterator[Tuple[str, List[str], List[List[str]]]]:
    [reference] = references
    reference_feature_indices = processor.attribute_indices(reference)

    for name, candidates in prediction.predictions.items():
        is_ipa_output = name in IPA_LAYERS
        if is_ipa_output:
            expected = reference
        else:
            try:
                expected = processor.full_attributes.feature_values(name, reference_feature_indices[name])
            except KeyError:
                warnings.warn(f'Missing feature in attributes: "{name}" - skipping', MissingFeatureWarning)
                continue

        if is_ipa_output and processor.split_complex:
            expected = list(segmentation.split_all_complex_segments(expected))

        yield name, expected, candidates


def _process_candidates(
    candidates, processor: EvaluationProcessor, language: str, is_ipa_output: bool = False
) -> Iterator[List[str]]:
    source_map = processor.language_mapper(language)
    for candidate in candidates:
        if not is_ipa_output:
            yield candidate
            continue
        actual = candidate if source_map is None else [source_map[phoneme] for phoneme in candidate]
        if processor.split_complex:
            actual = list(segmentation.split_all_complex_segments(actual))
        yield actual


def compute_edit_statistics(
    reader: PredictionReader,
    map_phonemes: bool = True,
    fix_unicode: bool = False,
    split_complex: bool = False,
    scorer: str = "device",
    show_progress: bool = False,
    device=None,
) -> Dict[str, Dict[str, EditStatistics]]:
    """Accumulates per-(language, classifier) edit statistics; the best of the
    n-best candidates (minimum WER) counts.

    ``scorer="device"`` scores every (utterance, classifier, candidate) pair in
    one batch by the DPs of ``ops/levenshtein.py`` on ``device`` (CUDA unless
    the caller asks for the CPU), with the native engine's counter tie-break;
    ``scorer="host"`` runs the C++ engine per utterance."""
    if scorer not in ("device", "host"):
        raise ValueError(f"Unknown scorer {scorer!r} (expected 'device' or 'host')")
    if scorer == "device":
        device = resolve_device(device)
    meta = reader.metadata
    processor = EvaluationProcessor(meta, map_phonemes, fix_unicode, split_complex)
    edit_statistics = {
        language: {name: EditStatistics.zeros() for name in meta.classifiers}
        for language in meta.languages
    }

    collected: List[Tuple[str, str, List[str], List[List[str]]]] = []
    progress = progress_bar(enabled=show_progress, desc="evaluate", unit="utt")
    for line, prediction in enumerate(reader, 1):
        progress.update(1)
        references = prediction.labels
        if references is None:
            raise ValueError(f"Missing label for evaluation in line {line}")
        language = prediction.language

        for name, expected, candidates in _process_prediction(prediction, references, processor):
            processed = list(
                _process_candidates(candidates, processor, language, name in IPA_LAYERS)
            )
            if not processed:
                warnings.warn(
                    f"Each category needs at least one candidate output, got no candidates for"
                    f" {name!r} in line {line} with utterance ID {prediction.utterance_id}"
                )
                continue
            if scorer == "host":
                lowest_error_rate = math.inf
                best_statistics = None
                for actual in processed:
                    statistics = native.levensthein_statistics(expected, actual)
                    error_rate = statistics.word_error_rate()
                    if error_rate < lowest_error_rate:
                        lowest_error_rate = error_rate
                        best_statistics = statistics
                if best_statistics is None:
                    # All candidates scored +inf (empty reference, no exact
                    # match): the utterance is skipped with the no-candidates
                    # warning, as the JAX package does.
                    warnings.warn(
                        f"Each category needs at least one candidate output, got no candidates"
                        f" for {name!r} in line {line} with utterance ID {prediction.utterance_id}"
                    )
                    continue
                edit_statistics[language][name] += best_statistics
            else:
                collected.append(
                    (language, name, expected, processed, line, prediction.utterance_id)
                )

    progress.close()
    if collected:
        _accumulate_device_statistics(collected, edit_statistics, device)
    return edit_statistics


def _accumulate_device_statistics(
    collected: List[Tuple[str, str, List[str], List[List[str]], int, str]],
    edit_statistics: Dict[str, Dict[str, EditStatistics]],
    device,
) -> None:
    """Scores all (expected, candidate) pairs in one batch on ``device``,
    selects the min-WER candidate of each entry (the first on ties, like the
    host loop) and adds its I/D/S/C statistics. Entries whose best candidate
    still scores +inf (empty reference, no exact match) are skipped with a
    warning, as on the host path."""
    expected_flat: List[List[str]] = []
    candidate_flat: List[List[str]] = []
    offsets = [0]
    for _language, _name, expected, candidates, _line, _utterance in collected:
        for candidate in candidates:
            expected_flat.append(expected)
            candidate_flat.append(candidate)
        offsets.append(offsets[-1] + len(candidates))

    a_ids, a_lengths, b_ids, b_lengths = encode_token_batches(expected_flat, candidate_flat)
    distances = (
        batched_levenshtein_distances(*(to_device(array, device) for array in (a_ids, a_lengths, b_ids, b_lengths)))
        .cpu()
        .numpy()
    )
    # WER = distance / len(expected); empty references: 0 if exact else +inf,
    # mirroring (S+D+I)/(S+D+C) with a zero denominator.
    with np.errstate(divide="ignore", invalid="ignore"):
        rates = np.where(
            a_lengths > 0,
            distances / np.maximum(a_lengths, 1),
            np.where(distances == 0, 0.0, np.inf),
        )

    best_indices = []
    kept_entries = []
    for entry, (start, end) in enumerate(zip(offsets[:-1], offsets[1:])):
        best_offset = int(np.argmin(rates[start:end]))
        if not np.isfinite(rates[start + best_offset]):
            language, name, _expected, _candidates, line, utterance_id = collected[entry]
            warnings.warn(
                f"Each category needs at least one candidate output, got no candidates"
                f" for {name!r} in line {line} with utterance ID {utterance_id}"
            )
            continue
        best_indices.append(start + best_offset)
        kept_entries.append(entry)
    if not best_indices:
        return
    best = np.asarray(best_indices)

    insertions, deletions, substitutions, correct = (
        values.cpu().numpy()
        for values in batched_edit_statistics(
            *(to_device(array[best], device) for array in (a_ids, a_lengths, b_ids, b_lengths))
        )
    )
    for row, entry in enumerate(kept_entries):
        language, name, _expected, _candidates, _line, _utterance = collected[entry]
        edit_statistics[language][name] += EditStatistics(
            int(insertions[row]), int(deletions[row]), int(substitutions[row]), int(correct[row])
        )


def summarize_edit_statistics(
    edit_statistics: Dict[str, Dict[str, EditStatistics]],
    classifiers: List[str],
    evaluation_arguments: str = "",
) -> MultilingualEvaluationResults:
    """Per-language and pooled "total" results."""
    total_statistics: Dict[str, EditStatistics] = defaultdict(EditStatistics.zeros)
    stats: Dict[str, EvaluationResults] = {}
    for language, language_statistics in edit_statistics.items():
        language_error_rates = {}
        for name, statistics in language_statistics.items():
            total_statistics[name] += statistics
            # word_error_rate handles empty references itself (0.0 when all
            # counts are zero, inf for insertions-only).
            language_error_rates[name] = statistics.word_error_rate()
        stats[language] = EvaluationResults(classifiers, language_error_rates, language_statistics)

    total_error_rates = {
        name: statistics.word_error_rate() for name, statistics in total_statistics.items()
    }
    stats["total"] = EvaluationResults(classifiers, total_error_rates, dict(total_statistics))
    return MultilingualEvaluationResults(evaluation_arguments, stats)


def compute_edits(
    reader: PredictionReader,
    map_phonemes: bool = True,
    fix_unicode: bool = False,
    split_complex: bool = False,
) -> Iterator[UtteranceEdits]:
    """Per-utterance alignment operation dumps."""
    processor = EvaluationProcessor(reader.metadata, map_phonemes, fix_unicode, split_complex)
    for line, prediction in enumerate(reader, 1):
        references = prediction.labels
        if references is None:
            raise ValueError(f"Missing label for evaluation in line {line}")
        language = prediction.language
        edits: Dict[str, List] = {}
        expected_sequences: Dict[str, List[str]] = {}
        for name, expected, candidates in _process_prediction(prediction, references, processor):
            # next() on an empty iterator would raise StopIteration, which PEP 479
            # turns into a RuntimeError inside this generator — skip and warn like
            # the statistics path instead.
            actual = next(
                _process_candidates(candidates, processor, language, name in IPA_LAYERS), None
            )
            if actual is None:
                warnings.warn(
                    f"Each category needs at least one candidate output, got no candidates"
                    f" for {name!r} in line {line} with utterance ID {prediction.utterance_id}"
                )
                continue
            edits[name] = levensthein_substitutions(expected, actual)
            expected_sequences[name] = expected
        yield UtteranceEdits(language, prediction.utterance_id, expected_sequences, edits)
