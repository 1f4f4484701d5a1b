"""Datasets: per-utterance feature + label generation.

The port's copy of ``allophant_tpu/data/dataset.py``.

Counterpart of the reference's allophant/dataset_processing.py:176-347. Items are
plain numpy samples; batching/padding happens in :mod:`allophant_tpu_torch.data.batching`."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from allophant_tpu_torch.config import Config
from allophant_tpu_torch.data.preprocessing import FeatureFunction
from allophant_tpu_torch.data.speech_corpus import IndexedEntry, MultilingualCorpus
from allophant_tpu_torch.phonetics.features import PhonemeIndexer, PhoneticAttributeIndexer, PhoneticIndexerState


@dataclass
class SamplesProcessor:
    feature_function: FeatureFunction
    attribute_indexer: PhoneticAttributeIndexer

    @property
    def feature_size(self) -> int:
        return self.feature_function.feature_size

    def indexer_state(self) -> PhoneticIndexerState:
        return self.attribute_indexer.state()

    @classmethod
    def from_config(cls, config: Config, sampling_rate: int, attribute_indexer: PhoneticAttributeIndexer):
        return cls(FeatureFunction.from_config(config, sampling_rate), attribute_indexer)


class BatchType(Enum):
    UNLABELED = 0
    RAW = 1
    INDEXED = 2


@dataclass
class Sample:
    """One dataset item before batching."""

    features: np.ndarray  # [T] raw audio or [T, F]
    length: int
    language_id: int
    attribute_indices: Optional[Dict[str, np.ndarray]] = None  # INDEXED
    raw_labels: Optional[List[List[str]]] = None  # RAW (per engine)
    utterance_id: Optional[str] = None


class PhonemeDataset:
    """Base dataset: audio -> features, phonemes -> per-attribute label ids."""

    _corpus: MultilingualCorpus
    _processor: SamplesProcessor
    _index_start_offset: int
    _features: Optional[List[np.ndarray]]
    _indexer: PhonemeIndexer
    _batch_type: BatchType
    _inventories: Optional[Dict[int, Set[str]]] = None

    def phoneme_count(self) -> int:
        return len(self._processor.attribute_indexer)

    @property
    def corpus(self) -> MultilingualCorpus:
        return self._corpus

    @property
    def unrestricted_inventory(self) -> bool:
        return True

    @property
    def indexer(self) -> PhonemeIndexer:
        return self._indexer

    @property
    def batch_type(self) -> BatchType:
        return self._batch_type

    def __len__(self) -> int:
        return len(self._corpus)

    def _filter_with_inventory(self, language_id: int, segmented_entries: Iterable[List[str]]):
        inventories = self._inventories
        if inventories is None:
            return segmented_entries
        inventory = inventories[language_id]
        return (
            [phoneme for phoneme in sentence if phoneme in inventory] for sentence in segmented_entries
        )

    def _indexed_labels(
        self, language_id: int, segmented_entries: Iterable[List[str]]
    ) -> Dict[str, np.ndarray]:
        """Per-attribute label sequence for exactly one transcription, blank offset
        applied. Indexed (CTC) targets require a single G2P engine — concatenating
        several engines' transcriptions would silently train on doubled targets;
        the reference enforces the same via single-element unpacking
        (reference estimator.py:636)."""
        entries = list(segmented_entries)
        if len(entries) != 1:
            raise ValueError(
                f"Indexed label generation expects exactly one transcription per"
                f" utterance, got {len(entries)} (was the corpus transcribed with"
                " multiple G2P engines?)"
            )
        (filtered,) = self._filter_with_inventory(language_id, entries)
        return self._indexer.get_named(
            self._indexer.phoneme_indices(filtered), self._index_start_offset
        )

    def _entry_segments(self, item: IndexedEntry) -> Iterable[List[str]]:
        raise NotImplementedError

    def feature_length(self, num_samples: int) -> int:
        """The feature frames of an item of ``num_samples`` audio samples (of
        precomputed features: their length as it is)."""
        if self._features is not None:
            return int(num_samples)
        return self._processor.feature_function.frame_count(int(num_samples))

    def sample_labels(self, index: int) -> Dict[str, np.ndarray]:
        """Per-attribute label ids for one item *without* touching audio — used by
        multi-host batching, where every process needs global label pad targets but
        loads only its own slice's audio."""
        item = self._corpus[index]
        return self._indexed_labels(item.language_id, self._entry_segments(item))

    def _generate_sample(self, index: int, item: IndexedEntry, segmented_entries: Iterable[List[str]]) -> Sample:
        language_id = item.language_id
        if self._features is None:
            features = self._processor.feature_function(self._corpus.audio_for(item)[0])
        else:
            features = np.asarray(self._features[index])
            if features.ndim > 1 and features.shape[1] == 1:
                features = features[:, 0]
        length = features.shape[0]

        if self._batch_type == BatchType.UNLABELED:
            return Sample(features, length, language_id)
        if self._batch_type == BatchType.INDEXED:
            attribute_indices = self._indexed_labels(language_id, segmented_entries)
            return Sample(features, length, language_id, attribute_indices=attribute_indices)
        # RAW
        return Sample(
            features,
            length,
            language_id,
            raw_labels=[list(entry) for entry in self._filter_with_inventory(language_id, segmented_entries)],
            utterance_id=item.entry.utterance_id,
        )


class TranscribedDataset(PhonemeDataset):
    """G2P-transcribed corpora (Common Voice): flattened per-engine transcriptions."""

    def __init__(
        self,
        batch_type: BatchType,
        corpus: MultilingualCorpus,
        processor: SamplesProcessor,
        index_start_offset: int = 0,
        features: Optional[List[np.ndarray]] = None,
        inventories: Optional[Dict[int, Set[str]]] = None,
        unrestricted_inventory: bool = False,
    ) -> None:
        self._batch_type = batch_type
        self._corpus = corpus
        self._processor = processor
        self._index_start_offset = index_start_offset
        self._features = features
        self._inventories = inventories
        self._unrestricted_inventory = unrestricted_inventory
        self._indexer = (
            processor.attribute_indexer.full_subset_attributes
            if unrestricted_inventory
            else processor.attribute_indexer
        )

    @property
    def unrestricted_inventory(self) -> bool:
        return self._unrestricted_inventory

    def _entry_segments(self, item: IndexedEntry) -> Iterable[List[str]]:
        return item.entry.phonemes.flattened_transcriptions()

    def __getitem__(self, index: int) -> Sample:
        item = self._corpus[index]
        return self._generate_sample(index, item, self._entry_segments(item))


class PhoneticallySegmentedDataset(PhonemeDataset):
    """Pre-segmented corpora (UCLA): a single phone sequence per utterance; always
    uses the unrestricted target inventory."""

    def __init__(
        self,
        batch_type: BatchType,
        corpus: MultilingualCorpus,
        processor: SamplesProcessor,
        index_start_offset: int = 0,
        features: Optional[List[np.ndarray]] = None,
        inventories: Optional[Dict[int, Set[str]]] = None,
    ) -> None:
        self._batch_type = batch_type
        self._corpus = corpus
        self._processor = processor
        self._index_start_offset = index_start_offset
        self._features = features
        self._inventories = inventories
        self._indexer = processor.attribute_indexer.full_subset_attributes

    def _entry_segments(self, item: IndexedEntry) -> Iterable[List[str]]:
        return (item.entry.phonemes,)

    def __getitem__(self, index: int) -> Sample:
        item = self._corpus[index]
        return self._generate_sample(index, item, self._entry_segments(item))
