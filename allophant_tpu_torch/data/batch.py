"""Batch containers crossing the host->device boundary (counterpart of
``allophant_tpu/data/batch.py``; the reference's is
allophant/dataset_processing.py:49-162). Arrays stay numpy on the host; the
Estimator and the training loop move them to the device. Labeled batches
carry statically padded label id arrays per attribute."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np


@dataclass
class Batch:
    """Inference batch: padded audio (or features), true lengths and language ids.

    ``audio_features``: [B, T] raw audio or [B, T, F] features; ``lengths``: [B];
    ``language_ids``: [B] (a scalar broadcasts, matching the reference README usage
    ``Batch(audio, lengths, language_ids=0)``)."""

    audio_features: np.ndarray
    lengths: np.ndarray
    language_ids: np.ndarray

    def __post_init__(self):
        self.audio_features = np.asarray(self.audio_features)
        self.lengths = np.atleast_1d(np.asarray(self.lengths, dtype=np.int32))
        language_ids = np.asarray(self.language_ids, dtype=np.int32)
        if language_ids.ndim == 0:
            language_ids = np.broadcast_to(language_ids, self.lengths.shape).copy()
        self.language_ids = language_ids

    def size(self) -> int:
        return len(self)

    def __len__(self) -> int:
        return int(self.lengths.size)

    def __repr__(self) -> str:
        return "{}(Features: ({}; {}))".format(
            self.__class__.__name__, self.audio_features.shape, self.audio_features.dtype
        )


@dataclass
class LabeledBatch(Batch):
    """Training batch: per-attribute padded label id arrays + label lengths.

    ``attribute_indices``: {attribute -> [B, N] int labels (blank offset applied)};
    ``label_lengths``: {attribute -> [B]}."""

    attribute_indices: Dict[str, np.ndarray] = field(default_factory=dict)
    label_lengths: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class RawLabeledBatch(Batch):
    """Evaluation batch carrying raw string labels and utterance ids."""

    raw_labels: List[List[List[str]]] = field(default_factory=list)
    utterance_ids: List[str] = field(default_factory=list)

    def split_by_language(self) -> Iterator[Tuple[int, "RawLabeledBatch"]]:
        """Splits a batch into per-language consecutive runs, cropping audio to each
        run's max length (reference dataset_processing.py:103-126)."""
        language_ids = self.language_ids
        boundaries = [0]
        for index in range(1, len(language_ids)):
            if language_ids[index] != language_ids[index - 1]:
                boundaries.append(index)
        boundaries.append(len(language_ids))

        for start, end in zip(boundaries[:-1], boundaries[1:]):
            lengths = self.lengths[start:end]
            max_length = int(lengths.max())
            yield (
                int(language_ids[start]),
                RawLabeledBatch(
                    self.audio_features[start:end, :max_length],
                    lengths,
                    language_ids[start:end],
                    [labels[start:end] for labels in self.raw_labels],
                    self.utterance_ids[start:end],
                ),
            )
