"""Inference batch container (counterpart of ``allophant_tpu/data/batch.py:Batch``).

Arrays stay numpy on the host; the Estimator moves them to its device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    """Padded audio, true lengths and language ids.

    ``audio_features``: [B, T] raw audio; ``lengths``: [B]; ``language_ids``: [B]
    (a scalar broadcasts to every row)."""

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

    def __len__(self) -> int:
        return int(self.lengths.size)
