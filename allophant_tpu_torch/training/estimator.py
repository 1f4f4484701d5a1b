"""Estimator, inference side (counterpart of the prediction surface of
``allophant_tpu/training/estimator.py``): bucketed ``predict``, the fused greedy
serving step ``predict_decoded``, the fused beam serving step
``predict_beam_decoded``, ``map_allophones`` and ``downsampled_lengths``.

PyTorch runs eagerly, so there is no per-bucket compile cache; the audio is
still bucketed exactly as the JAX estimator buckets it, because the width of
the decoded grid depends on the bucket."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.device import resolve_device, set_float32_precision
from allophant_tpu_torch.models.allophant import AllophantModel, Predictions
from allophant_tpu_torch.models.projection import PHONE, PHONEME_LAYER
from allophant_tpu_torch.ops.decode import beam_search_heads, greedy_decode_padded

#: Serving precision presets: name -> (dtype, head_dtype, f32_matmul_precision).
#: "float32" is full f32 (TF32 off for matmuls and cuDNN convolutions).
#: "mixed" runs the encoder in bf16 and the classifier head, composition and
#: allophone matmuls and log_softmax in f32. "float32_high" keeps f32
#: activations with TF32 matmuls and convolutions on the GPU — not the TPU's
#: 3-pass bf16 lowering that the JAX preset of the same name selects.
PRECISION_PRESETS = {
    "float32": (torch.float32, None, "highest"),
    "float32_high": (torch.float32, None, "high"),
    "mixed": (torch.bfloat16, torch.float32, "highest"),
    "bfloat16": (torch.bfloat16, None, "highest"),
}

#: The preset a serving estimator uses when the caller names none.
DEFAULT_SERVING_PRECISION = "mixed"

#: The CTC blank's class index: every head's classes are offset by one blank.
BLANK_INDEX = 0


def resolve_precision(precision: str):
    try:
        return PRECISION_PRESETS[precision]
    except KeyError:
        raise ValueError(
            f"Unknown precision preset {precision!r} (expected one of {sorted(PRECISION_PRESETS)})"
        ) from None


def _bucket_length(length: int, minimum: int = 1024) -> int:
    """Rounds a sequence length up to its bucket: powers of two below 64k
    samples, then multiples of 32k (2 s at 16 kHz)."""
    length = max(length, minimum)
    if length <= 65_536:
        return 1 << (length - 1).bit_length()
    step = 32_768
    return ((length + step - 1) // step) * step


class Estimator:
    """A model on a device with its precision preset, answering predictions."""

    def __init__(
        self,
        model: AllophantModel,
        precision: str = DEFAULT_SERVING_PRECISION,
        device=None,
    ):
        self.device = resolve_device(device)
        dtype, head_dtype, f32_matmul_precision = resolve_precision(precision)
        if model.dtype != dtype or model.head_dtype != (dtype if head_dtype is None else head_dtype):
            raise ValueError(f"Model dtypes ({model.dtype}, {model.head_dtype}) do not match preset {precision!r}")
        self.precision = precision
        self.f32_matmul_precision = f32_matmul_precision
        self.model = model.to(self.device).eval()

    @property
    def classes(self):
        return self.model.classes

    def _inputs(self, batch: Batch, target_feature_indices):
        """Bucket-pads the audio (as ``_padded`` in the JAX estimator) and moves
        the batch to the device."""
        audio = np.asarray(batch.audio_features, dtype=np.float32)
        target = _bucket_length(audio.shape[1])
        if audio.shape[1] < target:
            audio = np.pad(audio, [(0, 0), (0, target - audio.shape[1])])
        device = self.device
        inputs = (
            torch.from_numpy(audio).to(device),
            torch.from_numpy(np.asarray(batch.lengths, dtype=np.int64)).to(device),
            torch.from_numpy(np.asarray(batch.language_ids, dtype=np.int64)).to(device),
        )
        if target_feature_indices is not None:
            target_feature_indices = torch.as_tensor(np.asarray(target_feature_indices), dtype=torch.long, device=device)
        return inputs, target_feature_indices

    def _forward(self, batch: Batch, target_feature_indices) -> Tuple[Predictions, torch.Tensor]:
        set_float32_precision(self.f32_matmul_precision)
        (audio, lengths, language_ids), target_feature_indices = self._inputs(batch, target_feature_indices)
        predictions = self.model(audio, lengths, language_ids, target_feature_indices, predict=True)
        return predictions, language_ids

    @torch.inference_mode()
    def predict(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        log_probabilities: bool = True,
        time_major: bool = True,
    ) -> Predictions:
        """Per-task outputs, time-first [T, B, C] by default (batch-first with
        ``time_major=False``); log-probabilities are taken in f32 on every path."""
        predictions, _ = self._forward(batch, target_feature_indices)
        outputs = predictions.outputs
        if log_probabilities:
            outputs = {name: torch.log_softmax(value.float(), dim=-1) for name, value in outputs.items()}
        if time_major:
            outputs = {name: value.transpose(0, 1) for name, value in outputs.items()}
        return Predictions(outputs, predictions.lengths)

    @torch.inference_mode()
    def predict_decoded(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        heads: Tuple[str, ...] = (),
        map_allophones: bool = False,
    ):
        """Fused greedy serving step: returns (grid, lengths) device tensors where
        ``grid`` is uint16 [H, B, T'+1] — per head ``heads[h]``, row b: column 0
        the decoded token count, columns 1.. the blank-free collapsed token ids
        (0 past the count)."""
        predictions, language_ids = self._forward(batch, target_feature_indices)
        outputs = dict(predictions.outputs)
        if map_allophones:
            # Map log-probs, not raw logits: the allophone max-pool multiplies by
            # learned weights, so its argmax is not invariant to log_softmax.
            outputs[PHONEME_LAYER] = self.model.map_allophones(
                torch.log_softmax(outputs[PHONE].float(), dim=-1), language_ids
            )
        lanes = []
        for name in heads:
            # Per-head greedy argmax is invariant to log_softmax (a per-frame
            # shift), so plain heads decode raw outputs.
            tokens, _timesteps, counts, _scores = greedy_decode_padded(
                outputs[name], predictions.lengths, BLANK_INDEX
            )
            lanes.append(torch.cat((counts[:, None], tokens.clamp_min(0)), dim=1).to(torch.int32))
        return torch.stack(lanes).to(torch.uint16), predictions.lengths

    @torch.inference_mode()
    def predict_beam_decoded(
        self,
        batch: Batch,
        target_feature_indices: Optional[np.ndarray] = None,
        heads: Tuple[str, ...] = (),
        beam_width: int = 4,
        map_allophones: bool = False,
    ):
        """Fused beam serving step: returns device tensors ``(collected, scores,
        lengths)`` where ``collected`` is int16 [H, T, B, K] (the token emitted
        at step t by beam k of row b for head ``heads[h]``, -1 = none) and
        ``scores`` is f32 [H, B, K].

        Every head decodes f32 log-probs, since the reported beam scores are
        not invariant to log_softmax; with ``map_allophones`` the phoneme layer
        is the allophone map of the phone head's log-probs. Heads of equal
        class count share one search launch (``beam_search_heads``)."""
        predictions, language_ids = self._forward(batch, target_feature_indices)
        outputs = {name: torch.log_softmax(value.float(), dim=-1) for name, value in predictions.outputs.items()}
        if map_allophones:
            outputs[PHONEME_LAYER] = self.model.map_allophones(outputs[PHONE], language_ids)
        collected, scores = beam_search_heads(
            [outputs[name] for name in heads], predictions.lengths, beam_width, BLANK_INDEX
        )
        return collected, scores, predictions.lengths

    def downsampled_lengths(self, lengths) -> np.ndarray:
        """CTC frame counts of audio lengths in samples."""
        return self.model.architecture.downsampled_lengths(np.asarray(lengths))

    @torch.inference_mode()
    def map_allophones(self, phone_logits, language_ids, time_major: bool = True) -> torch.Tensor:
        """Maps phone log-probs to per-language phoneme log-probs (time-first in
        and out by default; ``time_major=False`` for batch-first)."""
        phone_logits = torch.as_tensor(phone_logits, device=self.device)
        batch_first = phone_logits.transpose(0, 1) if time_major else phone_logits
        language_ids = torch.as_tensor(np.asarray(language_ids), dtype=torch.long, device=self.device)
        mapped = self.model.map_allophones(batch_first, language_ids)
        return mapped.transpose(0, 1) if time_major else mapped
