"""Kaldi-style log-mel filterbank of w2v-BERT 2.0's front end (Seamless's
``SeamlessM4TFeatureExtractor``), on the device, batched over padded rows.

For each row of ``[B, S]`` audio in [-1, 1] and its length in samples:

- the signal times 2^15 (Kaldi reads 16-bit integers);
- frames of 400 samples every 160, none past the row's last sample (no
  centring): ``1 + (length - 400) // 160`` of them;
- each frame's mean removed, pre-emphasis 0.97 (the first sample times
  0.03), the povey window ``hann(400) ** 0.85``;
- the power spectrum of a 512-point real FFT;
- 80 mel bins on Kaldi's scale (``1127 ln(1 + f / 700)``) from 20 Hz to
  8 kHz, triangles drawn in mel space, and ``log`` with a floor of 2^-23;
- each bin normalised over the row's own frames: the mean, and the variance
  with one degree of freedom taken off;
- pairs of frames stacked into 160 features, an odd last frame dropped.

Everything is float32: the extractor computes in float64 and keeps the
spectrum in complex64, so the two part by float32 rounding. Frames past a
row's length are zero; a row's odd last frame stays in the first half of a
pair past its encoder frames, as in the extractor's padded output. The work
is small beside the encoder's (a 512-point FFT and a [257, 80] product a
frame), so it is plain PyTorch."""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16_000
FRAME_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
PREEMPHASIS = 0.97
MIN_FREQUENCY = 20.0
LOG_FLOOR = 1.192092955078125e-07
VARIANCE_EPS = 1e-7
PCM_SCALE = 2.0**15


def _kaldi_mel(hertz):
    return 1127.0 * np.log(1.0 + hertz / 700.0)


def mel_filters(num_mel_bins: int) -> np.ndarray:
    """The [257, num_mel_bins] triangular filters, float64: centres evenly
    spaced on Kaldi's mel scale from 20 Hz to the Nyquist frequency, each
    triangle drawn over the FFT bins' mel values."""
    centres = np.linspace(_kaldi_mel(MIN_FREQUENCY), _kaldi_mel(SAMPLE_RATE / 2), num_mel_bins + 2)
    bins = _kaldi_mel(SAMPLE_RATE / FFT_LENGTH * np.arange(FFT_LENGTH // 2 + 1))
    slopes = centres[None, :] - bins[:, None]
    widths = np.diff(centres)
    down = -slopes[:, :-2] / widths[:-1]
    up = slopes[:, 2:] / widths[1:]
    return np.maximum(0.0, np.minimum(down, up))


def povey_window() -> np.ndarray:
    """Kaldi's povey window of one frame, float64: a symmetric Hann window to
    the power 0.85."""
    return np.hanning(FRAME_LENGTH) ** 0.85


@lru_cache(maxsize=8)
def _tables(num_mel_bins: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window [400], filters [257, num_mel_bins]) as float32 on ``device``."""
    window = torch.as_tensor(povey_window(), dtype=torch.float32, device=device)
    filters = torch.as_tensor(mel_filters(num_mel_bins), dtype=torch.float32, device=device)
    return window, filters


def frame_count(lengths):
    """Filterbank frames of rows of ``lengths`` samples (0 below one frame);
    works on tensors, numpy arrays and ints."""
    frames = (lengths - FRAME_LENGTH) // HOP_LENGTH + 1
    return frames.clip(min=0) if hasattr(frames, "clip") else max(frames, 0)


def stacked_lengths(lengths, stride: int = 2):
    """Encoder frames of rows of ``lengths`` samples: whole stacks of
    ``stride`` filterbank frames."""
    return frame_count(lengths) // stride


def log_mel(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """[B, S] audio -> [B, F, num_mel_bins] float32 log-mel energies of
    every frame that fits in the padded width (frames past a row's length
    read its padding; the caller masks them)."""
    window, filters = _tables(num_mel_bins, audio.device)
    frames = (audio.float() * PCM_SCALE).unfold(1, FRAME_LENGTH, HOP_LENGTH)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat(
        (frames[..., :1] * (1.0 - PREEMPHASIS), frames[..., 1:] - PREEMPHASIS * frames[..., :-1]), dim=-1
    )
    spectrum = torch.fft.rfft(frames * window, n=FFT_LENGTH)
    power = spectrum.real.square() + spectrum.imag.square()
    return (power @ filters).clamp_min(LOG_FLOOR).log()


def normalised_stack(energies: torch.Tensor, frames: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Per-row, per-bin normalisation of [B, F, C] ``energies`` over each
    row's first ``frames`` frames (mean, and variance over n - 1), padded
    frames zeroed, then every ``stride`` frames stacked: [B, F // stride,
    stride * C]."""
    batch, count, bins = energies.shape
    valid = (torch.arange(count, device=energies.device)[None, :] < frames[:, None]).to(energies.dtype)[..., None]
    total = frames.to(energies.dtype)[:, None, None]
    mean = (energies * valid).sum(dim=1, keepdim=True) / total.clamp_min(1.0)
    centred = (energies - mean) * valid
    variance = centred.square().sum(dim=1, keepdim=True) / (total - 1.0).clamp_min(1.0)
    normalised = centred / torch.sqrt(variance + VARIANCE_EPS)
    pairs = count // stride
    return normalised[:, : pairs * stride].reshape(batch, pairs, stride * bins)


def kaldi_fbank(audio: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 80, stride: int = 2):
    """(features [B, F // stride, stride * num_mel_bins] float32, encoder
    frame lengths [B]) of padded ``audio`` [B, S] in [-1, 1] and its lengths
    in samples; all on ``audio``'s device."""
    frames = frame_count(lengths)
    if audio.shape[1] < FRAME_LENGTH:
        audio = torch.nn.functional.pad(audio, (0, FRAME_LENGTH - audio.shape[1]))
    features = normalised_stack(log_mel(audio, num_mel_bins), frames, stride)
    return features, frames // stride
