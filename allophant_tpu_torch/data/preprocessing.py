"""Acoustic feature frontend: raw passthrough, MFCC or log-Mel filterbanks.

The port's copy of ``allophant_tpu/data/preprocessing.py``.

Counterpart of the reference's allophant/preprocessing.py, torch-free: STFT features
are computed with numpy following torchaudio's conventions (center reflect padding,
hann window, power spectrum, HTK mel scale) plus the pre-emphasis filter and
instance-norm CMVN of the reference. Released checkpoints use RAW features; the STFT
paths serve the from-scratch transformer configurations."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from allophant_tpu_torch.config import Config, FeatureType, Window


def pre_emphasis(waveform: np.ndarray, coefficient: float = 0.97) -> np.ndarray:
    """y[t] = x[t] - c * x[t-1], with a reflect-padded first sample (matching the
    reference's conv1d([-c, 1]) with symmetric reflect padding; preprocessing.py:16-33)."""
    padded = np.concatenate((waveform[..., 1:2], waveform), axis=-1)
    return padded[..., 1:] - coefficient * padded[..., :-1]


def next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def frame_count(num_samples: int, stride_samples: int) -> int:
    # Matches torch.stft with center=True: 1 + floor(n / hop).
    return 1 + (num_samples // stride_samples)


def _stft_power(waveform: np.ndarray, n_fft: int, win_length: int, hop_length: int) -> np.ndarray:
    """Power spectrogram [frames, n_fft // 2 + 1] with center reflect padding and a
    periodic hann window, following torch.stft conventions."""
    pad = n_fft // 2
    padded = np.pad(waveform, pad, mode="reflect")
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = np.pad(window, (left, n_fft - win_length - left))
    frames = 1 + (len(padded) - n_fft) // hop_length
    indices = np.arange(n_fft)[None, :] + hop_length * np.arange(frames)[:, None]
    segments = padded[indices] * window[None, :]
    spectrum = np.fft.rfft(segments, n=n_fft, axis=1)
    return (spectrum.real**2 + spectrum.imag**2).astype(np.float32)


def _mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, f_min: float = 0.0, f_max: Optional[float] = None
) -> np.ndarray:
    """HTK-scale triangular mel filterbank [n_freqs, n_mels] (torchaudio default:
    mel_scale="htk", norm=None)."""
    if f_max is None:
        f_max = sample_rate / 2

    def hz_to_mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    mel_points = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    freq_points = mel_to_hz(mel_points)
    slopes = freq_points[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / np.maximum(freq_points[1:-1] - freq_points[:-2], 1e-10)
    up = slopes[:, 2:] / np.maximum(freq_points[2:] - freq_points[1:-1], 1e-10)
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal type-II DCT matrix [n_mels, n_mfcc] (torchaudio create_dct)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[None, :]
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k)
    dct[:, 0] *= 1.0 / np.sqrt(2)
    return (dct * np.sqrt(2.0 / n_mels)).astype(np.float32)


def _instance_norm(features: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """CMVN: per-feature mean/variance normalization over time ([frames, features])."""
    mean = features.mean(axis=0, keepdims=True)
    variance = features.var(axis=0, keepdims=True)
    return (features - mean) / np.sqrt(variance + eps)


class FeatureFunction:
    """Per-utterance acoustic feature computation with frame-count bookkeeping."""

    def __init__(
        self,
        name: str,
        function: Callable[[np.ndarray], np.ndarray],
        sample_rate: int,
        feature_size: int = 1,
        window: Optional[Window] = None,
    ):
        self._name = name
        self._function = function
        self._stride_samples = window.frame_stride_samples(sample_rate) if window is not None else None
        self._feature_size = feature_size

    @property
    def name(self) -> str:
        return self._name

    @property
    def feature_size(self) -> int:
        return self._feature_size

    def frame_count(self, num_samples: int) -> int:
        if not self._stride_samples:
            return num_samples
        return frame_count(num_samples, self._stride_samples)

    def __call__(self, waveform: np.ndarray) -> np.ndarray:
        """[channels, samples] -> [frames] (raw) or [frames, features]."""
        return self._function(waveform)

    @classmethod
    def from_config(cls, config: Config, sample_rate: int) -> "FeatureFunction":
        feature_type = config.preprocessing.feature_type
        num_filters = config.preprocessing.num_filters
        n_fft = next_power_of_2(int((1024 / 16_000) * sample_rate))

        if feature_type == FeatureType.RAW:
            return cls("raw", lambda waveform: np.asarray(waveform[0], dtype=np.float32), sample_rate)

        window = config.preprocessing.window
        if window is None:
            raise ValueError(f"{feature_type} features require a preprocessing window configuration")
        win_length = window.frame_duration_samples(sample_rate)
        hop_length = window.frame_stride_samples(sample_rate)
        mel_weights = _mel_filterbank(num_filters, n_fft, sample_rate)

        if feature_type == FeatureType.FILTERBANKS:

            def filterbanks(waveform: np.ndarray) -> np.ndarray:
                emphasized = pre_emphasis(np.asarray(waveform[0], dtype=np.float32))
                power = _stft_power(emphasized, n_fft, win_length, hop_length)
                mel = power @ mel_weights
                return _instance_norm(np.log(mel + 1e-5))

            return cls(feature_type.value, filterbanks, sample_rate, num_filters, window)

        if feature_type == FeatureType.MFCC:
            dct = _dct_matrix(num_filters, num_filters)

            def mfcc(waveform: np.ndarray) -> np.ndarray:
                emphasized = pre_emphasis(np.asarray(waveform[0], dtype=np.float32))
                power = _stft_power(emphasized, n_fft, win_length, hop_length)
                mel = power @ mel_weights
                # torchaudio MFCC with log_mels=False: amplitude_to_DB (power, top_db=80).
                db = 10.0 * np.log10(np.maximum(mel, 1e-10))
                db = np.maximum(db, db.max() - 80.0)
                return _instance_norm(db @ dct)

            return cls(feature_type.value, mfcc, sample_rate, num_filters, window)

        raise ValueError(f"Unsupported feature type: {feature_type}")
