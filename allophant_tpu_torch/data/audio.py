"""Audio loading, duration probing and sinc resampling — no torchaudio/mutagen
(the port's copy of ``allophant_tpu/data/audio.py``). MP3 goes through the
system libmpg123 (``native/audio_codecs.py``).

Counterparts:
- ``load_audio`` replaces ``torchaudio.load`` (reference speech_corpus.py:265-297):
  stdlib WAV parsing (PCM 8/16/24/32-bit and float32) returning channel-first float32.
- ``resample_sinc`` replicates torchaudio's windowed-sinc resampling math
  (hann-windowed lowpass, ``lowpass_filter_width=6``, ``rolloff=0.99``; output length
  ``ceil(target * n / orig)``) so lengths and values match the reference pipeline.
- ``probe_duration`` replaces the mutagen-based length estimation
  (speech_corpus.py:421-449): WAV headers read exactly; MP3 durations estimated by
  frame-header scanning (Xing/VBRI aware)."""

from __future__ import annotations

import math
import os
import struct
import wave
from typing import Optional, Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Reads a WAV file to float32 [channels, samples] plus its sample rate."""
    with open(path, "rb") as file:
        header = file.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path!r}")
        audio_format = None
        channels = rate = bits = None
        data = None
        while True:
            chunk_header = file.read(8)
            if len(chunk_header) < 8:
                break
            chunk_id, size = struct.unpack("<4sI", chunk_header)
            if chunk_id == b"fmt ":
                fmt = file.read(size)
                audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
                # WAVE_FORMAT_EXTENSIBLE: actual format in the extension.
                if audio_format == 0xFFFE and size >= 40:
                    audio_format = struct.unpack("<H", fmt[24:26])[0]
            elif chunk_id == b"data":
                data = file.read(size)
            else:
                file.seek(size + (size & 1), 1)
            if data is not None and audio_format is not None:
                break
        if data is None or audio_format is None:
            raise ValueError(f"Missing fmt/data chunk in {path!r}")

    if audio_format == 1:  # PCM
        if bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            values = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            values = np.where(values >= 1 << 23, values - (1 << 24), values)
            samples = values.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format code: {audio_format}")

    if channels and channels > 1:
        samples = samples.reshape(-1, channels).T
    else:
        samples = samples[None, :]
    return np.ascontiguousarray(samples), int(rate)


def load_audio(path: str, resample_to: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Loads an audio file to float32 [channels, samples]; optionally resampled.
    Returns (audio, original sample rate)."""
    lower = str(path).lower()
    if lower.endswith(".wav"):
        audio, rate = load_wav(path)
    elif lower.endswith(".mp3"):
        audio, rate = _load_mp3(path)
    else:
        raise ValueError(f"Unsupported audio format: {path!r}")
    if resample_to is not None and rate != resample_to:
        audio = resample_sinc(audio, rate, resample_to)
    return audio, rate


def _load_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decodes MP3 via the system libmpg123 (ctypes binding,
    ``native/audio_codecs.py``) — the path Common Voice clips take
    (reference: torchaudio.load, speech_corpus.py:178-181)."""
    from allophant_tpu_torch.native.audio_codecs import decode_mp3

    return decode_mp3(path)


_RESAMPLE_KERNEL_CACHE: dict = {}


def _sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> Tuple[np.ndarray, int]:
    """Hann-windowed sinc interpolation kernel, matching torchaudio's
    ``_get_sinc_resample_kernel``: per output phase ``new_freq // gcd`` filters of
    width ``2 * ceil(lowpass_filter_width * orig / base) + 1`` applied with stride
    ``orig_freq // gcd``. Returns (kernels [new, width], width)."""
    key = (orig_freq, new_freq, lowpass_filter_width, rolloff)
    cached = _RESAMPLE_KERNEL_CACHE.get(key)
    if cached is not None:
        return cached

    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    # torchaudio: idx spans [-width, width + orig) in steps of 1, per output phase i:
    # t = (-i/new + idx/orig) * base_freq, clamped to [-width_f, width_f].
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * scale
    result = (kernels.astype(np.float32), width)
    _RESAMPLE_KERNEL_CACHE[key] = result
    return result


def resample_sinc(
    audio: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Windowed-sinc resampling with torchaudio's exact output-length semantics:
    ``ceil(new_freq * length / orig_freq)``. ``audio``: [..., samples]."""
    if orig_freq == new_freq:
        return audio
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd

    kernels, width = _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    kernel_width = kernels.shape[1]

    shape = audio.shape
    flat = audio.reshape(-1, shape[-1]).astype(np.float32)
    length = flat.shape[1]
    padded = np.pad(flat, ((0, 0), (width, width + orig)))

    # Strided frame view: frames every `orig` samples of width `kernel_width`.
    num_frames = (padded.shape[1] - kernel_width) // orig + 1
    strides = (padded.strides[0], orig * padded.strides[1], padded.strides[1])
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(padded.shape[0], num_frames, kernel_width), strides=strides
    )
    # [C, F, W] x [N, W] -> [C, N, F] -> interleave phases -> [C, F*N]
    outputs = np.einsum("cfw,nw->cnf", frames, kernels)
    resampled = outputs.transpose(0, 2, 1).reshape(flat.shape[0], -1)

    target_length = int(math.ceil(new * length / orig))
    resampled = resampled[:, :target_length]
    return resampled.reshape(*shape[:-1], target_length)


def probe_wav(path: str) -> Tuple[float, int]:
    """(duration seconds, sample rate) from a WAV header without decoding."""
    with wave.open(path, "rb") as file:
        rate = file.getframerate()
        return file.getnframes() / rate, rate


_MP3_BITRATES = {
    # MPEG1 Layer III bitrate table (kbps)
    1: [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320],
    # MPEG2/2.5 Layer III
    2: [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
}
_MP3_RATES = {3: [44100, 48000, 32000], 2: [22050, 24000, 16000], 0: [11025, 12000, 8000]}


def probe_mp3(path: str) -> Tuple[float, int]:
    """Estimates (duration seconds, sample rate) of an MP3 by frame-header scanning,
    honoring Xing/Info VBR headers when present. Reads only a bounded prefix — the
    sync word, Xing/Info tag, and bitrate all live in the first frame, and the CBR
    fallback needs just the total byte count (corpus-wide length probing must not
    read whole files)."""
    file_size = os.path.getsize(path)
    with open(path, "rb") as file:
        prefix = file.read(10)
        id3_end = 0
        if prefix[:3] == b"ID3" and len(prefix) == 10:
            size = (prefix[6] << 21) | (prefix[7] << 14) | (prefix[8] << 7) | prefix[9]
            id3_end = 10 + size
            file.seek(id3_end)
            data = file.read(1 << 16)
        else:
            data = prefix + file.read((1 << 16) - len(prefix))

    # Find first frame sync within the prefix window.
    offset = 0
    while offset < len(data) - 4:
        if data[offset] == 0xFF and (data[offset + 1] & 0xE0) == 0xE0:
            break
        offset += 1
    if offset >= len(data) - 4:
        raise ValueError(f"No MP3 frame found in {path!r}")

    header = data[offset : offset + 4]
    version_bits = (header[1] >> 3) & 0x3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    bitrate_index = (header[2] >> 4) & 0xF
    rate_index = (header[2] >> 2) & 0x3
    sample_rate = _MP3_RATES.get(version_bits, [44100, 48000, 32000])[rate_index]
    samples_per_frame = 1152 if version_bits == 3 else 576

    # Xing/Info header gives exact frame counts for VBR files.
    for probe_at in (offset + 36, offset + 21, offset + 13):
        tag = data[probe_at : probe_at + 4]
        if tag in (b"Xing", b"Info"):
            flags = struct.unpack(">I", data[probe_at + 4 : probe_at + 8])[0]
            if flags & 1:
                frames = struct.unpack(">I", data[probe_at + 8 : probe_at + 12])[0]
                return frames * samples_per_frame / sample_rate, sample_rate
            break

    table = _MP3_BITRATES[1 if version_bits == 3 else 2]
    bitrate = table[bitrate_index] * 1000
    if bitrate == 0:
        raise ValueError(f"Cannot estimate duration for free-format MP3 {path!r}")
    audio_bytes = file_size - id3_end - offset
    return audio_bytes * 8 / bitrate, sample_rate


def probe_duration(path: str) -> Tuple[float, int]:
    """(duration seconds, sample rate) without decoding the audio."""
    lower = str(path).lower()
    if lower.endswith(".wav"):
        return probe_wav(path)
    if lower.endswith(".mp3"):
        return probe_mp3(path)
    raise ValueError(f"Unsupported audio format: {path!r}")


def estimated_resampled_length(duration_seconds: float, file_rate: int, target_rate: int) -> int:
    """Sample count after resampling, matching the reference's mutagen math
    (speech_corpus.py:437-441): ``ceil(target * duration * rate / rate)``."""
    original_samples = duration_seconds * file_rate
    return int(math.ceil((target_rate * original_samples) / file_rate))
