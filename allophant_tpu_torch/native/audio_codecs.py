"""MP3 decode/encode via the system mpg123 / LAME C libraries (ctypes); the
port's copy of ``allophant_tpu/native/audio_codecs.py``.

The reference loads Common Voice MP3 clips through torchaudio's C++ backends
(speech_corpus.py:178-181 -> torchaudio.load). The port needs neither
torchaudio nor ffmpeg: it binds the system ``libmpg123`` (decoder) and
``libmp3lame`` (encoder) directly, which must be installed to read or write
MP3. ``decode_mp3`` is the production path (Common Voice training
data); ``encode_mp3`` exists for tools and test fixtures.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

# mpg123.h constants
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ENC_SIGNED_16 = 0xD0


def _load_library(*names: str) -> Optional[ctypes.CDLL]:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".")[0].removeprefix("lib"))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            return None
    return None


_mpg123 = _load_library("libmpg123.so.0", "libmpg123.so")
_lame = _load_library("libmp3lame.so.0", "libmp3lame.so")

MPG123_AVAILABLE = _mpg123 is not None
LAME_AVAILABLE = _lame is not None

if _mpg123 is not None:
    _mpg123.mpg123_new.restype = ctypes.c_void_p
    _mpg123.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    _mpg123.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _mpg123.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _mpg123.mpg123_format_none.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_format_all.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_format.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
    ]
    _mpg123.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    _mpg123.mpg123_close.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_delete.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_plain_strerror.restype = ctypes.c_char_p
    _mpg123.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    try:
        _mpg123.mpg123_init()
    except AttributeError:  # newer libmpg123 auto-initializes
        pass


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decodes an MP3 file to float32 samples: ([channels, samples], rate)."""
    if _mpg123 is None:
        raise NotImplementedError(
            "MP3 decoding requires libmpg123, which was not found on this system"
            f" (file: {path!r}). Convert clips to WAV first."
        )
    error = ctypes.c_int(0)
    handle = _mpg123.mpg123_new(None, ctypes.byref(error))
    if not handle:
        raise RuntimeError(f"mpg123_new failed: {_mpg123.mpg123_plain_strerror(error.value).decode()}")
    try:
        # The output format must be locked before the stream starts decoding:
        # allow only float32 (any standard rate, mono or stereo). Falls back to
        # s16 below if this build has no float synthesis.
        _mpg123.mpg123_format_none(handle)
        float_supported = False
        for standard_rate in (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000):
            for num_channels in (1, 2):
                if (
                    _mpg123.mpg123_format(handle, standard_rate, num_channels, _MPG123_ENC_FLOAT_32)
                    == _MPG123_OK
                ):
                    float_supported = True
        if not float_supported:
            # Restrict the fallback to signed 16-bit explicitly: format_all
            # would let mpg123 negotiate u8/s32/etc., which frombuffer below
            # would silently misinterpret.
            for standard_rate in (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000):
                for num_channels in (1, 2):
                    _mpg123.mpg123_format(handle, standard_rate, num_channels, _MPG123_ENC_SIGNED_16)

        if _mpg123.mpg123_open(handle, path.encode()) != _MPG123_OK:
            raise FileNotFoundError(f"mpg123 could not open {path!r}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        status = _mpg123.mpg123_getformat(
            handle, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        if status != _MPG123_OK:
            raise RuntimeError(f"mpg123_getformat failed for {path!r}")
        if encoding.value not in (_MPG123_ENC_FLOAT_32, _MPG123_ENC_SIGNED_16):
            raise RuntimeError(
                f"mpg123 negotiated unsupported encoding 0x{encoding.value:x} for {path!r};"
                " only float32 and signed 16-bit output are handled"
            )
        is_float = encoding.value == _MPG123_ENC_FLOAT_32

        chunks = []
        buffer = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        sample_dtype = np.float32 if is_float else np.int16
        while True:
            status = _mpg123.mpg123_read(handle, buffer, len(buffer), ctypes.byref(done))
            if done.value:
                # buffer.raw[:n] already materializes fresh bytes; frombuffer
                # over them needs no further copy.
                chunks.append(np.frombuffer(buffer.raw[: done.value], dtype=sample_dtype))
            if status == _MPG123_DONE:
                break
            if status == _MPG123_NEW_FORMAT:
                # A mid-stream rate/channel change would silently corrupt the
                # interleaving math below; reject rather than mis-decode.
                new_rate = ctypes.c_long(0)
                new_channels = ctypes.c_int(0)
                new_encoding = ctypes.c_int(0)
                _mpg123.mpg123_getformat(
                    handle, ctypes.byref(new_rate), ctypes.byref(new_channels), ctypes.byref(new_encoding)
                )
                if (new_rate.value, new_channels.value, new_encoding.value) != (
                    rate.value,
                    channels.value,
                    encoding.value,
                ):
                    raise RuntimeError(
                        f"MP3 stream format changes mid-file in {path!r}"
                        f" ({rate.value} Hz x{channels.value} ->"
                        f" {new_rate.value} Hz x{new_channels.value}); re-encode the clip"
                    )
            elif status != _MPG123_OK:
                raise RuntimeError(
                    f"mpg123_read failed for {path!r}:"
                    f" {_mpg123.mpg123_plain_strerror(status).decode()}"
                )
        if chunks:
            samples = np.concatenate(chunks)
        else:
            samples = np.zeros(0, dtype=sample_dtype)
        if not is_float:
            samples = samples.astype(np.float32) / 32768.0
        audio = samples.reshape(-1, channels.value).T
        return np.ascontiguousarray(audio), int(rate.value)
    finally:
        _mpg123.mpg123_close(handle)
        _mpg123.mpg123_delete(handle)


if _lame is not None:
    _lame.lame_init.restype = ctypes.c_void_p
    _lame.lame_set_in_samplerate.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lame.lame_set_num_channels.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lame.lame_set_brate.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lame.lame_init_params.argtypes = [ctypes.c_void_p]
    _lame.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    _lame.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    _lame.lame_close.argtypes = [ctypes.c_void_p]


def encode_mp3(path: str, audio: np.ndarray, rate: int, bitrate_kbps: int = 128) -> None:
    """Encodes float32 samples ([channels, samples] or [samples]) to an MP3 file."""
    if _lame is None:
        raise NotImplementedError("MP3 encoding requires libmp3lame, which was not found")
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, num_samples = audio.shape
    if channels > 2:
        raise ValueError(f"MP3 supports at most 2 channels, got {channels}")
    audio = np.ascontiguousarray(audio.astype(np.float32))

    handle = _lame.lame_init()
    if not handle:
        raise RuntimeError("lame_init failed")
    try:
        _lame.lame_set_in_samplerate(handle, rate)
        _lame.lame_set_num_channels(handle, channels)
        _lame.lame_set_brate(handle, bitrate_kbps)
        if _lame.lame_init_params(handle) < 0:
            raise RuntimeError("lame_init_params failed")

        left = audio[0]
        right = audio[1] if channels == 2 else audio[0]
        out_size = int(1.25 * num_samples + 7200)
        out = ctypes.create_string_buffer(out_size)
        written = _lame.lame_encode_buffer_ieee_float(
            handle,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            num_samples,
            out,
            out_size,
        )
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({written})")
        with open(path, "wb") as file:
            file.write(out.raw[:written])
            flushed = _lame.lame_encode_flush(handle, out, out_size)
            if flushed > 0:
                file.write(out.raw[:flushed])
    finally:
        _lame.lame_close(handle)
