"""Zstandard decompression through the port's own decoder
(``native/src/zstd_decoder.cpp``, RFC 8878), bound with ctypes.

The Orbax checkpoint reader needs it twice over: tensorstore's OCDBT store
compresses its manifests and B-tree nodes with zstd, and Orbax's zarr arrays
compress each chunk with it. The decoder is compiled with the rest of the
port's C++ core (``native/build.py``) on first use; there is no pure-Python
fallback, and a failed build raises with the compiler's message."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["ZstdError", "decompress", "decompress_into", "content_size"]


class ZstdError(ValueError):
    """A frame the decoder cannot read: corrupt, a checksum that does not
    match, or one that needs a dictionary."""


_LIBRARY = None
_LOCK = threading.Lock()


def _library():
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            from allophant_tpu_torch.native.build import library_path

            library = ctypes.CDLL(str(library_path()))
            library.allophant_zstd_content_size.restype = ctypes.c_int64
            library.allophant_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            library.allophant_zstd_decompress.restype = ctypes.c_int64
            library.allophant_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            library.allophant_zstd_decompress_grown.restype = ctypes.c_void_p
            library.allophant_zstd_decompress_grown.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            library.allophant_zstd_free.restype = None
            library.allophant_zstd_free.argtypes = [ctypes.c_void_p]
            library.allophant_zstd_error.restype = ctypes.c_char_p
            library.allophant_zstd_error.argtypes = []
            _LIBRARY = library
    return _LIBRARY


def _source(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)[:0]


def _error(library) -> ZstdError:
    return ZstdError(library.allophant_zstd_error().decode())


def content_size(data) -> int | None:
    """The decoded size that the frames of ``data`` declare, or None when a
    frame does not declare it."""
    library = _library()
    source = _source(data)
    size = library.allophant_zstd_content_size(source.ctypes.data, source.size)
    if size == -2:
        raise _error(library)
    return None if size < 0 else int(size)


def decompress_into(data, output: np.ndarray) -> int:
    """Decodes every frame of ``data`` into the contiguous array ``output``
    (viewed as bytes) and returns the bytes written. Raises when the frames
    decode to more than it holds."""
    if not output.flags.c_contiguous:
        raise ValueError("zstd output buffer must be C-contiguous")
    library = _library()
    source = _source(data)
    target = output.reshape(-1).view(np.uint8)
    written = library.allophant_zstd_decompress(source.ctypes.data, source.size, target.ctypes.data, target.size)
    if written < 0:
        raise _error(library)
    return int(written)


def decompress(data) -> bytes:
    """Decodes every zstd frame of ``data`` (skippable frames skipped). The
    output is allocated once when the frames declare their sizes, else grown
    as the frames decode."""
    size = content_size(data)
    if size is not None:
        output = bytearray(size)
        written = decompress_into(data, np.frombuffer(output, np.uint8))
        if written != size:
            raise ZstdError(f"zstd frames decoded to {written} bytes, their headers say {size}")
        return bytes(output)
    library = _library()
    source = _source(data)
    produced = ctypes.c_int64(0)
    pointer = library.allophant_zstd_decompress_grown(source.ctypes.data, source.size, ctypes.byref(produced))
    if not pointer:
        raise _error(library)
    try:
        return ctypes.string_at(pointer, produced.value)
    finally:
        library.allophant_zstd_free(pointer)

