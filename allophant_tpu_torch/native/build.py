"""Builds the port's native C++ core (IPA segmentation, edit distances, the
LZ4 block decoder of the zarr caches and the zstd decoder of Orbax
checkpoints) on first use and caches it (counterpart of
``allophant_tpu/native/build.py``).

``native/src/segmenter.cpp``, ``edit_distance.cpp`` and ``lz4_codec.cpp`` are
the port's own copies of the JAX package's sources; ``zstd_decoder.cpp`` is
the port's own (the JAX package reads zstd through tensorstore). They
compile with the host C++ compiler
(``$CXX``, else ``g++``) into ``allophant_tpu_torch/_build/native/<hash>/``,
where the hash covers the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The library has a plain C
interface, bound with ctypes in ``allophant_tpu_torch.phonemes``,
``allophant_tpu_torch.data.zarr_store`` and ``allophant_tpu_torch.native.zstd``. Nothing
here runs at import time."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_SOURCE_DIR = Path(__file__).resolve().parent / "src"
SOURCES = ("segmenter.cpp", "edit_distance.cpp", "lz4_codec.cpp", "zstd_decoder.cpp")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build" / "native"
_lock = threading.Lock()


def _digest() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((_SOURCE_DIR / name).read_bytes())
    return digest.hexdigest()[:16]


def library_path() -> Path:
    """The built shared library, compiling it first if it is missing. Raises
    ``RuntimeError`` with the compiler's message when it fails (the
    segmenter, edit distances and LZ4 fall back to pure Python; the zstd
    decoder has no fallback)."""
    library = _BUILD_ROOT / _digest() / "liballophant_native.so"
    with _lock:
        if library.exists():
            return library
        library.parent.mkdir(parents=True, exist_ok=True)
        handle, temporary = tempfile.mkstemp(suffix=".so", dir=library.parent)
        os.close(handle)
        command = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", temporary, *(str(_SOURCE_DIR / name) for name in SOURCES)]
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            os.unlink(temporary)
            raise RuntimeError(f"native build failed:\n{result.stderr}")
        os.replace(temporary, library)
    return library
