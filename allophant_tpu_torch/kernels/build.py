"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds); the sources
share the ``csrc/*.cuh`` headers. Libraries land in
``allophant_tpu_torch/_build/<hash>/``, where the hash covers the sources, the
headers and the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import time: the CPU tests import every
module of the package on machines without nvcc."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_ROOT / "csrc"
BUILD_ROOT = PACKAGE_ROOT / "_build"
KERNEL_NAMES = ("oneshot_attention", "attention_dropout", "attention_backward", "frame_encoder", "beam_search")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_C_POINTER = ctypes.c_void_p
# Entry point -> (library, C symbol, argtypes[, restype]); every pointer and
# the stream are c_void_p, so ctypes never truncates them to 32-bit ints. The
# restype is the cudaGetLastError() code, a c_int, unless given.
_SIGNATURES = {
    "oneshot_attention": (
        "oneshot_attention",
        "oneshot_attention_forward",
        [_C_POINTER] * 5
        + [ctypes.c_int] * 4
        + [_C_POINTER, ctypes.c_float, ctypes.c_float, ctypes.c_int, _C_POINTER],
    ),
    "attention_dropout": (
        "attention_dropout",
        "attention_dropout_forward",
        [_C_POINTER] * 5
        + [ctypes.c_int] * 4
        + [_C_POINTER, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_uint32] * 3
        + [ctypes.c_float]
        + [ctypes.c_int] * 3
        + [_C_POINTER],
    ),
    "dropout_mask": (
        "attention_dropout",
        "dropout_mask_forward",
        [_C_POINTER] + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 2 + [ctypes.c_int] * 2 + [_C_POINTER],
    ),
    "attention_backward": (
        "attention_backward",
        "attention_backward",
        [_C_POINTER] * 9
        + [ctypes.c_int] * 4
        + [_C_POINTER]
        + [ctypes.c_float] * 3
        + [ctypes.c_uint32] * 3
        + [ctypes.c_float]
        + [ctypes.c_int] * 4
        + [_C_POINTER],
    ),
    "frame_encoder": (
        "frame_encoder",
        "frame_encoder_forward",
        [_C_POINTER] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, _C_POINTER],
    ),
    "beam_search": (
        "beam_search",
        "beam_search_forward",
        [_C_POINTER] * 5 + [ctypes.c_int] * 5 + [_C_POINTER] * 2,
    ),
    "beam_search_workspace_bytes": ("beam_search", "beam_search_workspace_bytes", [ctypes.c_int] * 2, ctypes.c_longlong),
    "beam_backtrace": (
        "beam_search",
        "beam_backtrace_forward",
        [_C_POINTER] * 4 + [ctypes.c_int] * 3 + [_C_POINTER],
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): CUDA_HOME's, else the PATH's."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / name
    if candidate.exists():
        return str(candidate)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME)")
    return found


def _source_hash(names: Sequence[str]) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(names):
        digest.update(name.encode())
        digest.update((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return digest.hexdigest()[:16]


def build_directory() -> Path:
    return BUILD_ROOT / _source_hash(KERNEL_NAMES)


def library_path(name: str) -> Path:
    return build_directory() / f"lib{name}.so"


def _compile(names: Sequence[str]) -> None:
    """One nvcc process per source, all started together; each writes to a
    temporary file that is renamed into place only when it compiled."""
    directory = build_directory()
    directory.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()
    jobs = []
    for name in names:
        handle, temporary = tempfile.mkstemp(suffix=".so", dir=directory)
        os.close(handle)
        command = [nvcc, *NVCC_FLAGS, "-o", temporary, str(SOURCE_DIR / f"{name}.cu")]
        process = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, temporary, process))
    failures = []
    for name, temporary, process in jobs:
        output, _ = process.communicate()
        if process.returncode != 0:
            os.unlink(temporary)
            failures.append(f"{name}.cu (exit {process.returncode}):\n{output}")
            continue
        os.replace(temporary, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build_all() -> float:
    """Builds every kernel library that is missing; returns the seconds spent."""
    start = time.perf_counter()
    with _lock:
        missing = [name for name in KERNEL_NAMES if not library_path(name).exists()]
        if missing:
            _compile(missing)
    return time.perf_counter() - start


def load_kernel(name: str):
    """The C entry point ``name`` (building its library if needed), with its
    argtypes and restype declared."""
    with _lock:
        function = _loaded.get(name)
        if function is None:
            library, symbol, argtypes, *restype = _SIGNATURES[name]
            path = library_path(library)
            if not path.exists():
                _compile([library])
            function = getattr(ctypes.CDLL(str(path)), symbol)
            function.argtypes = argtypes
            function.restype = restype[0] if restype else ctypes.c_int
            _loaded[name] = function
    return function


def check_launch(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
