"""Minimal zarr-v2 DirectoryStore interop for the reference's preprocessing
caches (the port's copy of ``allophant_tpu/data/zarr_store.py``).

The reference persists precomputed features and lengths through zarr: ragged
``dtype="array:float32"`` feature arrays compressed with
``Blosc(cname="lz4", shuffle=BITSHUFFLE)``, int64 length arrays with zarr's
default ``Blosc(cname="lz4", shuffle=SHUFFLE)``. This module implements that
on-disk format with numpy alone (no zarr, numcodecs or lz4 package):

- zarr v2 directory layout: ``.zgroup`` / ``.zattrs`` / ``.zarray`` JSON
  metadata with chunk files named by chunk index;
- the Blosc1 frame format (16-byte header, block starts, optional per-block
  typesize-split streams) with the LZ4 block codec, byte-shuffle and
  bit-shuffle filters;
- numcodecs' ``VLenArray`` object codec (the ``array:float32`` ragged dtype);
- N-dimensional arrays in a grid of chunks, compressed with zstd or not at
  all, over any key-value source: the arrays of Orbax checkpoints
  (``training/orbax_arrays.py``), read from an OCDBT store or a directory.

Reading supports everything the reference writes (lz4 + bitshuffle features,
lz4 + byteshuffle lengths, and uncompressed/memcpy frames). Writing emits
reference-layout stores with memcpy Blosc frames. LZ4 blocks decode through
the port's C++ decoder (``native/src/lz4_codec.cpp``) when it builds, and
through the pure-Python decoder below otherwise, as in the JAX package.
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass
from os import path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Blosc1 flag bits / codec codes (c-blosc blosc.h).
_FLAG_BYTE_SHUFFLE = 0x1
_FLAG_MEMCPY = 0x2
_FLAG_BIT_SHUFFLE = 0x4
_CODEC_SHIFT = 5
_CODEC_BLOSCLZ = 0
_CODEC_LZ4 = 1
# Split-stream thresholds (c-blosc blosc.c: MAX_SPLITS / MIN_BUFFERSIZE).
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128


# ---------------------------------------------------------------------------
# LZ4 block codec (pure Python; the block format of lz4 1.x)
# ---------------------------------------------------------------------------


_NATIVE_LZ4 = None
_NATIVE_LZ4_FAILED = False


def _native_lz4():
    """ctypes handle to the C++ decoder in liballophant_native.so (built from
    native/src/lz4_codec.cpp), or None when the native build is unavailable."""
    global _NATIVE_LZ4, _NATIVE_LZ4_FAILED
    if _NATIVE_LZ4 is not None or _NATIVE_LZ4_FAILED:
        return _NATIVE_LZ4
    try:
        import ctypes

        from allophant_tpu_torch.native.build import library_path

        lib = ctypes.CDLL(str(library_path()))
        lib.allophant_lz4_decompress.restype = ctypes.c_int32
        lib.allophant_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ]
        _NATIVE_LZ4 = lib
    except Exception:
        _NATIVE_LZ4_FAILED = True
    return _NATIVE_LZ4


def lz4_decompress_block(data: bytes, output_size: int) -> bytes:
    """Decodes one raw LZ4 block (no frame header) of known output size.

    Routes through the native C++ decoder when available (GB/s-class; the
    sequential token stream cannot be vectorized in numpy) with this
    pure-Python implementation as the complete fallback."""
    lib = _native_lz4()
    if lib is not None:
        import ctypes

        buffer = ctypes.create_string_buffer(output_size)
        written = lib.allophant_lz4_decompress(data, len(data), buffer, output_size)
        if written != output_size:
            raise ValueError(
                f"corrupt LZ4 block: produced {written} of {output_size} bytes"
            )
        return buffer.raw

    out = bytearray(output_size)
    position = 0
    out_position = 0
    length = len(data)
    while position < length:
        token = data[position]
        position += 1
        literal_length = token >> 4
        if literal_length == 15:
            while True:
                extra = data[position]
                position += 1
                literal_length += extra
                if extra != 255:
                    break
        if position + literal_length > length or out_position + literal_length > output_size:
            raise ValueError("corrupt LZ4 block: literal run exceeds input or output")
        out[out_position : out_position + literal_length] = data[
            position : position + literal_length
        ]
        position += literal_length
        out_position += literal_length
        if position >= length:
            break  # last sequence has no match
        offset = data[position] | (data[position + 1] << 8)
        position += 2
        # Same malformed-input contract as the native decoder
        # (lz4_codec.cpp: offset == 0 || offset > out -> error).
        if offset == 0 or offset > out_position:
            raise ValueError("corrupt LZ4 block: match offset outside decoded output")
        match_length = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                extra = data[position]
                position += 1
                match_length += extra
                if extra != 255:
                    break
        if out_position + match_length > output_size:
            raise ValueError("corrupt LZ4 block: match run exceeds output size")
        match_position = out_position - offset
        if offset >= match_length:
            out[out_position : out_position + match_length] = out[
                match_position : match_position + match_length
            ]
            out_position += match_length
        else:
            # Overlapping match: byte-by-byte semantics.
            for _ in range(match_length):
                out[out_position] = out[match_position]
                out_position += 1
                match_position += 1
    if out_position != output_size:
        raise ValueError(
            f"corrupt LZ4 block: produced {out_position} of {output_size} bytes"
        )
    return bytes(out)


def lz4_compress_block(data: bytes) -> bytes:
    """Greedy hash-chain LZ4 block encoder (valid format, modest ratio) — used
    for round-trip tests; production writes use memcpy Blosc frames."""
    length = len(data)
    out = bytearray()
    if length == 0:
        return bytes(out)
    table: Dict[bytes, int] = {}
    anchor = 0
    position = 0
    # The spec requires the last 5 bytes to be literals and the last match to
    # start at least 12 bytes before the end.
    match_limit = length - 12

    def emit(literal: bytes, match_length: int, offset: int) -> None:
        literal_length = len(literal)
        token_literal = min(literal_length, 15)
        token_match = min(match_length - 4, 15) if match_length else 0
        out.append((token_literal << 4) | token_match)
        remaining = literal_length - 15
        if token_literal == 15:
            while remaining >= 255:
                out.append(255)
                remaining -= 255
            out.append(max(remaining, 0))
        out.extend(literal)
        if match_length:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            remaining = match_length - 4 - 15
            if token_match == 15:
                while remaining >= 255:
                    out.append(255)
                    remaining -= 255
                out.append(max(remaining, 0))

    while position <= match_limit and match_limit > 0:
        key = bytes(data[position : position + 4])
        candidate = table.get(key)
        table[key] = position
        if candidate is not None and position - candidate <= 0xFFFF and data[
            candidate : candidate + 4
        ] == key:
            match_length = 4
            limit = length - 5
            while (
                position + match_length < limit
                and data[candidate + match_length] == data[position + match_length]
            ):
                match_length += 1
            emit(bytes(data[anchor:position]), match_length, position - candidate)
            position += match_length
            anchor = position
        else:
            position += 1
    emit(bytes(data[anchor:length]), 0, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# Shuffle filters (numpy)
# ---------------------------------------------------------------------------


def byte_shuffle(data: bytes, typesize: int) -> bytes:
    """Blosc byte shuffle: [n, typesize] bytes -> typesize contiguous planes."""
    array = np.frombuffer(data, np.uint8)
    whole = (len(array) // typesize) * typesize
    shuffled = array[:whole].reshape(-1, typesize).T.copy().reshape(-1)
    return shuffled.tobytes() + array[whole:].tobytes()

def byte_unshuffle(data: bytes, typesize: int) -> bytes:
    array = np.frombuffer(data, np.uint8)
    whole = (len(array) // typesize) * typesize
    planes = array[:whole].reshape(typesize, -1).T.copy().reshape(-1)
    return planes.tobytes() + array[whole:].tobytes()


def bit_shuffle(data: bytes, typesize: int) -> bytes:
    """bitshuffle's ``bshuf_trans_bit_elem``: byte-transpose then per-plane bit
    transpose (LSB-first within output bytes), over the largest multiple of
    ``8 * typesize`` bytes; the tail is copied (c-blosc shuffle.c semantics)."""
    array = np.frombuffer(data, np.uint8)
    block = 8 * typesize
    whole = (len(array) // block) * block
    if whole:
        n = whole // typesize
        planes = array[:whole].reshape(n, typesize).T  # [typesize, n]
        # bits[i, j, b] = bit b (LSB first) of byte j in plane i.
        bits = np.unpackbits(planes, axis=1, bitorder="little").reshape(typesize, n, 8)
        # Output plane order: for each byte-plane, bit 0 plane first; element j
        # lands in bit (j % 8) of output byte j // 8.
        transposed = bits.transpose(0, 2, 1)  # [typesize, 8, n]
        packed = np.packbits(transposed.reshape(typesize * 8, n), axis=1, bitorder="little")
        head = packed.reshape(-1).tobytes()
    else:
        head = b""
    return head + array[whole:].tobytes()


def bit_unshuffle(data: bytes, typesize: int) -> bytes:
    array = np.frombuffer(data, np.uint8)
    block = 8 * typesize
    whole = (len(array) // block) * block
    if whole:
        n = whole // typesize
        packed = array[:whole].reshape(typesize * 8, n // 8)
        bits = np.unpackbits(packed, axis=1, bitorder="little").reshape(typesize, 8, n)
        planes = np.packbits(bits.transpose(0, 2, 1).reshape(typesize, n * 8), axis=1, bitorder="little")
        head = planes.reshape(typesize, n).T.copy().reshape(-1).tobytes()
    else:
        head = b""
    return head + array[whole:].tobytes()


# ---------------------------------------------------------------------------
# Blosc1 frames
# ---------------------------------------------------------------------------


def _split_streams(codec: int, flags: int, typesize: int, blocksize: int) -> int:
    """Number of typesize-split streams per block (c-blosc ``split_block``)."""
    if (
        codec in (_CODEC_BLOSCLZ, _CODEC_LZ4)
        and (flags & _FLAG_BYTE_SHUFFLE)
        and typesize <= _MAX_SPLITS
        and blocksize // typesize >= _MIN_BUFFERSIZE
    ):
        return typesize
    return 1


def blosc_decompress(frame: bytes) -> bytes:
    """Decodes one Blosc1 frame (as written by c-blosc 1.x / python-blosc)."""
    if len(frame) < 16:
        raise ValueError("truncated blosc header")
    version, _versionlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    if version < 1 or version > 2:
        raise ValueError(f"unsupported blosc format version {version}")
    nbytes, blocksize, cbytes = np.frombuffer(frame[4:16], "<i4")
    nbytes, blocksize, cbytes = int(nbytes), int(blocksize), int(cbytes)
    if cbytes > len(frame):
        raise ValueError("truncated blosc frame")
    if flags & _FLAG_MEMCPY:
        return bytes(frame[16 : 16 + nbytes])

    codec = flags >> _CODEC_SHIFT
    if codec not in (_CODEC_LZ4,):
        raise ValueError(
            f"unsupported blosc codec id {codec} (only lz4 and memcpy frames are supported)"
        )
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = np.frombuffer(frame[16 : 16 + 4 * nblocks], "<i4")
    out = bytearray()
    for block_index in range(nblocks):
        block_bytes = min(blocksize, nbytes - block_index * blocksize)
        leftover = block_bytes != blocksize
        nstreams = 1 if leftover else _split_streams(codec, flags, typesize, blocksize)
        stream_size = block_bytes // nstreams
        position = int(bstarts[block_index])
        block = bytearray()
        for stream in range(nstreams):
            this_size = stream_size if stream < nstreams - 1 else block_bytes - stream_size * (nstreams - 1)
            (csize,) = np.frombuffer(frame[position : position + 4], "<i4")
            csize = int(csize)
            position += 4
            payload = frame[position : position + csize]
            position += csize
            if csize == this_size:
                block.extend(payload)  # stored uncompressed
            else:
                block.extend(lz4_decompress_block(payload, this_size))
        if flags & _FLAG_BIT_SHUFFLE:
            block = bytearray(bit_unshuffle(bytes(block), typesize))
        elif flags & _FLAG_BYTE_SHUFFLE:
            block = bytearray(byte_unshuffle(bytes(block), typesize))
        out.extend(block)
    if len(out) != nbytes:
        raise ValueError(f"blosc frame decoded {len(out)} of {nbytes} bytes")
    return bytes(out)


def blosc_compress_memcpy(data: bytes, typesize: int) -> bytes:
    """A valid Blosc1 frame storing ``data`` uncompressed (clevel-0 memcpy
    mode) — readable by every blosc build; no compressor spec risk."""
    header = bytearray(16)
    header[0] = 2  # format version
    header[1] = 1
    header[2] = _FLAG_MEMCPY
    header[3] = max(1, min(typesize, 255))
    header[4:8] = np.int32(len(data)).tobytes()
    header[8:12] = np.int32(len(data)).tobytes()  # one block
    header[12:16] = np.int32(len(data) + 16).tobytes()
    return bytes(header) + data


def blosc_compress_lz4(data: bytes, typesize: int, shuffle: int = 0, blocksize: int = 0) -> bytes:
    """Blosc1 lz4 frame writer (used by the round-trip tests; ``shuffle``:
    0 none, 1 byte, 2 bit)."""
    flags = _CODEC_LZ4 << _CODEC_SHIFT
    if shuffle == 1:
        flags |= _FLAG_BYTE_SHUFFLE
    elif shuffle == 2:
        flags |= _FLAG_BIT_SHUFFLE
    if not blocksize:
        blocksize = min(max(len(data), typesize * 8), 256 * 1024)
        blocksize = max(blocksize - blocksize % max(typesize * 8, 1), typesize * 8)
    nbytes = len(data)
    nblocks = max((nbytes + blocksize - 1) // blocksize, 1)
    body = bytearray()
    bstarts = np.zeros(nblocks, "<i4")
    header_size = 16 + 4 * nblocks
    for block_index in range(nblocks):
        start = block_index * blocksize
        block = data[start : start + blocksize]
        leftover = len(block) != blocksize
        if shuffle == 2:
            block = bit_shuffle(block, typesize)
        elif shuffle == 1:
            block = byte_shuffle(block, typesize)
        nstreams = 1 if leftover else _split_streams(_CODEC_LZ4, flags, typesize, blocksize)
        stream_size = len(block) // nstreams
        bstarts[block_index] = header_size + len(body)
        for stream in range(nstreams):
            begin = stream * stream_size
            end = begin + stream_size if stream < nstreams - 1 else len(block)
            piece = block[begin:end]
            compressed = lz4_compress_block(piece)
            if len(compressed) >= len(piece):
                compressed = piece  # store uncompressed; csize == stream size signals it
            body.extend(np.int32(len(compressed)).tobytes())
            body.extend(compressed)
    header = bytearray(16)
    header[0] = 2
    header[1] = 1
    header[2] = flags
    header[3] = max(1, min(typesize, 255))
    header[4:8] = np.int32(nbytes).tobytes()
    header[8:12] = np.int32(blocksize).tobytes()
    header[12:16] = np.int32(header_size + len(body)).tobytes()
    return bytes(header) + bstarts.tobytes() + bytes(body)


# ---------------------------------------------------------------------------
# VLenArray object codec (numcodecs vlen-array)
# ---------------------------------------------------------------------------


def vlen_array_decode(data: bytes, dtype: np.dtype) -> List[np.ndarray]:
    (count,) = np.frombuffer(data[:4], "<u4")
    items: List[np.ndarray] = []
    position = 4
    for _ in range(int(count)):
        (nbytes,) = np.frombuffer(data[position : position + 4], "<u4")
        position += 4
        items.append(np.frombuffer(data[position : position + int(nbytes)], dtype).copy())
        position += int(nbytes)
    return items


def vlen_array_encode(items: Sequence[np.ndarray], dtype: np.dtype) -> bytes:
    out = bytearray(np.uint32(len(items)).tobytes())
    for item in items:
        raw = np.ascontiguousarray(item, dtype).reshape(-1).tobytes()
        out.extend(np.uint32(len(raw)).tobytes())
        out.extend(raw)
    return bytes(out)


# ---------------------------------------------------------------------------
# zarr v2 directory store
# ---------------------------------------------------------------------------


def is_zarr_store(root: str) -> bool:
    return path.isfile(path.join(root, ".zgroup"))


def _read_json(file_path: str) -> dict:
    with open(file_path, "r", encoding="utf-8") as file:
        return json.load(file)


def read_array(array_dir: str) -> np.ndarray | List[np.ndarray]:
    """Reads a 1-D zarr v2 array (plain dtype, or object dtype with the
    vlen-array filter -> list of numpy arrays)."""
    meta = _read_json(path.join(array_dir, ".zarray"))
    _check_zarr_format(meta)
    if len(meta["shape"]) != 1:
        raise ValueError("only 1-D arrays are used by the reference store")
    (size,) = meta["shape"]
    (chunk_size,) = meta["chunks"]
    compressor = meta.get("compressor")
    filters = meta.get("filters") or []
    dtype_spec = meta["dtype"]

    vlen_dtype = None
    if dtype_spec in ("|O", "O"):
        for filter_config in filters:
            if filter_config.get("id") == "vlen-array":
                vlen_dtype = np.dtype(filter_config["dtype"])
        if vlen_dtype is None:
            raise ValueError("object array without a vlen-array filter")
        result_objects: List[np.ndarray] = []
    else:
        dtype = np.dtype(dtype_spec)
        result = np.zeros(size, dtype)
        fill = meta.get("fill_value")
        if fill not in (None, 0):
            result[:] = fill

    nchunks = (size + chunk_size - 1) // chunk_size if size else 0
    for chunk_index in range(nchunks):
        chunk_path = path.join(array_dir, str(chunk_index))
        start = chunk_index * chunk_size
        count = min(chunk_size, size - start)
        if not path.isfile(chunk_path):
            if vlen_dtype is not None:
                result_objects.extend(np.zeros(0, vlen_dtype) for _ in range(count))
            continue
        with open(chunk_path, "rb") as file:
            raw = file.read()
        if compressor is not None:
            if compressor.get("id") != "blosc":
                raise ValueError(f"unsupported compressor {compressor.get('id')!r}")
            raw = blosc_decompress(raw)
        if vlen_dtype is not None:
            items = vlen_array_decode(raw, vlen_dtype)
            result_objects.extend(items[:count])
        else:
            chunk = np.frombuffer(raw, dtype)
            result[start : start + count] = chunk[:count]
    return result_objects if vlen_dtype is not None else result


def read_file_into(file_path: str, offset: int, buffer: np.ndarray) -> None:
    """Reads ``buffer.nbytes`` bytes of ``file_path`` from ``offset`` into
    the contiguous ``buffer``, without an intermediate copy."""
    view = memoryview(buffer.reshape(-1).view(np.uint8))
    with open(file_path, "rb", buffering=0) as file:
        file.seek(offset)
        done = 0
        while done < len(view):
            read = file.readinto(view[done:])
            if not read:
                raise ValueError(f"{file_path} ends before byte {offset + len(view)}")
            done += read


def _check_zarr_format(meta: dict) -> None:
    if meta.get("zarr_format") != 2:
        raise ValueError(f"unsupported zarr format {meta.get('zarr_format')}")


# ---------------------------------------------------------------------------
# N-dimensional arrays in a chunk grid (Orbax checkpoints)
# ---------------------------------------------------------------------------

#: The dtypes of ``.zarray`` an N-dimensional array may have, and the numpy
#: dtype its chunk bytes hold (bfloat16 as its raw 16 bits).
_STORED_DTYPES = {
    "<f4": "<f4", "<f2": "<f2", "<f8": "<f8", "bfloat16": "<u2",
    "|i1": "|i1", "<i2": "<i2", "<i4": "<i4", "<i8": "<i8",
    "|u1": "|u1", "<u2": "<u2", "<u4": "<u4", "<u8": "<u8", "|b1": "|b1",
}


@dataclass(frozen=True)
class ArrayMetadata:
    """The ``.zarray`` of an N-dimensional array: C order, no filters, the
    fill value null, and chunks zstd-compressed or not compressed."""

    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: str
    compressor: Optional[str]
    separator: str = "."

    @property
    def stored_dtype(self) -> np.dtype:
        return np.dtype(_STORED_DTYPES[self.dtype])

    def chunk_keys(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(key, chunk index) of every chunk of the grid; a 0-d array has one,
        at key ``0``."""
        grid = [-(-size // chunk) if chunk else 0 for size, chunk in zip(self.shape, self.chunks)]
        if not grid:
            return [("0", ())]
        return [(self.separator.join(map(str, index)), index) for index in itertools.product(*map(range, grid))]

    def to_json(self) -> dict:
        return {
            "chunks": list(self.chunks),
            "compressor": None if self.compressor is None else {"id": self.compressor, "level": 1},
            "dimension_separator": self.separator,
            "dtype": self.dtype,
            "fill_value": None,
            "filters": None,
            "order": "C",
            "shape": list(self.shape),
            "zarr_format": 2,
        }


def zarr_dtype(dtype: np.dtype, name: str = "array") -> str:
    """The ``.zarray`` spelling of a numpy dtype that N-dimensional arrays
    hold (numpy's own ``dtype.str``)."""
    spelling = np.dtype(dtype).str
    if spelling not in _STORED_DTYPES:
        raise ValueError(f"{name}: unsupported dtype {dtype}")
    return spelling


def parse_array_metadata(meta: dict, name: str = "array") -> ArrayMetadata:
    """Checks a ``.zarray`` against what ``read_chunked_array`` reads."""
    _check_zarr_format(meta)
    dtype = meta.get("dtype")
    if dtype not in _STORED_DTYPES:
        raise ValueError(f"{name}: unsupported zarr dtype {dtype!r}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: only C-order chunks are supported, not {meta.get('order')!r}")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters are not supported ({meta['filters']})")
    if meta.get("fill_value") is not None:
        raise ValueError(f"{name}: only a null fill_value is supported, not {meta['fill_value']!r}")
    separator = meta.get("dimension_separator", ".")
    if separator not in (".", "/"):
        raise ValueError(f"{name}: unsupported dimension_separator {separator!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor {compressor.get('id')!r} (zstd or none)")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{name}: shape {shape} and chunks {chunks} differ in rank")
    return ArrayMetadata(shape, chunks, dtype, None if compressor is None else "zstd", separator)


def read_chunked_array(
    metadata: ArrayMetadata,
    fetch: Callable[[str], Optional[bytes]],
    read_into: Callable[[str, np.ndarray], bool],
    name: str = "array",
) -> np.ndarray:
    """Assembles an array from its chunks. ``fetch(key)`` returns a
    compressed chunk's bytes, or None when it is missing;
    ``read_into(key, buffer)`` reads an uncompressed chunk straight into a
    buffer of its size and returns False when it is missing. A missing chunk
    raises. Edge chunks are stored padded to the full chunk shape. bfloat16
    comes back as float32, which holds every bfloat16 exactly."""
    stored = metadata.stored_dtype
    result = np.empty(metadata.shape, stored)
    whole = metadata.chunks == metadata.shape
    for key, index in metadata.chunk_keys():
        target = result if whole else np.empty(metadata.chunks, stored)
        if metadata.compressor is None:
            if not read_into(key, target):
                raise KeyError(f"{name}: chunk {key!r} is missing")
        else:
            raw = fetch(key)
            if raw is None:
                raise KeyError(f"{name}: chunk {key!r} is missing")
            from allophant_tpu_torch.native import zstd

            written = zstd.decompress_into(raw, target)
            if written != target.nbytes:
                raise ValueError(f"{name}: chunk {key!r} holds {written} bytes, expected {target.nbytes}")
        if not whole:
            region = tuple(
                slice(i * c, min((i + 1) * c, size)) for i, c, size in zip(index, metadata.chunks, metadata.shape)
            )
            result[region] = target[tuple(slice(0, r.stop - r.start) for r in region)]
    if metadata.dtype == "bfloat16":
        return (result.astype(np.uint32) << 16).view(np.float32)
    return result


class ZarrDirectoryWriter:
    """Writes the reference's preprocessing-store layout: group metadata plus
    1-D arrays (plain or vlen ragged) in memcpy Blosc frames."""

    def __init__(self, root: str):
        self.root = root
        self._ensure_group("")

    def _ensure_group(self, relative: str) -> str:
        directory = path.join(self.root, relative) if relative else self.root
        os.makedirs(directory, exist_ok=True)
        group_file = path.join(directory, ".zgroup")
        if not path.isfile(group_file):
            with open(group_file, "w", encoding="utf-8") as file:
                json.dump({"zarr_format": 2}, file)
        return directory

    def write_attrs(self, relative: str, attrs: dict) -> None:
        directory = self._ensure_group(relative)
        with open(path.join(directory, ".zattrs"), "w", encoding="utf-8") as file:
            json.dump(attrs, file)

    def write_plain(self, relative: str, name: str, values: np.ndarray, chunk_size: int = 512) -> None:
        directory = path.join(self._ensure_group(relative), name)
        os.makedirs(directory, exist_ok=True)
        values = np.ascontiguousarray(values)
        meta = {
            "zarr_format": 2,
            "shape": [int(values.size)],
            "chunks": [int(chunk_size)],
            "dtype": values.dtype.str,
            "compressor": {
                "id": "blosc", "cname": "lz4", "clevel": 0, "shuffle": 0, "blocksize": 0,
            },
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        with open(path.join(directory, ".zarray"), "w", encoding="utf-8") as file:
            json.dump(meta, file)
        for chunk_index in range((values.size + chunk_size - 1) // chunk_size):
            chunk = values[chunk_index * chunk_size : (chunk_index + 1) * chunk_size]
            if chunk.size < chunk_size:
                padded = np.zeros(chunk_size, values.dtype)
                padded[: chunk.size] = chunk
                chunk = padded
            frame = blosc_compress_memcpy(chunk.tobytes(), values.dtype.itemsize)
            with open(path.join(directory, str(chunk_index)), "wb") as file:
                file.write(frame)

    def write_vlen(
        self, relative: str, name: str, items: Sequence[np.ndarray],
        dtype: np.dtype = np.dtype("<f4"), chunk_size: int = 512,
    ) -> None:
        directory = path.join(self._ensure_group(relative), name)
        os.makedirs(directory, exist_ok=True)
        meta = {
            "zarr_format": 2,
            "shape": [len(items)],
            "chunks": [int(chunk_size)],
            "dtype": "|O",
            "compressor": {
                "id": "blosc", "cname": "lz4", "clevel": 0, "shuffle": 0, "blocksize": 0,
            },
            "fill_value": 0,
            "order": "C",
            "filters": [{"id": "vlen-array", "dtype": np.dtype(dtype).str}],
        }
        with open(path.join(directory, ".zarray"), "w", encoding="utf-8") as file:
            json.dump(meta, file)
        for chunk_index in range((len(items) + chunk_size - 1) // chunk_size):
            chunk_items = list(items[chunk_index * chunk_size : (chunk_index + 1) * chunk_size])
            while len(chunk_items) < chunk_size:
                chunk_items.append(np.zeros(0, dtype))
            raw = vlen_array_encode(chunk_items, np.dtype(dtype))
            frame = blosc_compress_memcpy(raw, 1)
            with open(path.join(directory, str(chunk_index)), "wb") as file:
                file.write(frame)


class StreamingVlenWriter:
    """Streams ragged arrays into one vlen zarr array chunk by chunk, so a
    multi-GB language group never materializes in memory (the write-side
    analogue of the reference's chunked zarr assignment loop,
    reference datasets/__main__.py:195-213)."""

    def __init__(
        self,
        writer: "ZarrDirectoryWriter",
        relative: str,
        name: str,
        dtype=np.dtype("<f4"),
        chunk_size: int = 512,
    ):
        self._directory = path.join(writer._ensure_group(relative), name)
        os.makedirs(self._directory, exist_ok=True)
        self._dtype = np.dtype(dtype)
        self._chunk_size = chunk_size
        self._pending: List[np.ndarray] = []
        self._chunk_index = 0
        self._count = 0

    def append(self, item: np.ndarray) -> None:
        self._pending.append(np.ascontiguousarray(item, self._dtype).reshape(-1))
        self._count += 1
        if len(self._pending) == self._chunk_size:
            self._flush()

    def _flush(self) -> None:
        items = self._pending
        while len(items) < self._chunk_size:
            items.append(np.zeros(0, self._dtype))
        raw = vlen_array_encode(items, self._dtype)
        with open(path.join(self._directory, str(self._chunk_index)), "wb") as file:
            file.write(blosc_compress_memcpy(raw, 1))
        self._chunk_index += 1
        self._pending = []

    def close(self) -> None:
        if self._pending:
            self._flush()
        meta = {
            "zarr_format": 2,
            "shape": [self._count],
            "chunks": [self._chunk_size],
            "dtype": "|O",
            "compressor": {
                "id": "blosc", "cname": "lz4", "clevel": 0, "shuffle": 0, "blocksize": 0,
            },
            "fill_value": 0,
            "order": "C",
            "filters": [{"id": "vlen-array", "dtype": self._dtype.str}],
        }
        with open(path.join(self._directory, ".zarray"), "w", encoding="utf-8") as file:
            json.dump(meta, file)


# ---------------------------------------------------------------------------
# Reference preprocessing-store layout (read side)
# ---------------------------------------------------------------------------


def read_preprocessed_zarr(
    data_path: str, split_languages: Dict[str, Sequence[str]], lengths_only: bool = True
):
    """Reads a reference-written zarr feature/length cache into the same
    structures our ragged store loader returns (store.PreprocessedSplitData):
    per split, concatenated language-ordered lengths plus (optionally) the
    ragged per-utterance feature arrays reshaped to [frames, feature_size].
    Mirrors the reference's ``datasets/corpus_loading.py:143-162``."""
    from allophant_tpu_torch.data.store import PreprocessedSplitData

    feature_size: Optional[int] = None
    if not lengths_only:
        attrs_path = path.join(data_path, ".zattrs")
        feature_size = int(_read_json(attrs_path)["feature_size"])

    split_data: Dict[str, PreprocessedSplitData] = {}
    for split, languages in split_languages.items():
        lengths: List[np.ndarray] = []
        features: Optional[List[np.ndarray]] = [] if feature_size is not None else None
        for language in languages:
            group = path.join(data_path, split, language)
            lengths.append(np.asarray(read_array(path.join(group, "lengths"))))
            if features is not None:
                for flat in read_array(path.join(group, "features")):
                    features.append(np.asarray(flat, np.float32).reshape(-1, feature_size))
        split_data[split] = PreprocessedSplitData(
            np.concatenate(lengths) if lengths else np.zeros(0, np.int64), features
        )
    return split_data
