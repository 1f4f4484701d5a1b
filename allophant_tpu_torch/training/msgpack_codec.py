"""A vendored MessagePack codec: the subset of the format the native
checkpoint uses, written as ``msgpack.packb(..., use_bin_type=True)`` writes
it, and flax's array extension (``flax.serialization``: ext type 1 holding the
packed triple (shape, dtype name, C-order bytes)). The card's machine has no
``msgpack`` package, and the port needs none.

``packb`` takes None, bools, ints, floats (as float64), str, bytes, lists,
tuples, dicts with str keys, numpy arrays, numpy scalars and ``ExtType``
records; ``unpackb`` reads back what ``packb`` writes, arrays as read-only
numpy views of the buffer. As in msgpack, ``packb(..., default=f)`` packs
``f(value)`` for a value of any other type (``f`` may return an
``ExtType``), and ``unpackb(..., ext_hook=f)`` returns ``f(code, data)`` for
every extension record instead of decoding flax's arrays."""

from __future__ import annotations

import struct
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np

#: flax's ``_MsgpackExtType``: ndarray = 1, native complex = 2, numpy scalar = 3.
NDARRAY_EXT = 1
NPSCALAR_EXT = 3
#: flax splits arrays larger than this into chunks (``MAX_CHUNK_SIZE``); this
#: codec does not write them, and refuses such arrays; ``unchunk`` rebuilds the
#: chunked records of a file flax wrote.
MAX_ARRAY_BYTES = 2**30
CHUNKED_ARRAY_KEY = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """msgpack's ``ExtType``: an extension record of type ``code``."""

    code: int
    data: bytes


def _pack_length(out: List[bytes], length: int, fixed: Tuple[int, int], markers: Tuple[int, int, int]) -> None:
    """A header: the fix form (``fixed`` = (marker, limit)) or the 8/16/32-bit
    length forms (``markers``; 8-bit absent when 0)."""
    marker, limit = fixed
    if marker is not None and length < limit:
        out.append(bytes((marker | length,)))
    elif markers[0] and length <= 0xFF:
        out.append(struct.pack(">BB", markers[0], length))
    elif length <= 0xFFFF:
        out.append(struct.pack(">BH", markers[1], length))
    elif length <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", markers[2], length))
    else:
        raise ValueError(f"msgpack cannot hold {length} items or bytes")


def _pack_int(out: List[bytes], value: int) -> None:
    if 0 <= value < 0x80:
        out.append(bytes((value,)))
    elif -32 <= value < 0:
        out.append(struct.pack(">b", value))
    elif value >= 0:
        for marker, code, limit in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF), (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2**64 - 1)):
            if value <= limit:
                out.append(struct.pack(">B" + code, marker, value))
                return
        raise OverflowError(f"{value} does not fit msgpack's uint64")
    else:
        for marker, code, limit in ((0xD0, "b", -(2**7)), (0xD1, "h", -(2**15)), (0xD2, "i", -(2**31)), (0xD3, "q", -(2**63))):
            if value >= limit:
                out.append(struct.pack(">B" + code, marker, value))
                return
        raise OverflowError(f"{value} does not fit msgpack's int64")


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(struct.pack(">Bb", fixed[len(data)], code))
    elif len(data) <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, len(data), code))
    elif len(data) <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, len(data), code))
    else:
        out.append(struct.pack(">BIb", 0xC9, len(data), code))
    out.append(data)


def _array_bytes(array: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, C-order bytes))."""
    if array.dtype.hasobject or array.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes cannot be serialized")
    if array.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"An array of {array.nbytes} bytes needs flax's chunked layout, which is not implemented")
    return packb((tuple(int(size) for size in array.shape), array.dtype.name, array.tobytes("C")))


def _pack(out: List[bytes], value: Any, default: Optional[Callable[[Any], Any]] = None) -> None:
    if value is None:
        out.append(b"\xc0")
    elif value is True:
        out.append(b"\xc3")
    elif value is False:
        out.append(b"\xc2")
    elif isinstance(value, ExtType):
        _pack_ext(out, value.code, bytes(value.data))
    elif isinstance(value, np.ndarray):
        _pack_ext(out, NDARRAY_EXT, _array_bytes(value))
    elif isinstance(value, np.generic):
        _pack_ext(out, NPSCALAR_EXT, _array_bytes(np.asarray(value)))
    elif isinstance(value, int):
        _pack_int(out, value)
    elif isinstance(value, float):
        out.append(struct.pack(">Bd", 0xCB, value))
    elif isinstance(value, str):
        encoded = value.encode("utf-8")
        _pack_length(out, len(encoded), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(encoded)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        data = bytes(value)
        _pack_length(out, len(data), (None, 0), (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(value, (list, tuple)):
        _pack_length(out, len(value), (0x90, 16), (0, 0xDC, 0xDD))
        for item in value:
            _pack(out, item, default)
    elif isinstance(value, dict):
        _pack_length(out, len(value), (0x80, 16), (0, 0xDE, 0xDF))
        for key, item in value.items():
            if not isinstance(key, str):
                raise TypeError(f"msgpack map keys must be str here, got {type(key).__name__}")
            _pack(out, key)
            _pack(out, item, default)
    elif default is not None:
        _pack(out, default(value))
    else:
        raise TypeError(f"Cannot serialize {type(value).__name__}")


def packb(value: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    out: List[bytes] = []
    _pack(out, value, default)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, ext_hook: Optional[Callable[[int, bytes], Any]] = None):
        self.data = memoryview(data)
        self.offset = 0
        self.ext_hook = ext_hook

    def take(self, count: int) -> memoryview:
        start = self.offset
        self.offset += count
        if self.offset > len(self.data):
            raise ValueError("msgpack data ends early")
        return self.data[start : self.offset]

    def unpack(self, code: str):
        size = struct.calcsize(">" + code)
        return struct.unpack(">" + code, self.take(size))[0]

    def value(self) -> Any:
        marker = self.unpack("B")
        if marker < 0x80:
            return marker
        if marker >= 0xE0:
            return marker - 0x100
        if 0x80 <= marker <= 0x8F:
            return self.map(marker & 0x0F)
        if 0x90 <= marker <= 0x9F:
            return [self.value() for _ in range(marker & 0x0F)]
        if 0xA0 <= marker <= 0xBF:
            return str(self.take(marker & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if marker in simple:
            return simple[marker]
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if marker in lengths:
            return bytes(self.take(self.unpack(lengths[marker])))
        lengths = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if marker in lengths:
            return str(self.take(self.unpack(lengths[marker])), "utf-8")
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if marker in numbers:
            return self.unpack(numbers[marker])
        if marker in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack("H" if marker == 0xDC else "I"))]
        if marker in (0xDE, 0xDF):
            return self.map(self.unpack("H" if marker == 0xDE else "I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if marker in fixed:
            code = self.unpack("b")
            return self.ext(code, self.take(fixed[marker]))
        lengths = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if marker in lengths:
            length = self.unpack(lengths[marker])
            code = self.unpack("b")
            return self.ext(code, self.take(length))
        raise ValueError(f"Unknown msgpack marker 0x{marker:02x}")

    def ext(self, code: int, data: memoryview):
        if self.ext_hook is not None:
            return self.ext_hook(code, bytes(data))
        return _ext(code, data)

    def map(self, count: int) -> dict:
        result = {}
        for _ in range(count):
            key = self.value()
            result[key] = self.value()
        return result


def _ext(code: int, data: memoryview):
    if code not in (NDARRAY_EXT, NPSCALAR_EXT):
        raise ValueError(f"Unknown msgpack extension type {code}")
    shape, dtype, buffer = _Reader(bytes(data)).value()
    array = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape)
    return array[()] if code == NPSCALAR_EXT else array


def unpackb(data: bytes, ext_hook: Optional[Callable[[int, bytes], Any]] = None) -> Any:
    reader = _Reader(data, ext_hook)
    value = reader.value()
    if reader.offset != len(reader.data):
        raise ValueError("Extra bytes after the msgpack value")
    return value


def unchunk(tree: Any) -> Any:
    """``tree`` with every chunked-array record of flax's
    ``msgpack_serialize`` (``{"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": flat, ...}}``) rebuilt into its array."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_ARRAY_KEY in tree:
        shape = tuple(int(tree["shape"][str(index)]) for index in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(index)] for index in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: unchunk(value) for key, value in tree.items()}
