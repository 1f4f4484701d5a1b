"""The OCDBT key-value store (tensorstore's "optionally-cooperative
distributed B+tree"), read and written without tensorstore: the store under
an Orbax checkpoint's ``variables/`` directory.

A database is a directory with a ``manifest.ocdbt`` and data files under
``d/``. Every encoded piece (the manifest, B-tree nodes, version-tree nodes)
has the same frame: a 4-byte big-endian magic number, the frame's whole
length as a little-endian u64, a varint format version (0), a varint
compression (0 none, 1 zstd) that applies to the body, the body, and a
CRC-32C (Castagnoli) of everything before it as a little-endian u32.

- The manifest's body holds the config (uuid, manifest kind, the inline-value
  and decoded-node limits, the version tree's arity and the compression) and
  the version tree: its newest versions inline, older ones in version-tree
  nodes. A version names its B-tree root by (data file, offset, length).
- A B-tree node holds its height, a data-file table of (base path, relative
  path) pairs, and its entries in columns with prefix-compressed keys. An
  interior entry points to a child whose keys lose the entry's
  ``subtree_common_prefix``; a leaf entry holds its value inline or as a
  (data file, offset) reference of the value's length.
- Data-file paths resolve against the directory that holds the root
  manifest: Orbax's root database points into ``ocdbt.process_0/d/...``.

The writer makes one database with one version whose root is one leaf node,
every value out of line in one data file, and the compression "none" in the
config, so no compressor is needed and tensorstore reads it back. Only
"single" manifests (the kind Orbax writes) are read; numbered ones raise."""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from allophant_tpu_torch.data.zarr_store import read_file_into

__all__ = ["OcdbtReader", "OcdbtWriter", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
VERSION_NODE_MAGIC = 0x0CDB1234
MANIFEST_FILE = "manifest.ocdbt"
_NULL = (1 << 64) - 1
_COMPRESSION_NONE = 0
_COMPRESSION_ZSTD = 1
# The limits the writer puts in its config: tensorstore's defaults. It
# inlines no value, so only the node limit constrains what it writes.
_WRITER_MAX_INLINE_VALUE_BYTES = 1024
_WRITER_MAX_DECODED_NODE_BYTES = 100_000_000


def _crc32c_table() -> List[int]:
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli polynomial, reflected), as OCDBT frames use it."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.position = 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.position >= len(self.data):
                raise ValueError("OCDBT: truncated varint")
            byte = self.data[self.position]
            self.position += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, count: int) -> List[int]:
        return [self.varint() for _ in range(count)]

    def u8s(self, count: int) -> List[int]:
        if self.position + count > len(self.data):
            raise ValueError("OCDBT: truncated node")
        values = list(self.data[self.position : self.position + count])
        self.position += count
        return values

    def take(self, count: int) -> bytes:
        if self.position + count > len(self.data):
            raise ValueError("OCDBT: truncated node")
        value = self.data[self.position : self.position + count]
        self.position += count
        return value

    def u64s(self, count: int) -> List[int]:
        return list(struct.unpack(f"<{count}Q", self.take(8 * count)))


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, checked and decompressed."""
    if len(data) < 18:
        raise ValueError(f"OCDBT {what}: truncated ({len(data)} bytes)")
    (found,) = struct.unpack(">I", data[:4])
    if found != magic:
        raise ValueError(f"OCDBT {what}: bad magic number {found:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(f"OCDBT {what}: length field {length} != {len(data)} bytes")
    (stored,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != stored:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    cursor = _Cursor(data)
    cursor.position = 12
    version = cursor.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: unsupported format version {version}")
    compression = cursor.varint()
    body = data[cursor.position : -4]
    if compression == _COMPRESSION_ZSTD:
        from allophant_tpu_torch.native import zstd

        return zstd.decompress(body)
    if compression != _COMPRESSION_NONE:
        raise ValueError(f"OCDBT {what}: unknown compression {compression}")
    return body


def _frame(magic: int, body: bytes) -> bytes:
    header_tail = _varint(0) + _varint(_COMPRESSION_NONE)
    length = 4 + 8 + len(header_tail) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + header_tail + body
    return data + struct.pack("<I", crc32c(data))


def _read_data_file_table(cursor: _Cursor) -> List[str]:
    count = cursor.varint()
    if count == 0:
        return []
    prefix_lengths = [0] + cursor.varints(count - 1)
    suffix_lengths = cursor.varints(count)
    base_lengths = cursor.varints(count)
    paths, previous = [], b""
    for index in range(count):
        full = previous[: prefix_lengths[index]] + cursor.take(suffix_lengths[index])
        if base_lengths[index] > len(full):
            raise ValueError("OCDBT: data file base path longer than its path")
        paths.append(full.decode())
        previous = full
    return paths


def _write_data_file_table(paths: Sequence[Tuple[str, str]]) -> bytes:
    out = bytearray(_varint(len(paths)))
    fulls = [(base + relative).encode() for base, relative in paths]
    prefixes = [0] + [_common_prefix(fulls[i - 1], fulls[i]) for i in range(1, len(fulls))]
    out += b"".join(_varint(p) for p in prefixes[1:])
    out += b"".join(_varint(len(full) - p) for full, p in zip(fulls, prefixes))
    out += b"".join(_varint(len(base.encode())) for base, _ in paths)
    out += b"".join(full[p:] for full, p in zip(fulls, prefixes))
    return bytes(out)


def _common_prefix(a: bytes, b: bytes) -> int:
    limit = min(len(a), len(b))
    index = 0
    while index < limit and a[index] == b[index]:
        index += 1
    return index


def _read_keys(cursor: _Cursor, count: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix_lengths = [0] + cursor.varints(count - 1) if count else []
    suffix_lengths = cursor.varints(count)
    common = cursor.varints(count) if interior else []
    keys, previous = [], b""
    for index in range(count):
        key = previous[: prefix_lengths[index]] + cursor.take(suffix_lengths[index])
        keys.append(key)
        previous = key
    return keys, common


@dataclass(frozen=True)
class _Location:
    file: str
    offset: int
    length: int


@dataclass(frozen=True)
class _Version:
    generation: int
    root_height: int
    root: Optional[_Location]


@dataclass
class DatabaseConfig:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: Optional[int] = None


def _read_config(cursor: _Cursor) -> DatabaseConfig:
    identifier = cursor.take(16)
    kind, inline, node_bytes = cursor.varints(3)
    (arity,) = cursor.u8s(1)
    compression = cursor.varint()
    level = None
    if compression == _COMPRESSION_ZSTD:
        (level,) = struct.unpack("<i", cursor.take(4))
    elif compression != _COMPRESSION_NONE:
        raise ValueError(f"OCDBT config: unknown compression {compression}")
    return DatabaseConfig(identifier, kind, inline, node_bytes, arity, compression, level)


def _location(files: List[str], file_id: int, offset: int, length: int) -> Optional[_Location]:
    if offset == _NULL and length == _NULL:
        return None
    if file_id >= len(files):
        raise ValueError(f"OCDBT: data file {file_id} not in a table of {len(files)}")
    return _Location(files[file_id], offset, length)


def _read_version_leaves(cursor: _Cursor, files: List[str]) -> List[_Version]:
    count = cursor.varint()
    generations = cursor.varints(count)
    heights = cursor.u8s(count)
    file_ids, offsets, lengths = cursor.varints(count), cursor.varints(count), cursor.varints(count)
    for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
        cursor.varints(count)
    cursor.u64s(count)  # commit_time
    return [_Version(generations[i], heights[i], _location(files, file_ids[i], offsets[i], lengths[i])) for i in range(count)]


def _read_version_references(cursor: _Cursor, files: List[str], with_height: bool):
    count = cursor.varint()
    generations = cursor.varints(count)
    file_ids, offsets, lengths = cursor.varints(count), cursor.varints(count), cursor.varints(count)
    cursor.varints(count)  # num_generations
    cursor.u64s(count)  # commit_time
    heights = cursor.u8s(count) if with_height else [None] * count
    return [
        (generations[i], _location(files, file_ids[i], offsets[i], lengths[i]), heights[i]) for i in range(count)
    ]


class OcdbtReader:
    """Reads the newest version of the database at ``directory``.

    ``list(prefix)`` gives the keys (str) under a prefix in order;
    ``read(key)`` a value as bytes; ``read_into(key, array)`` reads it
    straight into a numpy buffer."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        manifest_path = os.path.join(self.directory, MANIFEST_FILE)
        with open(manifest_path, "rb") as file:
            body = _unframe(file.read(), MANIFEST_MAGIC, "manifest")
        cursor = _Cursor(body)
        self.config = _read_config(cursor)
        if self.config.manifest_kind != 0:
            raise ValueError(f"{manifest_path}: numbered OCDBT manifests are not supported (kind {self.config.manifest_kind})")
        files = _read_data_file_table(cursor)
        versions = _read_version_leaves(cursor, files)
        references = _read_version_references(cursor, files, with_height=True)
        if cursor.position != len(body):
            raise ValueError(f"{manifest_path}: {len(body) - cursor.position} bytes after the version tree")
        newest = max(versions, key=lambda version: version.generation) if versions else None
        if references:
            generation, location, height = max(references, key=lambda reference: reference[0])
            if newest is None or generation > newest.generation:
                newest = self._newest_in_version_node(location, height)
        self.version = newest
        self._entries: Dict[bytes, Tuple[Optional[_Location], Optional[bytes], int]] = {}
        if newest is not None and newest.root is not None:
            self._read_btree(newest.root, newest.root_height, b"")
        self._keys = sorted(self._entries)

    def _read_piece(self, location: _Location) -> bytes:
        with open(os.path.join(self.directory, location.file), "rb") as file:
            file.seek(location.offset)
            data = file.read(location.length)
        if len(data) != location.length:
            raise ValueError(f"OCDBT: {location.file} ends before byte {location.offset + location.length}")
        return data

    def _newest_in_version_node(self, location: _Location, height: int) -> _Version:
        body = _unframe(self._read_piece(location), VERSION_NODE_MAGIC, "version node")
        cursor = _Cursor(body)
        cursor.u8s(1)  # arity_log2
        (node_height,) = cursor.u8s(1)
        if node_height != height:
            raise ValueError(f"OCDBT version node: height {node_height}, expected {height}")
        files = _read_data_file_table(cursor)
        if node_height == 0:
            return max(_read_version_leaves(cursor, files), key=lambda version: version.generation)
        generation, child, _ = max(_read_version_references(cursor, files, with_height=False), key=lambda r: r[0])
        return self._newest_in_version_node(child, node_height - 1)

    def _read_btree(self, location: _Location, height: int, prefix: bytes) -> None:
        data = self._read_piece(location)
        body = _unframe(data, BTREE_NODE_MAGIC, "B-tree node")
        if len(body) > self.config.max_decoded_node_bytes:
            raise ValueError(f"OCDBT B-tree node of {len(body)} bytes above the configured maximum")
        cursor = _Cursor(body)
        (node_height,) = cursor.u8s(1)
        if node_height != height:
            raise ValueError(f"OCDBT B-tree node: height {node_height}, expected {height}")
        files = _read_data_file_table(cursor)
        count = cursor.varint()
        keys, common = _read_keys(cursor, count, interior=height > 0)
        if height > 0:
            file_ids, offsets, lengths = cursor.varints(count), cursor.varints(count), cursor.varints(count)
            for _ in range(3):  # num_keys, num_tree_bytes, num_indirect_value_bytes
                cursor.varints(count)
            for index in range(count):
                child = _location(files, file_ids[index], offsets[index], lengths[index])
                self._read_btree(child, height - 1, prefix + keys[index][: common[index]])
            return
        value_lengths = cursor.varints(count)
        kinds = cursor.u8s(count)
        indirect = [index for index in range(count) if kinds[index] == 1]
        if any(kind > 1 for kind in kinds):
            raise ValueError("OCDBT leaf: unknown value kind")
        file_ids, offsets = cursor.varints(len(indirect)), cursor.varints(len(indirect))
        references = {
            index: _location(files, file_ids[n], offsets[n], value_lengths[index]) for n, index in enumerate(indirect)
        }
        for index in range(count):
            key = prefix + keys[index]
            if kinds[index] == 1:
                self._entries[key] = (references[index], None, value_lengths[index])
            else:
                self._entries[key] = (None, cursor.take(value_lengths[index]), value_lengths[index])
        if cursor.position != len(body):
            raise ValueError(f"OCDBT leaf: {len(body) - cursor.position} bytes after its values")

    def list(self, prefix: str = "") -> List[str]:
        encoded = prefix.encode()
        return [key.decode() for key in self._keys if key.startswith(encoded)]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def size(self, key: str) -> int:
        return self._entry(key)[2]

    def _entry(self, key: str):
        try:
            return self._entries[key.encode()]
        except KeyError:
            raise KeyError(f"{key!r} is not in the OCDBT database at {self.directory}") from None

    def read(self, key: str) -> bytes:
        location, inline, _length = self._entry(key)
        return inline if location is None else self._read_piece(location)

    def read_into(self, key: str, buffer: np.ndarray) -> None:
        """Reads the value of ``key`` into ``buffer`` (contiguous, exactly the
        value's size in bytes) without an intermediate copy."""
        location, inline, length = self._entry(key)
        target = buffer.reshape(-1).view(np.uint8)
        if target.size != length:
            raise ValueError(f"{key!r} holds {length} bytes, the buffer {target.size}")
        if location is None:
            target[:] = np.frombuffer(inline, np.uint8)
            return
        read_file_into(os.path.join(self.directory, location.file), location.offset, target)


class OcdbtWriter:
    """Writes a new database at ``directory``: ``put`` appends each value to
    one data file as it comes; ``close`` writes the leaf node (every value
    out of line) after them and then the manifest."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(os.path.join(self.directory, "d"), exist_ok=True)
        if os.path.exists(os.path.join(self.directory, MANIFEST_FILE)):
            raise FileExistsError(f"an OCDBT database already exists at {self.directory}")
        self._relative = "d/" + uuid.uuid4().hex
        self._file = open(os.path.join(self.directory, self._relative), "wb")
        self._entries: Dict[bytes, Tuple[int, int]] = {}
        self._offset = 0

    def put(self, key: str, value) -> None:
        encoded = key.encode()
        if encoded in self._entries:
            raise KeyError(f"{key!r} written twice")
        view = memoryview(value).cast("B")
        self._file.write(view)
        self._entries[encoded] = (self._offset, view.nbytes)
        self._offset += view.nbytes

    def close(self) -> None:
        keys = sorted(self._entries)
        count = len(keys)
        prefixes = [0] + [_common_prefix(keys[i - 1], keys[i]) for i in range(1, count)]
        body = bytearray([0])  # height 0: a leaf
        body += _write_data_file_table([("", self._relative)])
        body += _varint(count)
        body += b"".join(_varint(p) for p in prefixes[1:])
        body += b"".join(_varint(len(key) - p) for key, p in zip(keys, prefixes))
        body += b"".join(key[p:] for key, p in zip(keys, prefixes))
        body += b"".join(_varint(self._entries[key][1]) for key in keys)
        body += bytes([1]) * count  # every value is a reference
        body += b"".join(_varint(0) for _ in keys)  # data file 0
        body += b"".join(_varint(self._entries[key][0]) for key in keys)
        if len(body) > _WRITER_MAX_DECODED_NODE_BYTES:
            raise ValueError(f"one leaf node of {len(body)} bytes exceeds max_decoded_node_bytes")
        node = _frame(BTREE_NODE_MAGIC, bytes(body))
        node_offset = self._offset
        self._file.write(node)
        self._file.close()

        manifest = bytearray(uuid.uuid4().bytes)
        manifest += _varint(0)  # manifest kind: single
        manifest += _varint(_WRITER_MAX_INLINE_VALUE_BYTES) + _varint(_WRITER_MAX_DECODED_NODE_BYTES)
        manifest += bytes([4])  # version_tree_arity_log2
        manifest += _varint(_COMPRESSION_NONE)
        manifest += _write_data_file_table([("", self._relative)])
        manifest += _varint(1)  # one version
        manifest += _varint(1)  # generation 1
        manifest += bytes([0])  # root height
        manifest += _varint(0) + _varint(node_offset) + _varint(len(node))
        manifest += _varint(count) + _varint(len(node)) + _varint(self._offset)
        manifest += struct.pack("<Q", time.time_ns())
        manifest += _varint(0)  # no version-tree nodes
        temporary = os.path.join(self.directory, MANIFEST_FILE + ".tmp")
        with open(temporary, "wb") as file:
            file.write(_frame(MANIFEST_MAGIC, bytes(manifest)))
        os.replace(temporary, os.path.join(self.directory, MANIFEST_FILE))

    def __enter__(self) -> "OcdbtWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self._file.close()
