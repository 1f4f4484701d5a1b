"""The port's zstd decoder (allophant_tpu_torch/native/src/zstd_decoder.cpp,
bound in allophant_tpu_torch/native/zstd.py) against the ``zstandard``
package, which is imported here only: every frame ``zstandard`` writes at
levels -5, 1, 3, 9 and 19, with and without the content size and the
checksum, decodes to the same bytes (0 B, 1 B, 100 KB and 4 MB of random and
repetitive float32 data, and of quantised float32 data but at level 19 and
4 MB); concatenated and skippable frames decode; a flipped checksum byte, a
dictionary frame and corrupt frames raise; a failed build raises with the
compiler's message. The committed timing frame (tests/data/zstd_timing/,
tools/write_zstd_timing_frame.py) decodes to the content the tool makes."""

import hashlib
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import zstandard

from allophant_tpu_torch.native import build, zstd

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import write_zstd_timing_frame as timing_frame  # noqa: E402

LEVELS = (-5, 1, 3, 9, 19)
SIZES = {"0B": 0, "1B": 1, "100KB": 100_000, "4MB": 4 << 20}
KINDS = ("random", "repetitive", "quantised")
FLAGS = {"size+checksum": (True, True), "size": (True, False), "checksum": (False, True), "bare": (False, False)}


def _data(kind: str, size: int) -> bytes:
    """``size`` bytes of float32 data: random normals (Huffman literals, few
    matches), a repeated 1000-value block (long matches, repeat offsets), or
    normals rounded to one decimal (short matches and literals mixed)."""
    rng = np.random.default_rng(size + len(kind))
    count = -(-size // 4)
    if kind == "random":
        values = rng.standard_normal(count)
    elif kind == "repetitive":
        values = np.resize(rng.standard_normal(1000), count)
    else:
        values = np.round(rng.standard_normal(count), 1)
    return values.astype(np.float32).tobytes()[:size]


# Every level x size x kind x flags, except quantised data at 4 MB and level
# 19, whose compression alone takes seconds (random and repetitive data
# cover that level and size).
CASES = [
    case
    for case in itertools.product(LEVELS, SIZES, KINDS, FLAGS)
    if not (case[0] == 19 and case[1] == "4MB" and case[2] == "quantised")
]


@pytest.mark.parametrize(
    "level, size, kind, flags", CASES, ids=["level{}-{}-{}-{}".format(*case) for case in CASES]
)
def test_decodes_what_zstandard_writes(level, size, kind, flags):
    data = _data(kind, SIZES[size])
    content_size, checksum = FLAGS[flags]
    frame = zstandard.ZstdCompressor(level=level, write_content_size=content_size, write_checksum=checksum).compress(data)
    assert zstd.content_size(frame) == (len(data) if content_size else None)
    assert zstd.decompress(frame) == data


def _streamed(data: bytes) -> bytes:
    """A frame without a content size, as a streaming writer makes it."""
    compressor = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    return compressor.compress(data) + compressor.flush()


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return (0x184D2A50 + nibble).to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


@pytest.mark.parametrize("arrangement", ["sized", "streamed", "mixed", "skippable", "only-skippable"])
def test_concatenated_and_skippable_frames(arrangement):
    parts = [_data("quantised", 70_000), _data("repetitive", 5_000), b"", _data("random", 3_000)]
    sized = [zstandard.ZstdCompressor(level=1, write_checksum=True).compress(part) for part in parts]
    if arrangement == "sized":
        frames, expected = b"".join(sized), b"".join(parts)
    elif arrangement == "streamed":
        frames, expected = b"".join(_streamed(part) for part in parts), b"".join(parts)
    elif arrangement == "mixed":
        frames, expected = sized[0] + _streamed(parts[1]) + sized[3], parts[0] + parts[1] + parts[3]
    elif arrangement == "skippable":
        frames = _skippable(b"meta", 3) + sized[0] + _skippable(b"", 15) + sized[1] + _skippable(bytes(100), 0)
        expected = parts[0] + parts[1]
    else:
        frames, expected = _skippable(b"x" * 10, 7), b""
    assert zstd.decompress(frames) == expected


def test_the_committed_timing_frame_decodes_to_its_content():
    directory = ROOT / "tests" / "data" / "zstd_timing"
    frame = (directory / timing_frame.FRAME_FILE).read_bytes()
    meta = json.loads((directory / timing_frame.META_FILE).read_text(encoding="utf-8"))
    expected = timing_frame.content()
    assert len(frame) < 150_000
    assert meta["decoded_bytes"] == len(expected) == timing_frame.SIZE
    assert meta["sha256"] == hashlib.sha256(expected).hexdigest()
    output = np.empty(len(expected), np.uint8)
    assert zstd.decompress_into(frame, output) == len(expected)
    assert output.tobytes() == expected == zstandard.ZstdDecompressor().decompress(frame)


def test_output_into_a_buffer_and_its_bound():
    data = _data("quantised", 50_000)
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    buffer = np.zeros(len(data), np.uint8)
    assert zstd.decompress_into(frame, buffer) == len(data)
    assert buffer.tobytes() == data
    with pytest.raises(zstd.ZstdError, match="larger than"):
        zstd.decompress_into(frame, np.zeros(len(data) - 1, np.uint8))


@pytest.mark.parametrize("position", [-1, -2, -3, -4])
def test_flipped_checksum_byte_raises(position):
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(_data("quantised", 20_000)))
    frame[position] ^= 0x20
    with pytest.raises(zstd.ZstdError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))


def test_dictionary_frame_raises():
    samples = [b"allophant " * 20 + bytes([index]) * 30 for index in range(200)]
    dictionary = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(b"allophant " * 50)
    with pytest.raises(zstd.ZstdError, match=f"dictionary {dictionary.dict_id()}"):
        zstd.decompress(frame)


def test_corrupt_frames_raise():
    data = _data("quantised", 40_000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    with pytest.raises(zstd.ZstdError, match="bad magic"):
        zstd.decompress(b"\x00" + frame)
    for cut in (3, 6, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])
    reserved = bytearray(frame)
    reserved[4] |= 0x08  # the frame header's reserved bit
    with pytest.raises(zstd.ZstdError, match="reserved bit"):
        zstd.decompress(bytes(reserved))
    # Damage anywhere in the blocks raises (the checksum catches what decodes).
    rng = np.random.default_rng(0)
    for position in rng.integers(6, len(frame) - 4, 40):
        damaged = bytearray(frame)
        damaged[position] ^= 1 << int(rng.integers(8))
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(damaged))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    compiler = tmp_path / "cxx"
    compiler.write_text("#!/bin/sh\necho 'zstd_decoder.cpp: no compiler here' >&2\nexit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setenv("CXX", str(compiler))
    monkeypatch.setattr(build, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(zstd, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        zstd.decompress(zstandard.ZstdCompressor().compress(b"data"))
