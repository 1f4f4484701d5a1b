"""The port's precomputed-feature stores (``data/store.py``, ``data/zarr_store.py``
and the C++ LZ4 decoder ``native/src/lz4_codec.cpp``) against the JAX
package's: the LZ4 block codec, byte- and bit-shuffle, Blosc frames and the
VLen codec equal to JAX's functions on seeded bytes; the native and Python
LZ4 decoders agree; ragged stores and zarr caches written by either package
read alike in the other, lengths and features equal."""

import numpy as np
import pytest

from allophant_tpu.data import store as jax_store
from allophant_tpu.data import zarr_store as jax_zarr
from allophant_tpu_torch.data import store, zarr_store

SPLITS = {"train": ["es", "it"], "dev": ["it"]}
FEATURE_SIZE = 3


def _bytes(seed: int, size: int, repetitive: bool) -> bytes:
    rng = np.random.default_rng(seed)
    if repetitive:
        return (rng.integers(0, 8, size // 4 + 1, dtype=np.uint8).tobytes() * 4)[:size]
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("size", [0, 1, 77, 4099])
@pytest.mark.parametrize("repetitive", [False, True])
def test_lz4_blocks_equal_jax(size, repetitive):
    data = _bytes(size, size, repetitive)
    block = zarr_store.lz4_compress_block(data)
    assert block == jax_zarr.lz4_compress_block(data)
    assert zarr_store.lz4_decompress_block(block, size) == jax_zarr.lz4_decompress_block(block, size) == data


def test_native_and_python_lz4_decoders_agree(monkeypatch):
    assert zarr_store._native_lz4() is not None, "the port's native LZ4 decoder did not build"
    blocks = [(zarr_store.lz4_compress_block(data), len(data)) for data in (_bytes(9, 3000, True), _bytes(10, 513, False), b"")]
    native = [zarr_store.lz4_decompress_block(block, size) for block, size in blocks]
    monkeypatch.setattr(zarr_store, "_NATIVE_LZ4", None)
    monkeypatch.setattr(zarr_store, "_NATIVE_LZ4_FAILED", True)
    assert [zarr_store.lz4_decompress_block(block, size) for block, size in blocks] == native
    with pytest.raises(ValueError):
        zarr_store.lz4_decompress_block(b"\x44abcd\x0a\x00" + b"\x50tail5", 17)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_shuffles_equal_jax(typesize):
    data = _bytes(typesize, 64 * typesize * 3, False)
    for name in ("byte_shuffle", "byte_unshuffle", "bit_shuffle", "bit_unshuffle"):
        assert getattr(zarr_store, name)(data, typesize) == getattr(jax_zarr, name)(data, typesize), name
    assert zarr_store.bit_unshuffle(zarr_store.bit_shuffle(data, typesize), typesize) == data


@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("blocksize", [0, 256])
def test_blosc_frames_equal_jax(shuffle, blocksize):
    data = np.random.default_rng(shuffle).standard_normal(700).astype(np.float32).tobytes()
    frame = zarr_store.blosc_compress_lz4(data, 4, shuffle, blocksize)
    assert frame == jax_zarr.blosc_compress_lz4(data, 4, shuffle, blocksize)
    assert zarr_store.blosc_decompress(frame) == jax_zarr.blosc_decompress(frame) == data
    memcpy = zarr_store.blosc_compress_memcpy(data, 4)
    assert memcpy == jax_zarr.blosc_compress_memcpy(data, 4)
    assert zarr_store.blosc_decompress(memcpy) == data


def test_vlen_codec_equals_jax():
    rng = np.random.default_rng(4)
    items = [rng.standard_normal(size).astype(np.float32) for size in (0, 5, 12)]
    encoded = zarr_store.vlen_array_encode(items, np.dtype(np.float32))
    assert encoded == jax_zarr.vlen_array_encode(items, np.dtype(np.float32))
    for got, expected in zip(zarr_store.vlen_array_decode(encoded, np.dtype(np.float32)), items):
        np.testing.assert_array_equal(got, expected)


def _utterances():
    """(split, language) -> seeded [frames, FEATURE_SIZE] feature arrays."""
    rng = np.random.default_rng(7)
    return {
        (split, language): [rng.standard_normal((int(frames), FEATURE_SIZE)).astype(np.float32) for frames in rng.integers(1, 9, 3)]
        for split, languages in SPLITS.items()
        for language in languages
    }


def _write_ragged(module, root, utterances):
    module.write_meta(str(root), FEATURE_SIZE)
    for (split, language), features in utterances.items():
        writer = module.RaggedFeatureWriter(str(root), split, language, FEATURE_SIZE)
        for array in features:
            writer.append(array)
        writer.close()


def _write_zarr(module, root, utterances):
    writer = module.ZarrDirectoryWriter(str(root))
    writer.write_attrs("", {"feature_size": FEATURE_SIZE})
    for (split, language), features in utterances.items():
        vlen = module.StreamingVlenWriter(writer, f"{split}/{language}", "features", chunk_size=2)
        for array in features:
            vlen.append(array)
        vlen.close()
        writer.write_plain(f"{split}/{language}", "lengths", np.asarray([len(array) for array in features], np.int64), chunk_size=2)


@pytest.mark.parametrize("layout", ["ragged", "zarr"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_stores_read_in_both_directions(tmp_path, layout, direction):
    utterances = _utterances()
    writer_module, reader = {
        ("ragged", "jax-to-port"): (jax_store, store),
        ("ragged", "port-to-jax"): (store, jax_store),
        ("zarr", "jax-to-port"): (jax_zarr, store),
        ("zarr", "port-to-jax"): (zarr_store, jax_store),
    }[layout, direction]
    (_write_ragged if layout == "ragged" else _write_zarr)(writer_module, tmp_path, utterances)
    for lengths_only in (True, False):
        data = reader.preprocessed_features_or_lengths(str(tmp_path), SPLITS, lengths_only)
        for split, languages in SPLITS.items():
            expected = [array for language in languages for array in utterances[split, language]]
            assert data[split].lengths.tolist() == [len(array) for array in expected]
            if lengths_only:
                assert data[split].features is None
            else:
                assert len(data[split].features) == len(expected)
                for got, value in zip(data[split].features, expected):
                    np.testing.assert_array_equal(got, value)


def test_port_writers_write_jax_bytes(tmp_path):
    """Both packages' writers leave the same files, byte for byte."""
    utterances = _utterances()
    for layout, writers in (("ragged", (_write_ragged, store, jax_store)), ("zarr", (_write_zarr, zarr_store, jax_zarr))):
        write, ours, theirs = writers
        write(ours, tmp_path / f"{layout}-ours", utterances)
        write(theirs, tmp_path / f"{layout}-theirs", utterances)
        files = {
            side: {path.relative_to(tmp_path / f"{layout}-{side}"): path.read_bytes() for path in sorted((tmp_path / f"{layout}-{side}").rglob("*")) if path.is_file()}
            for side in ("ours", "theirs")
        }
        assert files["ours"] == files["theirs"], layout
