"""Orbax checkpoints in the port (allophant_tpu_torch/training/ocdbt.py,
orbax_arrays.py and checkpoint.py's ``save_orbax`` / ``load_orbax``)
against the JAX package and tensorstore, which are imported here only.

- JAX's ``save_orbax`` of the mini model of tests/test_estimator.py restores
  in the port with every leaf bit-equal, the same optimizer bytes and
  metadata, and greedy grids integer-exact against JAX's restored estimator
  (log-probs within 1e-4).
- The port's ``save_orbax`` reads back bit-equal through JAX's
  ``load_orbax`` and ``Estimator.restore``.
- OCDBT corner cases written by tensorstore itself: interior B-tree nodes,
  several versions, values on both sides of the inline limit, zstd and
  uncompressed nodes; zarr arrays with edge chunks and a missing chunk.
- A sharded save on 4 virtual CPU devices (tools/write_orbax_fixture.py, in
  a subprocess) and the committed fixture it wrote, tests/data/orbax_mini/,
  read back equal to their gathered arrays in both packages.
- ``"use_ocdbt": false`` reads back equal; ``"use_zarr3": true`` raises.
- ``predict`` and ``train --restore`` take an Orbax directory; under two
  gloo ranks only rank 0 writes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.data.batch import Batch as JaxBatch
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_attribute_graph
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training import checkpoint as jax_checkpoint_module
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.data.zarr_store import parse_array_metadata, read_chunked_array
from allophant_tpu_torch.training import checkpoint as checkpoint_module
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.training.ocdbt import OcdbtReader, OcdbtWriter
from allophant_tpu_torch.training.orbax_arrays import read_tree

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "orbax_mini"


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            yield from _leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), value


def _numpy(tree):
    return {path: (value if isinstance(value, dict) else np.asarray(value)) for path, value in _leaves(tree)}


def _assert_bit_equal(got, expected):
    got, expected = _numpy(got), _numpy(expected)
    assert got.keys() == expected.keys()
    for path, value in expected.items():
        if isinstance(value, dict):
            assert got[path] == value, path
            continue
        assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


@pytest.fixture(scope="module")
def jax_orbax(tmp_path_factory):
    """(directory, JAX estimator, indexer) of JAX's ``save_orbax`` of the mini
    model (tests/test_estimator.py's TestOrbaxCheckpoint setup) with a
    non-zero epoch, a history and optimizer bytes."""
    config = JaxConfig.load(mini_config_dict())
    indexer = JaxIndexer.from_config(config, mini_allophoible_csv())
    estimator = JaxEstimator.from_config(
        config, 1, 16_000, jax_attribute_graph(config, indexer), indexer, load_pretrained_weights=False
    )
    directory = str(tmp_path_factory.mktemp("jax_orbax") / "checkpoint")
    jax_checkpoint_module.save_orbax(
        jax_checkpoint_module.Checkpoint(
            config=config,
            feature_size=1,
            sample_rate=16_000,
            attribute_graph=estimator.attribute_graph,
            epoch=jax_checkpoint_module.EpochPosition(3, 70, 7),
            phonetic_indexer_state=indexer.state(),
            variables=estimator.variables,
            optimizer_state=b"opaque-optimizer-bytes",
            history=[{"validation_loss": 2.5}],
        ),
        directory,
    )
    return directory, estimator, indexer


def test_port_reads_jax_orbax_bit_equal(jax_orbax):
    directory, estimator, _indexer = jax_orbax
    checkpoint = checkpoint_module.load_checkpoint(directory)
    _assert_bit_equal(checkpoint.variables, jax.tree_util.tree_map(np.asarray, estimator.variables))
    assert checkpoint.variables["buffers"] == {"projection": {}}
    assert checkpoint.optimizer_state == b"opaque-optimizer-bytes"
    expected = jax_checkpoint_module.load_orbax(directory)
    assert checkpoint_module.checkpoint_metadata(checkpoint) == json.loads(
        json.dumps(jax_checkpoint_module._checkpoint_metadata(expected))
    )


def _batch(rows=3):
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((rows, 1600)).astype(np.float32)
    lengths = np.full(rows, 1600, dtype=np.int32)
    lengths[-1] = 1100
    return audio, lengths, np.zeros(rows, dtype=np.int32)


def test_port_restore_predicts_like_jax(jax_orbax):
    directory = jax_orbax[0]
    jax_estimator, _ = JaxEstimator.restore(directory, precision="float32")
    estimator, indexer = Estimator.restore(directory, precision="float32", device="cpu")
    assert (estimator.epoch.epoch, estimator.epoch.global_step, estimator.epoch.step) == (3, 70, 7)
    assert estimator.training_state == b"opaque-optimizer-bytes"
    assert indexer.phonemes.tolist() == list(jax_orbax[2].phonemes)
    audio, lengths, language_ids = _batch()
    jax_batch, batch = JaxBatch(audio, lengths, language_ids), Batch(audio, lengths, language_ids)
    expected = jax_estimator.predict(jax_batch, time_major=False)
    got = estimator.predict(batch, time_major=False)
    heads = tuple(sorted(expected.outputs))
    assert set(got.outputs) == set(heads)
    for name in heads:
        np.testing.assert_allclose(got.outputs[name].numpy(), np.asarray(expected.outputs[name]), atol=1e-4, err_msg=name)
    expected_grid, _ = jax_estimator.predict_decoded(jax_batch, heads=heads)
    grid, _ = estimator.predict_decoded(batch, heads=heads)
    np.testing.assert_array_equal(grid.to(torch.int32).numpy(), np.asarray(expected_grid))


def test_jax_reads_the_ports_orbax_bit_equal(jax_orbax, tmp_path):
    directory, estimator, _indexer = jax_orbax
    checkpoint = checkpoint_module.load_checkpoint(directory)
    target = str(tmp_path / "port_orbax")
    checkpoint_module.save_orbax(checkpoint, target)
    restored = jax_checkpoint_module.load_orbax(target)
    _assert_bit_equal(
        jax.tree_util.tree_map(np.asarray, restored.variables),
        jax.tree_util.tree_map(np.asarray, estimator.variables),
    )
    assert restored.optimizer_state == b"opaque-optimizer-bytes"
    assert restored.epoch.global_step == 70 and restored.history == [{"validation_loss": 2.5}]
    jax_restored, _ = JaxEstimator.restore(target, precision="float32")
    _assert_bit_equal(
        jax.tree_util.tree_map(np.asarray, jax_restored.variables["params"]),
        jax.tree_util.tree_map(np.asarray, estimator.variables["params"]),
    )
    # Saving again over the directory replaces its variables.
    checkpoint.variables["params"]["acoustic_model"]["frontend_linear"]["bias"] += 1.0
    checkpoint_module.save_orbax(checkpoint, target)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, jax_checkpoint_module.load_orbax(target).variables), checkpoint.variables)


def test_the_port_round_trips_every_dtype(tmp_path):
    rng = np.random.default_rng(3)
    tree = {
        "float32": rng.standard_normal((3, 4, 5)).astype(np.float32),
        "float16": rng.standard_normal((6,)).astype(np.float16),
        "nested": {"int32": rng.integers(-9, 9, (2, 2)).astype(np.int32), "int64": np.arange(5, dtype=np.int64) << 40},
        "uint16": np.arange(7, dtype=np.uint16),
        "uint8": np.arange(4, dtype=np.uint8).reshape(2, 2),
        "bool": np.array([True, False, True]),
        "scalar": np.float32(1.5),
        "empty": {},
    }
    from allophant_tpu_torch.training.orbax_arrays import write_tree

    write_tree(str(tmp_path / "variables"), tree)
    got = read_tree(str(tmp_path / "variables"))
    _assert_bit_equal(got, {**tree, "scalar": np.asarray(tree["scalar"])})
    restored = jax.tree_util.tree_map(np.asarray, ocp.StandardCheckpointer().restore(str(tmp_path / "variables")))
    # JAX without x64 restores int64 leaves as int32, so they are held to the port's reader only.
    del restored["nested"]["int64"], tree["nested"]["int64"]
    _assert_bit_equal(restored, {**tree, "scalar": np.asarray(tree["scalar"])})


def _tensorstore_items(directory):
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}"}).result()
    return {key.decode(): store.read(key).result().value for key in store.list().result()}


def _tensorstore_write(directory, config, versions):
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}", "config": config}).result()
    for items in versions:
        transaction = ts.Transaction()
        for key, value in items.items():
            store.with_transaction(transaction).write(key, value).result()
        transaction.commit_async().result()


def _values(count, sizes, seed):
    rng = np.random.default_rng(seed)
    return {f"k{index:03d}/{'x' * (index % 5)}": rng.bytes(int(sizes[index % len(sizes)])) for index in range(count)}


@pytest.mark.parametrize("compression", [None, {"id": "zstd"}], ids=["uncompressed", "zstd"])
@pytest.mark.parametrize("case", ["interior-nodes", "two-versions", "inline-limit"])
def test_ocdbt_corner_cases_written_by_tensorstore(tmp_path, case, compression):
    config = {"compression": compression}
    if case == "interior-nodes":
        config["max_decoded_node_bytes"] = 256
        versions = [_values(60, [3, 40, 200], 0)]
    elif case == "two-versions":
        first, second = _values(20, [10, 2000], 1), _values(20, [5, 1500], 2)
        second.pop("k003/xxx")
        versions = [first, second]
    else:
        config["max_inline_value_bytes"] = 100
        versions = [_values(12, [0, 1, 99, 100, 101, 5000], 3)]
    directory = str(tmp_path / "db")
    _tensorstore_write(directory, config, versions)
    reader = OcdbtReader(directory)
    expected = _tensorstore_items(directory)
    assert reader.list() == sorted(expected)
    assert {key: reader.read(key) for key in reader.list()} == expected
    if case == "interior-nodes":
        assert reader.version.root_height > 0
    elif case == "two-versions":
        merged = {**versions[0], **versions[1]}
        assert expected == merged and expected["k003/xxx"] == versions[0]["k003/xxx"]
        assert reader.version.generation > 1
    else:
        assert {reader.size(key) for key in reader.list()} >= {99, 100, 101}
    assert reader.list("k00") == [key for key in sorted(expected) if key.startswith("k00")]


def test_tensorstore_reads_the_ports_ocdbt(tmp_path):
    items = _values(40, [0, 1, 1024, 1025, 70_000], 4)
    with OcdbtWriter(str(tmp_path / "db")) as writer:
        for key, value in items.items():
            writer.put(key, value)
    assert _tensorstore_items(str(tmp_path / "db")) == items
    buffer = np.zeros(70_000, np.uint8)
    key = next(key for key, value in items.items() if len(value) == 70_000)
    OcdbtReader(str(tmp_path / "db")).read_into(key, buffer)
    assert buffer.tobytes() == items[key]
    with pytest.raises(KeyError, match="not in the OCDBT database"):
        OcdbtReader(str(tmp_path / "db")).read("missing")


def _uncompressed_chunks_unused(key, _buffer):
    raise AssertionError(f"chunk {key!r} is zstd-compressed: read_chunked_array fetches it")


@pytest.mark.parametrize("kvstore", ["ocdbt", "file"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint16"])
def test_zarr_edge_chunks_and_a_missing_chunk(tmp_path, kvstore, dtype):
    """A [5, 7] array in [3, 4] chunks (padded edge chunks), zstd-compressed,
    written by tensorstore's zarr driver; then one chunk less."""
    base = {"driver": "file", "path": str(tmp_path / "store")}
    store = {"driver": "ocdbt", "base": base} if kvstore == "ocdbt" else base
    spec = {
        "driver": "zarr",
        "kvstore": {**store, "path": "array/"} if kvstore == "ocdbt" else {**store, "path": str(tmp_path / "store" / "array")},
        "metadata": {"shape": [5, 7], "chunks": [3, 4], "dtype": dtype if dtype == "bfloat16" else np.dtype(dtype).str,
                     "compressor": {"id": "zstd", "level": 3}, "fill_value": None},
        "create": True,
    }
    array = ts.open(spec).result()
    values = (np.arange(35).reshape(5, 7) * 3 + 1).astype(np.float32 if dtype != "uint16" else np.uint16)
    array.write(values.astype(array.dtype.numpy_dtype)).result()
    if kvstore == "ocdbt":
        reader = OcdbtReader(str(tmp_path / "store"))
        items = {key: reader.read(key) for key in reader.list("array/")}
    else:
        root = tmp_path / "store" / "array"
        items = {f"array/{path.name}": path.read_bytes() for path in root.iterdir()}
    metadata = parse_array_metadata(json.loads(items["array/.zarray"]))
    assert [key for key, _ in metadata.chunk_keys()] == ["0.0", "0.1", "1.0", "1.1"]
    got = read_chunked_array(metadata, lambda key: items.get(f"array/{key}"), _uncompressed_chunks_unused)
    assert got.dtype == (np.uint16 if dtype == "uint16" else np.float32)
    np.testing.assert_array_equal(got, values)
    del items["array/1.1"]
    with pytest.raises(KeyError, match="chunk '1.1' is missing"):
        read_chunked_array(metadata, lambda key: items.get(f"array/{key}"), _uncompressed_chunks_unused)


def _assert_matches_npz(tree, leaves, prefix):
    expected = {key[len(prefix) + 1 :]: leaves[key] for key in leaves.files if key.startswith(prefix + "/")}
    got = {"/".join(path): value for path, value in _leaves(tree) if not isinstance(value, dict)}
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        assert np.asarray(got[key]).dtype == value.dtype and np.shape(got[key]) == value.shape, key
        np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=key)


def _check_fixture(directory: Path, jax_too: bool):
    leaves = np.load(directory / "leaves.npz")
    checkpoint = checkpoint_module.load_checkpoint(str(directory / "checkpoint"))
    _assert_matches_npz(checkpoint.variables, leaves, "checkpoint")
    assert checkpoint.optimizer_state == b"fixture-optimizer"
    assert (checkpoint.epoch.epoch, checkpoint.epoch.global_step, checkpoint.epoch.step) == (2, 40, 5)
    _assert_matches_npz(read_tree(str(directory / "extras")), leaves, "extras")
    reader = OcdbtReader(str(directory / "checkpoint" / "variables"))
    chunks = [key for key in reader.list("params.acoustic_model.layers.q_proj.kernel/") if not key.endswith(".zarray")]
    assert len(chunks) > 1
    assert json.loads(reader.read("params.acoustic_model.layers.q_proj.kernel/.zarray"))["compressor"]["id"] == "zstd"
    if jax_too:
        restored = jax_checkpoint_module.load_orbax(str(directory / "checkpoint"))
        _assert_matches_npz(jax.tree_util.tree_map(np.asarray, restored.variables), leaves, "checkpoint")
        extras = ocp.StandardCheckpointer().restore(str(directory / "extras"))
        extras = {key: np.asarray(value) for key, value in extras.items()}
        extras["bfloat16"] = extras["bfloat16"].astype(np.float32)
        _assert_matches_npz(extras, leaves, "extras")


def test_a_sharded_jax_save_reads_back_equal(tmp_path):
    """tools/write_orbax_fixture.py in a subprocess on 4 virtual CPU devices:
    multi-chunk arrays under JAX's param_spec, a bf16 leaf and a scalar."""
    environment = {key: value for key, value in os.environ.items() if key != "XLA_FLAGS"}
    result = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "write_orbax_fixture.py"), str(tmp_path / "fixture")],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, env=environment, cwd=str(ROOT), timeout=600,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    _check_fixture(tmp_path / "fixture", jax_too=False)


def test_the_committed_fixture_reads_back_equal_in_both_packages():
    total = sum(path.stat().st_size for path in FIXTURE.rglob("*") if path.is_file())
    assert total < 300_000
    _check_fixture(FIXTURE, jax_too=True)


def test_without_ocdbt_and_zarr3(jax_orbax, tmp_path):
    directory, estimator, _indexer = jax_orbax
    target = tmp_path / "plain"
    target.mkdir()
    for name in (checkpoint_module.ORBAX_METADATA_FILE, "optimizer_state.bin"):
        shutil.copyfile(os.path.join(directory, name), target / name)
    checkpointer = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
    checkpointer.save(str(target / "variables"), estimator.variables)
    assert json.loads((target / "variables" / "_METADATA").read_text())["use_ocdbt"] is False
    assert not (target / "variables" / "manifest.ocdbt").exists()
    checkpoint = checkpoint_module.load_checkpoint(str(target))
    _assert_bit_equal(checkpoint.variables, jax.tree_util.tree_map(np.asarray, estimator.variables))

    # Uncompressed chunks as files: the port's own save, its OCDBT keys laid
    # out as a directory.
    ported = tmp_path / "ported"
    checkpoint_module.save_orbax(checkpoint, str(ported))
    files = tmp_path / "files"
    shutil.copytree(ported, files, ignore=shutil.ignore_patterns("variables"))
    store = OcdbtReader(str(ported / "variables"))
    for key in store.list():
        (files / "variables" / key).parent.mkdir(parents=True, exist_ok=True)
        (files / "variables" / key).write_bytes(store.read(key))
    metadata = json.loads((ported / "variables" / "_METADATA").read_text())
    (files / "variables" / "_METADATA").write_text(json.dumps({**metadata, "use_ocdbt": False}))
    _assert_bit_equal(checkpoint_module.load_checkpoint(str(files)).variables, checkpoint.variables)

    metadata = json.loads((target / "variables" / "_METADATA").read_text())
    metadata["use_zarr3"] = True
    (target / "variables" / "_METADATA").write_text(json.dumps(metadata))
    with pytest.raises(ValueError, match='"use_zarr3": true'):
        checkpoint_module.load_checkpoint(str(target))


PREDICT = ["--cpu", "--no-progress", "--precision", "float32", "-m", "utterances", "-s", "2"]


def _ucla_corpus(root: Path) -> Path:
    """tests/test_cli.py's corpus: 2 languages x 2 utterances of noise."""
    from test_cli import _write_wav

    rng = np.random.default_rng(0)
    for language, phonemes in [("spa", ["a", "t", "n"]), ("ita", ["a", "s"])]:
        base = root / language
        (base / "audio").mkdir(parents=True)
        (base / "inventory").write_text("".join(f"{phoneme} 5\n" for phoneme in phonemes), encoding="utf-8")
        utterances = [f"{language}_{index}" for index in range(2)]
        (base / "raw").write_text("".join(f"{utterance} rawform\n" for utterance in utterances), encoding="utf-8")
        (base / "text").write_text("".join(f"{utterance} {' '.join(phonemes)}\n" for utterance in utterances), encoding="utf-8")
        for index, utterance in enumerate(utterances):
            _write_wav(base / "audio" / f"{utterance}.wav", rng.uniform(-0.3, 0.3, 1600 + 320 * index).astype(np.float32))
    return root


class _Restored(Exception):
    pass


def test_the_clis_take_an_orbax_directory(jax_orbax, tmp_path, monkeypatch):
    """``predict`` from JAX's Orbax directory writes the same utterance lines
    as from a native copy of it (whose lines tests/test_torch_cli.py holds to
    JAX's CLI); ``train -d --restore`` with the directory as its save path
    restores from it while it holds no ``best.ckpt``
    (tests/test_torch_train_cli.py trains into it and restores again)."""
    from allophant_tpu_torch.cli import run as cli

    directory = jax_orbax[0]
    corpus = _ucla_corpus(tmp_path / "corpus")
    native = str(tmp_path / "model.ckpt")
    checkpoint_module.save_native(checkpoint_module.load_checkpoint(directory), native)
    lines = {}
    for name, checkpoint in (("orbax", directory), ("native", native)):
        output = tmp_path / f"{name}.jsonl"
        cli.main(["predict", str(corpus), checkpoint, *PREDICT, "-o", str(output)])
        lines[name] = output.read_text(encoding="utf-8").splitlines()[1:]  # after the header, which names the paths
    assert len(lines["orbax"]) == 4
    assert lines["orbax"] == lines["native"]

    read = []

    def load_checkpoint(path):
        read.append(path)
        raise _Restored

    monkeypatch.setattr(checkpoint_module, "load_checkpoint", load_checkpoint)
    with pytest.raises(_Restored):
        cli.main(["train", str(corpus), "-s", directory, "-d", "--restore", "--cpu", "--no-progress"])
    assert read == [directory]


_RANKS_SCRIPT = '''
import sys
import tempfile

from allophant_tpu_torch.parallel.launch import spawn
from allophant_tpu_torch.training import checkpoint as checkpoint_module


def save(rank, _world_size, _device, source, target):
    checkpoint = checkpoint_module.load_checkpoint(source)
    if rank == 1:  # what another rank holds must not reach the files
        checkpoint.variables["params"]["acoustic_model"]["frontend_linear"]["bias"] += 1.0
        checkpoint.optimizer_state = b"rank 1"
    checkpoint_module.save_orbax(checkpoint, target)


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as workdir:
        spawn(save, workdir, ["cpu", "cpu"], (sys.argv[1], sys.argv[2]))
'''


def test_under_two_ranks_rank_0_writes(jax_orbax, tmp_path):
    """Two gloo ranks (a subprocess spawning them) call ``save_orbax`` with
    different variables: the directory holds rank 0's."""
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS_SCRIPT)
    target = tmp_path / "written"
    environment = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    result = subprocess.run(
        [sys.executable, str(script), jax_orbax[0], str(target)],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, env=environment, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    written = checkpoint_module.load_checkpoint(str(target))
    _assert_bit_equal(written.variables, checkpoint_module.load_checkpoint(jax_orbax[0]).variables)
    assert written.optimizer_state == b"opaque-optimizer-bytes"
