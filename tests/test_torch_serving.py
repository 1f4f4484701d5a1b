"""The port's serving export (allophant_tpu_torch/serving.py, the ``export``
sub-command and the kernels' custom ops in kernels/library.py) against the
JAX package's (allophant_tpu/serving.py, tests/test_serving.py), on the CPU at
"float32": the mini configuration and inventories of tests/test_serving.py,
the JAX estimator's parameters carried across with ``weights.py``, inputs
drawn with numpy from a seed.

- each port artifact (export -> save -> load) against JAX's artifact
  (``export_transcriber`` -> ``save_transcriber`` -> ``load_transcriber``) on
  the same batch, for greedy, log_probs and beam4: tokens, counts and lengths
  integer-equal, log-probs within 1e-4, the beam triples through each
  package's ``backtrace_beams`` the same n-best tokens with scores within
  1e-4;
- the same artifacts against the port's live ``predict``,
  ``predict_decoded`` and ``predict_beam_decoded``;
- ``allophant-torch export --cpu`` end to end; the loader in a fresh process
  (no model, training or data module imported); ``torch.library.opcheck``
  of the three custom ops; what raises."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from allophant_tpu import serving as jax_serving
from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_graph_from_config
from allophant_tpu.ops.decode import backtrace_beams as jax_backtrace_beams
from allophant_tpu.phonetics.features import LanguageInventories as JaxInventories
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training import Estimator as JaxEstimator
from allophant_tpu_torch import serving
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.kernels import library
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.ops.decode import backtrace_beams
from allophant_tpu_torch.phonetics.features import LanguageInventories, PhoneticAttributeIndexer
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.weights import load_jax_variables

from fixtures import mini_allophoible_csv, mini_config_dict
from torch_parity import numpy_tree, shared_across_workers

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = Path(__file__).resolve().parent.parent
BATCH, SAMPLES = 2, 640
MODES = ("greedy", "log_probs", "beam4")
# float32 in two frameworks' summation orders (tests/test_serving.py holds
# JAX's artifact to its live path at 1e-5, the port's parity tests hold the
# two packages to each other at 1e-4).
LOG_PROB_ATOL, LIVE_ATOL, SCORE_ATOL = 1e-4, 1e-5, 1e-4
N_BEST = 2


def _inventories(package):
    return package({0: ["a", "o", "n"], 1: ["a", "s", "i"]}, ["es", "it"])


def _example_batch(batch_size=BATCH, samples=SAMPLES):
    """tests/test_serving.py's batch: seeded noise, the second row 128
    samples short, languages 0 and 1."""
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((batch_size, samples)).astype(np.float32)
    lengths = np.array([samples, samples - 128], dtype=np.int32)[:batch_size]
    language_ids = np.arange(batch_size, dtype=np.int32) % 2
    return audio, lengths, language_ids


def _jax_reference(directory):
    """JAX's float32 mini estimator's variables and each mode's artifact
    outputs on the example batch, as numpy."""
    config = JaxConfig.load(mini_config_dict())
    indexer = JaxIndexer.from_config(config, mini_allophoible_csv(), _inventories(JaxInventories))
    estimator = JaxEstimator.from_config(
        config, 1, 16_000, jax_graph_from_config(config, indexer), indexer, load_pretrained_weights=False, precision="float32"
    )
    outputs = {}
    for mode in MODES:
        path = str(Path(directory) / f"{mode}.stablehlo")
        jax_serving.save_transcriber(jax_serving.export_transcriber(estimator, BATCH, SAMPLES, decode=mode), path)
        result = jax_serving.load_transcriber(path)(*_example_batch())
        outputs[mode] = jax.tree_util.tree_map(np.asarray, result)
    return {"variables": numpy_tree(jax.tree_util.tree_map(np.asarray, estimator.variables)), "outputs": outputs}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return shared_across_workers(tmp_path_factory, "jax-serving", _jax_reference)


@pytest.fixture(scope="module")
def port(reference):
    """(the port's float32 mini estimator on the CPU with JAX's weights, its
    indexer)."""
    config = Config.load(mini_config_dict())
    indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv(), _inventories(LanguageInventories))
    estimator = Estimator.from_config(
        config, 1, 16_000, attribute_graph_from_config(config, indexer), indexer,
        load_pretrained_weights=False, precision="float32", device="cpu",
    )
    load_jax_variables(estimator.model, reference["variables"])
    return estimator, indexer


@pytest.fixture(scope="module")
def artifacts(port, tmp_path_factory):
    """{mode: (path, the loaded artifact's outputs on the example batch)}."""
    estimator, _indexer = port
    directory = tmp_path_factory.mktemp("port-artifacts")
    results = {}
    for mode in MODES:
        path = str(directory / f"{mode}.pt2")
        serving.save_transcriber(serving.export_transcriber(estimator, BATCH, SAMPLES, decode=mode, device="cpu"), path)
        results[mode] = (path, serving.load_transcriber(path)(*_example_batch()))
    return results


def _numpy(tree):
    return jax.tree_util.tree_map(lambda leaf: leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf), tree)


def _n_best(backtrace, parents, emitted, scores, lengths):
    """Per row, the N_BEST best hypotheses as (tokens, score), through a
    package's host backtrace."""
    return _ranked(*backtrace(np.asarray(parents), np.asarray(emitted), np.asarray(scores), np.asarray(lengths)))


def _ranked(collected, scores):
    """Per row, the N_BEST best (tokens, score) of [T, B, K] tokens (-1 =
    none) and [B, K] scores."""
    rows = []
    for row in range(collected.shape[1]):
        order = np.argsort(-scores[row], kind="stable")[:N_BEST]
        rows.append([(collected[:, row, beam][collected[:, row, beam] >= 0], float(scores[row, beam])) for beam in order])
    return rows


def _assert_same_n_best(got, expected):
    for got_row, expected_row in zip(got, expected, strict=True):
        for (tokens, score), (expected_tokens, expected_score) in zip(got_row, expected_row, strict=True):
            np.testing.assert_array_equal(tokens, expected_tokens)
            assert score == pytest.approx(expected_score, abs=SCORE_ATOL)


def _assert_greedy_equal(decoded, expected):
    assert set(decoded) == set(expected)
    for name, (tokens, counts) in decoded.items():
        np.testing.assert_array_equal(tokens, expected[name][0], err_msg=name)
        np.testing.assert_array_equal(counts, expected[name][1], err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_artifact_matches_jax_artifact(reference, artifacts, mode):
    got = _numpy(artifacts[mode][1])
    expected = reference["outputs"][mode]
    np.testing.assert_array_equal(got[-1], expected[-1])
    assert got[-1].dtype == np.int32
    if mode == "log_probs":
        assert set(got[0]) == set(expected[0])
        for name, value in got[0].items():
            for row, length in enumerate(got[-1]):
                np.testing.assert_allclose(value[row, :length], expected[0][name][row, :length], atol=LOG_PROB_ATOL, rtol=0, err_msg=name)
        return
    _assert_greedy_equal(got[0], expected[0])
    if mode == "beam4":
        assert "phoneme" not in got[0]
        _assert_same_n_best(_n_best(backtrace_beams, *got[1], got[-1]), _n_best(jax_backtrace_beams, *expected[1], expected[-1]))


@pytest.mark.parametrize("mode", MODES)
def test_artifact_matches_the_live_calls(port, artifacts, mode):
    """The artifact equals the port's own ``predict`` (log-probs within 1e-5,
    the live path padding to its length bucket as JAX's test notes),
    ``predict_decoded`` and ``predict_beam_decoded`` on the same batch."""
    estimator, _indexer = port
    got = _numpy(artifacts[mode][1])
    batch = Batch(*_example_batch())
    if mode == "log_probs":
        predictions = estimator.predict(batch, time_major=False)
        np.testing.assert_array_equal(got[-1], predictions.lengths.numpy())
        for name, value in got[0].items():
            live = predictions.outputs[name].numpy()[:, : value.shape[1]]
            np.testing.assert_allclose(value, live, atol=LIVE_ATOL, rtol=0, err_msg=name)
        return
    heads = tuple(sorted(got[0]))
    grid, lengths = estimator.predict_decoded(batch, heads=heads)
    np.testing.assert_array_equal(got[-1], lengths.numpy())
    grid = grid.numpy().astype(np.int64)
    for index, name in enumerate(heads):
        tokens, counts = got[0][name]
        np.testing.assert_array_equal(counts, grid[index, :, 0], err_msg=name)
        for row, count in enumerate(counts):
            np.testing.assert_array_equal(tokens[row, :count], grid[index, row, 1 : 1 + count], err_msg=name)
            assert (tokens[row, count:] == -1).all()
    if mode == "beam4":
        collected, scores, _lengths = estimator.predict_beam_decoded(batch, heads=("phoneme",), beam_width=4)
        live = _ranked(collected[0].numpy().astype(np.int64), scores[0].numpy())
        _assert_same_n_best(_n_best(backtrace_beams, *got[1], got[-1]), live)


def test_export_cli_roundtrip(port, reference, tmp_path):
    """``allophant-torch export --cpu`` from a checkpoint writes an artifact
    that loads and runs, and decodes as JAX's greedy artifact does."""
    from allophant_tpu_torch.cli import run as run_cli

    estimator, indexer = port
    checkpoint = str(tmp_path / "model.ckpt")
    estimator.save(checkpoint, phonetic_indexer_state=indexer.state())
    artifact = str(tmp_path / "transcriber.pt2")
    run_cli.main(["export", checkpoint, artifact, "--cpu", "-s", "2", "-d", "0.04", "--decode", "greedy"])
    call = serving.load_transcriber(artifact)
    metadata = call.metadata
    assert metadata["batch_size"] == BATCH and metadata["samples"] == SAMPLES and metadata["device"] == "cpu"
    assert metadata["decode"] == "greedy" and "phoneme" in metadata["heads"]
    # The restore's default preset, which the export recorded.
    restored, _ = Estimator.restore(checkpoint, precision=metadata["precision"], device="cpu")
    decoded, frame_lengths = call(*_example_batch())
    assert "phoneme" in decoded and tuple(frame_lengths.shape) == (BATCH,)
    grid, _lengths = restored.predict_decoded(Batch(*_example_batch()), heads=("phoneme",))
    tokens, counts = decoded["phoneme"]
    np.testing.assert_array_equal(counts.numpy(), grid[0, :, 0].numpy().astype(np.int64))


_LOADER_SCRIPT = """
import json, sys
import numpy as np
from allophant_tpu_torch.serving import load_transcriber
call = load_transcriber(sys.argv[1])
rng = np.random.default_rng(4)
audio = rng.standard_normal((2, 640)).astype(np.float32)
decoded, lengths = call(audio, np.array([640, 512], np.int32), np.array([0, 1], np.int32))
prefixes = tuple(f"allophant_tpu_torch.{package}" for package in ("models", "training", "data"))
loaded = sorted(name for name in sys.modules if name.startswith(prefixes))
counts = {name: value[1].tolist() for name, value in decoded.items()}
print(json.dumps({"loaded": loaded, "counts": counts, "lengths": lengths.tolist()}))
"""


def test_loader_imports_no_model_code(artifacts):
    """A fresh process loads and runs the greedy artifact with the port's
    models, training and data packages never imported, and decodes as this
    process does."""
    path, outputs = artifacts["greedy"]
    result = subprocess.run(
        [sys.executable, "-c", _LOADER_SCRIPT, path], stdin=subprocess.DEVNULL, capture_output=True, text=True,
        cwd=str(ROOT), timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert result.returncode == 0, result.stderr[-4000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    decoded, lengths = outputs
    assert report["lengths"] == lengths.tolist()
    assert report["counts"] == {name: value[1].tolist() for name, value in decoded.items()}


def _opcheck_inputs(name):
    rng = np.random.default_rng(9)

    def tensor(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if name == "oneshot_attention":
        bias = torch.zeros(2, 7)
        bias[1, 5:] = -1e9
        return library.oneshot_attention, (tensor(2, 7, 16), tensor(2, 7, 16), tensor(2, 7, 16), bias, 0.25, 2)
    if name == "frame_conv":
        return library.frame_conv, (tensor(2, 103), tensor(10, 8), tensor(8), tensor(8), tensor(8), 1e-5, torch.bfloat16)
    return library.beam_search, (torch.log_softmax(tensor(2, 9, 5), dim=-1), torch.tensor([9, 4]), 3, 0)


@pytest.mark.parametrize("name", ["oneshot_attention", "frame_conv", "beam_search"])
def test_custom_ops_pass_opcheck(name):
    """The schema, the fake rule (shapes, dtypes and strides of the CPU
    implementation's outputs) and the op under AOT dispatch."""
    op, arguments = _opcheck_inputs(name)
    results = torch.library.opcheck(op, arguments)
    assert set(results.values()) == {"SUCCESS"}, results


def test_unknown_modes_and_platforms_raise(port, tmp_path):
    from allophant_tpu_torch.cli import run as run_cli

    estimator, _indexer = port
    with pytest.raises(ValueError, match="Unknown decode mode 'viterbi'"):
        serving.make_serving_fn(estimator, decode="viterbi")
    for platforms in ("tpu", "cuda,cpu"):
        with pytest.raises(ValueError, match="one device"):
            run_cli.main(["export", str(tmp_path / "missing.ckpt"), str(tmp_path / "out.pt2"), "--platforms", platforms])
    with pytest.raises(ValueError, match="lies on cpu"):
        serving.export_transcriber(estimator, BATCH, SAMPLES, device="meta")
    from allophant_tpu_torch.parallel.mesh import create_mesh

    try:
        with pytest.raises(ValueError, match="spread over a mesh"):
            serving.export_transcriber(estimator.use_data_parallel(create_mesh()), BATCH, SAMPLES, device="cpu")
    finally:
        estimator.mesh = None


def test_artifact_takes_only_its_static_shape(artifacts):
    call = serving.load_transcriber(artifacts["greedy"][0])
    audio, lengths, language_ids = _example_batch(BATCH, 320)
    with pytest.raises(ValueError, match="takes audio of shape"):
        call(audio, lengths, language_ids)
