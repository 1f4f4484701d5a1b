"""The port's evaluation (allophant_tpu_torch/ops/levenshtein.py,
evaluation.py, evaluation_runner.py) against the JAX package's and against
the port's C++ edit-distance engine: the batched distances and I/D/S/C counts
are integer-equal, ties included; the device scorer equals the host scorer
over a predictions file; the result files round-trip through JSON and format
as JAX's do."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allophant_tpu import evaluation as jax_evaluation
from allophant_tpu import evaluation_runner as jax_runner
from allophant_tpu.ops import levenshtein as jax_levenshtein
from allophant_tpu.predictions import PredictionReader as JaxPredictionReader
from allophant_tpu_torch import evaluation_runner, phonemes
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.evaluation import MultilingualEvaluationResults, macro_average_error_rates
from allophant_tpu_torch.ops import levenshtein
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.predictions import JsonlWriter, PredictionMetaData, PredictionReader, UtterancePrediction

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _pairs(seed: int, alphabet: int, count: int = 200, longest: int = 14):
    """Seeded (expected, actual) token lists: random pairs with empty sides,
    every tenth pair equal and every seventh a one-token edit of the other. A
    small alphabet makes ties between the DP's sources frequent."""
    rng = np.random.default_rng(seed)
    symbols = [chr(ord("a") + index) for index in range(alphabet)]
    pairs = [([], []), (["a"], []), ([], ["b", "a"])]
    for index in range(count):
        expected = list(rng.choice(symbols, int(rng.integers(0, longest))))
        actual = list(rng.choice(symbols, int(rng.integers(0, longest))))
        if index % 10 == 0:
            actual = list(expected)
        elif index % 7 == 0 and expected:
            actual = list(expected)
            actual[int(rng.integers(len(actual)))] = symbols[-1]
        pairs.append((expected, actual))
    return pairs


@pytest.mark.parametrize("seed, alphabet", [(0, 2), (1, 3), (2, 8)])
def test_edit_statistics_equal_jax_and_the_native_engine(seed, alphabet):
    expected, actual = zip(*_pairs(seed, alphabet))
    ids = levenshtein.encode_token_batches(list(expected), list(actual))
    jax_ids = jax_levenshtein.encode_token_batches(list(expected), list(actual))
    for ours, theirs in zip(ids, jax_ids):
        np.testing.assert_array_equal(ours, theirs)

    tensors = [torch.from_numpy(array) for array in ids]
    distances = levenshtein.batched_levenshtein_distances(*tensors).numpy()
    np.testing.assert_array_equal(distances, np.asarray(jax_levenshtein.batched_levenshtein_distances(*map(jnp.asarray, ids))))
    counts = np.stack([values.numpy() for values in levenshtein.batched_edit_statistics(*tensors)])
    jax_counts = np.stack([np.asarray(values) for values in jax_levenshtein.batched_edit_statistics(*map(jnp.asarray, ids))])
    np.testing.assert_array_equal(counts, jax_counts)
    assert counts.dtype == np.int32

    native = [phonemes.levensthein_statistics(a, b) for a, b in zip(expected, actual)]
    np.testing.assert_array_equal(
        counts, np.array([[s.insertions for s in native], [s.deletions for s in native], [s.substitutions for s in native], [s.correct for s in native]])
    )
    np.testing.assert_array_equal(distances, [phonemes.levensthein(a, b) for a, b in zip(expected, actual)])


def test_corpus_error_rate_equals_jax():
    expected, actual = zip(*_pairs(3, 4))
    ids = levenshtein.encode_token_batches(list(expected), list(actual))
    ours = levenshtein.corpus_error_rate(*ids, device="cpu")
    assert ours == jax_levenshtein.corpus_error_rate(*ids)
    assert ours > 0


@pytest.fixture(scope="module")
def predictions_file(tmp_path_factory):
    """A predictions file over the mini table: 2 languages x 6 utterances,
    seeded phoneme labels, 2 candidates a head for "phoneme", "nasal" and
    "labial" (one candidate empty, one reference empty)."""
    config = Config.load(mini_config_dict())
    indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv())
    inventories = {"spa": ["a", "e", "t", "n", "s"], "ita": ["a", "i", "s", "ʃ", "t͡ʃ"]}
    heads = ["phoneme", "nasal", "labial"]
    metadata = PredictionMetaData("test", "ucla-phonetic", list(inventories), "phoible", indexer.state(), heads, inventories)
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("evaluation") / "predictions.jsonl")
    with JsonlWriter(path, metadata) as writer:
        for language, inventory in inventories.items():
            for index in range(6):
                labels = list(rng.choice(inventory, int(rng.integers(0 if index == 5 else 1, 8))))
                predictions = {}
                for head in heads:
                    values = inventory if head == "phoneme" else ["+", "-"]
                    predictions[head] = [
                        [] if index == 1 and candidate == 0 else list(rng.choice(values, int(rng.integers(0, 9))))
                        for candidate in range(2)
                    ]
                writer.write(UtterancePrediction(language, f"{language}_{index}", predictions, [labels]))
    return path


@pytest.mark.parametrize("remap", [False, True], ids=["no-remap", "remap"])
def test_device_scorer_equals_host_scorer_and_jax(predictions_file, remap):
    results = {}
    for scorer in ("device", "host"):
        with PredictionReader(predictions_file) as reader:
            results[scorer] = evaluation_runner.compute_edit_statistics(reader, map_phonemes=remap, scorer=scorer, device="cpu")
    assert results["device"] == results["host"]
    with JaxPredictionReader(predictions_file) as reader:
        jax_statistics = jax_runner.compute_edit_statistics(reader, map_phonemes=remap, scorer="host")
    as_tuples = lambda statistics: {
        language: {name: (s.insertions, s.deletions, s.substitutions, s.correct) for name, s in heads.items()}
        for language, heads in statistics.items()
    }
    assert as_tuples(results["device"]) == as_tuples(jax_statistics)
    assert sum(s.correct + s.substitutions for heads in results["device"].values() for s in heads.values()) > 0


def test_results_round_trip_and_format_as_jax(predictions_file, tmp_path):
    with PredictionReader(predictions_file) as reader:
        statistics = evaluation_runner.compute_edit_statistics(reader, map_phonemes=False, scorer="device", device="cpu")
        results = evaluation_runner.summarize_edit_statistics(statistics, reader.metadata.classifiers, "evaluate args")
    path = str(tmp_path / "results.json")
    results.dump(path)
    loaded = MultilingualEvaluationResults.load(path)
    assert loaded.dumps() == results.dumps()
    buffer = io.StringIO()
    results.dump(buffer)
    assert MultilingualEvaluationResults.load(io.StringIO(buffer.getvalue())) == loaded

    theirs = jax_evaluation.MultilingualEvaluationResults.load(path)
    assert json.loads(theirs.dumps()) == json.loads(results.dumps())
    assert f"{results}" == f"{theirs}" and f"{results:.2}" == f"{theirs:.2}"
    assert macro_average_error_rates(results) == jax_evaluation.macro_average_error_rates(theirs)


def test_device_scorer_runs_on_the_card_unless_asked_for_the_cpu(predictions_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with PredictionReader(predictions_file) as reader, pytest.raises(RuntimeError, match="No CUDA device"):
        evaluation_runner.compute_edit_statistics(reader, map_phonemes=False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        levenshtein.corpus_error_rate(np.zeros((1, 8), np.int32), np.ones(1, np.int32), np.zeros((1, 8), np.int32), np.ones(1, np.int32))
