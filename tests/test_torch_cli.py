"""The port's CLI (allophant_tpu_torch/cli/run.py) against the JAX package's
(allophant_tpu/cli/run.py) on the CPU: ``predict`` writes equal JSONL
utterance lines at "float32" (greedy; beam 4 with 2 candidates over a subset
of heads; the allophone map with ``--language-phonemes``), ``evaluate``,
``edits`` and the error-rate report agree, and JAX's ``evaluate`` reads the
port's files.

The corpus is tests/test_cli.py's (2 languages x 2 utterances); the
checkpoints are its configurations with a wav2vec2 encoder instead of the
transformer acoustic model, which the port has not ported. A native
checkpoint does not record the encoder's architecture (restore assumes
XLS-R 300M, as in JAX), so both CLIs restore these under a monkeypatch that
passes the tiny encoder's architecture to ``Estimator.restore``."""

import contextlib
import json

import numpy as np
import pytest
import torch

from allophant_tpu.cli import error_rates as jax_error_rates
from allophant_tpu.cli import run as jax_cli
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu_torch.cli import error_rates
from allophant_tpu_torch.cli import run as cli
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH
from allophant_tpu_torch.phonetics.features import LanguageInventories, PhoneticAttributeIndexer
from allophant_tpu_torch.training.estimator import Estimator

from fixtures import mini_allophoible_csv, mini_config_dict
from test_cli import _write_wav
from torch_parity import exact_frame_encoder_erf

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TINY = dict(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=96,
    conv_dim=(32, 32, 32),
    conv_kernel=(10, 3, 2),
    conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
PREDICT = ["--cpu", "--no-progress", "--precision", "float32", "-m", "utterances", "-s", "2"]
# (checkpoint, extra predict arguments) of each compared run.
CASES = {
    "greedy": ("shared", []),
    "beam": ("shared", ["-b", "4", "-n", "2", "-f", "phoneme,nasal"]),
    "language-phonemes": ("allophones", ["--language-phonemes"]),
    # The phoneme head recomposed over each language's inventory, batches
    # split by language.
    "composition": ("composition", []),
}


def _restore_with(estimator_class, architecture):
    original = estimator_class.restore.__func__

    def restore(cls, checkpoint, *args, **kwargs):
        kwargs.setdefault("wav2vec2_architecture", architecture)
        return original(cls, checkpoint, *args, **kwargs)

    return classmethod(restore)


@contextlib.contextmanager
def tiny_encoder_restore():
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(JaxEstimator, "restore", _restore_with(JaxEstimator, JaxArchitecture(**TINY)))
        patch.setattr(Estimator, "restore", _restore_with(Estimator, Wav2Vec2Architecture(**TINY)))
        yield


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The corpus of tests/test_cli.py and the checkpoints, written by the
    port (``Estimator.save``; JAX's ``load_native`` reads them): a shared
    phoneme layer, an allophone layer whose matrices are moved off their 0/1
    initialization so the allophone map is observable, and each with the
    embedding composition."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for language, phonemes in [("spa", ["a", "t", "n"]), ("ita", ["a", "s"])]:
        base = root / "corpus" / language
        (base / "audio").mkdir(parents=True)
        (base / "inventory").write_text("".join(f"{phoneme} 5\n" for phoneme in phonemes), encoding="utf-8")
        utterances = [f"{language}_{index}" for index in range(2)]
        (base / "raw").write_text("".join(f"{utterance} rawform\n" for utterance in utterances), encoding="utf-8")
        (base / "text").write_text(
            "".join(f"{utterance} {' '.join(phonemes)}\n" for utterance in utterances), encoding="utf-8"
        )
        for index, utterance in enumerate(utterances):
            _write_wav(base / "audio" / f"{utterance}.wav", rng.uniform(-0.3, 0.3, 1600 + 320 * index).astype(np.float32))

    for name, layer, composition in (
        ("shared", "shared", False),
        ("allophones", "allophones", False),
        ("composition", "shared", True),
        ("composition-allophones", "allophones", True),
    ):
        config = Config.load(mini_config_dict(layer, composition, "wav2vec2-pretrained"))
        inventories = None
        if layer == "allophones":
            inventories = LanguageInventories({0: ["a", "b", "d", "t"], 1: ["a", "t", "s"]}, ["es", "it"])
        indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv(), inventories)
        estimator = Estimator.from_config(
            config, 1, 16_000, attribute_graph_from_config(config, indexer), indexer,
            wav2vec2_architecture=Wav2Vec2Architecture(**TINY), seed=3, precision="float32", device="cpu",
        )
        if layer == "allophones":
            matrices = estimator.model.projection.allophone.allophone_matrices
            noise = np.random.default_rng(6).uniform(0.2, 2.0, tuple(matrices.shape)).astype(np.float32)
            with torch.no_grad():
                matrices.add_(torch.from_numpy(noise))
        estimator.save(str(root / f"{name}.ckpt"), phonetic_indexer_state=indexer.state())
    return root


@pytest.fixture(scope="module")
def runs(workdir):
    """The files of each case, made on first use: both CLIs' predictions,
    and the reports of JAX's ``evaluate -j`` on each (on the port's file
    with its host scorer) and of the port's on JAX's file."""
    made = {}

    def run(case):
        if case in made:
            return made[case]
        checkpoint, extra = CASES[case]
        paths = {key: workdir / f"{case}-{key}" for key in ("jax.jsonl", "port.jsonl", "jax-jax.json", "jax-port.json", "port-jax.json")}
        arguments = [str(workdir / "corpus"), str(workdir / f"{checkpoint}.ckpt"), *PREDICT, *extra]
        with tiny_encoder_restore():
            with exact_frame_encoder_erf():
                jax_cli.main(["predict", *arguments, "-o", str(paths["jax.jsonl"])])
                jax_cli.main(["evaluate", str(paths["jax.jsonl"]), "--no-remap", "-j", "-o", str(paths["jax-jax.json"])])
            cli.main(["predict", *arguments, "-o", str(paths["port.jsonl"])])
        # JAX's host scorer here: its device scorer compiles for each file's shapes.
        jax_cli.main(["evaluate", str(paths["port.jsonl"]), "--no-remap", "--host-scorer", "-j", "-o", str(paths["jax-port.json"])])
        cli.main(["evaluate", str(paths["jax.jsonl"]), "--cpu", "--no-remap", "-j", "-o", str(paths["port-jax.json"])])
        made[case] = paths
        return paths

    return run


def _lines(path):
    return path.read_text(encoding="utf-8").splitlines()


def _report(path):
    """A results file without its command line, which names the file read."""
    results = json.loads(path.read_text(encoding="utf-8"))
    del results["evaluation_arguments"]
    return results


@pytest.mark.parametrize("case", CASES)
def test_predict_equals_jax(runs, case):
    paths = runs(case)
    jax_lines, lines = _lines(paths["jax.jsonl"]), _lines(paths["port.jsonl"])
    assert len(lines) == len(jax_lines) == 5  # the metadata line and 4 utterances
    assert lines[1:] == jax_lines[1:]
    metadata, jax_metadata = json.loads(lines[0]), json.loads(jax_lines[0])
    assert metadata.keys() == jax_metadata.keys()
    for key in metadata.keys() - {"prediction_arguments"}:
        assert metadata[key] == jax_metadata[key], key
    entries = [json.loads(line) for line in lines[1:]]
    if case == "beam":
        assert metadata["classifiers"] == ["phoneme", "nasal"]
        assert {len(candidates) for entry in entries for candidates in entry["predictions"].values()} == {2}
    if case == "language-phonemes":
        assert {"phone", "phoneme"} <= set(metadata["classifiers"])


@pytest.mark.parametrize("case", CASES)
def test_evaluate_equals_jax(runs, case):
    """The port's ``evaluate`` (device scorer, on the CPU) and JAX's on the
    same file give equal reports, and JAX's ``evaluate`` reads the port's file
    to its own file's report."""
    paths = runs(case)
    expected = _report(paths["jax-jax.json"])
    assert _report(paths["port-jax.json"]) == expected
    assert _report(paths["jax-port.json"]) == expected
    assert "total" in expected["results"]


def test_edits_and_error_rates_equal_jax(runs, workdir, capsys):
    paths = runs("greedy")
    outputs = {}
    for name, module in (("jax", jax_cli), ("port", cli)):
        target = workdir / f"edits-{name}.jsonl"
        module.main(["edits", str(paths["jax.jsonl"]), "--no-remap", "-o", str(target)])
        outputs[name] = _lines(target)
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"]) == 5 and "edit_operations" in json.loads(outputs["port"][1])

    reports = {}
    for name, module in (("jax", jax_error_rates), ("port", error_rates)):
        capsys.readouterr()
        module.main([str(paths["jax-jax.json"])])
        reports[name] = capsys.readouterr().out
    assert reports["port"] == reports["jax"] and "Average" in reports["port"]


def test_language_phonemes_on_a_composition_model_keep_the_training_phones(workdir, tmp_path):
    """With ``--language-phonemes`` the allophone map takes the phone head
    over the training phones, so a composition model's phone head is not
    recomposed per language (the JAX CLI recomposes it and gathers out of
    range): phone candidates are training phones, phoneme candidates the
    training phonemes."""
    output = tmp_path / "composition-allophones.jsonl"
    arguments = [str(workdir / "corpus"), str(workdir / "composition-allophones.ckpt"), *PREDICT, "--language-phonemes"]
    with tiny_encoder_restore():
        cli.main(["predict", *arguments, "-o", str(output)])
    lines = _lines(output)
    metadata = json.loads(lines[0])
    entries = [json.loads(line) for line in lines[1:]]
    assert len(entries) == 4 and {"phone", "phoneme"} <= set(metadata["classifiers"])
    training_phones = set(metadata["indexer_state"]["language_allophones"]["shared_phones"])
    training_phonemes = set(metadata["indexer_state"]["phoneme_inventory"])
    for entry in entries:
        assert set(entry["predictions"]["phone"][0]) <= training_phones
        assert set(entry["predictions"]["phoneme"][0]) <= training_phonemes
    assert any(entry["predictions"]["phone"][0] for entry in entries)


def test_n_best_larger_than_beam_and_worker_processes_are_rejected(workdir, tmp_path):
    """``-n`` above ``-b`` is rejected. Worker processes (``-w N``) were
    rejected until the port's Batcher had them; now ``-w 2`` must write the
    same JSONL as ``-w 0`` (the name is kept from that time)."""
    arguments = [str(workdir / "corpus"), str(workdir / "shared.ckpt"), *PREDICT]
    with pytest.raises(ValueError, match="larger than the beam"):
        cli.main(["predict", *arguments, "-b", "2", "-n", "4", "-o", str(tmp_path / "x.jsonl")])
    outputs = {}
    with tiny_encoder_restore():
        for workers in ("0", "2"):
            path = tmp_path / f"w{workers}.jsonl"
            cli.main(["predict", *arguments, "-w", workers, "-o", str(path)])
            outputs[workers] = path.read_text(encoding="utf-8").splitlines()
    # The first line is the metadata, which records the arguments.
    assert len(outputs["0"]) == 5 and outputs["2"][1:] == outputs["0"][1:]


def test_predict_runs_on_the_card_unless_asked_for_the_cpu(workdir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tiny_encoder_restore(), pytest.raises(RuntimeError, match="No CUDA device"):
        cli.main(["predict", str(workdir / "corpus"), str(workdir / "shared.ckpt"), "--no-progress", "-o", str(tmp_path / "x.jsonl")])


def test_generate_config(tmp_path, capsys):
    cli.main(["generate-config"])
    with open(DEFAULT_CONFIG_PATH, "r", encoding="utf-8") as file:
        assert capsys.readouterr().out == file.read()
    target = tmp_path / "config.toml"
    cli.main(["generate-config", str(target)])
    assert Config.from_toml(str(target)).nn.batch_size > 0
