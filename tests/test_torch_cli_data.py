"""The port's offline CLIs (``allophant_tpu_torch/cli/data.py``,
``cli/features.py``) against the JAX package's on the Common Voice corpus
``tests/fixtures.py:build_cv_corpus`` writes: ``save-lengths`` and
``preprocess`` (40 log-mel filterbanks, the ragged store and ``--zarr``)
write the same files byte for byte, ``stats -j`` prints the same statistics,
and ``allophant-features`` writes the same CSV from the demo feature table.
Then ``train -f`` (features from a store) and ``train -l`` (lengths from a
zarr cache) against the JAX CLI's runs from the same initial weights, with
``tests/test_torch_train_cli.py``'s mini transformer and limits."""

import json

import numpy as np
import pytest

from allophant_tpu.cli import data as jax_cli_data
from allophant_tpu.cli import features as jax_cli_features
from allophant_tpu.data import store as jax_store
from allophant_tpu_torch.cli import data as cli_data
from allophant_tpu_torch.cli import features as cli_features
from allophant_tpu_torch.data import store
from allophant_tpu_torch.demo import demo_feature_table_csv

from fixtures import build_cv_corpus, mini_allophoible_csv
from test_torch_train_cli import _config, assert_parameters_match, train_both

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SPLITS = {"train": ["es", "it"], "dev": ["es", "it"], "test": ["es", "it"]}
MAINS = {"ours": cli_data.main, "theirs": jax_cli_data.main}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli-data")
    build_cv_corpus(str(root / "cv"), (("train", 4), ("dev", 2), ("test", 1)))
    (root / "table.csv").write_text(mini_allophoible_csv(), encoding="utf-8")
    return root


def _files(directory):
    return {str(path.relative_to(directory)): path.read_bytes() for path in sorted(directory.rglob("*")) if path.is_file()}


@pytest.fixture(scope="module")
def stores(workdir):
    """Both CLIs' ``save-lengths`` and ``preprocess`` outputs, ragged and
    zarr: {(command, layout, side): directory}."""
    config = json.dumps(_config(1))
    outputs = {}
    for command in ("save-lengths", "preprocess"):
        for layout, flags in (("ragged", []), ("zarr", ["--zarr"])):
            for side, main in MAINS.items():
                directory = workdir / f"{command}-{layout}-{side}"
                main([command, str(workdir / "cv"), str(directory), "-j", config, *flags])
                outputs[command, layout, side] = directory
    return outputs


@pytest.mark.parametrize("command", ["save-lengths", "preprocess"])
@pytest.mark.parametrize("layout", ["ragged", "zarr"])
def test_stores_equal_jax(stores, command, layout):
    ours, theirs = _files(stores[command, layout, "ours"]), _files(stores[command, layout, "theirs"])
    assert ours.keys() == theirs.keys() and ours
    for name, content in theirs.items():
        assert ours[name] == content, name
    data = store.preprocessed_features_or_lengths(str(stores[command, layout, "ours"]), SPLITS, command == "save-lengths")
    expected = jax_store.preprocessed_features_or_lengths(str(stores[command, layout, "theirs"]), SPLITS, command == "save-lengths")
    for split in SPLITS:
        np.testing.assert_array_equal(data[split].lengths, expected[split].lengths)
        if command == "preprocess":
            assert data[split].features[0].shape[1] == 40
            for got, value in zip(data[split].features, expected[split].features):
                np.testing.assert_array_equal(got, value)


@pytest.mark.parametrize("layout", ["ragged", "zarr"])
def test_stats_equal_jax(stores, workdir, capsys, layout):
    printed = {}
    for side, main in MAINS.items():
        main(["stats", str(workdir / "cv"), "-l", str(stores["save-lengths", layout, side]), "-s", "train,dev", "-j", "-r", "100"])
        printed[side] = capsys.readouterr().out
    assert printed["ours"] == printed["theirs"]
    assert json.loads(printed["ours"])["train"]["utterance_counts"] == {"es": 4, "it": 4}


def test_features_cli_writes_jax_csv(tmp_path):
    table = tmp_path / "demo.csv"
    table.write_text(demo_feature_table_csv(), encoding="utf-8")
    for side, main in (("ours", cli_features.main), ("theirs", jax_cli_features.main)):
        main(["-p", str(table), "-o", str(tmp_path / f"{side}.csv"), "-r"])
        main(["spa,ita", "-p", str(table), "-o", str(tmp_path / f"{side}-subset.csv"), "-d"])
    for name in ("{}.csv", "{}-subset.csv"):
        ours, theirs = (tmp_path / name.format("ours")).read_bytes(), (tmp_path / name.format("theirs")).read_bytes()
        assert ours == theirs and ours.count(b"\n") > 1, name


@pytest.mark.parametrize(
    "flag, store_key",
    [("-f", ("preprocess", "zarr", "ours")), ("-f", ("preprocess", "ragged", "theirs")), ("-l", ("save-lengths", "zarr", "theirs"))],
    ids=["features-zarr", "features-ragged", "lengths-zarr"],
)
def test_train_from_a_store_matches_jax(stores, workdir, flag, store_key):
    """One epoch of both CLIs from the same store: the saved parameters agree
    within test_torch_train_cli.py's limits."""
    directory = workdir / f"train{flag}-{'-'.join(store_key)}"
    arguments = [
        "train", str(workdir / "cv"), "-j", json.dumps(_config(1)), "-a", str(workdir / "table.csv"), "-d", "--cpu",
        flag, str(stores[store_key]),
    ]
    train_both([*arguments, "-s", str(directory / "jax")], [*arguments, "-s", str(directory / "port")])
    assert_parameters_match(directory / "port" / "epoch-1.ckpt", directory / "jax" / "epoch-1.ckpt")
