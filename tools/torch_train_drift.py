"""Which side parts when the port's and JAX's ``train`` run on raw-sample
frames: both CLIs train the mini transformer of
``tests/test_torch_train_cli.py`` (d_model 32, 2 heads, 2 layers, SGD with
momentum, dropout 0) on raw 16 kHz samples, one frame a sample, from JAX's
initial weights, in float32 and again wholly in float64. The port's
float64 run is its ``float32`` preset with the model in float64 and
``Tensor.float`` upcasting to float64 (norms, log_softmax, the CTC and the
attention twins upcast through it); JAX's runs under ``jax_enable_x64``, set
here and in no module of the package, with its preset's dtypes float64, its
initial weights cast, and float64 where its CTC names float32. Each run is
a process of its own.

    python3 tools/torch_train_drift.py [--epochs 1]

Prints, for the leaf where the two float32 runs part most, and over all
leaves, how far each float32 run lies from its own float64 run and how far
the two float64 runs lie apart, each as a share of the leaf's largest value
(for a leaf that stays near zero, of the test's floor: ZERO_FLOOR of the
largest of all leaves over PARAMETER_SHARE). The case is
``tests/test_torch_train_cli.py``'s raw-sample test; its limit is derived
from these readings."""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def raw_config(epochs: int) -> dict:
    """``tests/test_torch_train_cli.py``'s config on raw samples."""
    from test_torch_train_cli import _config

    config = _config(epochs)
    config["preprocessing"] = {"feature_type": "RAW", "resample": 16000}
    return config


def train_arguments(workdir: Path, side: str, precision: str, epochs: int) -> list:
    return [
        "train", str(workdir / "cv"), "-j", json.dumps(raw_config(epochs)), "-a", str(workdir / "table.csv"),
        "-s", str(workdir / f"{side}-{precision}"), "--cpu", "--no-progress",
    ]


def flat(tree, prefix=()) -> dict:
    leaves = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            leaves.update(flat(value, (*prefix, key)))
        else:
            leaves["/".join((*prefix, key))] = np.asarray(value, np.float64)
    return leaves


def run_jax(workdir: Path, precision: str, epochs: int) -> None:
    import jax

    if precision == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from allophant_tpu.cli import run as cli
    from allophant_tpu.training import estimator as estimator_module

    initial_path = workdir / "initial.pkl"
    original = estimator_module.Estimator.from_config.__func__
    captured = {}

    def from_config(cls, *args, **kwargs):
        estimator = original(cls, *args, **kwargs)
        if precision == "float32":
            with open(initial_path, "wb") as file:
                pickle.dump(jax.tree_util.tree_map(np.asarray, estimator.variables), file)
        else:
            with open(initial_path, "rb") as file:
                initial = pickle.load(file)
            params = jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, jnp.float64), initial["params"])
            estimator.variables = {**estimator.variables, "params": params}
        captured["estimator"] = estimator
        return estimator

    if precision == "float64":
        from allophant_tpu.ops import ctc

        estimator_module.PRECISION_PRESETS["float32"] = (jnp.float64, None, "highest")
        # The CTC casts its logits to float32 by name: there, float32 is float64.
        ctc.jnp = types.SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    estimator_module.Estimator.from_config = classmethod(from_config)
    cli.main(train_arguments(workdir, "jax", precision, epochs))
    np.savez(workdir / f"jax-{precision}.npz", **flat(jax.tree_util.tree_map(np.asarray, captured["estimator"].variables["params"])))


def run_port(workdir: Path, precision: str, epochs: int) -> None:
    import torch

    from allophant_tpu_torch.cli import run as cli
    from allophant_tpu_torch.training import estimator as estimator_module
    from allophant_tpu_torch.weights import jax_params_from_state, load_jax_variables

    with open(workdir / "initial.pkl", "rb") as file:
        initial = pickle.load(file)
    original = estimator_module.Estimator.from_config.__func__
    captured = {}

    def from_config(cls, *args, **kwargs):
        estimator = original(cls, *args, **kwargs)
        model = load_jax_variables(estimator.model, initial)
        if precision == "float64":
            model.double()
            for module in model.modules():
                for attribute in ("dtype", "head_dtype"):
                    if isinstance(getattr(module, attribute, None), torch.dtype):
                        setattr(module, attribute, torch.float64)
        captured["estimator"] = estimator
        return estimator

    estimator_module.Estimator.from_config = classmethod(from_config)
    if precision == "float64":
        # Norms, log_softmax, the CTC and the attention twins upcast with
        # ``.float()``: there, it upcasts to float64.
        upcast = torch.Tensor.float
        torch.Tensor.float = lambda self, *args, **kwargs: self.double() if self.is_floating_point() else upcast(self, *args, **kwargs)
    cli.main(train_arguments(workdir, "port", precision, epochs))
    model = captured["estimator"].model
    params = jax_params_from_state({name: parameter.detach().double() for name, parameter in model.named_parameters()}, model.architecture)
    np.savez(workdir / f"port-{precision}.npz", **flat(params))


def report(workdir: Path) -> None:
    from test_torch_train_cli import PARAMETER_SHARE, ZERO_FLOOR

    runs = {name: dict(np.load(workdir / f"{name}.npz")) for name in ("jax-float32", "jax-float64", "port-float32", "port-float64")}
    reference = runs["jax-float64"]
    largest = max(np.abs(value).max() for value in reference.values())

    def share(first, second, key):
        """The distance as a share of the leaf's largest value, or of the
        test's floor (ZERO_FLOOR of the largest of all leaves, read as a share
        of PARAMETER_SHARE) for a leaf that stays near zero."""
        scale = max(np.abs(reference[key]).max(), ZERO_FLOOR / PARAMETER_SHARE * largest)
        return float(np.abs(runs[first][key] - runs[second][key]).max() / scale)

    keys = sorted(runs["jax-float64"])
    parting = max(keys, key=lambda key: share("port-float32", "jax-float32", key))
    for label, keys_shown in ((f"leaf {parting}", [parting]), ("all leaves (largest share)", keys)):
        values = {
            pair: max(share(*pair, key) for key in keys_shown)
            for pair in (("port-float32", "jax-float32"), ("port-float32", "port-float64"), ("jax-float32", "jax-float64"), ("port-float64", "jax-float64"))
        }
        print(f"{label}: " + ", ".join(f"{first} vs {second} {value:.3e}" for (first, second), value in values.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--run", nargs=3, metavar=("SIDE", "PRECISION", "WORKDIR"), help=argparse.SUPPRESS)
    options = parser.parse_args()
    if options.run is not None:
        side, precision, workdir = options.run
        (run_jax if side == "jax" else run_port)(Path(workdir), precision, options.epochs)
        return 0
    from fixtures import build_cv_corpus, mini_allophoible_csv

    with tempfile.TemporaryDirectory(prefix="train_drift_") as directory:
        workdir = Path(directory)
        build_cv_corpus(str(workdir / "cv"), (("train", 4), ("dev", 2), ("test", 1)))
        (workdir / "table.csv").write_text(mini_allophoible_csv(), encoding="utf-8")
        for side, precision in (("jax", "float32"), ("jax", "float64"), ("port", "float32"), ("port", "float64")):
            subprocess.run(
                [sys.executable, __file__, "--epochs", str(options.epochs), "--run", side, precision, str(workdir)],
                check=True, stdin=subprocess.DEVNULL, env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
            )
        report(workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
