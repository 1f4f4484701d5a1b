"""Shared helpers for the PyTorch port's parity tests: seeded numpy weights for
a JAX variable tree, so both packages run on the same numbers."""

from __future__ import annotations

import contextlib
from typing import Any, Mapping

import jax
import numpy as np


def shared_across_workers(tmp_path_factory, name: str, compute):
    """``compute()``'s result, computed once in the test session whatever the
    number of xdist workers: the first worker to ask computes it under a file
    lock in the workers' common temporary directory and saves it there
    (``torch.save``); the others load it. ``compute`` may also write files
    into the directory it is given (``compute(directory)``)."""
    import fcntl

    import torch

    base = tmp_path_factory.getbasetemp()
    root = base.parent if base.name.startswith("popen-gw") else base
    directory = root / f"shared-{name}"
    directory.mkdir(exist_ok=True)
    result = directory / "result.pt"
    with open(root / f"shared-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not result.exists():
                value = compute(directory)
                torch.save(value, result)
                return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return torch.load(result, weights_only=False)


@contextlib.contextmanager
def exact_frame_encoder_erf():
    """Runs the JAX fused frame encoder with exact erf for the duration.

    The Pallas kernel evaluates GELU's erf with the Abramowitz-Stegun formula
    and an approximate reciprocal, which interpret mode computes in bf16: 1.7e-3
    from exact GELU, enough to move 2-layer hidden states by 1e-2. The port's
    kernel uses exact erff, so parity at 1e-4 is checked against the JAX model
    with the exact erf swapped in at trace time (compile caches cleared on both
    sides so no program traced with the other erf is reused)."""
    from allophant_tpu.ops import frame_encoder

    original = frame_encoder._erf
    frame_encoder._erf = jax.lax.erf
    jax.clear_caches()
    try:
        yield
    finally:
        frame_encoder._erf = original
        jax.clear_caches()


#: The mini transformer's filterbanks a frame (tests/test_torch_transformer.py).
MINI_TRANSFORMER_FEATURES = 40


def mini_transformer_inputs(dropout: float = 0.0) -> dict:
    """``parallel.dryrun.config_model``'s inputs of the fixtures' mini
    transformer (linear frontend, d_model 32, 2 heads of 16, FFN 64, 2
    layers) on 40 filterbanks, float32, with an attention classifier of 2
    heads (sinusoidal positions) on its composed phoneme head, and
    ``dropout`` on every dropout site (the transformer's and the heads'
    tap)."""
    from allophant_tpu_torch.phonetics.features import LanguageInventories

    from fixtures import mini_allophoible_csv, mini_config_dict

    config = mini_config_dict(embedding_composition=True)
    config["nn"]["mixed_precision"] = False
    config["nn"]["acoustic_model"]["transformer"]["dropout_rate"] = dropout
    config["nn"]["projection"]["acoustic_model_dropout"] = dropout
    for entry in config["nn"]["projection"]["classes"]:
        if entry["name"] == "phoneme":
            entry["time_layer"] = {"type": "multi-head-attention", "num_heads": 2, "positional_embeddings": True}
    config["preprocessing"] = {
        "feature_type": "FILTERBANKS", "window": {"frame_duration": 25, "frame_stride": 10}, "resample": 16000,
        "num_filters": MINI_TRANSFORMER_FEATURES,
    }
    inventories = LanguageInventories({0: ["a", "o", "n", "s"], 1: ["a", "s", "i", "t"]}, ["es", "it"])
    return {"config": config, "table": mini_allophoible_csv(), "inventories": inventories, "feature_size": MINI_TRANSFORMER_FEATURES}


def random_variables(init_fn, seed: int) -> dict:
    """A variable tree shaped like ``init_fn()``'s (traced with eval_shape, not
    run) filled from a numpy generator: kernels N(0, 1/fan_in), biases N(0, 0.1),
    norm scales 1 + N(0, 0.1), embeddings N(0, 1); integer leaves zero."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        stacked = any(getattr(entry, "key", None) == "layers" for entry in path)
        shape = leaf.shape
        if not np.issubdtype(leaf.dtype, np.floating):
            return np.zeros(shape, leaf.dtype)
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            fan_shape = shape[1:-1] if stacked else shape[:-1]
            return noise / np.sqrt(max(int(np.prod(fan_shape)), 1))
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name == "bias":
            return 0.1 * noise
        return noise

    return jax.tree_util.tree_map_with_path(fill, _plain(shapes))


def _plain(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {key: _plain(value) for key, value in tree.items()}
    return tree


def numpy_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {key: numpy_tree(value) for key, value in tree.items()}
    return np.asarray(tree)
