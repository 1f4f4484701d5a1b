"""Freezes the flagship model's projection plan and static tables for the
PyTorch port, which cannot derive them itself (that needs the JAX package's
phonetic indexer and pandas).

    JAX_PLATFORMS=cpu python tools/export_torch_flagship_plan.py

writes ``allophant_tpu_torch/package_data/flagship_plan.json`` (architecture,
plan, and the training config's ``nn`` section) and ``flagship_static.npz`` (composition feature table, allophone
matrices and gather table, and a zero-shot inventory table of the shared phone
set's size). ``tests/test_torch_estimator.py`` checks that the committed files
still equal what ``allophant_tpu.demo.build_flagship()`` produces."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PACKAGE_DATA = ROOT / "allophant_tpu_torch" / "package_data"
ZERO_SHOT_SEED = 17


def zero_shot_feature_table(training_table: np.ndarray, seed: int = ZERO_SHOT_SEED) -> np.ndarray:
    """A synthetic unseen-language inventory with as many phones as the shared
    phone set (so the allophone layer still applies): the training rows in a
    seeded order, with one feature of every third phone moved to another
    category that the column already uses."""
    rng = np.random.default_rng(seed)
    table = training_table[rng.permutation(len(training_table))].copy()
    for row in range(0, len(table), 3):
        column = int(rng.integers(table.shape[1]))
        table[row, column] = (table[row, column] + 1) % (int(training_table[:, column].max()) + 1)
    return table.astype(np.int32)


def flagship_plan_data():
    """(JSON-ready dict, dict of numpy arrays) for the default flagship."""
    from allophant_tpu.demo import build_flagship

    config, _indexer, built = build_flagship()
    static = {key: np.asarray(value) for key, value in built.static_data.items()}
    static["zero_shot_feature_table"] = zero_shot_feature_table(static["composition_feature_table"])
    document = {
        "architecture": dataclasses.asdict(built.model.acoustic_config),
        "plan": dataclasses.asdict(built.model.plan),
        "nn": config.nn.to_dict(),
    }
    # Round-trip through JSON so tuples compare as the lists a reader gets back.
    return json.loads(json.dumps(document)), static


def main() -> int:
    document, static = flagship_plan_data()
    PACKAGE_DATA.mkdir(parents=True, exist_ok=True)
    (PACKAGE_DATA / "flagship_plan.json").write_text(json.dumps(document, indent=1) + "\n")
    np.savez_compressed(PACKAGE_DATA / "flagship_static.npz", **static)
    print(f"wrote {PACKAGE_DATA}/flagship_plan.json and flagship_static.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
