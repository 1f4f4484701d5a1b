"""The flagship model for serving, training, tests and benchmarks (counterpart
of ``allophant_tpu/demo.py:build_flagship``): the XLS-R 300M encoder with the
36-attribute hierarchical head, 640-wide embedding composition and allophone
layer over the JAX demo's synthetic phoneme table.

The projection plan, the training config (the JAX config's ``nn`` section)
and the static tables come frozen from ``package_data/flagship_plan.json``
and ``flagship_static.npz`` (written by ``tools/export_torch_flagship_plan.py``);
the weights are random, drawn from a seed. Nothing here needs JAX, pandas or a
network."""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch.config import Architecture, whole_run_frozen_prefix
from allophant_tpu_torch.device import resolve_device, set_float32_precision
from allophant_tpu_torch.models.allophant import AllophantModel
from allophant_tpu_torch.models.projection import ProjectionPlan
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.training.estimator import DEFAULT_SERVING_PRECISION, Estimator, resolve_precision
from allophant_tpu_torch.weights import architecture_from_dict, load_static_data, seeded_initialization

PACKAGE_DATA = Path(__file__).resolve().parent / "package_data"


@lru_cache(maxsize=1)
def flagship_data() -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(document with "architecture" and "plan", static tables) as frozen."""
    document = json.loads((PACKAGE_DATA / "flagship_plan.json").read_text())
    with np.load(PACKAGE_DATA / "flagship_static.npz") as arrays:
        static = {key: arrays[key] for key in arrays.files}
    return document, static


def flagship_config() -> Architecture:
    """The flagship's training config (optimizer, schedule, clipping, seed,
    freeze flags, losses) as frozen from the JAX demo config."""
    return Architecture.from_dict(flagship_data()[0]["nn"])


def flagship_zero_shot_table() -> np.ndarray:
    """A synthetic unseen-language inventory [P, F] of category ids, with as
    many phones as the shared phone set."""
    return flagship_data()[1]["zero_shot_feature_table"].copy()


def build_flagship(
    seed: int = 0,
    architecture: Optional[Wav2Vec2Architecture] = None,
    precision: str = DEFAULT_SERVING_PRECISION,
    device=None,
) -> Estimator:
    """The flagship Estimator with seeded random weights, built directly on
    ``device`` (CUDA unless the caller asks otherwise). ``architecture``
    replaces the frozen XLS-R 300M encoder (e.g. a tiny one for tests)."""
    device = resolve_device(device)
    document, static = flagship_data()
    if architecture is None:
        architecture = architecture_from_dict(document["architecture"])
    plan = ProjectionPlan.from_dict(document["plan"]).with_output_features(architecture.hidden_size)
    dtype, head_dtype, _ = resolve_precision(precision)
    model = AllophantModel(architecture, plan, dtype, head_dtype, device=device)
    seeded_initialization(model, seed)
    load_static_data(model, static)
    return Estimator(model, precision, device)


def build_flagship_for_training(
    seed: int = 0,
    architecture: Optional[Wav2Vec2Architecture] = None,
    precision: str = DEFAULT_SERVING_PRECISION,
    device=None,
) -> Tuple[Architecture, AllophantModel]:
    """(training config, model) of the flagship for ``training/train_step``:
    float32 parameters (the optimizer's master weights, cast to the preset's
    compute dtypes at each call), the config's whole-run-frozen prefix, and
    the frozen dropout rates (``architecture`` replaces the encoder, e.g. a
    tiny one or one with other rates). Sets the preset's float32 matmul
    precision, which is process-global."""
    device = resolve_device(device)
    document, static = flagship_data()
    config = flagship_config()
    if architecture is None:
        architecture = architecture_from_dict(document["architecture"])
    plan = ProjectionPlan.from_dict(document["plan"]).with_output_features(architecture.hidden_size)
    dtype, head_dtype, f32_matmul_precision = resolve_precision(precision)
    model = AllophantModel(
        architecture, plan, dtype, head_dtype, device=device, param_dtype=torch.float32,
        frozen_prefix=whole_run_frozen_prefix(config.acoustic_model),
    )
    seeded_initialization(model, seed)
    load_static_data(model, static)
    set_float32_precision(f32_matmul_precision)
    return config, model
