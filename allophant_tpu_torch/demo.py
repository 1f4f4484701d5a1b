"""The flagship model for serving, training, tests and benchmarks (counterpart
of ``allophant_tpu/demo.py``): the XLS-R 300M encoder with the 36-attribute
hierarchical head, 640-wide embedding composition and allophone layer over the
JAX demo's synthetic phoneme table.

``demo_feature_table_csv`` and ``demo_config_dict`` are the JAX demo's table
and configuration (the CSV equal to it byte for byte); the flagship is built
from them through the port's own ``Config``, ``PhoneticAttributeIndexer`` and
``build_model``, with random weights drawn from a seed. ``flagship_data``
reads the plan that ``tools/export_torch_flagship_plan.py`` froze from the JAX
package, which the tests hold the port's build to. Nothing here needs JAX,
pandas or a network."""

from __future__ import annotations

import dataclasses
import json
import warnings
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from allophant_tpu_torch.config import Architecture, Config
from allophant_tpu_torch.device import resolve_device, set_float32_precision
from allophant_tpu_torch.models.allophant import AllophantModel, attribute_graph_from_config, build_model
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.phonetics.features import (
    Frame,
    LanguageInventories,
    PhoneticAttributeIndexer,
    SingletonFeatureWarning,
)
from allophant_tpu_torch.training.estimator import DEFAULT_SERVING_PRECISION, Estimator, resolve_precision
from allophant_tpu_torch.weights import seeded_initialization

PACKAGE_DATA = Path(__file__).resolve().parent / "package_data"
#: Languages of the flagship's inventories, in order.
FLAGSHIP_LANGUAGES = ("es", "it", "de", "fr", "pt", "ru", "tr", "fi")
ZERO_SHOT_SEED = 17

# The full PHOIBLE feature column set the reference's default config classifies
# over ("tone" is a feature column but not a classifier): 36 attribute heads +
# the phoneme head = the reference's 37 classifiers
# (the reference's allophant/package_data/default_config.toml:61-99).
DEMO_FEATURES = [
    "tone",
    "stress",
    "syllabic",
    "short",
    "long",
    "consonantal",
    "sonorant",
    "continuant",
    "delayedRelease",
    "approximant",
    "tap",
    "trill",
    "nasal",
    "lateral",
    "labial",
    "round",
    "labiodental",
    "coronal",
    "anterior",
    "distributed",
    "strident",
    "dorsal",
    "high",
    "low",
    "front",
    "back",
    "tense",
    "retractedTongueRoot",
    "advancedTongueRoot",
    "periodicGlottalSource",
    "epilaryngealSource",
    "spreadGlottis",
    "constrictedGlottis",
    "fortis",
    "raisedLarynxEjective",
    "loweredLarynxImplosive",
    "click",
]

_METADATA_COLUMNS = [
    "InventoryID",
    "Glottocode",
    "ISO6393",
    "LanguageName",
    "SpecificDialect",
    "GlyphID",
    "Phoneme",
    "Allophones",
    "Marginal",
    "SegmentClass",
    "Source",
]

_BASE_SEGMENTS = [
    "a", "e", "i", "o", "u", "y", "ə", "ɛ", "ɔ", "ɪ", "ʊ",
    "p", "b", "t", "d", "k", "ɡ", "q", "ʔ",
    "m", "n", "ɲ", "ŋ",
    "f", "v", "s", "z", "ʃ", "ʒ", "x", "h",
    "l", "r", "ɾ", "j", "w",
    "t͡ʃ", "d͡ʒ", "t͡s",
]


_DIACRITICS = ["ʰ", "ʲ", "ʷ", "ː", "̃", "̥", "̤", "˞"]


def _synthetic_segments(total: int) -> List[str]:
    """The base IPA-ish segments, extended with diacritic combinations up to
    ``total`` distinct segments (for full-Allophoible-scale benchmarking).
    ``total`` below the base-set size returns the whole base set."""
    capacity = len(_BASE_SEGMENTS) * (1 + len(_DIACRITICS) + len(_DIACRITICS) * (len(_DIACRITICS) - 1))
    if total > capacity:
        raise ValueError(f"num_segments {total} exceeds the synthetic capacity of {capacity}")
    segments = list(_BASE_SEGMENTS)
    for first in _DIACRITICS:
        for base in _BASE_SEGMENTS:
            if len(segments) >= total:
                return segments
            segments.append(base + first)
    for first in _DIACRITICS:
        for second in _DIACRITICS:
            if first == second:
                continue
            for base in _BASE_SEGMENTS:
                if len(segments) >= total:
                    return segments
                segments.append(base + first + second)
    return segments


def demo_feature_table_csv(num_languages: int = 8, seed: int = 0, num_segments: int | None = None) -> str:
    """Generates a deterministic synthetic Allophoible-format CSV: ~40 segments
    (or ``num_segments`` via diacritic combinations, up to full Allophoible
    scale) with random-but-consistent feature assignments shared across
    `num_languages` language inventories (subsets), with a few allophone
    relations."""
    rng = np.random.default_rng(seed)
    segments = _synthetic_segments(num_segments) if num_segments else list(_BASE_SEGMENTS)
    values = ["+", "-", "0"]
    feature_rows = {}
    for segment in segments:
        feature_rows[segment] = ["-"] + [values[rng.integers(0, 3)] for _ in DEMO_FEATURES[1:]]

    language_codes = [
        "spa", "ita", "deu", "fra", "por", "rus", "tur", "fin", "pol", "nld",
        "swe", "ces", "ell", "hun", "ron", "dan",
    ][:num_languages]

    rows = []
    for index, language in enumerate(language_codes, start=1):
        inventory_size = int(rng.integers(25, len(segments)))
        inventory = list(rng.choice(segments, size=inventory_size, replace=False))
        for phoneme in inventory:
            allophones = phoneme
            # A few multi-allophone relations per language.
            if rng.random() < 0.2:
                other = segments[int(rng.integers(0, len(segments)))]
                allophones = f"{phoneme} {other}"
            rows.append(
                {
                    "InventoryID": index,
                    "Glottocode": f"{language}1234",
                    "ISO6393": language,
                    "LanguageName": language,
                    "SpecificDialect": "",
                    "GlyphID": "+".join(f"{ord(c):04X}" for c in phoneme),
                    "Phoneme": phoneme,
                    "Allophones": allophones,
                    "Marginal": "FALSE",
                    "SegmentClass": "vowel" if phoneme[0] in "aeiouyəɛɔɪʊ" else "consonant",
                    "Source": "demo",
                    **dict(zip(DEMO_FEATURES, feature_rows[phoneme])),
                }
            )
    # Feature bank: every segment as a marginal row so allophone references resolve.
    for phoneme in segments:
        rows.append(
            {
                "InventoryID": 999,
                "Glottocode": "",
                "ISO6393": "mis",
                "LanguageName": "FeatureBank",
                "SpecificDialect": "",
                "GlyphID": "+".join(f"{ord(c):04X}" for c in phoneme),
                "Phoneme": phoneme,
                "Allophones": phoneme,
                "Marginal": "TRUE",
                "SegmentClass": "vowel" if phoneme[0] in "aeiouyəɛɔɪʊ" else "consonant",
                "Source": "demo",
                **dict(zip(DEMO_FEATURES, feature_rows[phoneme])),
            }
        )

    columns = _METADATA_COLUMNS + DEMO_FEATURES
    return Frame(columns, [[row[name] for name in columns] for row in rows]).to_csv()


def demo_config_dict(
    phoneme_layer: str = "allophones",
    embedding_size: int = 640,
    languages: Optional[List[str]] = None,
) -> dict:
    """Full training config over the demo feature set (flagship XLS-R encoder)."""
    classes = [{"name": name, "dependencies": ["OUTPUT"]} for name in DEMO_FEATURES[1:]]
    classes.append({"name": "phoneme", "dependencies": ["OUTPUT"]})
    return {
        "nn": {
            "batch_size": 1_600_000,
            "batching_mode": "frames",
            "accumulation_factor": 1,
            "projection": {
                "classes": classes,
                "feature_set": "phoible",
                "phoneme_layer": phoneme_layer,
                "acoustic_model_dropout": 0.2,
                "allophone_l2_alpha": 10.0,
                "embedding_composition": {"embedding_size": embedding_size},
            },
            "acoustic_model": {
                "type": "wav2vec2-pretrained",
                "model_id": "facebook/wav2vec2-xls-r-300m",
            },
            "optimizer": {"algorithm": "adam", "learning_rate": 0.001},
            "loss": {"type": "CTC"},
            "lr_schedule": {"type": "warmup", "warmup_steps": 2500, "constant_steps": 10000, "factor": 2},
            "clip_norm": 1.0,
            "seed": 2,
            "mixed_precision": True,
        },
        "preprocessing": {"feature_type": "RAW", "resample": 16000},
        "data": {"languages": languages or ["es", "it", "de", "fr"]},
    }


def demo_indexer(
    config: Config,
    num_languages: int = 4,
    num_segments: Optional[int] = None,
    languages: Optional[Sequence[str]] = None,
) -> PhoneticAttributeIndexer:
    """The indexer of ``config`` over the demo table, with the inventories of
    the first ``num_languages`` flagship languages (as the JAX demo's
    ``build_flagship`` makes it), or of ``languages`` in that order (a
    corpus's language ids)."""
    table = demo_feature_table_csv(num_segments=num_segments)
    language_codes = list(FLAGSHIP_LANGUAGES[:num_languages] if languages is None else languages)
    # The demo table's singleton feature column ("tone", all "-") is
    # structural: silence just that warning.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SingletonFeatureWarning)
        bootstrap = PhoneticAttributeIndexer("phoible", table)
        inventories = LanguageInventories(
            {index: bootstrap.phoneme_inventory(code) for index, code in enumerate(language_codes)}, language_codes
        )
        return PhoneticAttributeIndexer.from_config(config, table, inventories)


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


@lru_cache(maxsize=1)
def flagship_data() -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(document with "architecture", "plan" and "nn", static tables) as
    ``tools/export_torch_flagship_plan.py`` froze them from the JAX package:
    the oracle of ``flagship_plan_data``."""
    document = json.loads((PACKAGE_DATA / "flagship_plan.json").read_text())
    with np.load(PACKAGE_DATA / "flagship_static.npz") as arrays:
        static = {key: arrays[key] for key in arrays.files}
    return document, static


def flagship_config() -> Architecture:
    """The flagship's ``nn`` configuration (optimizer, schedule, clipping,
    seed, freeze flags, losses, dropout)."""
    return Config.load(demo_config_dict()).nn


def _flagship_build(architecture: Optional[Wav2Vec2Architecture], dtype, head_dtype, device, param_dtype=None, remat=False, mesh=None):
    config = Config.load(demo_config_dict())
    indexer = demo_indexer(config)
    return build_model(
        config.nn, 1, 16_000, attribute_graph_from_config(config, indexer), indexer,
        architecture, dtype=dtype, head_dtype=head_dtype, device=device, param_dtype=param_dtype, remat=remat,
        mesh=mesh,
    )


@lru_cache(maxsize=1)
def flagship_plan_data() -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(JSON-ready document, static tables) of the default flagship as the
    port builds it, in the layout of ``flagship_data``."""
    built = _flagship_build(None, torch.float32, None, "meta")
    static = dict(built.static_data)
    static["zero_shot_feature_table"] = zero_shot_feature_table(static["composition_feature_table"])
    plan = dataclasses.asdict(built.model.plan)
    document = {
        "architecture": dataclasses.asdict(built.model.architecture),
        "plan": plan,
        "nn": flagship_config().to_dict(),
    }
    return json.loads(json.dumps(document)), static


def flagship_zero_shot_table() -> np.ndarray:
    """A synthetic unseen-language inventory [P, F] of category ids, with as
    many phones as the shared phone set."""
    return flagship_plan_data()[1]["zero_shot_feature_table"].copy()


def build_flagship(
    seed: int = 0,
    architecture: Optional[Wav2Vec2Architecture] = None,
    precision: str = DEFAULT_SERVING_PRECISION,
    device=None,
) -> Estimator:
    """The flagship Estimator with seeded random weights, built directly on
    ``device`` (CUDA unless the caller asks otherwise). ``architecture``
    replaces the XLS-R 300M encoder (e.g. a tiny one for tests)."""
    device = resolve_device(device)
    dtype, head_dtype, _ = resolve_precision(precision)
    model = _flagship_build(architecture, dtype, head_dtype, device).model
    seeded_initialization(model, seed)
    return Estimator(model, precision, device)


def build_flagship_for_training(
    seed: int = 0,
    architecture: Optional[Wav2Vec2Architecture] = None,
    precision: str = DEFAULT_SERVING_PRECISION,
    device=None,
    remat: bool = False,
    mesh=None,
) -> Tuple[Architecture, AllophantModel]:
    """(training config, model) of the flagship for ``training/train_step``:
    float32 parameters (the optimizer's master weights, cast to the preset's
    compute dtypes at each call), the config's whole-run-frozen prefix, and
    the configured dropout rates (``architecture`` replaces the encoder, e.g.
    a tiny one or one with other rates); ``remat`` rematerialises the encoder
    layers; over a ``mesh`` with a model axis, the model is this rank's shard
    of the one-device model of ``seed``. Sets the preset's float32 matmul
    precision, which is process-global."""
    device = resolve_device(device)
    dtype, head_dtype, f32_matmul_precision = resolve_precision(precision)
    model = _flagship_build(architecture, dtype, head_dtype, device, param_dtype=torch.float32, remat=remat, mesh=mesh).model
    seeded_initialization(model, seed, mesh)
    set_float32_precision(f32_matmul_precision)
    return flagship_config(), model
