"""Prediction decoding and JSONL (+gzip) serialization (counterpart of
``allophant_tpu/predictions.py``): per-feature CTC decoders, ``FeatureDecoder``
bundles for per-language zero-shot inventories, and the versioned JSONL
prediction/edits file format with a metadata header line. The decoders run on
``device`` (CUDA unless the caller asks for another)."""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from os import path
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from allophant_tpu_torch import phonemes
from allophant_tpu_torch.ops.decode import DeviceBeamCTCDecoder, GreedyCTCDecoder
from allophant_tpu_torch.phonemes import Action
from allophant_tpu_torch.phonetics.features import ArticulatoryAttributes, PhonemeIndexer, PhoneticIndexerState
from allophant_tpu_torch.training.checkpoint import VERSION

# Major, Minor, Patch — matches the reference's current format so files interoperate.
CURRENT_FORMAT_VERSION = (1, 1, 0)
SUPPORTED_VERSIONS = [CURRENT_FORMAT_VERSION]


@dataclass
class PredictionMetaData:
    prediction_arguments: str
    corpus_type: str
    languages: List[str]
    feature_set: str
    indexer_state: PhoneticIndexerState
    classifiers: List[str]
    label_inventories: Dict[str, List[str]] | None = None
    package_version: str = VERSION
    format_version: Tuple[int, int, int] = CURRENT_FORMAT_VERSION

    def to_json(self) -> Dict[str, Any]:
        return {
            "prediction_arguments": self.prediction_arguments,
            "corpus_type": self.corpus_type,
            "languages": self.languages,
            "feature_set": self.feature_set,
            "indexer_state": self.indexer_state.to_dict(),
            "classifiers": self.classifiers,
            "label_inventories": self.label_inventories,
            "package_version": self.package_version,
            "format_version": list(self.format_version),
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "PredictionMetaData":
        return cls(
            data["prediction_arguments"],
            data["corpus_type"],
            list(data["languages"]),
            data["feature_set"] if isinstance(data["feature_set"], str) else data["feature_set"],
            PhoneticIndexerState.from_dict(data["indexer_state"]),
            list(data["classifiers"]),
            data.get("label_inventories"),
            data.get("package_version", "unknown"),
            tuple(data.get("format_version", CURRENT_FORMAT_VERSION)),
        )

    @classmethod
    def loads(cls, line: str) -> "PredictionMetaData":
        return cls.from_json(json.loads(line))


@dataclass
class UtterancePrediction:
    language: str
    utterance_id: str
    predictions: Dict[str, List[List[str]]]
    labels: List[List[str]] | None = None

    def to_json(self) -> str:
        # ensure_ascii=False keeps IPA as raw UTF-8: parses identically, writes
        # smaller files, and skips the \uXXXX escape scan in the predict drain's
        # hot serialization loop.
        return json.dumps(
            {
                "language": self.language,
                "utterance_id": self.utterance_id,
                "predictions": self.predictions,
                "labels": self.labels,
            },
            ensure_ascii=False,
        )

    @classmethod
    def from_json(cls, line: str) -> "UtterancePrediction":
        data = json.loads(line)
        return cls(data["language"], data["utterance_id"], data["predictions"], data.get("labels"))


def levensthein_substitutions(expected: List[str], actual: List[str]) -> List[Tuple[Action, str, str]]:
    return phonemes.to_substitutions(expected, actual, phonemes.levensthein_operations(expected, actual)[0])


@dataclass
class UtteranceEdits:
    language: str
    utterance_id: str
    expected: Dict[str, List[str]]
    edit_operations: Dict[str, List[Tuple[Action, str, str]]]

    def to_json(self) -> str:
        return json.dumps(
            {
                "language": self.language,
                "utterance_id": self.utterance_id,
                "expected": self.expected,
                "edit_operations": {
                    name: [[int(action), a, b] for action, a, b in operations]
                    for name, operations in self.edit_operations.items()
                },
            },
            ensure_ascii=False,
        )

    @classmethod
    def from_json(cls, line: str) -> "UtteranceEdits":
        data = json.loads(line)
        return cls(
            data["language"],
            data["utterance_id"],
            data["expected"],
            {
                name: [(Action.from_int(action), a, b) for action, a, b in operations]
                for name, operations in data["edit_operations"].items()
            },
        )


def _infer_gzip(filepath) -> bool:
    name = filepath if isinstance(filepath, str) else getattr(filepath, "name", "")
    return path.splitext(str(name))[1] == ".gz"


class JsonlReader:
    """Line-oriented JSONL reader with optional gzip and a metadata header."""

    def __init__(self, file, use_gzip: bool | None = None) -> None:
        self._wrapped_file = file
        self._gzip = _infer_gzip(file) if use_gzip is None else use_gzip

    def read_meta(self):
        return None

    def process_line(self, line):
        return line

    def __iter__(self):
        for line in self._file:
            yield self.process_line(line)

    def __enter__(self):
        if self._gzip:
            self._file = gzip.open(self._wrapped_file, "rt", encoding="utf-8")
        elif isinstance(self._wrapped_file, str):
            self._file = open(self._wrapped_file, "r", encoding="utf-8")
        else:
            self._file = self._wrapped_file
        self._metadata = self.read_meta()
        return self

    def __exit__(self, *_) -> None:
        self._file.close()


class PredictionReader(JsonlReader):
    def read_meta(self) -> PredictionMetaData:
        return PredictionMetaData.loads(self._file.readline())

    @property
    def metadata(self) -> PredictionMetaData:
        return self._metadata

    def process_line(self, line) -> UtterancePrediction:
        return UtterancePrediction.from_json(line)


class StatisticsReader(JsonlReader):
    def read_meta(self) -> PredictionMetaData:
        return PredictionMetaData.loads(self._file.readline())

    @property
    def metadata(self) -> PredictionMetaData:
        return self._metadata

    def process_line(self, line) -> UtteranceEdits:
        return UtteranceEdits.from_json(line)


class JsonlWriter:
    def __init__(self, file, metadata: PredictionMetaData, use_gzip: bool = False) -> None:
        self._wrapped_file = file
        self._gzip = _infer_gzip(file) if use_gzip is None else use_gzip
        self._meta_data = metadata

    def __enter__(self):
        if self._gzip:
            self._file = gzip.open(self._wrapped_file, "xt", encoding="utf-8")
        elif isinstance(self._wrapped_file, str):
            self._file = open(self._wrapped_file, "x", encoding="utf-8")
        else:
            self._file = self._wrapped_file
        self._file.write(self._meta_data.dumps() + "\n")
        return self

    def __exit__(self, *_) -> None:
        self._file.close()

    def write(self, serialized) -> None:
        self._file.write(str(serialized.to_json()) + "\n")


def _ctc_decoder(categories: Iterable[str], beam_width: int = 1, n_best: int = 1, device=None):
    if n_best > beam_width:
        raise ValueError("N-best can not exceed beam width")
    if beam_width == 1:
        return GreedyCTCDecoder(device=device)
    return DeviceBeamCTCDecoder(["<blank>", *categories], beam_width, n_best, device=device)


class FeatureDecoder:
    """Per-language decode bundle: subset attributes, dense feature matrix (for the
    composition layer) and a CTC decoder over the inventory."""

    def __init__(self, feature_attributes: ArticulatoryAttributes, beam_width: int = 1, n_best: int = 1, device=None):
        self.attributes = feature_attributes
        self.feature_matrix = feature_attributes.dense_feature_table.astype(np.int64)
        self.decoder = _ctc_decoder(feature_attributes.phonemes, beam_width, n_best, device)


def feature_decoders(
    indexer: PhonemeIndexer,
    beam_width: int = 1,
    feature_names: Iterable[str] | None = None,
    n_best: int = 1,
    device=None,
) -> Dict[str, Any]:
    """One CTC decoder per feature name over its category vocabulary."""
    return {
        name: _ctc_decoder(indexer.feature_categories(name), beam_width, n_best, device)
        for name in (indexer.feature_names if feature_names is None else feature_names)
    }
