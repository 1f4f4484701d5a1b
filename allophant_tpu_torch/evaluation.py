"""Evaluation result containers (counterpart of ``allophant_tpu/evaluation.py``),
in the JSON shape of the reference's result files, so the two packages' files
interoperate."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List

from allophant_tpu_torch.phonemes import EditStatistics
from allophant_tpu_torch.training.checkpoint import VERSION


def _statistics_to_json(value: EditStatistics) -> Dict[str, int]:
    return {
        "insertions": value.insertions,
        "deletions": value.deletions,
        "substitutions": value.substitutions,
        "correct": value.correct,
    }


def _statistics_from_json(value: Dict[str, int]) -> EditStatistics:
    keys = {"insertions", "deletions", "substitutions", "correct"}
    if set(value.keys()) != keys:
        raise ValueError("EditStatistics field mismatch, either missing or superfluous fields present")
    return EditStatistics(value["insertions"], value["deletions"], value["substitutions"], value["correct"])


@dataclass
class EvaluationResults:
    properties: List[str]
    error_rates: Dict[str, float]
    error_statistics: Dict[str, EditStatistics]

    def to_json(self) -> Dict[str, Any]:
        return {
            "properties": self.properties,
            "error_rates": self.error_rates,
            "error_statistics": {
                name: _statistics_to_json(statistics) for name, statistics in self.error_statistics.items()
            },
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "EvaluationResults":
        return cls(
            list(data["properties"]),
            {name: float(rate) for name, rate in data["error_rates"].items()},
            {name: _statistics_from_json(value) for name, value in data["error_statistics"].items()},
        )

    def __format__(self, format_spec: str) -> str:
        strings = []
        for name in self.properties:
            strings.append(
                f"{name}: | {self.error_statistics[name]} | {self.error_rates[name] * 100:{format_spec + 'f'}}"
            )
        return "\n".join(strings)

    def __str__(self) -> str:
        return f"{self:.4}"


@dataclass
class MultilingualEvaluationResults:
    evaluation_arguments: str
    results: Dict[str, EvaluationResults]
    package_version: str = VERSION

    def to_json(self) -> Dict[str, Any]:
        return {
            "evaluation_arguments": self.evaluation_arguments,
            "results": {language: results.to_json() for language, results in self.results.items()},
            "package_version": self.package_version,
        }

    def dump(self, file) -> None:
        if isinstance(file, str):
            with open(file, "w", encoding="utf-8") as handle:
                json.dump(self.to_json(), handle)
        else:
            json.dump(self.to_json(), file)

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "MultilingualEvaluationResults":
        return cls(
            data["evaluation_arguments"],
            {language: EvaluationResults.from_json(results) for language, results in data["results"].items()},
            data.get("package_version", "unknown"),
        )

    @classmethod
    def load(cls, file) -> "MultilingualEvaluationResults":
        if isinstance(file, str):
            with open(file, "r", encoding="utf-8") as handle:
                return cls.from_json(json.load(handle))
        return cls.from_json(json.load(file))

    def __format__(self, format_spec: str) -> str:
        strings = [f"Command: {self.evaluation_arguments}\nVersion: {self.package_version}"]
        for language, results in self.results.items():
            strings.append(f"{language}:\n{results:{format_spec}}")
        return "\n".join(strings)

    def __str__(self) -> str:
        return f"{self:.4}"


def macro_average_error_rates(
    results: MultilingualEvaluationResults, ipa_layers: tuple = ("phone", "phoneme")
) -> Dict[str, float]:
    """Macro averages over languages (and over attributes for AER), as the
    published README numbers are averaged."""
    per_language = {
        language: dict(entry.error_rates)
        for language, entry in results.results.items()
        if language != "total"
    }
    summary: Dict[str, float] = {}
    languages = list(per_language)
    if not languages:
        return summary

    for layer in ipa_layers:
        if layer in per_language[languages[0]]:
            values = [per_language[language].pop(layer) for language in languages]
            summary[f"{layer}_error_rate"] = sum(values) / len(values)
    # The headline PER: phone-layer rates for allophone models (which decode raw
    # phones), else the phoneme layer.
    for layer in ipa_layers:
        if f"{layer}_error_rate" in summary:
            summary["phoneme_error_rate"] = summary[f"{layer}_error_rate"]
            break

    attribute_matrix = [list(rates.values()) for rates in per_language.values() if rates]
    if attribute_matrix and attribute_matrix[0]:
        flat = [rate for row in attribute_matrix for rate in row]
        summary["attribute_error_rate"] = sum(flat) / len(flat)
    return summary
