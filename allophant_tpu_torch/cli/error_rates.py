"""``allophant-error-rates`` CLI (counterpart of
``allophant_tpu/cli/error_rates.py``): the macro-average PER/AER report of an
evaluation results file (``allophant evaluate -j``): per-language phone/phoneme
error rates with their macro averages, per-language and per-attribute macro
attribute error rates, and the overall macro AER."""

from __future__ import annotations

import sys
from argparse import ArgumentParser, FileType
from typing import Dict, List, Sequence

import numpy as np

_IPA_CATEGORIES = ("phone", "phoneme")


def _report(results_data, language_subset) -> List[str]:
    """Builds the report lines from parsed results."""
    per_language: Dict[str, Dict[str, float]] = {
        language: dict(entry.error_rates)
        for language, entry in results_data.results.items()
        if language != "total" and (language_subset is None or language in language_subset)
    }
    if language_subset is not None:
        missing = language_subset - per_language.keys()
        if missing:
            raise ValueError(
                f"Languages from -l/--languages are missing from the results file:"
                f" [{', '.join(sorted(missing))}]"
            )

    lines = [
        f"Evaluation Arguments {results_data.evaluation_arguments}",
        f"Package Version {results_data.package_version}",
    ]
    languages = list(per_language)
    if not languages:
        lines.append("No results")
        return lines

    # IPA-level categories get their own per-language sections + macro average.
    for category in _IPA_CATEGORIES:
        if category not in per_language[languages[0]]:
            continue
        rates = [per_language[language].pop(category) * 100 for language in languages]
        lines.extend(f"{language},{rate}" for language, rate in zip(languages, rates))
        lines.append(f"Average {category} error rate,{np.mean(rates)}")

    attribute_names = list(per_language[languages[0]])
    if not attribute_names:
        lines.append("No Attribute Error Rates")
        return lines

    matrix = (
        np.asarray(
            [[per_language[language][name] for name in attribute_names] for language in languages]
        )
        * 100
    )
    lines.extend(f"{language},{rate}" for language, rate in zip(languages, matrix.mean(axis=1)))
    lines.extend(f"{name},{rate}" for name, rate in zip(attribute_names, matrix.mean(axis=0)))
    lines.append(f"Average,{matrix.mean()}")
    return lines


def main(args: Sequence[str] | None = None) -> None:
    parser = ArgumentParser(description="Macro-averaged PER/AER report from evaluation results")
    parser.add_argument(
        "results_file", type=FileType("r", encoding="utf-8"),
        help="Path to a results file from the evaluation command",
    )
    parser.add_argument(
        "-l", "--languages", type=lambda codes: set(codes.split(",")),
        help="Comma separated list of language codes to display the results and averages for",
    )
    arguments = parser.parse_args(sys.argv[1:] if args is None else args)

    from allophant_tpu_torch.evaluation import MultilingualEvaluationResults

    results_data = MultilingualEvaluationResults.load(arguments.results_file)
    for line in _report(results_data, arguments.languages):
        print(line)


if __name__ == "__main__":
    main()
