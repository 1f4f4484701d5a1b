"""``allophant-features`` CLI of the port (counterpart of
``allophant_tpu/cli/features.py``): extracts the most suitable PHOIBLE
inventories per language into a processed feature CSV."""

from __future__ import annotations

import sys
from argparse import ArgumentParser, FileType
from typing import Sequence


def main(args: Sequence[str] | None = None) -> None:
    if args is None:
        args = sys.argv[1:]

    parser = ArgumentParser(
        description="Extracts the most suitable PHOIBLE inventories for every language or a subset"
    )
    parser.add_argument(
        "language_codes",
        nargs="?",
        type=lambda codes: codes.split(","),
        help="ISO639 language codes for which to extract inventories",
    )
    parser.add_argument(
        "-o", "--out", type=FileType("w", encoding="utf-8"), default=sys.stdout,
        help="Output path for the processed PHOIBLE CSV",
    )
    parser.add_argument(
        "-p", "--feature-path", type=FileType("r", encoding="utf-8"),
        help="Path to a custom PHOIBLE version to process instead of the included version",
    )
    parser.add_argument(
        "-r", "--remove-zero", action="store_true",
        help="Removes the zero phoneme from allophone positions",
    )
    parser.add_argument(
        "-d", "--prefer-allophant-dialects", action="store_true",
        help="Selects the dialects used during Allophant pre-training over the largest inventory",
    )

    arguments = parser.parse_args(args)

    from allophant_tpu_torch.phonetics.features import extract_allophone_inventories, read_allophoible

    if arguments.feature_path is None:
        allophoible = read_allophoible()
    else:
        with arguments.feature_path as file:
            allophoible = read_allophoible(file)

    with arguments.out as file:
        file.write(
            extract_allophone_inventories(
                allophoible,
                arguments.language_codes,
                None,
                None,
                arguments.prefer_allophant_dialects,
                arguments.remove_zero,
            ).to_csv()
        )


if __name__ == "__main__":
    main()
