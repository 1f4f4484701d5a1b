"""``allophant-data`` CLI of the port (counterpart of
``allophant_tpu/cli/data.py``, with its subcommands and flag spellings):
``transcribe`` (G2P -> msgpack corpus), ``download-meta``, ``save-lengths``
(audio-header lengths -> store), ``preprocess`` (feature tensors -> store)
and ``stats``. Stores are the ragged numpy layout of
:mod:`allophant_tpu_torch.data.store`, or with ``--zarr`` the reference's
zarr-v2 cache (:mod:`allophant_tpu_torch.data.zarr_store`); both packages
read both. Everything here runs on the host.

    python -m allophant_tpu_torch.cli.data preprocess CORPUS STORE [-c CONFIG] [--zarr]"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import tomllib
from argparse import ArgumentParser, FileType, Namespace
from typing import Dict, Optional, Sequence

import numpy as np

DATA_LOGGER = logging.getLogger("allophant_tpu_torch.data")
DATA_LOGGER.setLevel(logging.INFO)


def _load_config(arguments: Namespace):
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.package_data import DEFAULT_CONFIG_PATH

    if getattr(arguments, "config_json_data", None) is not None:
        return Config.load(json.loads(arguments.config_json_data))
    config_path = getattr(arguments, "config", None) or DEFAULT_CONFIG_PATH
    with open(config_path, "rb") as file:
        return Config.load(tomllib.load(file))


# ---------------------------------------------------------------------------
# transcribe
# ---------------------------------------------------------------------------


def generate_phoneme_transcriptions(parser: ArgumentParser, arguments: Namespace) -> None:
    """G2P-transcribes Common Voice into msgpack corpora + inventory files
    (reference datasets/__main__.py:48-105)."""
    from allophant_tpu_torch.data import common_voice
    from allophant_tpu_torch.data.common_voice import CommonVoiceCorpus
    from allophant_tpu_torch.data.g2p import G2PEngineType, GraphemeToPhonemeEnsemble
    from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
    from allophant_tpu_torch.phonetics.language_codes import LanguageCodeMap
    from allophant_tpu_torch.phonetics.segmentation import SEGMENTATION_LOGGER

    if arguments.engine is None:
        g2p_engine = None
        if arguments.feature_set or arguments.attribute_path:
            parser.error(
                "Attribute path (-a/--attribute-path) and/or feature sets (-f/--feature-set)"
                " are only valid when a grapheme to phoneme engine is specified"
            )
    else:
        if arguments.feature_set:
            phoneme_inventory = PhoneticAttributeIndexer(
                arguments.feature_set,
                arguments.attribute_path.read() if arguments.attribute_path else None,
            ).phonemes.tolist()
        elif arguments.attribute_path:
            with arguments.attribute_path as file:
                phoneme_inventory = [segment.strip() for segment in file]
        else:
            parser.error(
                "At least one of -f/--feature-set and -a/--attribute-path has to be"
                " specified if grapheme to phoneme engines are given"
            )

        engines = []
        seen = set()
        for engine_type in arguments.engine:
            if engine_type in seen:
                parser.error(f"G2P engine {engine_type!r} specified more than once")
            engines.append(G2PEngineType(engine_type).model())
            seen.add(engine_type)
        g2p_engine = GraphemeToPhonemeEnsemble(engines, phoneme_inventory, arguments.batch_size)
        if arguments.log is not None:
            SEGMENTATION_LOGGER.add_file_handler(arguments.log)

    language_codes = arguments.language_codes
    training_limits = arguments.training_limits
    if language_codes is not None or isinstance(training_limits, dict):
        language_map = LanguageCodeMap(
            CommonVoiceCorpus.language_codes_from_meta(arguments.common_voice_path)
        )
        if language_codes is not None:
            language_codes = [language_map[code] for code in language_codes]
        if isinstance(training_limits, dict):
            training_limits = {language_map[code]: limit for code, limit in training_limits.items()}

    common_voice.load_common_voice(
        arguments.common_voice_path,
        g2p_engine,
        arguments.feature_set,
        arguments.include_single_upvote,
        arguments.batch_size,
        language_codes,
        arguments.map_to_allophoible,
        training_limits,
        arguments.progress,
        arguments.mapping_threshold,
    ).save(arguments.common_voice_path, arguments.output_directory)


def download_meta(_parser: ArgumentParser, arguments: Namespace) -> None:
    from allophant_tpu_torch.data.common_voice import download_release_meta

    with arguments.output as output:
        json.dump(download_release_meta(arguments.version), output)


# ---------------------------------------------------------------------------
# save-lengths / preprocess
# ---------------------------------------------------------------------------


def save_lengths(_parser: ArgumentParser, arguments: Namespace) -> None:
    """Audio-header frame counts per utterance -> ragged store (reference
    datasets/__main__.py:216-242)."""
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.data.preprocessing import FeatureFunction
    from allophant_tpu_torch.data.store import write_lengths, write_meta

    config = _load_config(arguments)
    splits = corpus_loading.load_corpus(
        arguments.dataset_path,
        arguments.dataset_type,
        config.preprocessing.resample,
        only_primary_script=config.data.only_primary_script,
        progress_bar=True,
    )
    sample_rate = splits.audio_info().sample_rate or config.preprocessing.resample or 16_000
    feature_function = FeatureFunction.from_config(config, sample_rate)

    if getattr(arguments, "zarr", False):
        from allophant_tpu_torch.data.zarr_store import ZarrDirectoryWriter

        zarr_writer = ZarrDirectoryWriter(arguments.output_directory)
        zarr_writer.write_attrs("", {"feature_size": feature_function.feature_size})
        for split_name, split in zip(("train", "dev", "test"), splits):
            for language_code, lengths in split.read_lengths():
                zarr_writer.write_plain(
                    f"{split_name}/{language_code}",
                    "lengths",
                    np.fromiter(
                        (feature_function.frame_count(length) for length in lengths),
                        dtype=np.int64,
                    ),
                )
        return

    write_meta(arguments.output_directory, feature_function.feature_size)
    for split_name, split in zip(("train", "dev", "test"), splits):
        for language_code, lengths in split.read_lengths():
            write_lengths(
                arguments.output_directory,
                split_name,
                language_code,
                (feature_function.frame_count(length) for length in lengths),
            )


def preprocess_features(_parser: ArgumentParser, arguments: Namespace) -> None:
    """Computes acoustic features for every utterance into the ragged store
    (reference datasets/__main__.py:161-213)."""
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.data.preprocessing import FeatureFunction
    from allophant_tpu_torch.data.store import RaggedFeatureWriter, write_meta
    from allophant_tpu_torch.utils import progress_bar

    config = _load_config(arguments)
    splits = corpus_loading.load_corpus(
        arguments.dataset_path,
        arguments.dataset_type,
        config.preprocessing.resample,
        only_primary_script=config.data.only_primary_script,
        progress_bar=True,
    )
    sample_rate = splits.audio_info().sample_rate or config.preprocessing.resample or 16_000
    feature_function = FeatureFunction.from_config(config, sample_rate)

    use_zarr = getattr(arguments, "zarr", False)
    if use_zarr:
        from allophant_tpu_torch.data.zarr_store import StreamingVlenWriter, ZarrDirectoryWriter

        zarr_writer = ZarrDirectoryWriter(arguments.output_directory)
        zarr_writer.write_attrs("", {"feature_size": feature_function.feature_size})
    else:
        write_meta(arguments.output_directory, feature_function.feature_size)

    progress = progress_bar(desc="preprocess", unit="utt")
    for split_name, split in zip(("train", "dev", "test"), splits):
        for language in split.languages:
            frame_counts = []
            if use_zarr:
                writer = StreamingVlenWriter(
                    zarr_writer, f"{split_name}/{language}", "features"
                )
            else:
                writer = RaggedFeatureWriter(
                    arguments.output_directory, split_name, language, feature_function.feature_size
                )
            progress.set_description(f"preprocess {split_name}/{language}")
            for index in split.monolingual_index_range(language):
                audio, _rate = split.audio(index)
                # FeatureFunction expects [channels, samples] and extracts the
                # mono channel itself (reference preprocessing.py:50-161).
                features = feature_function(audio if audio.ndim > 1 else audio[None, :])
                if features.ndim == 1:
                    features = features[:, None]
                writer.append(features)
                if use_zarr:
                    frame_counts.append(features.shape[0])
                progress.update(1)
            writer.close()
            if use_zarr:
                # The reference's preprocess stores per-utterance frame counts
                # next to the features (datasets/__main__.py:189-194).
                zarr_writer.write_plain(
                    f"{split_name}/{language}",
                    "lengths",
                    np.asarray(frame_counts, np.int64),
                )
    progress.close()


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UtteranceDurations:
    total: int
    average: float
    sample_rate: Optional[int] = None

    def __str__(self) -> str:
        if self.sample_rate is None:
            seconds = hours = 1
        else:
            seconds = self.sample_rate
            hours = self.sample_rate * 60 * 60
        return (
            f"{self.total} frames at {self.sample_rate}: {self.total / hours:.2f}h"
            f" (Average: {self.average / seconds:.4f}s)"
        )

    @classmethod
    def compute(cls, lengths: np.ndarray, sample_rate: int | None = None) -> "UtteranceDurations":
        return cls(int(lengths.sum()), float(lengths.mean()), sample_rate)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def corpus_statistics(_parser: ArgumentParser, arguments: Namespace) -> None:
    """Per-split utterance counts and (optional) duration statistics (reference
    datasets/__main__.py:298-324)."""
    from allophant_tpu_torch.data import corpus_loading

    splits = corpus_loading.load_corpus(
        arguments.dataset_path,
        arguments.dataset_type,
        only_primary_script=arguments.only_primary_script,
        progress_bar=True,
    )

    lengths_data = None
    if arguments.lengths is not None:
        lengths_data = corpus_loading.preprocessed_features_or_lengths(
            arguments.lengths,
            {split: getattr(splits, split).languages for split in arguments.splits},
        )

    statistics: Dict[str, Dict] = {}
    for split_name in arguments.splits:
        split = getattr(splits, split_name)
        entry: Dict = {
            "languages": list(split.languages),
            "utterance_counts": {
                language: len(split.monolingual_index_range(language))
                for language in split.languages
            },
        }
        if lengths_data is not None:
            lengths = lengths_data[split_name].lengths
            entry["durations"] = {}
            for language in split.languages:
                index_range = split.monolingual_index_range(language)
                entry["durations"][language] = UtteranceDurations.compute(
                    lengths[index_range.start : index_range.stop], arguments.sample_rate
                )
        statistics[split_name] = entry

    if arguments.json:
        print(
            json.dumps(
                statistics,
                default=lambda value: value.to_json() if hasattr(value, "to_json") else str(value),
            )
        )
    else:
        for split_name, entry in statistics.items():
            print(f"== {split_name} ==")
            print(f"languages: {', '.join(entry['languages'])}")
            for language, count in entry["utterance_counts"].items():
                line = f"  {language}: {count} utterances"
                if "durations" in entry:
                    line += f" | {entry['durations'][language]}"
                print(line)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


def make_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Preprocessing for phonetically transcribed corpora")
    subparsers = parser.add_subparsers(dest="mode")
    subparsers.required = True

    transcription_parser = subparsers.add_parser(
        "transcribe",
        help="Generates phonemic transcriptions for the Mozilla Common Voice corpus",
    )
    transcription_parser.add_argument(
        "common_voice_path", help="Path to a version of the Mozilla Common Voice dataset"
    )
    transcription_parser.add_argument(
        "-e", "--engine", action="append", choices=["espeak-ng", "epitran"], default=None,
        help="G2P engine(s) for extracting phonemic transcriptions",
    )
    transcription_parser.add_argument(
        "-u", "--include-single-upvote", action="store_true",
        help="Includes unvalidated utterances with more upvotes than downvotes",
    )
    transcription_parser.add_argument(
        "-b", "--batch-size", type=int, default=1,
        help="Batch size for tokenization and G2P engines",
    )
    transcription_parser.add_argument(
        "-l", "--language-codes", type=lambda codes: codes.split(","), default=None,
        help="ISO639 language codes for each language to be transcribed",
    )
    transcription_parser.add_argument(
        "-t", "--training-limits", type=_parse_limits, default=None,
        help="Per-language utterance limit (single number or JSON dict)",
    )
    transcription_parser.add_argument(
        "-a", "--attribute-path", type=FileType("r", encoding="utf-8"), default=None,
        help="Path to a phoneme inventory or feature file",
    )
    transcription_parser.add_argument(
        "-f", "--feature-set", choices=["phoible", "panphon"], default=None,
        help="Feature set to load (Allophoible for phoible)",
    )
    transcription_parser.add_argument(
        "-p", "--progress", action="store_true", help="Shows progress bars"
    )
    transcription_parser.add_argument(
        "-m", "--map-to-allophoible", action="store_true",
        help="Remaps train/dev inventories to Allophoible inventories",
    )
    transcription_parser.add_argument(
        "-o", "--output-directory", default=None,
        help="Directory transcriptions are saved to (corpus directory by default)",
    )
    transcription_parser.add_argument(
        "--log", help="Path to a log file for phonemes missing from the feature set"
    )
    transcription_parser.add_argument(
        "--mapping-threshold", type=int, default=None,
        help="Distance threshold above which inventory mapping is skipped",
    )

    download_meta_parser = subparsers.add_parser(
        "download-meta", help="Downloads Common Voice release metadata"
    )
    download_meta_parser.add_argument(
        "output", nargs="?", type=FileType("w", encoding="utf-8"), default=sys.stdout,
        help="Output file for the metadata",
    )
    download_meta_parser.add_argument(
        "-v", "--version", default="10.0-2022-07-04", help="Common Voice corpus version"
    )

    data_config_parser = ArgumentParser(add_help=False)
    data_config_parser.add_argument(
        "-t", "--dataset-type", choices=["common-voice"], default="common-voice",
        help="Type of the dataset",
    )
    data_config_parser.add_argument(
        "-c", "--config", default=None, help="Path to a TOML configuration file"
    )
    data_config_parser.add_argument(
        "-j", "--config-json-data", default=None, help="Inline JSON configuration"
    )

    data_processing_parser = ArgumentParser(add_help=False)
    data_processing_parser.add_argument(
        "dataset_path", help="Path to a corpus containing phonetically transcribed utterances"
    )
    data_processing_parser.add_argument(
        "output_directory", help="Directory the processed data is stored in"
    )
    data_processing_parser.add_argument(
        "--zarr", action="store_true",
        help="Write the reference framework's zarr-v2 cache layout instead of"
        " the native ragged store (readable by the reference's zarr reader;"
        " this framework reads both formats transparently)",
    )

    subparsers.add_parser(
        "save-lengths",
        parents=[data_config_parser, data_processing_parser],
        help="Generates and saves frame lengths based on the configured feature function",
    )

    preprocessing_parser = subparsers.add_parser(
        "preprocess",
        parents=[data_config_parser, data_processing_parser],
        help="Precomputes acoustic features for the given dataset",
    )
    preprocessing_parser.add_argument(
        "-w", "--data-workers", type=int, default=None, help="Number of data workers"
    )

    statistics_parser = subparsers.add_parser("stats", help="Corpus statistics")
    statistics_parser.add_argument(
        "dataset_path", help="Path to a corpus containing phonetically transcribed utterances"
    )
    statistics_parser.add_argument(
        "-t", "--dataset-type", choices=["common-voice"], default="common-voice",
        help="Type of the dataset",
    )
    statistics_parser.add_argument(
        "-l", "--lengths", help="Path to previously saved utterance lengths"
    )
    statistics_parser.add_argument(
        "-p", "--only-primary-script", action="store_true",
        help="Keeps only transcriptions in each language's primary script",
    )
    statistics_parser.add_argument(
        "-s", "--splits", type=lambda value: value.split(","), default=["train", "dev", "test"],
        help="Comma separated splits to calculate statistics for",
    )
    statistics_parser.add_argument(
        "-j", "--json", action="store_true", help="Outputs statistics in JSON format"
    )
    statistics_parser.add_argument(
        "-r", "--sample-rate", type=int, default=None,
        help="Interprets lengths as frame counts at the given sample rate",
    )

    return parser


def _parse_limits(value: str):
    try:
        return int(value)
    except ValueError:
        return {str(code): int(limit) for code, limit in json.loads(value).items()}


def main(args: Sequence[str] | None = None) -> None:
    if args is None:
        args = sys.argv[1:]
    parser = make_parser()
    arguments = parser.parse_args(args)
    if arguments.mode == "transcribe":
        generate_phoneme_transcriptions(parser, arguments)
    elif arguments.mode == "download-meta":
        download_meta(parser, arguments)
    elif arguments.mode == "save-lengths":
        save_lengths(parser, arguments)
    elif arguments.mode == "preprocess":
        preprocess_features(parser, arguments)
    elif arguments.mode == "stats":
        corpus_statistics(parser, arguments)
    else:
        raise ValueError(f"Unsupported action: {arguments.mode}")


if __name__ == "__main__":
    main()
