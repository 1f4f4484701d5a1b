"""Mozilla Common Voice corpus (the port's copy of
``allophant_tpu/data/common_voice.py``): TSV parsing, offline G2P
transcription, the ``{split}_transcriptions.bin`` corpus files and their
inventories, release metadata, and ``load_corpus``'s splits.

The on-disk format (msgpack with transcription records as extension types 2
and 4, field-name keyed maps inside, plus ``{split}_inventories.json``) is the
JAX package's and the reference's, read and written byte for byte through the
port's own codec (``training/msgpack_codec.py``)."""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field
from os import path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple, Union

from allophant_tpu_torch.data import csv_validator
from allophant_tpu_torch.data.csv_validator import CsvSchema
from allophant_tpu_torch.data.g2p import (
    PhonemeTranscriber,
    PhonemeTranscription,
    TaggedTranscription,
)
from allophant_tpu_torch.data.speech_corpus import (
    LanguageData,
    LanguageInfo,
    MultilingualCorpus,
    MultilingualSplits,
)
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.phonetics.segmentation import SEGMENTATION_LOGGER
from allophant_tpu_torch.training import msgpack_codec
from allophant_tpu_torch.training.checkpoint import VERSION
from allophant_tpu_torch.training.msgpack_codec import ExtType


LANGUAGE_META_URL_TEMPLATE = "https://commonvoice.mozilla.org/dist/releases/cv-corpus-{}.json"


def download_release_meta(version: str) -> Any:
    """Fetches release metadata for a Common Voice version (reference
    mozilla_common_voice.py:117-118). Requires network access."""
    import urllib.request

    with urllib.request.urlopen(LANGUAGE_META_URL_TEMPLATE.format(version)) as response:
        return json.load(response)


@dataclass
class RawTranscription:
    """An orthographic Common Voice utterance."""

    raw_sentence: str
    utterance_id: str
    client_id: str
    age: Optional[str]
    gender: Optional[str]
    accents: Optional[str]

    _EXT_ID = 2

    def _fields(self) -> Dict[str, Any]:
        return {
            "raw_sentence": self.raw_sentence,
            "utterance_id": self.utterance_id,
            "client_id": self.client_id,
            "age": self.age,
            "gender": self.gender,
            "accents": self.accents,
        }

    def to_msgpack(self) -> bytes:
        return msgpack_codec.packb(self._fields())

    @classmethod
    def from_msgpack(cls, data: bytes) -> "RawTranscription":
        fields = msgpack_codec.unpackb(data)
        return cls(
            fields["raw_sentence"],
            fields["utterance_id"],
            fields["client_id"],
            fields.get("age"),
            fields.get("gender"),
            fields.get("accents"),
        )


@dataclass
class Transcription(RawTranscription):
    """A phonemically transcribed Common Voice utterance."""

    phonemes: PhonemeTranscription = None  # type: ignore[assignment]

    _EXT_ID = 4

    def to_msgpack(self) -> bytes:
        fields = self._fields()
        fields["phonemes"] = self.phonemes.to_json()
        return msgpack_codec.packb(fields)

    @classmethod
    def from_msgpack(cls, data: bytes) -> "Transcription":
        fields = msgpack_codec.unpackb(data)
        return cls(
            fields["raw_sentence"],
            fields["utterance_id"],
            fields["client_id"],
            fields.get("age"),
            fields.get("gender"),
            fields.get("accents"),
            PhonemeTranscription.from_json(fields["phonemes"]),
        )


_TRANSCRIPTION_TYPES = (Transcription, RawTranscription)


def transcription_ext_encoder(obj: Any) -> ExtType:
    for transcription_type in _TRANSCRIPTION_TYPES:
        if isinstance(obj, transcription_type):
            return ExtType(transcription_type._EXT_ID, obj.to_msgpack())
    raise TypeError(f"Received object of unknown type: {type(obj)}")


def transcription_ext_decoder(code: int, data: bytes):
    for transcription_type in _TRANSCRIPTION_TYPES:
        if code == transcription_type._EXT_ID:
            return transcription_type.from_msgpack(data)
    return ExtType(code, data)


@dataclass
class CommonVoiceCorpusMeta:
    corpus_name: str
    phoneme_sources: Optional[List[str]] = None
    feature_set: Optional[str] = None
    limits: Union[Dict[str, int], int, None] = None
    utterance_counts: Dict[str, int] = field(default_factory=dict)
    package_version: str = VERSION
    audio_format: str = "mp3"  # CV releases ship mp3; converted corpora may use wav

    def to_json(self) -> Dict[str, Any]:
        data = {
            "corpus_name": self.corpus_name,
            "phoneme_sources": self.phoneme_sources,
            "feature_set": self.feature_set,
            "limits": self.limits,
            "utterance_counts": self.utterance_counts,
            "package_version": self.package_version,
        }
        # "audio_format" is this framework's extension (WAV-converted corpora);
        # the reference's CommonVoiceCorpusMeta marshmallow schema raises on
        # unknown keys at load (marshmallow default unknown=RAISE; reference
        # mozilla_common_voice.py:165-175 declares no Meta). Omit the key for
        # the mp3 default so stock-format corpora stay reference-portable;
        # non-mp3 corpora are a this-framework-only feature either way.
        if self.audio_format != "mp3":
            data["audio_format"] = self.audio_format
        return data

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "CommonVoiceCorpusMeta":
        return cls(
            data["corpus_name"],
            data.get("phoneme_sources"),
            data.get("feature_set"),
            data.get("limits"),
            dict(data.get("utterance_counts", {})),
            data.get("package_version", "unknown"),
            data.get("audio_format", "mp3"),
        )


class CommonVoiceCorpus(MultilingualCorpus):
    UTTERANCE_TYPE = "transcribed"

    CORPUS_PATH_FILE = ".corpus_path"
    META_FILE = "meta.json"
    TRANSCRIPTION_PATTERN = "{split}_transcriptions.bin"
    INVENTORY_PATTERN = "{split}_inventories.json"

    _AUDIO_DIRECTORY = "clips"

    def __init__(
        self,
        base_directory: str,
        languages: Iterable[LanguageData],
        meta_data: CommonVoiceCorpusMeta,
        resample: int | None = None,
        phoneme_sources: Sequence[str] | None = None,
        limits: Dict[str, int] | int | None = None,
        data_directory: Optional[str] = None,
    ) -> None:
        super().__init__(
            base_directory, languages, self._AUDIO_DIRECTORY, meta_data.audio_format, limits,
            resample, phoneme_sources,
        )
        meta_data.utterance_counts = {
            subset.info.code: len(subset.transcribed_samples) for subset in self
        }
        self._original_meta_data = meta_data
        self._meta_data = meta_data.to_json()
        self._data_directory = data_directory
        self._limits = limits

    def __str__(self) -> str:
        return (
            f"Mozilla Common Voice Corpus containing {len(self._languages)} languages with"
            f" {self._num_utterances} utterances"
        )

    @property
    def data_directory(self) -> Optional[str]:
        return self._data_directory

    @classmethod
    def write_corpus_path(cls, directory: str, corpus_directory: str) -> None:
        with open(path.join(directory, cls.CORPUS_PATH_FILE), "w", encoding="utf-8") as file:
            file.write(str(corpus_directory))

    @classmethod
    def get_corpus_path(cls, directory: str) -> str:
        path_file = path.join(directory, cls.CORPUS_PATH_FILE)
        if not path.isfile(path_file):
            return directory
        with open(path_file, "r", encoding="utf-8") as file:
            return file.read().strip("\r\n")

    @classmethod
    def read_meta_from(cls, directory: str) -> Dict[str, Any]:
        with open(path.join(cls.get_corpus_path(directory), cls.META_FILE), "r", encoding="utf-8") as file:
            return json.load(file)

    @classmethod
    def language_codes_from_meta(cls, directory: str) -> List[str]:
        return list(cls.read_meta_from(directory).get("locales", {}).keys())

    @classmethod
    def load_split(
        cls,
        directory: str,
        split: str,
        g2p_engine: Optional[PhonemeTranscriber] = None,
        feature_set: Optional[str] = None,
        include_single_upvote_other: bool = False,
        batch_size: int = 1,
        language_codes: Optional[Sequence[str]] = None,
        map_to_allophoible: bool = False,
        limits: Dict[str, int] | int | None = None,
        use_progress_bar: bool = False,
        mapping_threshold: int | None = None,
        attribute_table=None,
    ) -> "CommonVoiceCorpus":
        """Loads a split from raw Common Voice TSVs, optionally running G2P
        transcription and remapping inventories to Allophoible."""
        language_codes = (
            [entry for entry in os.listdir(directory) if path.isdir(path.join(directory, entry))]
            if language_codes is None
            else language_codes
        )

        inventory_indexer = (
            PhoneticAttributeIndexer(
                "phoible",
                attribute_table,
                language_inventories=language_codes,
                allophones_from_allophoible=True,
            )
            if map_to_allophoible
            else None
        )

        if g2p_engine is not None:
            for language in language_codes:
                if not g2p_engine.supports(language):
                    raise ValueError(f"Language {language!r} not supported by all G2P engines")
                if not g2p_engine.supports_tokenization(language):
                    raise ValueError(f"No available tokenizer model for {language!r}")

        if use_progress_bar:
            SEGMENTATION_LOGGER.reset()

        phoneme_sources = None if g2p_engine is None else g2p_engine.phoneme_sources
        return cls(
            directory,
            _load_common_voice_splits(
                directory,
                language_codes,
                [split, _OTHER_SPLIT] if include_single_upvote_other else [split],
                g2p_engine,
                batch_size,
                inventory_indexer,
                limits,
                use_progress_bar,
                mapping_threshold,
            ),
            CommonVoiceCorpusMeta(
                path.basename(path.normpath(directory)),
                None if phoneme_sources is None else [source.value for source in phoneme_sources],
                feature_set,
                limits,
            ),
            phoneme_sources=None
            if phoneme_sources is None
            else [source.value for source in phoneme_sources],
        )

    def transcriptions_to_json(self) -> Dict[str, Any]:
        transcriptions = {}
        inventory_mappings = {}
        for language in self.languages:
            subset = self.monolingual_subset(language)
            transcriptions[language] = subset.transcribed_samples
            inventory_mappings[language] = subset.info.phoneme_mappings
        return {
            "meta": self._original_meta_data.to_json(),
            "inventory_mappings": inventory_mappings,
            "transcriptions": transcriptions,
        }

    def save(self, corpus_directory: str, split: str, output_directory: Optional[str] = None) -> None:
        if output_directory is None:
            output_directory = corpus_directory
        else:
            os.makedirs(output_directory, exist_ok=True)
            self.write_corpus_path(output_directory, corpus_directory)

        with open(path.join(output_directory, self.TRANSCRIPTION_PATTERN.format(split=split)), "wb") as file:
            file.write(msgpack_codec.packb(self.transcriptions_to_json(), default=transcription_ext_encoder))
        with open(
            path.join(output_directory, self.INVENTORY_PATTERN.format(split=split)), "w", encoding="utf-8"
        ) as file:
            json.dump(
                {language: self.monolingual_subset(language).info.phoneme_inventory for language in self.languages},
                file,
            )

    @classmethod
    def load(
        cls,
        transcriptions: Dict[str, Any],
        inventories: Dict[str, List[str]],
        data_directory: str,
        base_directory: str,
        resample: Optional[int] = None,
        languages: Optional[Sequence[str]] = None,
        limits: Dict[str, int] | int | None = None,
        only_primary_script: bool = False,
    ) -> "CommonVoiceCorpus":
        meta = CommonVoiceCorpusMeta.from_json(transcriptions["meta"])
        transcribed_utterances = transcriptions["transcriptions"]
        inventory_mappings = transcriptions["inventory_mappings"]

        if languages is None:
            allowed_languages = None
        else:
            allowed_languages = set(languages)
            missing = allowed_languages - transcribed_utterances.keys()
            if missing:
                raise KeyError(f"Languages are missing from the locally stored Common Voice dataset: {missing}")

        return cls(
            base_directory,
            (
                LanguageData(
                    LanguageInfo(language, inventories[language], inventory_mappings[language]),
                    (
                        [
                            transcription
                            for transcription in utterances
                            if transcription.phonemes.only_primary_script()
                        ]
                        if only_primary_script
                        else utterances
                    ),
                )
                for language, utterances in transcribed_utterances.items()
                if allowed_languages is None or language in allowed_languages
            ),
            CommonVoiceCorpusMeta(
                meta.corpus_name,
                meta.phoneme_sources,
                meta.feature_set,
                (limits or meta.limits),
                meta.utterance_counts,
                meta.package_version,
                meta.audio_format,
            ),
            resample,
            meta.phoneme_sources,
            limits,
            data_directory,
        )

    @classmethod
    def from_file(
        cls,
        data_directory: str,
        split: str,
        resample: Optional[int] = None,
        languages: Optional[Sequence[str]] = None,
        corpus_directory: Optional[str] = None,
        limits: Dict[str, int] | int | None = None,
        only_primary_script: bool = False,
        progress_bar: bool = False,
    ) -> "CommonVoiceCorpus":
        if corpus_directory is None:
            corpus_directory = cls.get_corpus_path(data_directory)
        with open(path.join(data_directory, cls.TRANSCRIPTION_PATTERN.format(split=split)), "rb") as file:
            transcriptions = msgpack_codec.unpackb(file.read(), ext_hook=transcription_ext_decoder)
        with open(
            path.join(data_directory, cls.INVENTORY_PATTERN.format(split=split)), "r", encoding="utf-8"
        ) as file:
            inventories = json.load(file)
        return cls.load(
            transcriptions,
            inventories,
            data_directory,
            corpus_directory,
            resample,
            languages,
            limits,
            only_primary_script,
        )

    def load_inventories_for(self, split: str) -> Dict[str, List[str]]:
        with open(
            path.join(self._data_directory or self._base_directory, self.INVENTORY_PATTERN.format(split=split)),
            "r",
            encoding="utf-8",
        ) as file:
            return json.load(file)


@dataclass
class CommonVoiceSplits(MultilingualSplits):
    def save(self, corpus_directory: str, output_directory: Optional[str] = None) -> None:
        if output_directory is None:
            output_directory = corpus_directory
        else:
            os.makedirs(output_directory, exist_ok=True)
            CommonVoiceCorpus.write_corpus_path(output_directory, corpus_directory)
        for split in self.SPLIT_NAMES:
            getattr(self, split).save(output_directory, split)

    @classmethod
    def from_file(
        cls,
        directory: str,
        resample: Optional[int] = None,
        languages: Optional[Sequence[str]] = None,
        corpus_directory: Optional[str] = None,
        validation_limits: Dict[str, int] | int | None = None,
        only_primary_script: bool = False,
        progress_bar: bool = False,
    ) -> "CommonVoiceSplits":
        if corpus_directory is None:
            corpus_directory = CommonVoiceCorpus.get_corpus_path(directory)
        train, dev, test = cls.SPLIT_NAMES
        return cls(
            CommonVoiceCorpus.from_file(
                directory, train, resample, languages, corpus_directory,
                only_primary_script=only_primary_script, progress_bar=progress_bar,
            ),
            CommonVoiceCorpus.from_file(
                directory, dev, resample, languages, corpus_directory,
                validation_limits, only_primary_script, progress_bar,
            ),
            CommonVoiceCorpus.from_file(
                directory, test, resample, languages, corpus_directory,
                only_primary_script=only_primary_script, progress_bar=progress_bar,
            ),
        )


_OTHER_SPLIT = "other"


@dataclass
class _CommonVoiceEntry:
    client_id: str
    path: str
    sentence: str
    up_votes: int
    down_votes: int
    age: Optional[str]
    gender: Optional[str]
    accents: Optional[str]
    locale: str
    segment: Optional[str]

    @classmethod
    def schema(cls) -> CsvSchema:
        return csv_validator.make_schema(_CommonVoiceEntry)


def _extract_entries(
    language_path: str,
    splits: Sequence[str],
    split_filters: Sequence[Callable[[_CommonVoiceEntry], bool]],
    schema: CsvSchema,
    limit: Optional[int] = None,
) -> Iterator[_CommonVoiceEntry]:
    produced = 0
    for split, split_filter in zip(splits, split_filters):
        with open(path.join(language_path, split + ".tsv"), "r", encoding="utf-8") as file:
            tsv_file = csv.reader(file, delimiter="\t", quoting=csv.QUOTE_NONE)
            next(tsv_file, None)  # header
            for line_number, line in enumerate(tsv_file):
                if limit is not None and produced >= limit:
                    return
                try:
                    entry = schema.convert_line(line)
                except csv.Error as error:
                    raise csv.Error(f"In line {line_number}: {line}") from error
                if not split_filter(entry):
                    continue
                produced += 1
                yield entry


def _vote_validated(entry: _CommonVoiceEntry) -> bool:
    """Filter for the unvalidated "other" split: keep rows whose net community
    vote ends up positive, matching the reference's validation rule."""
    return entry.up_votes - entry.down_votes > 1


def _utterance_fields(entry: _CommonVoiceEntry) -> Tuple[str, str, str, str, str, str]:
    """Shared leading fields of Raw/Transcription records: the audio id is the
    clip filename without its extension."""
    return (
        entry.sentence,
        path.splitext(entry.path)[0],
        entry.client_id,
        entry.age,
        entry.gender,
        entry.accents,
    )


def _transcribe_language(
    extractor, entries: Iterator[_CommonVoiceEntry], batch_size: int
) -> Tuple[List[Transcription], List[Set[str]]]:
    """Runs the (possibly multi-engine) G2P extractor over all entries and
    accumulates each engine's observed phoneme inventory alongside the records."""
    records: List[Transcription] = []
    inventories: List[Set[str]] = []
    for batch, per_entry_transcriptions in extractor.auto_batch_g2p_transcribe(entries, batch_size):
        for entry, transcriptions in zip(batch, per_entry_transcriptions):
            primary = transcriptions.flattened_primary_transcriptions()
            for engine_index, engine_phonemes in enumerate(primary):
                if engine_index == len(inventories):
                    inventories.append(set())
                inventories[engine_index].update(engine_phonemes)
            records.append(Transcription(*_utterance_fields(entry), transcriptions))
    return records, inventories


def _remap_tagged_segments(
    mapping: Dict[str, List[str]], segments: List[TaggedTranscription]
) -> List[TaggedTranscription]:
    """Rewrites primary-script (untagged) segments through the phoneme mapping;
    segments carrying an embedded foreign-language tag pass through unchanged."""
    rewritten = []
    for segment in segments:
        if segment.language is not None:
            rewritten.append(segment)
            continue
        expanded: List[str] = []
        for phoneme in segment.transcription:
            expanded.extend(mapping[phoneme])
        rewritten.append(TaggedTranscription(expanded, segment.language))
    return rewritten


def _remap_to_indexer_inventory(
    records: List[Transcription],
    engine_inventories: List[List[str]],
    inventory_indexer: PhoneticAttributeIndexer,
    language: str,
    mapping_threshold: int | None,
) -> Tuple[List[str], List[Dict[str, List[str]]]]:
    """Maps each engine's observed inventory onto the indexer's phoneme set and
    rewrites every stored transcription in place through its engine's mapping.
    Returns the post-mapping inventory union and the per-engine mappings."""
    mappings = inventory_indexer.map_language_inventory(
        engine_inventories, language, distance_threshold=mapping_threshold
    )

    reachable: Set[str] = set()
    for mapping, inventory in zip(mappings, engine_inventories):
        for phoneme in inventory:
            reachable.update(mapping[phoneme])

    for record in records:
        record.phonemes.phonemes = [
            _remap_tagged_segments(mapping, engine_segments)
            for mapping, engine_segments in zip(mappings, record.phonemes.phonemes)
        ]
    return sorted(reachable), mappings


def _load_common_voice_splits(
    directory: str,
    languages: Sequence[str],
    splits: Sequence[str],
    g2p_engine: Optional[PhonemeTranscriber] = None,
    batch_size: int = 1,
    inventory_indexer: Optional[PhoneticAttributeIndexer] = None,
    limits: Optional[Union[int, Dict[str, int]]] = None,
    use_progress_bar: bool = False,
    mapping_threshold: int | None = None,
) -> Iterator[LanguageData]:
    """Streams one :class:`LanguageData` per language: TSV rows filtered per split,
    optionally G2P-transcribed, optionally remapped onto the indexer's inventory.
    Semantics follow reference mozilla_common_voice.py:666-781; the structure here
    is decomposed into the helpers above."""
    schema = _CommonVoiceEntry.schema()
    split_filters = [
        _vote_validated if split == _OTHER_SPLIT else (lambda _: True) for split in splits
    ]
    progress = _language_progress(languages) if use_progress_bar else languages

    for language in progress:
        SEGMENTATION_LOGGER.context_language(language)
        limit = limits if limits is None or isinstance(limits, int) else limits.get(language)
        entries = _extract_entries(path.join(directory, language), splits, split_filters, schema, limit)

        if g2p_engine is None:
            records: List[Any] = [RawTranscription(*_utterance_fields(entry)) for entry in entries]
            engine_inventories: List[List[str]] = []
        else:
            records, observed = _transcribe_language(g2p_engine.extractor(language), entries, batch_size)
            # Engines that produced nothing still need an (empty) inventory slot.
            observed.extend(set() for _ in range(g2p_engine.num_engines - len(observed)))
            engine_inventories = [sorted(inventory) for inventory in observed]

        if inventory_indexer is None:
            inventory = sorted(
                phoneme for engine_inventory in engine_inventories for phoneme in engine_inventory
            )
            mappings: List[Dict[str, List[str]]] = []
        else:
            inventory, mappings = _remap_to_indexer_inventory(
                records, engine_inventories, inventory_indexer, language, mapping_threshold
            )

        yield LanguageData(LanguageInfo(language, inventory, mappings), records)


def _language_progress(languages: Sequence[str]) -> Iterable[str]:
    """Wraps the language loop in a tqdm bar when available."""
    try:
        from tqdm import tqdm
    except ImportError:
        return languages
    return tqdm(languages, position=0, unit=" languages")


def load_common_voice(
    directory: str,
    g2p_engine: Optional[PhonemeTranscriber] = None,
    feature_set: Optional[str] = None,
    include_single_upvote_other: bool = False,
    batch_size: int = 1,
    languages: Optional[Sequence[str]] = None,
    map_to_allophoible: bool = False,
    training_limits: Optional[Union[int, Dict[str, int]]] = None,
    use_progress_bar: bool = False,
    mapping_threshold: int | None = None,
    attribute_table=None,
) -> CommonVoiceSplits:
    """Loads train/dev/test with transcription; test phonemes are never remapped for
    freedom at evaluation time (reference mozilla_common_voice.py:814-867)."""
    train_split = CommonVoiceCorpus.load_split(
        directory, "train", g2p_engine, feature_set, include_single_upvote_other, batch_size,
        languages, map_to_allophoible, training_limits, use_progress_bar, mapping_threshold,
        attribute_table,
    )
    return CommonVoiceSplits(
        train_split,
        CommonVoiceCorpus.load_split(
            directory, "dev", g2p_engine, feature_set, batch_size=batch_size,
            language_codes=train_split.languages, map_to_allophoible=map_to_allophoible,
            use_progress_bar=use_progress_bar, mapping_threshold=mapping_threshold,
            attribute_table=attribute_table,
        ),
        CommonVoiceCorpus.load_split(
            directory, "test", g2p_engine, feature_set, batch_size=batch_size,
            language_codes=train_split.languages, map_to_allophoible=False,
            use_progress_bar=use_progress_bar, attribute_table=attribute_table,
        ),
    )
