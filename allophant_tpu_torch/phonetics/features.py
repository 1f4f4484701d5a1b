"""Phonetic feature tables, attribute indexing and inventory mapping (the
port's copy of ``allophant_tpu/phonetics/features.py``, on the standard
library and numpy instead of pandas).

The JAX package keeps its tables in pandas frames; here a ``Frame`` holds rows
of named columns with row labels, and the handful of pandas operations the
module uses are written out with pandas' semantics, since they set every
integer order the model sees (phoneme order, class indices, inventories):

- ``read_csv(dtype=str)`` turns an empty cell (and pandas' other default NA
  strings) into a missing value (``None`` here, NaN there), and a missing
  feature cell splits as the string "nan";
- ``groupby`` sorts its keys, missing values last, and ``dropna=False`` keeps
  their groups; ``idxmax`` takes the first maximum;
- ``unique`` and ``drop_duplicates`` keep the first appearance;
- ``nunique`` ignores missing values;
- ``isin`` over (Source, ISO6393, SpecificDialect) keys matches a missing
  value with a missing value;
- ``to_csv`` writes through the csv module with "\\n" line ends, missing
  values empty.

Key semantic invariants preserved from the reference (they determine
checkpoint compatibility and PER/AER):

- Per-feature categorical vocabularies are the *sorted unique* contour values of each
  column, binarized to integer ids (reference ``_binarize_contours``, :549-555).
- Contour cells ("+,-") become tuples of ids; dense tables take the first element.
- ``subset`` reindexes the "phoneme" feature to subset positions (reference :253-256).
- Hamming distances are computed over dense feature vectors (reference cdist p=0).
- Allophone inventory extraction picks the largest (or preferred-dialect) inventory per
  language, resolves macro-language codes, and assigns ``InventoryID == 0`` to extra
  feature-only rows (reference :1067-1189).
"""

from __future__ import annotations

import csv
import io
import itertools
import json
import logging
import re
import unicodedata
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from allophant_tpu_torch.phonemes import IpaSegmenter, MissingSegmentError
from allophant_tpu_torch.phonetics import segmentation
from allophant_tpu_torch.phonetics.language_codes import LanguageCode, standardize_to_iso6393
from allophant_tpu_torch.phonetics.segmentation import IpaSentenceSegmenter

# IPA tie character
TIE = "͡"

PHONEME_FEATURE = "phoneme"
PHONE_FEATURE = "phone"

# The strings pandas' read_csv reads as missing by default (``na_values``).
_NA_STRINGS = frozenset(
    {
        "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
        "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
    }
)


def _as_text(value) -> str:
    """``str(value)`` with pandas' NaN for a missing cell: "nan"."""
    return "nan" if value is None else str(value)


def _missing_last(value) -> Tuple[bool, Any]:
    """Sort key of a group key: pandas sorts missing keys after every value."""
    return (value is None, "" if value is None else value)


class PhonemeIndex(tuple):
    """Row labels of a phoneme table: a tuple with pandas' ``Index`` lookups
    (``get_loc``, ``get_indexer``, ``tolist``) and a constant-time ``in``."""

    def __new__(cls, labels: Iterable = ()):
        index = super().__new__(cls, labels)
        positions: Dict[Any, int] = {}
        for position, label in enumerate(index):
            positions.setdefault(label, position)
        index._positions = positions
        index._unique = len(positions) == len(index)
        return index

    def __contains__(self, label) -> bool:
        return label in self._positions

    def get_loc(self, label) -> int:
        if label not in self._positions:
            raise KeyError(label)
        return self._positions[label]

    def get_indexer(self, labels: Sequence) -> np.ndarray:
        if not self._unique:
            raise ValueError("Reindexing only valid with uniquely valued Index objects")
        return np.array([self._positions.get(label, -1) for label in labels], dtype=np.int64)

    def unique(self) -> List:
        return list(self._positions)

    def tolist(self) -> List:
        return list(self)

    to_list = tolist


class Frame:
    """Rows of named columns with row labels, a missing cell being ``None``:
    what this module needs of a pandas DataFrame."""

    def __init__(self, columns: Sequence[str], rows: List[list], index: Optional[Sequence] = None):
        self.columns = list(columns)
        self.rows = rows
        self.index = PhonemeIndex(range(len(rows)) if index is None else index)
        self._positions = {name: position for position, name in enumerate(self.columns)}

    def __len__(self) -> int:
        return len(self.rows)

    def position(self, name: str) -> int:
        return self._positions[name]

    def column(self, name: str) -> List:
        position = self._positions[name]
        return [row[position] for row in self.rows]

    def take(self, positions: Iterable[int]) -> "Frame":
        """The rows at ``positions``, in that order (pandas' ``iloc``)."""
        positions = list(positions)
        return Frame(self.columns, [list(self.rows[i]) for i in positions], [self.index[i] for i in positions])

    def where(self, name: str, predicate: Callable[[Any], bool]) -> "Frame":
        """The rows whose ``name`` cell satisfies ``predicate``, in order."""
        position = self._positions[name]
        return self.take(i for i, row in enumerate(self.rows) if predicate(row[position]))

    def first_of_each(self, name: str) -> "Frame":
        """``drop_duplicates(name)``: the first row of each ``name`` value."""
        seen: Set = set()
        position = self._positions[name]
        keep = []
        for i, row in enumerate(self.rows):
            if row[position] not in seen:
                seen.add(row[position])
                keep.append(i)
        return self.take(keep)

    def first_of_each_label(self) -> "Frame":
        """``loc[~index.duplicated(keep="first")]``."""
        seen: Set = set()
        keep = []
        for i, label in enumerate(self.index):
            if label not in seen:
                seen.add(label)
                keep.append(i)
        return self.take(keep)

    def select_columns(self, names: Sequence[str]) -> "Frame":
        positions = [self._positions[name] for name in names]
        return Frame(names, [[row[p] for p in positions] for row in self.rows], self.index)

    def columns_from(self, name: str) -> List[str]:
        return self.columns[self._positions[name] :]

    def set_column(self, name: str, values: Sequence) -> None:
        """Replaces (or appends) a column."""
        values = list(values)
        if name in self._positions:
            position = self._positions[name]
            for row, value in zip(self.rows, values):
                row[position] = value
        else:
            self.columns.append(name)
            self._positions[name] = len(self.columns) - 1
            for row, value in zip(self.rows, values):
                row.append(value)

    def set_index(self, name: str) -> "Frame":
        position = self._positions[name]
        columns = [column for column in self.columns if column != name]
        rows = [row[:position] + row[position + 1 :] for row in self.rows]
        return Frame(columns, rows, [row[position] for row in self.rows])

    def reset_index(self, name: str) -> "Frame":
        return Frame([name, *self.columns], [[label, *row] for label, row in zip(self.index, self.rows)])

    def to_csv(self, index_label: Optional[str] = None) -> str:
        """pandas' ``to_csv`` text (``index=index_label is not None``)."""
        buffer = io.StringIO()
        writer = csv.writer(buffer, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        with_index = index_label is not None
        writer.writerow(([index_label] if with_index else []) + self.columns)
        for label, row in zip(self.index, self.rows):
            cells = [label, *row] if with_index else row
            writer.writerow(["" if cell is None else cell for cell in cells])
        return buffer.getvalue()

    @classmethod
    def concat(cls, frames: Sequence["Frame"]) -> "Frame":
        columns = frames[0].columns
        for frame in frames[1:]:
            if frame.columns != columns:
                raise ValueError("Frames to concatenate need the same columns")
        return cls(
            columns,
            [list(row) for frame in frames for row in frame.rows],
            [label for frame in frames for label in frame.index],
        )


def _read_csv(file) -> Frame:
    """pandas' ``read_csv(file, dtype=str)``: every cell a string, the NA
    strings and empty cells ``None``, blank lines skipped."""
    if isinstance(file, str) and "\n" in file:
        text = file
    elif hasattr(file, "read"):
        text = file.read()
    else:
        with open(file, encoding="utf-8", newline="") as handle:
            text = handle.read()
    if text.startswith("\ufeff"):
        text = text[1:]
    rows = [row for row in csv.reader(io.StringIO(text, newline="")) if row]
    header, body = rows[0], rows[1:]
    width = len(header)
    cells = [[None if cell in _NA_STRINGS else cell for cell in row[:width]] + [None] * (width - len(row)) for row in body]
    return Frame(header, cells)


@dataclass
class LanguageAllophoneMappings:
    """{language_id -> {phoneme index -> [shared-phone indices]}} consumed by the
    allophone layer (reference phonetic_features.py:40-82)."""

    allophones: Dict[int, Dict[int, List[int]]]
    languages: List[str]
    shared_phones: List[str]

    def iso6393_inventories(self, shared_phoneme_inventory: Sequence[str]) -> Dict[str, List[str]]:
        return {
            LanguageCode.from_str(language).alpha3: [
                shared_phoneme_inventory[phoneme_index]
                for phoneme_index in self.allophones[language_id].keys()
            ]
            for language_id, language in enumerate(self.languages)
        }

    @classmethod
    def from_allophone_data(cls, attribute_indexer: "PhoneticAttributeIndexer", languages: List[str]):
        allophone_data = attribute_indexer.allophone_data
        if allophone_data is None:
            raise ValueError("No allophone data is available in the indexer")

        inventories = allophone_data.inventories
        shared_phone_indexer = allophone_data.shared_phone_indexer
        standardized_codes = [LanguageCode.from_str(code).alpha3 for code in languages]
        allophones = {}

        for language_id, language in enumerate(standardized_codes):
            language_rows = inventories.where("ISO6393", lambda code: code == language)
            allophone_inventory = {
                phoneme: _as_text(allophone_string).split(" ")
                for phoneme, allophone_string in zip(language_rows.index, language_rows.column("Allophones"))
            }
            allophones[language_id] = {
                attribute_indexer.phoneme_index(phoneme): [
                    int(i) for i in shared_phone_indexer.phoneme_indices(allophone_list)
                ]
                for phoneme, allophone_list in allophone_inventory.items()
            }

        return cls(allophones, languages, shared_phone_indexer.phonemes.tolist())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "allophones": {
                str(language_id): {str(k): v for k, v in mapping.items()}
                for language_id, mapping in self.allophones.items()
            },
            "languages": self.languages,
            "shared_phones": self.shared_phones,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "LanguageAllophoneMappings":
        return cls(
            {
                int(language_id): {int(k): list(map(int, v)) for k, v in mapping.items()}
                for language_id, mapping in data["allophones"].items()
            },
            list(data["languages"]),
            list(data["shared_phones"]),
        )


@dataclass
class LanguageInventories:
    """Per-language phoneme inventory lists with an identity allophone fallback."""

    inventories: Dict[int, List[str]]
    languages: List[str]

    def shared_inventory(self) -> List[str]:
        # Sorted for reproducibility
        return sorted(set(itertools.chain.from_iterable(self.inventories.values())))

    def iso6393_inventories(self) -> Dict[str, List[str]]:
        return {
            LanguageCode.from_str(language).alpha3: self.inventories[language_id]
            for language_id, language in enumerate(self.languages)
        }

    def map_allophones(self, attribute_indexer: "PhonemeIndexer") -> LanguageAllophoneMappings:
        return LanguageAllophoneMappings(
            {
                language_id: {
                    int(phoneme): [int(phoneme)]
                    for phoneme in attribute_indexer.phoneme_indices(inventory)
                }
                for language_id, inventory in self.inventories.items()
            },
            self.languages,
            attribute_indexer.phonemes.tolist(),
        )


@dataclass
class PhoneticIndexerState:
    """Serializable indexer state embedded in checkpoints: phoneme inventory, optional
    allophone mappings and the full feature CSV text for reproducibility."""

    phoneme_inventory: List[str]
    language_allophones: Optional[LanguageAllophoneMappings] = None
    table_file: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "phoneme_inventory": self.phoneme_inventory,
            "language_allophones": None
            if self.language_allophones is None
            else self.language_allophones.to_dict(),
            "table_file": self.table_file,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PhoneticIndexerState":
        allophones = data.get("language_allophones")
        return cls(
            list(data["phoneme_inventory"]),
            None if allophones is None else LanguageAllophoneMappings.from_dict(allophones),
            data.get("table_file"),
        )


class PhonemeIndexer:
    """Base feature-table view: phoneme <-> index and per-feature category lookups."""

    _phonemes: PhonemeIndex
    _feature_table: np.ndarray
    _feature_columns: List[str]
    _feature_names: List[str]
    _feature_categories: Dict[str, List[str]]

    @property
    def feature_table(self) -> np.ndarray:
        return self._feature_table

    @property
    def phonemes(self) -> PhonemeIndex:
        return self._phonemes

    @property
    def feature_columns(self) -> List[str]:
        return self._feature_columns

    def phoneme_indices(self, phonemes: Sequence[str]) -> np.ndarray:
        indices = self._phonemes.get_indexer(list(phonemes))
        if -1 in indices:
            missing = [phonemes[index] for index in np.where(indices == -1)[0]]
            raise ValueError(f"Missing phonemes: {missing}")
        return indices.astype(np.int64)

    def phoneme_indices_with_missing(self, phonemes: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
        indices = self._phonemes.get_indexer(list(phonemes)).astype(np.int64)
        return indices, [phonemes[int(index)] for index in np.where(indices == -1)[0]]

    def phoneme_index(self, phoneme: str) -> int:
        return int(self._phonemes.get_loc(phoneme))

    def phoneme(self, index):
        """The phoneme at ``index``, or the list of them at an array of indices
        (as indexing the JAX package's pandas ``Index`` gives)."""
        if np.ndim(index) == 0:
            return self._phonemes[int(index)]
        return [self._phonemes[position] for position in np.asarray(index).ravel().tolist()]

    def state(self) -> PhoneticIndexerState:
        return PhoneticIndexerState(self.phonemes.tolist())

    def segmenter(self) -> IpaSentenceSegmenter:
        return IpaSentenceSegmenter(self.phonemes.to_list())

    def __getitem__(self, indices) -> List[np.ndarray]:
        """Per-feature concatenated contour ids for a sequence of phoneme indices."""
        indices = np.asarray(indices)
        columns = self._feature_table[indices].T
        if columns.shape[1] == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(len(columns))]
        return [np.concatenate([np.asarray(cell, dtype=np.int64) for cell in column]) for column in columns]

    def get_named(self, index_or_name, attribute_index_offset: int = 0) -> Dict[str, np.ndarray]:
        """Per-feature concatenated contour ids, keyed by feature name, with an
        optional offset (e.g. the CTC blank offset for label generation)."""
        if isinstance(index_or_name, list):
            indices = self.phoneme_indices(index_or_name)
        elif isinstance(index_or_name, str):
            indices = np.array([self.phoneme_index(index_or_name)])
        else:
            indices = np.asarray(index_or_name)

        matrix = self._feature_table[indices].T
        if matrix.shape[1] == 0:
            return {name: np.empty(0, dtype=np.int64) for name in self._feature_columns}
        return {
            name: np.concatenate([np.asarray(cell, dtype=np.int64) for cell in column])
            + attribute_index_offset
            for name, column in zip(self._feature_columns, matrix)
        }

    def feature_categories(self, feature: str) -> List[str]:
        return self._feature_categories[feature]

    def feature_category_index(self, name: str) -> int:
        return self._feature_columns.index(name)

    def feature_values(self, name: str, feature_indices) -> List[str]:
        categories = self._feature_categories[name]
        return [categories[int(index)] for index in feature_indices]

    @property
    def feature_names(self) -> List[str]:
        return self._feature_names

    def __len__(self) -> int:
        return self._feature_table.shape[0]


PhonemeMapping = Dict[str, List[str]]


@dataclass
class LabeledMatrix:
    """A distance matrix with its row and column labels (the JAX package's
    DataFrame)."""

    values: np.ndarray
    index: List[str]
    columns: List[str]


@dataclass
class DistanceMatrices:
    main: LabeledMatrix
    splits: Dict[str, LabeledMatrix]


def _chunked_hamming(left: np.ndarray, right: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Pairwise hamming distance between int matrices [K,F] x [P,F] -> [K,P],
    chunked to bound peak memory."""
    result = np.empty((left.shape[0], right.shape[0]), dtype=np.float32)
    for start in range(0, left.shape[0], chunk):
        block = left[start : start + chunk]
        result[start : start + chunk] = (block[:, None, :] != right[None, :, :]).sum(-1)
    return result


def _object_table(rows: List[list], width: int) -> np.ndarray:
    """An object array [rows, width] of the (tuple) cells, as pandas'
    ``DataFrame.values`` gives it."""
    table = np.empty((len(rows), width), dtype=object)
    for i, row in enumerate(rows):
        for j, cell in enumerate(row):
            table[i, j] = cell
    return table


class ArticulatoryAttributes(PhonemeIndexer):
    """Immutable feature-table view with subsetting, hamming distances, closest-phone
    queries and inventory mapping (reference phonetic_features.py:246-520).
    ``phoneme_features`` holds the binarized contour tuples, one row a phoneme."""

    def __init__(
        self,
        phoneme_features: Frame,
        feature_categories: Dict[str, List[str]],
        reindex_phonemes: bool = True,
    ):
        self._phoneme_data = phoneme_features
        self._phonemes = phoneme_features.index

        if reindex_phonemes and PHONEME_FEATURE in phoneme_features.columns:
            # Reindex phonemes in subset order
            phoneme_features.set_column(PHONEME_FEATURE, [(index,) for index in range(len(phoneme_features))])
            feature_categories[PHONEME_FEATURE] = self._phonemes.tolist()

        self._feature_columns = list(phoneme_features.columns)
        self._feature_table = _object_table(phoneme_features.rows, len(self._feature_columns))
        # Keep only categories for available columns, in column order.
        self._feature_categories = {name: feature_categories[name] for name in self._feature_columns}
        self._feature_names = list(self._feature_columns)

        # First feature of every contour, for hamming distances.
        if self._feature_table.size:
            self._dense_feature_table = np.array(
                [[np.asarray(cell).flat[0] for cell in row] for row in self._feature_table],
                dtype=np.int32,
            )
        else:
            self._dense_feature_table = np.zeros(self._feature_table.shape, dtype=np.int32)

    @property
    def phoneme_data(self) -> Frame:
        return self._phoneme_data

    @property
    def dense_feature_table(self) -> np.ndarray:
        return self._dense_feature_table

    def _phoneme_subset_fallback(self, subset_phonemes: Frame, phonemes: Sequence[str]) -> Frame:
        segmenter = self.segmenter().word_segmenter
        subset_indices, missing = self.phoneme_indices_with_missing(phonemes)
        missing_mask = subset_indices == -1
        if missing:
            # Missing phonemes fall back to the features of their first subsegment.
            subset_indices[missing_mask] = self.phoneme_indices(
                [segmenter.segment_checked(phoneme)[0] for phoneme in missing]
            )
        subset_phonemes = subset_phonemes.take(subset_indices.tolist())
        if missing:
            index = list(subset_phonemes.index)
            for position, phoneme in zip(np.where(missing_mask)[0], missing):
                index[int(position)] = phoneme
            subset_phonemes.index = PhonemeIndex(index)
        return subset_phonemes

    def subset(
        self,
        phonemes: Sequence[str] | None = None,
        attribute_subset: Sequence[str] | None = None,
        reindex_phonemes: bool = True,
        missing_feature_fallback: bool = False,
    ) -> "ArticulatoryAttributes":
        subset_phonemes = self._phoneme_data.take(range(len(self._phoneme_data)))
        if phonemes is not None:
            if missing_feature_fallback:
                subset_phonemes = self._phoneme_subset_fallback(subset_phonemes, phonemes)
            else:
                subset_phonemes = subset_phonemes.take(self.phoneme_indices(phonemes).tolist())
        if attribute_subset is not None:
            subset_phonemes = subset_phonemes.select_columns(list(attribute_subset))
        return self.__class__(subset_phonemes, self._feature_categories.copy(), reindex_phonemes)

    def _hamming_distance(self, features: np.ndarray) -> np.ndarray:
        if features.size == 0:
            raise ValueError("Cannot compute hamming distance without phonetic features")
        if self._dense_feature_table.size == 0:
            raise ValueError("No features defined in the indexer")
        return _chunked_hamming(np.atleast_2d(features), self._dense_feature_table)

    def _simplified_inventory_features(self, inventory: Sequence[str], add_base_count: bool = False) -> np.ndarray:
        features = self._dense_feature_table[self.phoneme_indices(inventory)]
        if not add_base_count:
            return features
        base_counts = np.array(
            [segmentation.iterator_length(segmentation.base_phonemes(segment)) for segment in inventory],
            dtype=np.int32,
        )
        return np.concatenate((features, base_counts[:, None]), axis=1)

    def _inventory_distance_matrix(
        self, source_inventory: List[str], target_inventory: List[str], add_base_count: bool = False
    ) -> np.ndarray:
        return _chunked_hamming(
            self._simplified_inventory_features(source_inventory, add_base_count),
            self._simplified_inventory_features(target_inventory, add_base_count),
        )

    def map_inventories_closest(
        self,
        source_inventory: Sequence[str],
        target_inventory: Sequence[str],
        split_non_matching_complex: bool = False,
        return_distance_matrices: bool = False,
        distance_threshold: int | None = None,
    ):
        """Maps source phonemes to the closest target phonemes by feature hamming
        distance (reference phonetic_features.py:355-445 provides the semantics).

        Resolution happens in three stages: exact string matches are pinned to
        themselves up front (distinct phonemes can share a feature row, so feature
        search could reassign them arbitrarily); the remainder are matched against
        one batched distance matrix; and — when ``split_non_matching_complex`` is
        set — complex segments whose nearest target has a different base-segment
        count are deferred, split into subsegments, and matched through a second
        distance matrix computed once over *all* deferred subsegments. Any match at
        or above ``distance_threshold`` falls back to the identity mapping.
        """
        targets = list(target_inventory)
        target_set = set(targets)

        mapping: PhonemeMapping = {}
        unmatched: List[str] = []
        for phoneme in source_inventory:
            if phoneme in target_set:
                mapping[phoneme] = [phoneme]
            else:
                unmatched.append(phoneme)

        pairwise = self._inventory_distance_matrix(unmatched, targets, add_base_count=True)

        def nearest(row: np.ndarray) -> Tuple[str, int]:
            column = int(row.argmin())
            return targets[column], int(row[column])

        def thresholded(candidate: str, distance: int, identity: str) -> str:
            if distance_threshold is not None and distance >= distance_threshold:
                return identity
            return candidate

        # Stage 1: direct assignment, deferring complex segments whose best
        # candidate disagrees on base-segment count.
        deferred: List[Tuple[str, List[str]]] = []
        for row, phoneme in enumerate(unmatched):
            candidate, distance = nearest(pairwise[row])
            if split_non_matching_complex:
                source_bases = segmentation.iterator_length(segmentation.base_phonemes(phoneme))
                candidate_bases = segmentation.iterator_length(segmentation.base_phonemes(candidate))
                if source_bases != candidate_bases:
                    deferred.append((phoneme, segmentation.split_complex_segment(phoneme)))
                    continue
            mapping[phoneme] = [thresholded(candidate, distance, phoneme)]

        # Stage 2: one distance computation over every deferred subsegment,
        # sliced back into per-phoneme blocks.
        split_frames: Dict[str, LabeledMatrix] = {}
        if deferred:
            flat_subsegments = [subsegment for _, subsegments in deferred for subsegment in subsegments]
            subsegment_matrix = self._inventory_distance_matrix(flat_subsegments, targets, add_base_count=True)
            offset = 0
            for phoneme, subsegments in deferred:
                block = subsegment_matrix[offset : offset + len(subsegments)]
                offset += len(subsegments)
                if return_distance_matrices:
                    split_frames[phoneme] = LabeledMatrix(block, list(subsegments), targets)
                mapping[phoneme] = [
                    thresholded(*nearest(block[index]), identity=subsegment)
                    for index, subsegment in enumerate(subsegments)
                ]

        covered = {assigned for group in mapping.values() for assigned in group}
        never_selected = target_set - covered
        if never_selected:
            logging.warning(f"{len(never_selected)} unmapped from target: {never_selected}")

        if return_distance_matrices:
            return mapping, DistanceMatrices(LabeledMatrix(pairwise, unmatched, targets), split_frames)
        return mapping

    def closest_phone(self, features: np.ndarray) -> int:
        return int(self._hamming_distance(np.atleast_2d(features)).argmin())

    def closest_phone_for(self, phone: str, features: np.ndarray) -> int:
        if phone in self.phonemes:
            return self.phoneme_index(phone)
        return self.closest_phone(features)

    def feature_vector(self, phone: str | int) -> np.ndarray:
        if isinstance(phone, str):
            phone = self.phoneme_index(phone)
        return self._feature_table[phone]

    def simplified_feature_vector(self, phone: str | int) -> np.ndarray:
        if isinstance(phone, str):
            phone = self.phoneme_index(phone)
        return self._dense_feature_table[phone]

    def k_nearest_phones(self, phone_or_features, k: int) -> np.ndarray:
        if isinstance(phone_or_features, (str, int)):
            phone_or_features = self.simplified_feature_vector(phone_or_features)
        distances = self._hamming_distance(np.atleast_2d(phone_or_features))[0]
        order = np.argsort(distances, kind="stable")[:k]
        # Distances in the first row, indices in the second.
        return np.stack((distances[order], order.astype(np.float32)))

    def missing_inventory_mappings(
        self, shared_inventory: Sequence[str], segment_missing: bool = False
    ) -> Dict[str, str]:
        """Maps phonemes missing purely due to unicode normalization (NFC) and,
        optionally, unknown clusters to their first known subsegment."""
        segmenter = self.segmenter().word_segmenter
        mapping: Dict[str, str] = {}
        for phoneme in shared_inventory:
            if phoneme not in self.phonemes:
                combined = unicodedata.normalize("NFC", phoneme)
                if combined in self.phonemes:
                    mapping[phoneme] = combined
                    continue
                if not segment_missing:
                    raise ValueError(f"No suitable mapping found for segment {phoneme!r}")
                try:
                    mapping[phoneme] = segmenter.segment_checked(phoneme)[0]
                except MissingSegmentError as error:
                    raise ValueError(f"No suitable mapping found for segment {phoneme!r}") from error
        return mapping


@dataclass
class AllophoneData:
    inventories: Frame
    shared_phone_indexer: ArticulatoryAttributes


def _binarize_contours(
    data: Frame, feature_start_column: str, vocabularies: Dict[str, Dict[str, int]] | None = None
) -> Dict[str, Dict[str, int]]:
    """Splits contour strings ("+,-") into tuples and binarizes each feature column
    against its (sorted unique) category vocabulary, in place. Returns the
    vocabularies used (computed if not provided)."""
    feature_names = data.columns_from(feature_start_column)
    contours = {name: [_as_text(value).split(",") for value in data.column(name)] for name in feature_names}

    if vocabularies is None:
        vocabularies = {
            name: {value: index for index, value in enumerate(sorted(set(itertools.chain.from_iterable(rows))))}
            for name, rows in contours.items()
        }

    for name in feature_names:
        vocabulary = vocabularies[name]
        data.set_column(name, [tuple(vocabulary[element] for element in row) for row in contours[name]])
    return vocabularies


class FeatureSet:
    PHOIBLE = "phoible"
    PANPHON = "panphon"


LanguageInventoryTypes = LanguageInventories | LanguageAllophoneMappings | Sequence[str] | None


def generate_allophone_data(
    language_inventories: LanguageInventoryTypes,
    feature_table: Frame,
    attribute_subset: Sequence[str] | None = None,
    phoneme_subset: Sequence[str] | None = None,
) -> Tuple[Frame, Sequence[str]]:
    """The allophone inventories of the table (indexed by phoneme) and the
    training phoneme subset (given, or every phoneme of a real inventory in
    order of first appearance). ``feature_table`` is indexed by "Phoneme"."""
    if isinstance(language_inventories, LanguageInventories):
        languages = language_inventories.languages
        inventories = language_inventories.iso6393_inventories()
    elif isinstance(language_inventories, LanguageAllophoneMappings):
        languages = language_inventories.languages
        if phoneme_subset is None:
            raise ValueError(
                "allophone inventories can only be restored from LanguageAllophoneMappings"
                " if a correct phoneme_subset is provided"
            )
        inventories = language_inventories.iso6393_inventories(phoneme_subset)
    elif language_inventories is None:
        languages = None
        inventories = None
    else:
        languages = list(language_inventories)
        inventories = None

    allophone_data = extract_allophone_inventories(
        feature_table.reset_index("Phoneme"),
        languages,
        attribute_subset,
        inventories,
        prefer_default_dialects=True,
        remove_zero_phoneme=True,
    ).set_index(PHONEME_FEATURE)

    if phoneme_subset is None:
        phonemes = allophone_data.where("InventoryID", lambda inventory: inventory != 0)
        phoneme_subset = phonemes.index.unique()

    return allophone_data, phoneme_subset


class PhoneticAttributeIndexer(PhonemeIndexer):
    """Central phonetic oracle: loads the Allophoible feature CSV, binarizes feature
    categories, and exposes full / training-subset / full-phoneme-subset views plus
    allophone data and zero-shot composition matrices (reference :601-971).
    PHOIBLE and panphon feature sets."""

    def __init__(
        self,
        feature_set: str,
        attribute_table_file=None,
        attribute_subset: Sequence[str] | None = None,
        phoneme_subset: Sequence[str] | None = None,
        language_inventories: LanguageInventoryTypes = None,
        allophones_from_allophoible: bool = False,
    ):
        self._allophone_data: AllophoneData | None = None

        if feature_set == FeatureSet.PHOIBLE:
            original_feature_table = read_allophoible(attribute_table_file, index_column="Phoneme")
            self._allophone_data_frame, phoneme_subset = generate_allophone_data(
                language_inventories, original_feature_table, phoneme_subset=phoneme_subset
            )
            feature_start_column = "tone"
            index_label = "Phoneme"
            phoneme_attributes = original_feature_table.first_of_each_label().select_columns(
                ["SegmentClass", *original_feature_table.columns_from(feature_start_column)]
            )
        elif feature_set == FeatureSet.PANPHON:
            if allophones_from_allophoible:
                raise NotImplementedError("Allophone handling is not implemented for Panphon features")
            self._allophone_data_frame = None
            index_label = "ipa"
            original_feature_table = read_panphon(attribute_table_file, index_column=index_label)
            feature_start_column = "syl"
            # Drop erroneous duplicate vowels differing only in delrel; keeping the
            # first selects delrel 0 (reference :628-638; a defect of the panphon table).
            phoneme_attributes = original_feature_table.first_of_each_label().select_columns(
                original_feature_table.columns_from(feature_start_column)
            )
            # Add tie-stripped variants of multi-segment phonemes so G2P output
            # without ties still resolves.
            tied = phoneme_attributes.take(i for i, label in enumerate(phoneme_attributes.index) if TIE in label)
            tied.index = PhonemeIndex(label.replace(TIE, "") for label in tied.index)
            phoneme_attributes = Frame.concat([phoneme_attributes, tied])
            if len(phoneme_attributes.index.unique()) != len(phoneme_attributes.index):
                raise ValueError("Tie-stripped panphon segments duplicate existing ones")
        else:
            raise ValueError(f"Unsupported feature set: {feature_set}")

        self._feature_set = feature_set
        self._table_file = original_feature_table.to_csv(index_label=index_label)

        # Add phonemes as an extra (categorical) feature column.
        phoneme_attributes.set_column(PHONEME_FEATURE, list(phoneme_attributes.index))
        attribute_vocabularies = _binarize_contours(phoneme_attributes, feature_start_column)

        feature_categories = {
            name: [value for value, _ in sorted(vocabulary.items(), key=lambda item: item[1])]
            for name, vocabulary in attribute_vocabularies.items()
        }
        # Full feature set, for general phoneme hamming distance.
        self._full_attributes = ArticulatoryAttributes(
            phoneme_attributes.select_columns(phoneme_attributes.columns_from(feature_start_column)),
            feature_categories,
        )
        # Classifier subset (training inventory x classifier features).
        self._subset_attributes = self._full_attributes.subset(phoneme_subset, attribute_subset)
        # Classifier features but all phonemes (for evaluation-label generation).
        if attribute_subset is None or PHONEME_FEATURE in attribute_subset:
            full_subset = attribute_subset
        else:
            full_subset = [*attribute_subset, PHONEME_FEATURE]
        self._full_phoneme_subset_attributes = self._full_attributes.subset(attribute_subset=full_subset)

        self._phonemes = self._subset_attributes.phonemes
        self._feature_categories = self._subset_attributes._feature_categories
        self._feature_table = self._subset_attributes.feature_table
        self._feature_columns = self._subset_attributes.feature_columns
        self._feature_names = self._subset_attributes.feature_names

        self._feature_counts = np.array(
            [len(self._feature_categories[name]) for name in self._feature_columns], dtype=np.int64
        )
        self._total_size = int(self._feature_counts.sum())

        # Composition features: everything after the start column ("tone"), minus the
        # phoneme identity column.
        full_columns = list(self._full_attributes._feature_columns)
        start_position = full_columns.index(feature_start_column)
        composition_start_column = full_columns[start_position + 1]
        # PHOIBLE's start column ("tone") is excluded from the composition
        # features; panphon's ("syl") is a regular varying feature
        # (reference :689-692).
        varying_feature_categories = {
            name: categories
            for name, categories in self._full_attributes._feature_categories.items()
            if not (feature_set == FeatureSet.PHOIBLE and name == feature_start_column)
        }
        features_only = dict(varying_feature_categories)
        features_only.pop(PHONEME_FEATURE, None)
        self._composition_features = list(features_only)

        if self._allophone_data_frame is not None:
            _binarize_contours(self._allophone_data_frame, composition_start_column, attribute_vocabularies)
            unique_rows = self._allophone_data_frame.first_of_each_label()
            self._allophone_data = AllophoneData(
                self._allophone_data_frame,
                ArticulatoryAttributes(
                    unique_rows.select_columns(unique_rows.columns_from(composition_start_column)),
                    dict(varying_feature_categories),
                ),
            )

        # Language-allophone mappings.
        if isinstance(language_inventories, LanguageAllophoneMappings):
            self._language_allophones: LanguageAllophoneMappings | None = language_inventories
        elif isinstance(language_inventories, LanguageInventories):
            if allophones_from_allophoible:
                self._language_allophones = LanguageAllophoneMappings.from_allophone_data(
                    self, language_inventories.languages
                )
            else:
                self._language_allophones = language_inventories.map_allophones(self)
        else:
            self._language_allophones = None

        if self._language_allophones is not None:
            self._feature_categories[PHONE_FEATURE] = self._language_allophones.shared_phones

    def state(self) -> PhoneticIndexerState:
        return PhoneticIndexerState(self.phonemes.tolist(), self._language_allophones, self._table_file)

    @classmethod
    def from_state(
        cls,
        feature_set: str,
        state: PhoneticIndexerState,
        feature_subset: List[str] | None = None,
    ) -> "PhoneticAttributeIndexer":
        # Always initialize with allophone data if phoible features are used
        # (reference :737-744 does not restore language allophones through this path).
        return cls(
            feature_set,
            state.table_file,
            feature_subset,
            state.phoneme_inventory,
            allophones_from_allophoible=feature_set == FeatureSet.PHOIBLE,
        )

    @classmethod
    def from_config(
        cls,
        config,
        attribute_table_file=None,
        language_inventories: LanguageInventories | None = None,
        state_dict: PhoneticIndexerState | None = None,
    ) -> "PhoneticAttributeIndexer":
        """Derives the classifier feature subset from the projection config and builds
        the indexer, optionally from a checkpoint state (reference :746-786)."""
        from allophant_tpu_torch.config import PhonemeLayerType, ProjectionEntryConfig

        # dict preserves insertion order while deduplicating.
        existing_entries: Dict[str, None] = {}
        for entry in config.nn.projection.classes:
            existing_entries[entry.name] = None
            existing_entries.update((attribute, None) for attribute in entry.dependencies)

        existing_entries.pop(ProjectionEntryConfig.OUTPUT_DEPENDENCY, None)
        for attribute in list(existing_entries):
            if ProjectionEntryConfig.OUTPUT_PATTERN.match(attribute):
                del existing_entries[attribute]

        if state_dict is not None:
            # Checkpoint states are self-contained: the embedded CSV text and phoneme
            # inventory always apply; allophone mappings only when present.
            language_allophone_mappings: LanguageInventoryTypes = (
                state_dict.language_allophones
                if isinstance(state_dict.language_allophones, LanguageAllophoneMappings)
                else None
            )
            phoneme_subset: Sequence[str] | None = state_dict.phoneme_inventory
            attribute_table_file = state_dict.table_file
        elif language_inventories is not None:
            language_allophone_mappings = language_inventories
            phoneme_subset = sorted(language_inventories.shared_inventory())
        else:
            language_allophone_mappings = phoneme_subset = None

        return cls(
            config.nn.projection.feature_set,
            attribute_table_file,
            list(existing_entries.keys()),
            phoneme_subset,
            language_allophone_mappings,
            config.nn.projection.phoneme_layer == PhonemeLayerType.ALLOPHONES,
        )

    @property
    def feature_set(self) -> str:
        return self._feature_set

    @property
    def composition_features(self) -> List[str]:
        return self._composition_features

    @property
    def language_allophones(self) -> LanguageAllophoneMappings | None:
        return self._language_allophones

    @property
    def attributes(self) -> ArticulatoryAttributes:
        return self._subset_attributes

    @property
    def full_attributes(self) -> ArticulatoryAttributes:
        return self._full_attributes

    @property
    def full_subset_attributes(self) -> ArticulatoryAttributes:
        return self._full_phoneme_subset_attributes

    def composition_feature_matrix(self, inventory: List[str]) -> np.ndarray:
        """Dense int feature matrix for the embedding-composition layer — the zero-shot
        inventory mechanism (reference :808-818)."""
        return self._full_attributes.subset(inventory, list(self._composition_features)).dense_feature_table.astype(
            np.int64
        )

    def allophone_inventory(self, language_code: str) -> Frame:
        if self._allophone_data is None:
            raise ValueError(
                "Allophone inventories can only be accessed if features were extracted from Allophoible"
            )
        code = standardize_to_iso6393(language_code)
        return self._allophone_data.inventories.where("ISO6393", lambda value: value == code)

    def phoneme_inventory(self, languages: Sequence[str] | str) -> List[str]:
        """Union phoneme inventory for one or more language codes."""
        if self._allophone_data is None:
            raise ValueError(
                "Allophone inventories can only be accessed if features were extracted from Allophoible"
            )
        if isinstance(languages, str):
            codes = {standardize_to_iso6393(languages)}
        else:
            codes = {standardize_to_iso6393(language_code) for language_code in languages}
        return self._allophone_data.inventories.where("ISO6393", lambda value: value in codes).index.unique()

    def map_language_inventory(
        self,
        inventories: Iterable[List[str]],
        language: str,
        return_distance_matrices: bool = False,
        distance_threshold: int | None = None,
    ):
        phoneme_inventory = self.allophone_inventory(language).index.tolist()
        return [
            self.full_attributes.map_inventories_closest(
                inventory,
                phoneme_inventory,
                split_non_matching_complex=True,
                return_distance_matrices=return_distance_matrices,
                distance_threshold=distance_threshold,
            )
            for inventory in inventories
        ]

    @property
    def allophone_data(self) -> AllophoneData | None:
        return self._allophone_data

    def size(self, column: int | str | None = None) -> int:
        if column is None:
            return self._total_size
        if isinstance(column, str):
            column = self.feature_category_index(column)
        return int(self._feature_counts[column])

    def map_to_subset(self, inventory: Sequence[str]) -> Dict[str, str]:
        current_segments = self._subset_attributes
        inventory_segments = self._full_attributes.subset(inventory)
        return {
            phoneme: current_segments.phoneme(
                current_segments.closest_phone_for(phoneme, inventory_segments.simplified_feature_vector(phoneme))
            )
            for phoneme in inventory
        }

    def _phoneme_fallback(self, segmenter: IpaSegmenter, phoneme: str) -> str:
        if phoneme in self.phonemes:
            return phoneme
        return segmenter.segment_checked(phoneme)[0]

    def map_target_inventory(
        self,
        inventory: Sequence[str],
        map_uncovered_target_phonemes: bool = True,
        missing_feature_fallback: bool = False,
    ) -> Dict[str, str]:
        """"tr2tgt" mapping scheme (Xu et al., 2022): every source phoneme maps to its
        closest target; uncovered targets then claim their closest source."""
        current_segments = self._subset_attributes
        inventory_segments = self._full_attributes.subset(
            inventory, missing_feature_fallback=missing_feature_fallback
        )
        remaining_phonemes = set(inventory)

        source_mapping: Dict[str, str] = {}
        for phoneme in self.phonemes:
            target_phoneme = inventory_segments.phoneme(
                inventory_segments.closest_phone_for(
                    phoneme, current_segments.simplified_feature_vector(phoneme)
                )
            )
            source_mapping[phoneme] = target_phoneme
            remaining_phonemes.discard(target_phoneme)

        if map_uncovered_target_phonemes:
            for target_phoneme in remaining_phonemes:
                closest_in_source = current_segments.phoneme(
                    current_segments.closest_phone_for(
                        target_phoneme, inventory_segments.simplified_feature_vector(target_phoneme)
                    )
                )
                source_mapping[closest_in_source] = target_phoneme

        return source_mapping


def read_panphon(file=None, index_column: str | None = None) -> Frame:
    """Reads a panphon feature CSV (``ipa_all.csv`` format) from a path, buffer or
    CSV text string, every cell a string or ``None``; with no file, falls back
    to the table shipped with the optional ``panphon`` package (reference
    phonetic_features.py:974-986)."""
    if file is None:
        try:
            from importlib import resources

            import panphon  # type: ignore[import-not-found]
        except ImportError as error:
            raise FileNotFoundError(
                "No panphon feature table provided and the optional panphon package"
                " is not installed; pass a path to an ipa_all.csv-format table"
            ) from error
        with (resources.files(panphon) / "data/ipa_all.csv").open("r", encoding="utf-8") as default_file:
            table = _read_csv(default_file)
    else:
        table = _read_csv(file)
    return table if index_column is None else table.set_index(index_column)


def read_allophoible(file=None, index_column: str | None = None) -> Frame:
    """Reads an Allophoible CSV from a path, buffer or CSV text string: every
    cell a string or ``None``, "InventoryID" an int, indexed by
    ``index_column`` when given."""
    if file is None:
        raise FileNotFoundError(
            "No Allophoible feature table provided. The database is not bundled;"
            " released checkpoints embed their own copy (PhoneticIndexerState.table_file),"
            " and fresh preprocessing requires a downloaded copy of"
            " https://github.com/Aariciah/allophoible"
        )
    table = _read_csv(file)
    table.set_column("InventoryID", [int(value) for value in table.column("InventoryID")])
    return table if index_column is None else table.set_index(index_column)


class LanguageMappingWarning(UserWarning):
    """Warns about languages being remapped to a closely related variant."""


class SingletonFeatureWarning(UserWarning):
    """Warns about features not varying."""


warnings.simplefilter("always", LanguageMappingWarning)
warnings.simplefilter("always", SingletonFeatureWarning)


_SOURCE_AND_LANGUAGE = ["Source", "ISO6393", "SpecificDialect"]


def _inventory_keys(frame: Frame) -> List[Tuple]:
    positions = [frame.position(name) for name in _SOURCE_AND_LANGUAGE]
    return [tuple(row[p] for p in positions) for row in frame.rows]


def _select_largest_inventories(
    non_marginal_allophones: Frame, preferred_dialects: Dict[str, str] | None = None
) -> List[Tuple]:
    """One ``(Source, ISO6393, SpecificDialect)`` key per language, in the
    order of the sorted language codes: the inventory with the most phoneme
    rows wins, the first in key order on a tie. Languages with an entry in
    ``preferred_dialects`` are pinned to that dialect — their other dialects never
    compete (reference phonetic_features.py:1018-1041 defines the selection rule)."""
    keys = _inventory_keys(non_marginal_allophones)
    if preferred_dialects is not None:
        keys = [
            key for key in keys if key[1] not in preferred_dialects or key[2] == preferred_dialects[key[1]]
        ]
    sizes: Dict[Tuple, int] = {}
    for key in keys:
        sizes[key] = sizes.get(key, 0) + 1
    winners: Dict[Any, Tuple] = {}
    for key in sorted(sizes, key=lambda key: tuple(map(_missing_last, key))):
        best = winners.get(key[1])
        if best is None or sizes[key] > sizes[best]:
            winners[key[1]] = key
    return [winners[language] for language in sorted(winners, key=_missing_last)]


def _filter_inventories_by_remap(
    phoible: Frame, filtered: Frame, remapped_inventories: Dict[str, List[str]]
) -> Frame:
    """Restricts each language's rows to a remapped inventory, pulling in feature rows
    (with the language's metadata) for phonemes absent from the original inventory."""
    groups = []
    languages = filtered.column("ISO6393")
    metadata_columns = phoible.columns[phoible.position("InventoryID") : phoible.position("SpecificDialect") + 1]
    for language in sorted({code for code in languages if code is not None}):
        inventory = filtered.take(i for i, code in enumerate(languages) if code == language)
        expected_inventory = set(remapped_inventories[language])
        inventory_subset = inventory.where("Phoneme", lambda phoneme: phoneme in expected_inventory)
        remaining_phonemes = expected_inventory - set(inventory_subset.column("Phoneme"))
        if not remaining_phonemes:
            groups.append(inventory_subset)
            continue
        remaining = phoible.where("Phoneme", lambda phoneme: phoneme in remaining_phonemes).first_of_each("Phoneme")
        remaining.set_column("Allophones", remaining.column("Phoneme"))
        first_row = inventory_subset.rows[0]
        for column in metadata_columns:
            remaining.set_column(column, [first_row[inventory_subset.position(column)]] * len(remaining))
        remaining.set_column("Marginal", [None] * len(remaining))
        if len(remaining) != len(remaining_phonemes):
            raise ValueError("Inventory mismatch detected")
        groups.append(Frame.concat((inventory_subset, remaining)))
    return Frame.concat(groups)


def _resolve_macro_language_variants(pool: Frame, unresolved: Set[str]) -> Dict[str, str]:
    """For requested languages with no inventory of their own, picks a PHOIBLE
    variant sharing the same macro-language code. If the macro code itself shows
    up among the PHOIBLE codes, it replaces any sibling variant chosen earlier.
    (The reference states this preference in a comment but updates the wrong dict
    key, phonetic_features.py:1105-1107; we implement the stated intent.)
    Returns ``{requested code: chosen PHOIBLE variant}``; raises if any requested
    language has no variant with allophone data at all."""
    awaiting: Dict[str, List[str]] = {}
    for code in unresolved:
        awaiting.setdefault(LanguageCode.from_str(code, True, True).alpha3_t, []).append(code)
    chosen: Dict[str, str] = {}
    resolved_by_macro: Dict[str, List[str]] = {}
    for variant in dict.fromkeys(pool.column("ISO6393")):
        macro = LanguageCode.from_str(variant, True, True).alpha3_t
        if macro in awaiting:
            requested_codes = awaiting.pop(macro)
            resolved_by_macro[macro] = requested_codes
            for code in requested_codes:
                chosen[code] = variant
        elif variant == macro and macro in resolved_by_macro:
            # The macro-language inventory itself exists later in the pool:
            # it replaces the sibling variant picked first.
            for code in resolved_by_macro[macro]:
                chosen[code] = variant

    if awaiting:
        raise ValueError(
            "Some of the requested languages don't contain allophone data:"
            f" {sorted(code for codes in awaiting.values() for code in codes)}"
        )
    return chosen


def _feature_only_rows(phoible: Frame, phonemes: Set[str]) -> Frame:
    """Builds feature rows for allophones that never occur as a phoneme of their
    own in the selected inventories: one deduplicated row per phoneme with the
    unused inventory id 0 and all language metadata cleared."""
    rows = phoible.where("Phoneme", lambda phoneme: phoneme in phonemes).first_of_each("Phoneme")
    undefined = phonemes - set(rows.column("Phoneme"))
    if undefined:
        raise ValueError(
            f"Missing pre-computed feature definitions for {len(undefined)} allophones:"
            f" {undefined}"
        )
    rows.set_column("InventoryID", [0] * len(rows))
    cleared = rows.columns[rows.position("Glottocode") : rows.position("SpecificDialect") + 1]
    for column in (*cleared, "Source", "Allophones"):
        rows.set_column(column, [None] * len(rows))
    return rows


def _referenced_allophones(selected: Frame) -> Set[str]:
    """Every phoneme named in a space-separated ``Allophones`` list that has no
    ``Phoneme`` row of its own in the selection (missing and empty entries skipped)."""
    known = set(selected.column("Phoneme"))
    referenced: Set[str] = set()
    for allophone_list in dict.fromkeys(value for value in selected.column("Allophones") if value is not None):
        referenced.update(allophone_list.split(" "))
    return {phoneme for phoneme in referenced if phoneme and phoneme not in known}


_ZERO_PHONEME = re.compile(r"( ?∅|∅ ?)")


def extract_allophone_inventories(
    phoible: Frame,
    language_codes: Sequence[str] | None = None,
    attribute_subset: Sequence[str] | None = None,
    remapped_inventories: Dict[str, List[str]] | None = None,
    prefer_default_dialects: bool = False,
    remove_zero_phoneme: bool = False,
) -> Frame:
    """Builds the per-language allophone feature table from a PHOIBLE-format frame
    (semantics per reference phonetic_features.py:1067-1189): pick one inventory
    per language (largest, or the preferred dialect), fall back to macro-language
    variants for codes PHOIBLE lacks, optionally restrict to remapped inventories,
    and append ``InventoryID == 0`` feature-only rows so every referenced
    allophone has a feature vector."""
    dialects = _load_default_dialects() if prefer_default_dialects else None
    allophones, marginal = phoible.position("Allophones"), phoible.position("Marginal")
    usable = phoible.take(
        i for i, row in enumerate(phoible.rows) if row[allophones] is not None and row[marginal] != "TRUE"
    )

    requested: Set[str] | None = None
    pool = usable
    if language_codes is not None:
        requested = {LanguageCode.from_str(code).alpha3 for code in language_codes}
        pool = usable.where("ISO6393", lambda code: code in requested)

    chosen = _select_largest_inventories(pool, dialects)

    # Requested codes absent from the selection are served by a macro-language
    # sibling, renamed back to the requested code below.
    renames: Dict[str, str] = {}
    if requested is not None and len(chosen) != len(requested):
        renames = _resolve_macro_language_variants(usable, requested - {key[1] for key in chosen})
        warnings.warn(
            f"Remapped some languages to a variant within the same macro language: {renames}",
            LanguageMappingWarning,
        )
        variants = set(renames.values())
        variant_pool = usable.where("ISO6393", lambda code: code in variants)
        chosen = chosen + _select_largest_inventories(variant_pool, dialects)

    inventory_keys = set(chosen)
    selected = phoible.take(i for i, key in enumerate(_inventory_keys(phoible)) if key in inventory_keys)
    inverse_renames = {variant: requested_code for requested_code, variant in renames.items()}
    selected.set_column("ISO6393", [inverse_renames.get(code, code) for code in selected.column("ISO6393")])

    if remapped_inventories is not None:
        selected = _filter_inventories_by_remap(phoible, selected, remapped_inventories)

    if remove_zero_phoneme:
        selected.set_column(
            "Allophones",
            [None if value is None else _ZERO_PHONEME.sub("", value) for value in selected.column("Allophones")],
        )

    table = Frame.concat((_feature_only_rows(phoible, _referenced_allophones(selected)), selected))
    table = table.select_columns([column for column in table.columns if column != "Marginal"])
    table.columns[table.position("Phoneme")] = PHONEME_FEATURE
    table = Frame(table.columns, table.rows, table.index)

    features_start = table.position("Source") + 1
    if attribute_subset is not None:
        metadata_columns = [column for column in table.columns[:features_start] if column != PHONEME_FEATURE]
        table = table.select_columns(metadata_columns + list(attribute_subset))
        features_start = len(metadata_columns)

    constant = [
        name
        for name in table.columns[features_start:]
        if len({value for value in table.column(name) if value is not None}) <= 1
    ]
    if constant:
        warnings.warn(f"Only one feature variant found in {constant}", SingletonFeatureWarning)

    return table


def _load_default_dialects() -> Dict[str, str]:
    from allophant_tpu_torch.package_data import DEFAULT_DIALECTS_PATH

    with open(DEFAULT_DIALECTS_PATH, "r", encoding="utf-8") as file:
        return json.load(file)
