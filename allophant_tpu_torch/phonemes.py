"""IPA segmentation and edit-distance engine (native C++ core with Python
fallback), the port's copy of ``allophant_tpu/phonemes.py``. The C++ core
(``native/src``) is built with the host compiler on first use, not at import
(``native/build.py``).

Provides the same public surface as the reference's Rust pyo3 extension
``allophant.phonemes`` (contract: its ``allophant/phonemes.pyi``, implementation
``src/ipa_segmenter.rs`` and ``src/edit_distance.rs``):
``IpaSegmenter``, ``Action``, ``EditStatistics``, ``PropertyWeighting`` and the
``levensthein*`` functions (reference spelling kept for API parity).

Differences from the reference by design:
- ``levensthein_matrix`` returns a numpy array instead of a ``torch.Tensor``.
- ``PropertyWeighting`` precomputes the pairwise substitution-cost matrix with numpy
  (vectorized hamming distance over feature rows) instead of calling back into Python
  per DP cell, which removes the FFI round trip from the O(m*n) inner loop.
"""

from __future__ import annotations

import ctypes
import math
from enum import IntEnum
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Action",
    "EditStatistics",
    "IpaSegmenter",
    "MissingSegmentError",
    "PropertyWeighting",
    "levensthein",
    "levensthein_matrix",
    "levensthein_operations",
    "levensthein_statistics",
    "to_substitutions",
    "NATIVE_AVAILABLE",
]


class MissingSegmentError(ValueError):
    """Raised when checked segmentation encounters a span missing from the vocabulary."""


class Action(IntEnum):
    INSERTION = 0
    DELETION = 1
    SUBSTITUTION = 2

    @staticmethod
    def from_int(integer: int) -> "Action":
        try:
            return Action(integer)
        except ValueError:
            raise ValueError(f"Invalid enum value {integer}") from None


class EditStatistics:
    """Aggregate insertion/deletion/substitution/correct counts with error-rate helpers.

    Semantics match the reference's src/edit_distance.rs:281-370.
    """

    __slots__ = ("insertions", "deletions", "substitutions", "correct")

    def __init__(self, insertions: int, deletions: int, substitutions: int, correct: int):
        self.insertions = int(insertions)
        self.deletions = int(deletions)
        self.substitutions = int(substitutions)
        self.correct = int(correct)

    @classmethod
    def zeros(cls) -> "EditStatistics":
        return cls(0, 0, 0, 0)

    def word_error_rate(self) -> float:
        """(S+D+I)/(S+D+C). The reference divides in Rust f64 where an empty
        reference (S=D=C=0) yields inf/NaN silently (edit_distance.rs:311-333);
        here that degenerate case returns inf with I>0 and 0.0 when every count
        is zero, so Python never raises ZeroDivisionError mid-evaluation."""
        substituted_or_deleted = self.substitutions + self.deletions
        expected = substituted_or_deleted + self.correct
        if expected == 0:
            return math.inf if self.insertions else 0.0
        return (substituted_or_deleted + self.insertions) / expected

    def _expected_count(self) -> float:
        return float(self.substitutions + self.deletions + self.correct)

    def _rate(self, count: int) -> float:
        expected = self._expected_count()
        if expected == 0:
            return math.inf if count else 0.0
        return count / expected

    def substitution_rate(self) -> float:
        return self._rate(self.substitutions)

    def insertion_rate(self) -> float:
        return self._rate(self.insertions)

    def deletion_rate(self) -> float:
        return self._rate(self.deletions)

    def _fields(self) -> Tuple[int, int, int, int]:
        return (self.insertions, self.deletions, self.substitutions, self.correct)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, EditStatistics):
            return NotImplemented
        return self._fields() == other._fields()

    def __hash__(self) -> int:
        return hash(self._fields())

    def __add__(self, other: "EditStatistics") -> "EditStatistics":
        return EditStatistics(
            self.insertions + other.insertions,
            self.deletions + other.deletions,
            self.substitutions + other.substitutions,
            self.correct + other.correct,
        )

    def __iadd__(self, other: "EditStatistics") -> "EditStatistics":
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.substitutions += other.substitutions
        self.correct += other.correct
        return self

    def __repr__(self) -> str:
        return (
            f"EditStatistics(insertions={self.insertions}, deletions={self.deletions},"
            f" substitutions={self.substitutions}, correct={self.correct})"
        )


# ---------------------------------------------------------------------------
# Native library loading (ctypes)
# ---------------------------------------------------------------------------

_LIB = None
_LOAD_FAILED = False
NATIVE_AVAILABLE = False


def _load_native():
    global _LIB, _LOAD_FAILED, NATIVE_AVAILABLE
    if _LIB is not None:
        return _LIB
    if _LOAD_FAILED:
        # Memoize failure: without this, every edit-distance call would re-hash
        # the C++ sources and re-spawn a doomed compile attempt.
        return None
    try:
        from allophant_tpu_torch.native.build import library_path

        lib = ctypes.CDLL(str(library_path()))
    except Exception:
        NATIVE_AVAILABLE = False
        _LOAD_FAILED = True
        return None

    lib.allophant_ac_build.restype = ctypes.c_void_p
    lib.allophant_ac_build.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.allophant_ac_free.argtypes = [ctypes.c_void_p]
    lib.allophant_ac_find.restype = ctypes.c_int32
    lib.allophant_ac_find.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.allophant_lev_distance.restype = ctypes.c_int64
    lib.allophant_lev_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _float_ptr = ctypes.POINTER(ctypes.c_float)
    lib.allophant_lev_statistics.restype = ctypes.c_float
    lib.allophant_lev_statistics.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        _float_ptr,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.allophant_lev_operations.restype = ctypes.c_int32
    lib.allophant_lev_operations.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        _float_ptr,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        _float_ptr,
    ]
    lib.allophant_lev_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        _float_ptr,
        ctypes.c_float,
        ctypes.c_float,
        _float_ptr,
    ]
    _LIB = lib
    NATIVE_AVAILABLE = True
    return lib



def _as_int32_array(values: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.int32)


def _int32_ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _intern_ids(*sequences: Sequence[Any]) -> List[np.ndarray]:
    """Maps arbitrary (hashable) elements to dense int ids preserving equality."""
    mapping: Dict[Any, int] = {}
    result = []
    for sequence in sequences:
        ids = np.empty(len(sequence), dtype=np.int32)
        for position, element in enumerate(sequence):
            identifier = mapping.get(element)
            if identifier is None:
                identifier = len(mapping)
                mapping[element] = identifier
            ids[position] = identifier
        result.append(ids)
    return result


# ---------------------------------------------------------------------------
# Segmenter
# ---------------------------------------------------------------------------


class IpaSegmenter:
    """Leftmost-longest multi-pattern segmenter over a phoneme vocabulary.

    Matches the reference's three segmentation modes (silent-skip, include-missing and
    checked; the reference's src/ipa_segmenter.rs:107-140).
    """

    def __init__(self, ipa_segments: List[str]):
        self.ipa_segments = list(ipa_segments)
        self._patterns = [segment.encode("utf-8") for segment in self.ipa_segments]
        lib = _load_native()
        if lib is not None:
            pattern_array = (ctypes.c_char_p * len(self._patterns))(*self._patterns)
            lengths = _as_int32_array([len(pattern) for pattern in self._patterns])
            self._handle = lib.allophant_ac_build(pattern_array, _int32_ptr(lengths), len(self._patterns))
            self._lib = lib
        else:
            self._handle = None
            self._lib = None
            # Fallback: patterns grouped by first byte for the pure-Python matcher.
            self._by_first: Dict[int, List[bytes]] = {}
            for pattern in self._patterns:
                if pattern:
                    self._by_first.setdefault(pattern[0], []).append(pattern)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.allophant_ac_free(handle)

    def _matches(self, word: str) -> List[Tuple[int, int, bytes]]:
        """Leftmost-longest non-overlapping matches as (start, end, text_bytes)."""
        text = word.encode("utf-8")
        if self._lib is not None:
            capacity = max(8, len(text))
            while True:
                starts = np.empty(capacity, dtype=np.int32)
                ends = np.empty(capacity, dtype=np.int32)
                count = self._lib.allophant_ac_find(
                    self._handle, text, len(text), _int32_ptr(starts), _int32_ptr(ends), capacity
                )
                if count <= capacity:
                    return [(int(starts[i]), int(ends[i]), text) for i in range(count)]
                capacity = count
        # Pure-Python fallback: best (longest) match per start, then the same
        # leftmost-longest non-overlapping selection as the native code.
        best_end = [0] * (len(text) + 1)
        for position in range(len(text)):
            for pattern in self._by_first.get(text[position], ()):
                end = position + len(pattern)
                if end <= len(text) and text[position:end] == pattern and end > best_end[position]:
                    best_end[position] = end
        matches = []
        cursor = 0
        while cursor <= len(text):
            if best_end[cursor] > cursor:
                matches.append((cursor, best_end[cursor], text))
                cursor = best_end[cursor]
            else:
                cursor += 1
        return matches

    def _segment_word(self, word: str) -> List[str]:
        return [text[start:end].decode("utf-8") for start, end, text in self._matches(word)]

    def _segment_word_with_missing(self, word: str) -> List[str]:
        segments = []
        text = word.encode("utf-8")
        last_end = 0
        for start, end, _ in self._matches(word):
            if start != last_end:
                segments.append(text[last_end:start].decode("utf-8"))
            segments.append(text[start:end].decode("utf-8"))
            last_end = end
        if last_end != len(text):
            segments.append(text[last_end:].decode("utf-8"))
        return segments

    def _segment_word_checked(self, word: str) -> List[str]:
        segments = []
        text = word.encode("utf-8")
        last_end = 0
        for start, end, _ in self._matches(word):
            if start != last_end:
                missing = text[last_end:start].decode("utf-8")
                raise MissingSegmentError(
                    f"Segment {missing!r} is missing from the vocabulary. Found in: {word!r}"
                )
            segments.append(text[start:end].decode("utf-8"))
            last_end = end
        if last_end != len(text):
            missing = text[last_end:].decode("utf-8")
            raise MissingSegmentError(
                f"Segment {missing!r} is missing from the vocabulary. Found in: {word!r}"
            )
        return segments

    def segment(self, transcription: str, include_missing: bool = False) -> List[str]:
        if include_missing:
            return self._segment_word_with_missing(transcription)
        return self._segment_word(transcription)

    def segment_checked(self, transcription: str) -> List[str]:
        return self._segment_word_checked(transcription)

    def segment_words(self, transcription: List[str], include_missing: bool = False) -> List[str]:
        segments: List[str] = []
        for word in transcription:
            segments.extend(self.segment(word, include_missing))
        return segments

    def segment_words_checked(self, transcription: List[str]) -> List[str]:
        segments: List[str] = []
        for word in transcription:
            segments.extend(self._segment_word_checked(word))
        return segments


# ---------------------------------------------------------------------------
# Edit distance
# ---------------------------------------------------------------------------

Operations = List[Tuple[Action, int, int]]


def levensthein(string_a: Sequence[Any], string_b: Sequence[Any]) -> int:
    ids_a, ids_b = _intern_ids(string_a, string_b)
    lib = _load_native()
    if lib is not None:
        return int(
            lib.allophant_lev_distance(_int32_ptr(ids_a), len(ids_a), _int32_ptr(ids_b), len(ids_b))
        )
    return _python_distance(ids_a, ids_b)


def _python_distance(ids_a: np.ndarray, ids_b: np.ndarray) -> int:
    n = len(ids_b)
    previous = list(range(n + 1))
    for i, element in enumerate(ids_a):
        current = [i + 1] + [0] * n
        for j in range(n):
            current[j + 1] = min(
                previous[j + 1] + 1,
                current[j] + 1,
                previous[j] + (1 if element != ids_b[j] else 0),
            )
        previous = current
    return previous[n]


def _python_matrix(
    ids_a: np.ndarray,
    ids_b: np.ndarray,
    sub_costs: np.ndarray | None,
    insertion_cost: float,
    deletion_cost: float,
) -> np.ndarray:
    m, n = len(ids_a), len(ids_b)
    matrix = np.zeros((m + 1, n + 1), dtype=np.float32)
    matrix[0] = np.arange(n + 1, dtype=np.float32)
    for i in range(1, m + 1):
        matrix[i, 0] = matrix[i - 1, 0] + deletion_cost
        for j in range(1, n + 1):
            if sub_costs is not None:
                sub = sub_costs[i - 1, j - 1]
            else:
                sub = 0.0 if ids_a[i - 1] == ids_b[j - 1] else 1.0
            matrix[i, j] = min(
                matrix[i - 1, j] + deletion_cost,
                matrix[i, j - 1] + insertion_cost,
                matrix[i - 1, j - 1] + sub,
            )
    return matrix


def _python_backtrace(matrix: np.ndarray):
    """Yields (action_or_None, i, j) steps using the reference tie-break rules."""
    m = matrix.shape[0] - 1
    n = matrix.shape[1] - 1
    current_cost = float(matrix[m, n])
    i, j = m, n
    while current_cost != 0.0:
        if i == 0:
            if j == 0:
                break
            action: Action | None = Action.INSERTION
            cost = float(matrix[i, j - 1])
        elif j == 0:
            action = Action.DELETION
            cost = float(matrix[i - 1, j])
        else:
            deletion = float(matrix[i - 1, j])
            insertion = float(matrix[i, j - 1])
            substitution = float(matrix[i - 1, j - 1])
            if deletion < insertion:
                action, cost = Action.DELETION, deletion
            else:
                action, cost = Action.INSERTION, insertion
            if substitution <= cost:
                action = None if substitution == current_cost else Action.SUBSTITUTION
                cost = substitution
        current_cost = cost
        if action is None or action == Action.SUBSTITUTION:
            i -= 1
            j -= 1
        elif action == Action.DELETION:
            i -= 1
        else:
            j -= 1
        yield action, i, j
    for _ in range(i):
        yield None, -1, -1


def _native_or_python_statistics(
    ids_a: np.ndarray,
    ids_b: np.ndarray,
    sub_costs: np.ndarray | None,
    insertion_cost: float,
    deletion_cost: float,
) -> EditStatistics:
    lib = _load_native()
    if lib is not None:
        counts = np.zeros(4, dtype=np.uint64)
        costs_ptr = None
        if sub_costs is not None:
            sub_costs = np.ascontiguousarray(sub_costs, dtype=np.float32)
            costs_ptr = sub_costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        lib.allophant_lev_statistics(
            _int32_ptr(ids_a),
            len(ids_a),
            _int32_ptr(ids_b),
            len(ids_b),
            costs_ptr,
            ctypes.c_float(insertion_cost),
            ctypes.c_float(deletion_cost),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return EditStatistics(*(int(value) for value in counts))
    matrix = _python_matrix(ids_a, ids_b, sub_costs, insertion_cost, deletion_cost)
    counts = {None: 0, Action.INSERTION: 0, Action.DELETION: 0, Action.SUBSTITUTION: 0}
    for action, _, _ in _python_backtrace(matrix):
        counts[action] += 1
    return EditStatistics(
        counts[Action.INSERTION], counts[Action.DELETION], counts[Action.SUBSTITUTION], counts[None]
    )


def _native_or_python_operations(
    ids_a: np.ndarray,
    ids_b: np.ndarray,
    sub_costs: np.ndarray | None,
    insertion_cost: float,
    deletion_cost: float,
) -> Tuple[Operations, float]:
    lib = _load_native()
    if lib is not None:
        capacity = len(ids_a) + len(ids_b) + 1
        actions = np.empty(capacity, dtype=np.int8)
        out_i = np.empty(capacity, dtype=np.int32)
        out_j = np.empty(capacity, dtype=np.int32)
        cost = ctypes.c_float()
        costs_ptr = None
        if sub_costs is not None:
            sub_costs = np.ascontiguousarray(sub_costs, dtype=np.float32)
            costs_ptr = sub_costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        count = lib.allophant_lev_operations(
            _int32_ptr(ids_a),
            len(ids_a),
            _int32_ptr(ids_b),
            len(ids_b),
            costs_ptr,
            ctypes.c_float(insertion_cost),
            ctypes.c_float(deletion_cost),
            actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _int32_ptr(out_i),
            _int32_ptr(out_j),
            capacity,
            ctypes.byref(cost),
        )
        operations = [
            (Action(int(actions[k])), int(out_i[k]), int(out_j[k])) for k in range(count)
        ]
        return operations, float(cost.value)
    matrix = _python_matrix(ids_a, ids_b, sub_costs, insertion_cost, deletion_cost)
    operations = [
        (action, i, j) for action, i, j in _python_backtrace(matrix) if action is not None
    ]
    operations.reverse()
    return operations, float(matrix[-1, -1])


def levensthein_statistics(string_a: Sequence[Any], string_b: Sequence[Any]) -> EditStatistics:
    ids_a, ids_b = _intern_ids(string_a, string_b)
    return _native_or_python_statistics(ids_a, ids_b, None, 1.0, 1.0)


def levensthein_operations(
    string_a: Sequence[Any], string_b: Sequence[Any]
) -> Tuple[Operations, float]:
    ids_a, ids_b = _intern_ids(string_a, string_b)
    return _native_or_python_operations(ids_a, ids_b, None, 1.0, 1.0)


def levensthein_matrix(string_a: Sequence[Any], string_b: Sequence[Any]) -> np.ndarray:
    """Full DP cost matrix. Returns numpy (the reference returns ``torch.Tensor``)."""
    ids_a, ids_b = _intern_ids(string_a, string_b)
    lib = _load_native()
    if lib is not None:
        out = np.empty((len(ids_a) + 1, len(ids_b) + 1), dtype=np.float32)
        lib.allophant_lev_matrix(
            _int32_ptr(ids_a),
            len(ids_a),
            _int32_ptr(ids_b),
            len(ids_b),
            None,
            ctypes.c_float(1.0),
            ctypes.c_float(1.0),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    return _python_matrix(ids_a, ids_b, None, 1.0, 1.0)


def to_substitutions(
    string_a: Sequence[str], string_b: Sequence[str], operations: Operations
) -> List[Tuple[Action, str, str]]:
    result = []
    for operation, a_index, b_index in operations:
        if operation == Action.DELETION:
            result.append((operation, string_a[a_index], ""))
        elif operation == Action.INSERTION:
            result.append((operation, "", string_b[b_index]))
        else:
            result.append((operation, string_a[a_index], string_b[b_index]))
    return result


class PropertyWeighting:
    """Feature-weighted edit costs: substitution cost is the hamming distance between
    the feature-table rows of the two symbols (reference:
    the reference's src/edit_distance.rs:498-599). The pairwise cost matrix is
    precomputed with numpy instead of a per-cell callback."""

    def __init__(self, insertion_cost: float, deletion_cost: float, property_table: Any):
        self._insertion_cost = float(insertion_cost)
        self._deletion_cost = float(deletion_cost)
        self._table = property_table

    def _prepare(
        self, string_a: Sequence[Any], string_b: Sequence[Any]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ids_a, ids_b = _intern_ids(string_a, string_b)
        features_a = (
            np.stack([np.asarray(self._table[element]) for element in string_a])
            if len(string_a)
            else np.zeros((0, 0))
        )
        features_b = (
            np.stack([np.asarray(self._table[element]) for element in string_b])
            if len(string_b)
            else np.zeros((0, 0))
        )
        if len(string_a) and len(string_b):
            sub_costs = (features_a[:, None, :] != features_b[None, :, :]).sum(-1).astype(np.float32)
        else:
            sub_costs = np.zeros((len(string_a), len(string_b)), dtype=np.float32)
        return ids_a, ids_b, sub_costs

    def levensthein_matrix(self, string_a: Sequence[Any], string_b: Sequence[Any]) -> np.ndarray:
        ids_a, ids_b, sub_costs = self._prepare(string_a, string_b)
        lib = _load_native()
        if lib is not None:
            out = np.empty((len(ids_a) + 1, len(ids_b) + 1), dtype=np.float32)
            costs = np.ascontiguousarray(sub_costs, dtype=np.float32)
            lib.allophant_lev_matrix(
                _int32_ptr(ids_a),
                len(ids_a),
                _int32_ptr(ids_b),
                len(ids_b),
                costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if costs.size else None,
                ctypes.c_float(self._insertion_cost),
                ctypes.c_float(self._deletion_cost),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            return out
        return _python_matrix(ids_a, ids_b, sub_costs, self._insertion_cost, self._deletion_cost)

    def levensthein_operations(
        self, string_a: Sequence[Any], string_b: Sequence[Any]
    ) -> Tuple[Operations, float]:
        ids_a, ids_b, sub_costs = self._prepare(string_a, string_b)
        return _native_or_python_operations(
            ids_a, ids_b, sub_costs if sub_costs.size else None, self._insertion_cost, self._deletion_cost
        )

    def levensthein_statistics(
        self, string_a: Sequence[Any], string_b: Sequence[Any]
    ) -> EditStatistics:
        ids_a, ids_b, sub_costs = self._prepare(string_a, string_b)
        return _native_or_python_statistics(
            ids_a, ids_b, sub_costs if sub_costs.size else None, self._insertion_cost, self._deletion_cost
        )
