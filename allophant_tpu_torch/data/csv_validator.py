"""Typed CSV/TSV row parsing driven by dataclass annotations.

The port's copy of ``allophant_tpu/data/csv_validator.py``. Validates Common
Voice TSV rows into dataclass instances (the role of the reference's
``allophant/csv_validator.py``). Columns are converted by the target
field's annotated type; ``Optional[T]`` fields treat the empty string as ``None``.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass
from typing import Any, Callable, Generic, List, Sequence, Type, TypeVar

RowType = TypeVar("RowType")


class CsvSchemaError(Exception):
    """A CSV row does not fit the declared schema."""


def _field_converter(annotation: Any) -> Callable[[str], Any]:
    """Maps one dataclass field annotation to a cell-string converter."""
    origin = typing.get_origin(annotation)
    if origin is typing.Union:
        arguments = typing.get_args(annotation)
        non_none = [argument for argument in arguments if argument is not type(None)]
        if len(non_none) == len(arguments) - 1 and len(non_none) == 1:
            inner = non_none[0]
            return lambda cell: inner(cell) if cell else None
    return annotation


@dataclass(frozen=True)
class CsvSchema(Generic[RowType]):
    """Compiled row parser for one dataclass."""

    row_type: Type[RowType]
    converters: Sequence[Callable[[str], Any]]

    def convert_line(self, cells: Sequence[str]) -> RowType:
        expected = len(self.converters)
        if len(cells) != expected:
            raise CsvSchemaError(
                f"Number of columns doesn't match, expected {expected}, got {len(cells)}"
            )
        values: List[Any] = []
        for convert, cell in zip(self.converters, cells):
            values.append(convert(cell))
        return self.row_type(*values)


def make_schema(row_type: Type[RowType]) -> CsvSchema[RowType]:
    """Compiles a dataclass into a row parser, one converter per annotated field."""
    hints = typing.get_type_hints(row_type)
    return CsvSchema(row_type, tuple(_field_converter(hint) for hint in hints.values()))
