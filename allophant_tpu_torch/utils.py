"""General utilities: streaming statistics, worker counts, argparse helpers.

The port's copy of ``allophant_tpu/utils.py``.

Counterpart of the reference's allophant/utils.py (the mask/conv-length helpers live
in :mod:`allophant_tpu_torch.ops.masking` since they run on device)."""

from __future__ import annotations

import os
from argparse import Action, ArgumentParser, Namespace
from enum import Enum
from typing import Any, Iterable, Iterator, Optional, Type


def progress_bar(
    iterable: Optional[Iterable] = None,
    *,
    enabled: bool = True,
    total: Optional[int] = None,
    desc: Optional[str] = None,
    unit: str = "it",
    leave: bool = True,
) -> Any:
    """A tqdm progress bar over ``iterable`` (or a manually-updated bar when
    ``iterable`` is None), mirroring the reference's loop reporting
    (reference estimator.py:470-478, 616-623). Disabled bars — and environments
    without tqdm — degrade to a no-op pass-through so callers never branch."""
    if not enabled:
        if iterable is None:
            return _NullProgress()
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:
        if iterable is None:
            return _NullProgress()
        return iterable
    return tqdm(iterable, total=total, desc=desc, unit=unit, leave=leave, dynamic_ncols=True)


class _NullProgress:
    """Inert stand-in for a manually-driven tqdm bar."""

    def update(self, n: int = 1) -> None:
        pass

    def set_postfix(self, *args, **kwargs) -> None:
        pass

    def set_description(self, desc: Optional[str] = None, refresh: bool = True) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "_NullProgress":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __iter__(self) -> Iterator:
        return iter(())


class OnlineMean:
    """Numerically stable streaming mean (reference utils.py:174-190)."""

    def __init__(self) -> None:
        self._mean = 0.0
        self._count = 0

    def add(self, value: float, count: int = 1) -> "OnlineMean":
        """Folds in `count` observations whose mean is `value`."""
        self._count += count
        self._mean += (value - self._mean) * count / self._count
        return self

    def __repr__(self) -> str:
        return f"OnlineMean({self._mean:.6f}, n={self._count})"

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._mean


def get_worker_count(requested: Optional[int] = None) -> int:
    """Number of data workers: the requested count, or the process CPU affinity
    count (reference utils.py:216-231)."""
    if requested is not None:
        if requested < 0:
            raise ValueError(f"Worker count must be non-negative, got {requested}")
        return requested
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # platforms without sched_getaffinity
        return os.cpu_count() or 1


class EnumAction(Action):
    """argparse action mapping choice strings onto an Enum by value (reference
    utils.py:154-171)."""

    def __init__(self, option_strings, dest, type: Type[Enum] | None = None, **kwargs):
        if type is None or not issubclass(type, Enum):
            raise TypeError("EnumAction requires an Enum `type`")
        self._enum = type
        kwargs.setdefault("choices", [entry.value for entry in type])
        if isinstance(kwargs.get("default"), Enum):
            kwargs["default"] = kwargs["default"].value
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser: ArgumentParser, namespace: Namespace, values, option_string=None):
        setattr(namespace, self.dest, self._enum(values))


def global_or_local(value, key: str):
    """Resolves `{key: v}`-style per-key overrides against a global scalar."""
    if isinstance(value, dict):
        return value.get(key)
    return value
