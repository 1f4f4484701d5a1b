"""The port's spans and counters, off unless a caller turns them on.

- ``span(name)``: a context manager around one piece of the program's work.
  On, it opens ``torch.profiler.record_function("allophant." + name)``:
  under an active ``torch.profiler`` the span lands in the Chrome trace as a
  ``user_annotation`` on the clock of the kernels it launched (joined to them
  by correlation id), inside whichever range encloses it. Off, it returns one
  shared no-op context after a single flag check, and dispatches nothing.
- ``count(name, n=1)``: adds ``n`` to a counter kept in memory; off, it
  returns at once.
- ``recording()``: a context manager that turns both on and yields the dict
  of counters, which holds the block's counts when the block ends; tracing
  is then as it was before (off, unless an outer recording is open).

``training/run.py:StepProfiler`` records while its profiler runs.

Spans: ``estimator.request`` (a ``predict*`` call) encloses
``estimator.inputs``, ``estimator.forward`` and ``estimator.decode``;
``train.step`` (an update) encloses each microbatch's ``train.forward``,
``train.loss`` and ``train.backward``, then ``train.optimizer`` and
``train.metrics``. Counters: ``decode_calls`` (``ops/decode.py``: one a
``greedy_decode_padded`` call, so one a group of heads of equal class count
in greedy serving, and one a ``beam_search_heads`` call), ``decode_heads``
(the heads those serving calls decode: ``decode_heads / decode_calls`` is
how many heads a greedy call stacks), ``ctc_calls`` (``ops/ctc.py``: one a
``F.ctc_loss`` call) and ``host_reads`` (one a ``.cpu()`` read of the
training or evaluation step's metrics). How often the host waits for the
card is the CUDA runtime's to count (``torch.cuda.set_sync_debug_mode``),
not the code's: ``F.ctc_loss`` and its backward wait several times a call."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

#: The prefix of every span's range in a trace.
PREFIX = "allophant."

_on = False
_counts: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of one span named ``PREFIX + name`` (a no-op while off)."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (nothing while off)."""
    if not _on:
        return
    _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Spans and counters on for the block; yields the block's counters."""
    global _on, _counts
    outer = _on, _counts
    _on, _counts = True, {}
    try:
        yield _counts
    finally:
        _on, _counts = outer
