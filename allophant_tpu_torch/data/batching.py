"""Samplers and batch generation with static bucketing (the port's copy of
``allophant_tpu/data/batching.py``).

Counterpart of the reference's allophant/batching.py, with the key XLA-driven change:
batches are padded to *shape buckets* (sequence lengths rounded up to a multiple,
batch sizes optionally rounded to powers of two with zero-length filler rows) so the
jit cache sees few distinct shapes, replacing fully dynamic padded shapes.

- ``LanguageOversamplingSampler``: XLS-R temperature sampling over per-language bins
  with without-replacement cycling inside each bin (reference batching.py:48-91).
- ``MaxFrameBatchSampler``: packs utterances until ``(batch + 1) * max_len`` exceeds
  the padded-frame budget (reference :94-139).
- ``SkipBatchSampler``: resume support (reference :142-159).
- ``Batcher``: draws samples, collates, pads; a background prefetch thread, or
  forked worker processes (``data_workers >= 1``, the reference's DataLoader
  workers), overlap host-side audio decoding with device steps; with
  ``process_shard`` each process builds only its slice of a global batch."""

from __future__ import annotations

import queue
import signal
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from allophant_tpu_torch.config import BatchingMode
from allophant_tpu_torch.data.batch import Batch, LabeledBatch, RawLabeledBatch
from allophant_tpu_torch.data.dataset import BatchType, PhonemeDataset, Sample
from allophant_tpu_torch.data.speech_corpus import MultilingualCorpus


class _LanguageBinSampler:
    """Without-replacement sampling within one language's index range, recycling when
    exhausted."""

    def __init__(self, language_indices: range, shuffle: bool, rng: np.random.Generator):
        self._indices = language_indices
        self._shuffle = shuffle
        self._rng = rng
        self._queue: List[int] = []

    def _refill(self) -> None:
        order = np.arange(len(self._indices))
        if self._shuffle:
            self._rng.shuffle(order)
        self._queue = list(order[::-1])

    def sample(self) -> int:
        if not self._queue:
            self._refill()
        return self._indices.start + self._queue.pop()


class LanguageOversamplingSampler:
    """XLS-R-style temperature sampling (Babu et al., 2021): language sampling
    probabilities proportional to ``count**factor``, scaled so the highest-resource
    language is fully covered each epoch."""

    def __init__(
        self,
        corpus: MultilingualCorpus,
        oversampling_factor: float = 0.5,
        shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        rng = rng if rng is not None else np.random.default_rng()
        self._rng = rng
        self._language_bins = []
        utterance_counts = []
        for language in corpus.languages:
            indices = corpus.monolingual_index_range(language)
            self._language_bins.append(_LanguageBinSampler(indices, shuffle, rng))
            utterance_counts.append(len(indices))

        counts = np.asarray(utterance_counts, dtype=np.float64)
        weights = (counts / counts.sum()) ** oversampling_factor
        highest = int(weights.argmax())
        highest_factor = counts[highest] / weights[highest]
        expected_samples = np.round(highest_factor * weights).astype(np.int64)
        self._bin_indices = np.repeat(np.arange(len(expected_samples)), expected_samples)
        self._samples_per_epoch = int(expected_samples.sum())

    def __iter__(self) -> Iterator[int]:
        order = self._rng.permutation(len(self._bin_indices))
        for position in order:
            yield self._language_bins[self._bin_indices[position]].sample()

    def __len__(self) -> int:
        return self._samples_per_epoch


class SequentialSampler:
    def __init__(self, size: int):
        self._size = size

    def __iter__(self) -> Iterator[int]:
        return iter(range(self._size))

    def __len__(self) -> int:
        return self._size


class RandomSampler:
    def __init__(self, size: int, rng: np.random.Generator):
        self._size = size
        self._rng = rng

    def __iter__(self) -> Iterator[int]:
        return iter(self._rng.permutation(self._size).tolist())

    def __len__(self) -> int:
        return self._size


class MaxFrameBatchSampler:
    """Packs indices until the *padded* batch volume would exceed the frame budget.

    ``length_multiple`` is the static length bucket ``build_batch`` will round the
    batch up to; budgeting with the bucketed length (not the raw maximum) keeps the
    materialized array volume within ``batch_size`` frames."""

    def __init__(
        self, sampler, batch_size: int, frame_lengths: np.ndarray, length_multiple: int = 1
    ) -> None:
        self._sampler = sampler
        self._batch_size = batch_size
        self._frame_lengths = np.asarray(frame_lengths)
        self._length_multiple = max(int(length_multiple), 1)

    def __iter__(self) -> Iterator[List[int]]:
        batch_indices: List[int] = []
        max_length = 0
        for index in self._sampler:
            length = _round_up(int(self._frame_lengths[index]), self._length_multiple)
            if length > max_length:
                max_length = length
            if (len(batch_indices) + 1) * max_length > self._batch_size and batch_indices:
                yield batch_indices
                max_length = length
                batch_indices = [index]
            else:
                batch_indices.append(index)
        if batch_indices:
            yield batch_indices


class FixedBatchSampler:
    def __init__(self, sampler, batch_size: int):
        self._sampler = sampler
        self._batch_size = batch_size

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for index in self._sampler:
            batch.append(index)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


class SkipBatchSampler:
    def __init__(self, sampler, skip_count: int) -> None:
        self._sampler = sampler
        self._skip_count = skip_count

    def __iter__(self) -> Iterator[List[int]]:
        iterator = iter(self._sampler)
        for _ in range(self._skip_count):
            next(iterator, None)
        return iterator


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def build_batch(
    samples: Sequence[Sample],
    batch_type: BatchType,
    length_multiple: int = 128,
    pad_batch_to_power_of_two: bool = False,
    label_multiple: int = 8,
    pad_to_length: Optional[int] = None,
    pad_to_batch: Optional[int] = None,
    label_pad: Optional[Dict[str, int]] = None,
) -> Batch:
    """Collates samples into a statically bucketed dense batch. Sequence length is
    rounded up to ``length_multiple``; the batch dimension optionally to a power of
    two with zero-length filler rows (masked out by lengths downstream).

    ``pad_to_length`` / ``pad_to_batch`` / ``label_pad`` override the locally
    derived pad targets — multi-host batching passes *global* targets so every
    process's local slice assembles into one consistently shaped distributed
    array."""
    batch_size = len(samples)
    if pad_to_batch is not None:
        # A global target pins the row count exactly: every process must
        # assemble the same shape, so a fuller process must not round its
        # local slice past the agreed target (and a tail process must not
        # fall short of it).
        if pad_to_batch < batch_size:
            raise ValueError(
                f"Global batch target {pad_to_batch} is smaller than the local slice ({batch_size})"
            )
        padded_batch = pad_to_batch
    elif pad_batch_to_power_of_two and batch_size > 0:
        padded_batch = 1 << (batch_size - 1).bit_length()
    else:
        padded_batch = batch_size

    max_length = max(sample.length for sample in samples)
    padded_length = _round_up(max_length, length_multiple)
    if pad_to_length is not None:
        # The global target may come from approximate header math (MP3 length
        # estimates); what must hold is that the *materialized* bucket fits the
        # longest local sample, not the raw estimate itself.
        global_padded = _round_up(pad_to_length, length_multiple)
        if global_padded < max_length:
            raise ValueError(
                f"Global pad target {pad_to_length} (bucket {global_padded}) is shorter"
                f" than a local sample ({max_length})"
            )
        padded_length = global_padded
    feature_shape = samples[0].features.shape[1:] if samples[0].features.ndim > 1 else ()

    audio = np.zeros((padded_batch, padded_length, *feature_shape), dtype=np.float32)
    lengths = np.zeros(padded_batch, dtype=np.int32)
    language_ids = np.zeros(padded_batch, dtype=np.int32)
    for row, sample in enumerate(samples):
        audio[row, : sample.length] = sample.features
        lengths[row] = sample.length
        language_ids[row] = sample.language_id
    # Filler rows keep the last real language id so allophone gathers stay in
    # range; their length stays 0, which downstream converts into a zero row
    # weight (no loss contribution) before clamping for masking math.
    if padded_batch > batch_size:
        language_ids[batch_size:] = language_ids[batch_size - 1] if batch_size else 0

    if batch_type == BatchType.UNLABELED:
        return Batch(audio, lengths, language_ids)

    if batch_type == BatchType.RAW:
        num_engines = len(samples[0].raw_labels or [[]])
        filler = padded_batch - batch_size
        raw_labels = [
            [sample.raw_labels[engine] for sample in samples] + [[]] * filler
            for engine in range(num_engines)
        ]
        return RawLabeledBatch(
            audio,
            lengths,
            language_ids,
            raw_labels,
            [sample.utterance_id or "" for sample in samples] + [""] * filler,
        )

    # INDEXED: per-attribute padded label arrays with a shared label-length bucket.
    attribute_names = list(samples[0].attribute_indices or {})
    attribute_indices: Dict[str, np.ndarray] = {}
    label_lengths: Dict[str, np.ndarray] = {}
    for name in attribute_names:
        per_sample = [np.asarray(sample.attribute_indices[name]) for sample in samples]
        local_max = max((len(labels) for labels in per_sample), default=1)
        if label_pad is not None:
            local_max = max(local_max, label_pad.get(name, 0))
        max_labels = _round_up(local_max, label_multiple)
        packed = np.zeros((padded_batch, max(max_labels, 1)), dtype=np.int32)
        lengths_array = np.zeros(padded_batch, dtype=np.int32)
        for row, labels in enumerate(per_sample):
            packed[row, : len(labels)] = labels
            lengths_array[row] = len(labels)
        attribute_indices[name] = packed
        label_lengths[name] = lengths_array
    return LabeledBatch(audio, lengths, language_ids, attribute_indices, label_lengths)


# Worker-process state for batch building in worker processes, set once per
# worker by ``_pool_worker_init`` (inherited by fork, so the dataset is never
# pickled — the process-based counterpart of the reference's DataLoader
# workers, reference batching.py:302-311).
_POOL_STATE: dict = {}
# Index batches handed to each worker ahead of the one being read.
_WORKER_AHEAD = 2


def _pool_worker_init(data, length_multiple, pad_batch, label_multiple) -> None:
    # A worker inherits the parent's signal handlers (the train CLI's graceful
    # stop); it only builds batches, so it dies as any process would and the
    # parent decides when to stop.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    _POOL_STATE["data"] = data
    _POOL_STATE["length_multiple"] = length_multiple
    _POOL_STATE["pad_batch"] = pad_batch
    _POOL_STATE["label_multiple"] = label_multiple


def _pool_build_batch(indices: List[int]) -> Batch:
    data = _POOL_STATE["data"]
    samples = [data[index] for index in indices]
    return build_batch(
        samples,
        data.batch_type,
        _POOL_STATE["length_multiple"],
        _POOL_STATE["pad_batch"],
        _POOL_STATE["label_multiple"],
    )


def _pool_worker(connection, initargs) -> None:
    """A worker process: builds the batch of each index list it receives and
    sends back ``(True, batch)``, or ``(False, error)`` if building raised,
    until the parent kills it or is gone."""
    _pool_worker_init(*initargs)
    while True:
        try:
            indices = connection.recv()
        except EOFError:
            return
        try:
            result = (True, _pool_build_batch(indices))
        except BaseException as error:  # re-raised by the parent
            result = (False, error)
        connection.send(result)


def _prefetch(iterator: Iterator, buffer_size: int = 2) -> Iterator:
    """Runs `iterator` in a daemon thread with a bounded queue (overlaps host-side
    feature extraction with device execution)."""
    results: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                results.put(item)
        except BaseException as error:  # propagate worker failures
            results.put(("__error__", error))
        results.put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = results.get()
        if item is sentinel:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item


class Batcher:
    """Generates padded batches in utterance- or frame-budget mode."""

    def __init__(
        self,
        batch_size: int,
        batching_mode: BatchingMode,
        language_oversampling_factor: float | None = None,
        data_workers: int | None = 0,
        length_multiple: int = 128,
        pad_batch_to_power_of_two: bool = False,
        label_multiple: int = 8,
    ):
        self._batch_size = batch_size
        self._batching_mode = batching_mode
        self._language_oversampling_factor = language_oversampling_factor
        # None -> one prefetch thread builds host arrays ahead of the step
        # (the host-to-device copy stays with the caller); N >= 1 -> N forked
        # worker processes build batches (decode + resample + labels +
        # padding) outside the GIL; 0 -> synchronous.
        self._workers = data_workers
        self._prefetch = data_workers is None
        self._length_multiple = length_multiple
        self._pad_batch = pad_batch_to_power_of_two
        self._label_multiple = label_multiple

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def batches(
        self,
        data: PhonemeDataset,
        data_lengths: Optional[np.ndarray] = None,
        shuffle: bool = False,
        seed: Optional[int] = None,
        skip_batches: int = 0,
        process_shard: Optional[tuple] = None,
        shard_multiple: int = 1,
    ) -> Iterator[Batch]:
        """The batches of ``data`` in sampler order; ``skip_batches`` skips the
        first ones (mid-epoch resume). With ``shuffle`` the order is drawn from
        ``seed`` by numpy's generator, as the JAX package draws it, so both
        give the same batches.

        ``process_shard=(process_index, process_count)`` enables multi-process
        loading: every process draws the *same* batch sequence (same seed) but
        materializes audio only for its contiguous row slice, padded to
        globally agreed shapes (the feature frames of ``data_lengths``, by
        ``data.feature_length``). Requires ``data_lengths``. ``shard_multiple`` rounds
        the global batch row count up to a multiple (the total device count)
        with filler rows so every step shards evenly."""
        corpus = data.corpus
        rng = np.random.default_rng(seed)

        if self._language_oversampling_factor is not None:
            sampler = LanguageOversamplingSampler(
                corpus, self._language_oversampling_factor, shuffle, rng
            )
        elif shuffle:
            sampler = RandomSampler(len(corpus), rng)
        else:
            sampler = SequentialSampler(len(corpus))

        if self._batching_mode == BatchingMode.UTTERANCES:
            batch_sampler = FixedBatchSampler(sampler, self._batch_size)
        else:
            if data_lengths is None:
                raise ValueError("Frame lengths for each utterance are required for max frame batching")
            batch_sampler = MaxFrameBatchSampler(
                sampler, self._batch_size, data_lengths, self._length_multiple
            )

        index_batches: Iterable[List[int]] = SkipBatchSampler(batch_sampler, skip_batches)

        if process_shard is not None and process_shard[1] > 1:
            iterator = self._generate_process_slices(
                data, data_lengths, index_batches, process_shard, shard_multiple
            )
            if self._prefetch:
                iterator = _prefetch(iterator)
        elif self._workers and self._workers > 0:
            iterator = self._generate_pooled(data, index_batches)
        else:
            iterator = self._generate_full(data, index_batches)
            if self._prefetch:
                iterator = _prefetch(iterator)
        yield from iterator

    def _generate_pooled(self, data: PhonemeDataset, index_batches) -> Iterator[Batch]:
        """Builds batches in ``self._workers`` forked processes, each joined to
        this one by a pipe of its own: index batch ``k`` goes to worker
        ``k % workers``, which keeps batch order, and every worker holds up to
        ``_WORKER_AHEAD`` batches. The dataset is inherited by fork (never
        pickled); finished batches come back as pickled numpy arrays. The
        workers run numpy and Python only: a CUDA call in a forked child
        fails, so nothing on this path may touch the card. Closing the
        generator (or dropping it) kills the workers; no lock is shared with
        them, so none can be left held (``multiprocessing.Pool.terminate``
        can hang on a worker caught sending a batch)."""
        import collections
        import itertools
        import multiprocessing
        import warnings

        context = multiprocessing.get_context("fork")
        initargs = (data, self._length_multiple, self._pad_batch, self._label_multiple)
        workers = []
        try:
            with warnings.catch_warnings():
                # Python warns that fork in a threaded process can deadlock if
                # the child takes a lock another thread held; the workers take
                # none of the parent's locks (the DataLoader's own contract).
                warnings.filterwarnings("ignore", message=".*fork.*", category=DeprecationWarning)
                warnings.filterwarnings("ignore", message=".*fork.*", category=RuntimeWarning)
                for _ in range(self._workers):
                    connection, child_connection = context.Pipe()
                    process = context.Process(target=_pool_worker, args=(child_connection, initargs), daemon=True)
                    process.start()
                    child_connection.close()
                    workers.append((process, connection))
            index_batches = iter(index_batches)
            pending = collections.deque()
            connections = itertools.cycle([connection for _process, connection in workers])

            def submit(indices) -> None:
                connection = next(connections)
                connection.send(indices)
                pending.append(connection)

            for indices in itertools.islice(index_batches, _WORKER_AHEAD * len(workers)):
                submit(indices)
            while pending:
                built, value = pending.popleft().recv()
                if not built:
                    raise value
                indices = next(index_batches, None)
                if indices is not None:
                    submit(indices)
                yield value
        finally:
            for process, connection in workers:
                process.kill()
            for process, connection in workers:
                process.join()
                connection.close()

    def _generate_full(self, data: PhonemeDataset, index_batches) -> Iterator[Batch]:
        for indices in index_batches:
            samples = [data[index] for index in indices]
            yield build_batch(
                samples, data.batch_type, self._length_multiple, self._pad_batch,
                self._label_multiple,
            )

    def _generate_process_slices(
        self, data: PhonemeDataset, data_lengths, index_batches, process_shard, shard_multiple
    ) -> Iterator[Batch]:
        process_index, process_count = process_shard
        if data_lengths is None:
            raise ValueError(
                "Multi-process batching needs per-utterance frame lengths to agree on"
                " global pad targets without loading every process's audio"
            )
        data_lengths = np.asarray(data_lengths)

        for indices in index_batches:
            # Global row count padded so it splits evenly over processes and
            # devices; filler rows carry zero lengths and are excluded from the
            # loss via row weights downstream.
            global_rows = _round_up(len(indices), max(process_count * shard_multiple, 1))
            local_rows = global_rows // process_count
            start = process_index * local_rows
            local_indices = indices[start : start + local_rows]

            # Global pad targets every process derives identically: audio length
            # from the precomputed length table, label widths from the
            # (audio-free) label path for rows other processes own.
            pad_to_length = max(data.feature_length(data_lengths[index]) for index in indices)
            label_pad: Optional[Dict[str, int]] = None
            if data.batch_type == BatchType.INDEXED:
                local_set = set(local_indices)
                label_pad = {}
                for index in indices:
                    if index in local_set:
                        continue  # counted from the fully loaded samples below
                    for name, labels in data.sample_labels(index).items():
                        label_pad[name] = max(label_pad.get(name, 0), len(labels))

            samples = [data[index] for index in local_indices]
            if samples and label_pad is not None:
                for sample in samples:
                    for name, labels in (sample.attribute_indices or {}).items():
                        label_pad[name] = max(label_pad.get(name, 0), len(labels))
            if not samples:
                # Degenerate tail (fewer rows than processes): materialize one
                # sample as a shape template and turn it into zero-length filler.
                template = data[indices[0]]
                template.features = template.features[:0]
                template.length = 0
                if template.attribute_indices is not None:
                    template.attribute_indices = {
                        name: values[:0] for name, values in template.attribute_indices.items()
                    }
                samples = [template]
            yield build_batch(
                samples,
                data.batch_type,
                self._length_multiple,
                self._pad_batch,
                self._label_multiple,
                pad_to_length=pad_to_length,
                pad_to_batch=local_rows,
                label_pad=label_pad,
            )
