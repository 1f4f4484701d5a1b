"""Utterance traffic: a seeded stream of 16-bit PCM utterances packed into
batches by a frame budget, with phoneme and attribute labels for training.

Each cycle of ``cycle_utterances`` utterances holds the quantiles of the
configured duration distribution in an order of that cycle's own, the same
order for every seed: packing follows arrival order, so every seed offers
the same requests of the same padded shapes, one after another, and seeds
differ only in content (audio, gain, language, labels). The audio of an utterance is
a stretch of one seeded noise pool, scaled by a per-utterance gain and
rounded to 16-bit PCM, then divided by 32768 as a WAV reader gives it.

Packing follows allophant's ``MaxFrameBatchSampler``: utterances join a
batch in arrival order until (rows + 1) x the longest length, rounded up to
``length_multiple``, would pass ``batch_samples``. Each cycle is packed on
its own, so a cycle is a fixed list of requests; a mix with
``replay_cycles`` makes that many cycles in set-up and offers them again
and again (``replayed``), so that a window spends no time making traffic."""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional

import numpy as np

#: Samples of the noise pool the utterances are cut from (about 262 s at 16 kHz).
POOL_SAMPLES = 1 << 22
#: The key of every seed's arrival order (the order depends on the cycle only).
ORDER_KEY = 0x0DE5


@dataclass
class Utterance:
    audio: np.ndarray  # int16 [n]
    language: int
    labels: Optional[Dict[str, np.ndarray]] = None  # head -> label ids (blank offset applied)

    @property
    def length(self) -> int:
        return int(self.audio.shape[0])


@dataclass
class Request:
    """One batch as the program receives it."""

    index: int
    audio: np.ndarray  # float32 [B, S], zero padded
    lengths: np.ndarray  # int32 [B]
    language_ids: np.ndarray  # int32 [B]
    labels: Optional[Dict[str, np.ndarray]] = None  # head -> int32 [B, N]
    label_lengths: Optional[Dict[str, np.ndarray]] = None  # head -> int32 [B]

    @property
    def real_samples(self) -> int:
        return int(self.lengths.sum())


def _seed_words(seed: int) -> List[int]:
    """A non-negative seed sequence of any integer (NumPy's SeedSequence
    takes no negative entropy)."""
    return [int(seed) % (1 << 64), 0x5EED]


def durations_s(params: dict) -> np.ndarray:
    """The cycle's durations in seconds: the distribution's quantiles at
    (i + 1/2) / N, clipped to [min, max]."""
    spec = params["duration_s"]
    count = int(params["cycle_utterances"])
    if spec["distribution"] != "lognormal":
        raise ValueError(f"unknown duration distribution {spec['distribution']!r}")
    normal = NormalDist()
    quantiles = np.array([normal.inv_cdf((index + 0.5) / count) for index in range(count)])
    values = np.exp(math.log(spec["median"]) + spec["sigma"] * quantiles)
    return np.clip(values, spec["min"], spec["max"])


class UtteranceStream:
    """The endless utterance stream of one seed."""

    def __init__(self, params: dict, seed: int, head: Optional[dict] = None):
        self.params = params
        self.seed = seed
        self.head = head
        self.sample_rate = int(params["sample_rate"])
        self.lengths = np.rint(durations_s(params) * self.sample_rate).astype(np.int64)
        pool_rng = np.random.default_rng(_seed_words(seed) + [1])
        amplitude = params["amplitude"]
        pool = pool_rng.standard_normal(POOL_SAMPLES, dtype=np.float32) * np.float32(amplitude["rms"] * 32768.0)
        self.pool = np.concatenate([pool, pool[: int(self.lengths.max())]])

    def cycle(self, index: int) -> Iterator[Utterance]:
        params = self.params
        order = np.random.default_rng([ORDER_KEY, index]).permutation(len(self.lengths))
        rng = np.random.default_rng(_seed_words(self.seed) + [2, index])
        spread = params["amplitude"]["spread"]
        for position in order:
            length = int(self.lengths[position])
            offset = int(rng.integers(0, POOL_SAMPLES))
            gain = float(np.exp(spread * rng.standard_normal()))
            pcm = np.clip(np.rint(self.pool[offset : offset + length] * gain), -32768, 32767).astype(np.int16)
            language = int(rng.integers(0, params["languages"]))
            labels = None
            if self.head is not None and "labels_per_second" in params:
                labels = self._labels(rng, language, length)
            yield Utterance(pcm, language, labels)

    def _labels(self, rng: np.random.Generator, language: int, length: int) -> Dict[str, np.ndarray]:
        """Phonemes drawn from the language's inventory at ``labels_per_second``,
        and each head's labels: those phonemes' ids in the head's table."""
        table = self.head["label_table"]  # [P, H], blank offset applied
        inventory = np.flatnonzero(self.head["inventories"][language])
        count = max(1, int(round(self.params["labels_per_second"] * length / self.sample_rate)))
        phonemes = inventory[rng.integers(0, len(inventory), count)]
        return {name: table[phonemes, column].astype(np.int32) for column, name in enumerate(self.head["heads"])}

    def __iter__(self) -> Iterator[Utterance]:
        index = 0
        while True:
            yield from self.cycle(index)
            index += 1


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def pack(utterances: Iterator[Utterance], params: dict) -> Iterator[List[Utterance]]:
    """Batches of utterances in arrival order by the frame budget."""
    budget = int(params["batch_samples"])
    multiple = int(params.get("length_multiple", 1))
    batch: List[Utterance] = []
    longest = 0
    for utterance in utterances:
        length = _round_up(utterance.length, multiple)
        candidate = max(longest, length)
        if batch and (len(batch) + 1) * candidate > budget:
            yield batch
            batch, candidate = [], length
        batch.append(utterance)
        longest = candidate
    if batch:
        yield batch


def collate(index: int, batch: List[Utterance], params: dict) -> Request:
    """The padded request of a batch: audio to the longest row rounded up to
    ``length_multiple``, labels to the longest rounded up to
    ``label_multiple``."""
    multiple = int(params.get("length_multiple", 1))
    width = _round_up(max(item.length for item in batch), multiple)
    audio = np.zeros((len(batch), width), dtype=np.float32)
    for row, item in enumerate(batch):
        audio[row, : item.length] = item.audio.astype(np.float32) / np.float32(32768.0)
    lengths = np.array([item.length for item in batch], dtype=np.int32)
    languages = np.array([item.language for item in batch], dtype=np.int32)
    labels = label_lengths = None
    if batch[0].labels is not None:
        label_multiple = int(params.get("label_multiple", 1))
        labels, label_lengths = {}, {}
        for name in batch[0].labels:
            sizes = np.array([len(item.labels[name]) for item in batch], dtype=np.int32)
            padded = np.zeros((len(batch), _round_up(int(sizes.max()), label_multiple)), dtype=np.int32)
            for row, item in enumerate(batch):
                padded[row, : sizes[row]] = item.labels[name]
            labels[name], label_lengths[name] = padded, sizes
    return Request(index, audio, lengths, languages, labels, label_lengths)


def cycles(params: dict, seed: int, head: Optional[dict] = None) -> Iterator[List[Request]]:
    """The seed's endless cycles, each the list of its packed requests."""
    stream = UtteranceStream(params, seed, head)
    number = 0
    for index in itertools.count():
        out = []
        for batch in pack(stream.cycle(index), params):
            out.append(collate(number, batch, params))
            number += 1
        yield out


def requests(params: dict, seed: int, head: Optional[dict] = None) -> Iterator[Request]:
    """The seed's endless stream of requests (one packed batch each)."""
    for cycle in cycles(params, seed, head):
        yield from cycle


def replayed(params: dict, seed: int, head: Optional[dict] = None) -> Iterator[Request]:
    """The seed's first ``replay_cycles`` cycles, made now and then offered
    in order again and again."""
    made = [request for cycle in itertools.islice(cycles(params, seed, head), int(params["replay_cycles"])) for request in cycle]
    return itertools.cycle(made)


def warmup_requests(params: dict, seed: int, head: Optional[dict] = None) -> List[Request]:
    """One full request at the longest length of each distinct padded width
    that the stream's packing can produce for the program's shape buckets:
    the shortest and longest utterances of the cycle, and the lengths
    between them at every ``length_multiple`` (or power of two, for
    serving's buckets)."""
    sample_rate = int(params["sample_rate"])
    cycle = np.rint(durations_s(params) * sample_rate).astype(np.int64)
    budget = int(params["batch_samples"])
    multiple = int(params.get("length_multiple", 1))
    if multiple > 1:
        widths = sorted({_round_up(int(value), multiple) for value in cycle})
    else:
        widths = sorted({int(value) for value in _bucket_edges(int(cycle.min()), int(cycle.max()))})
    stream = UtteranceStream(params, seed, head)
    template = next(iter(stream))
    out = []
    for index, width in enumerate(widths):
        rows = max(1, budget // _round_up(width, multiple))
        batch = []
        for row in range(rows):
            audio = np.resize(template.audio, width)
            labels = None
            if template.labels is not None:
                labels = stream._labels(np.random.default_rng([index, row]), template.language, width)
            batch.append(Utterance(audio, template.language, labels))
        out.append(collate(-1 - index, batch, params))
    return out


def _bucket_edges(shortest: int, longest: int) -> List[int]:
    """The longest length of each serving bucket that lengths from
    ``shortest`` to ``longest`` fall in: powers of two up to 65,536 samples,
    then multiples of 32,768 (the estimator's bucketing)."""
    tops = [1 << power for power in range(10, 17)]
    tops += list(range(65_536 + 32_768, longest + 32_768, 32_768))
    first = next(top for top in tops if top >= shortest)
    return [top for top in tops if first <= top < longest] + [longest]
