"""The traffic generator: seeded, the same work for every seed, allophant's
packing rule, 16-bit PCM, labels from the inventories."""

import numpy as np
import pytest

from cardbench.core import registry

KIND = registry.traffic_kind("utterances")
HEAD = registry.head("allophant-demo")


def take(params, seed, count, head=None):
    stream = KIND.requests(params, seed, head)
    return [next(stream) for _ in range(count)]


@pytest.mark.parametrize("name", ["cv-greedy", "cv-beam4", "cv-train"])
def test_same_seed_same_traffic(name):
    params = registry.traffic(name)
    head = HEAD if params["task"] == "train" else None
    first, second = take(params, 2**31 + 11, 6, head), take(params, 2**31 + 11, 6, head)
    for a, b in zip(first, second):
        assert np.array_equal(a.audio, b.audio) and np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.language_ids, b.language_ids)
    other = take(params, 2**31 + 12, 6, head)
    assert not all(np.array_equal(a.audio, b.audio) for a, b in zip(first, other))


def test_every_seed_offers_the_same_lengths():
    params = registry.traffic("cv-greedy")
    cycles = []
    for seed in (3, 2**40 + 1, 2**31 + 7):
        stream = KIND.UtteranceStream(params, seed)
        cycles.append([item.length for item in stream.cycle(0)])
    assert cycles[0] == cycles[1] == cycles[2]
    assert cycles[0] != [item.length for item in KIND.UtteranceStream(params, 3).cycle(1)]
    assert len(cycles[0]) == params["cycle_utterances"]
    seconds = np.array(sorted(cycles[0])) / params["sample_rate"]
    assert seconds.min() >= params["duration_s"]["min"] and seconds.max() <= params["duration_s"]["max"]
    assert abs(np.median(seconds) - params["duration_s"]["median"]) < 0.05


@pytest.mark.parametrize("name", ["cv-greedy", "cv-train"])
def test_packing_rule(name):
    params = registry.traffic(name)
    head = HEAD if params["task"] == "train" else None
    multiple = params.get("length_multiple", 1)
    budget = params["batch_samples"]
    stream = KIND.UtteranceStream(params, 5, head)
    utterances = [item for _, item in zip(range(300), iter(stream))]
    batches = list(KIND.pack(iter(utterances), params))[:-1]
    flat = [item for batch in batches for item in batch]
    assert [item.length for item in flat] == [item.length for item in utterances[: len(flat)]]
    position = 0
    for batch in batches:
        widths = [-(-item.length // multiple) * multiple for item in batch]
        assert len(batch) * max(widths) <= budget
        following = utterances[position + len(batch)]
        grown = max(widths + [-(-following.length // multiple) * multiple])
        assert (len(batch) + 1) * grown > budget
        position += len(batch)


def test_audio_is_16_bit_pcm():
    request = take(registry.traffic("cv-greedy"), 9, 1)[0]
    scaled = request.audio * 32768.0
    assert np.array_equal(scaled, np.rint(scaled)) and scaled.min() >= -32768 and scaled.max() <= 32767
    for row, length in enumerate(request.lengths):
        assert not request.audio[row, length:].any()


def test_labels_come_from_the_inventories():
    params = registry.traffic("cv-train")
    request = take(params, 4, 1, HEAD)[0]
    table = HEAD["label_table"]
    for row, language in enumerate(request.language_ids):
        phonemes = request.labels["phoneme"][row, : request.label_lengths["phoneme"][row]] - 1
        assert HEAD["inventories"][language][phonemes].all()
        seconds = request.lengths[row] / params["sample_rate"]
        assert len(phonemes) == max(1, round(params["labels_per_second"] * seconds))
        for column, name in enumerate(HEAD["heads"]):
            assert np.array_equal(request.labels[name][row, : len(phonemes)], table[phonemes, column])
    assert request.labels["stress"].shape[1] % params["label_multiple"] == 0


def test_warmup_covers_every_padded_width():
    params = registry.traffic("cv-greedy")
    widths = [request.audio.shape[1] for request in KIND.warmup_requests(params, 3)]
    assert widths == [32768, 65536, 98304, 131072, 160000]
    for request in KIND.warmup_requests(params, 3):
        assert len(request.lengths) * request.audio.shape[1] <= params["batch_samples"]


def test_replay_offers_the_first_cycles_again():
    params = dict(registry.traffic("cv-greedy"), cycle_utterances=24)
    seed = 2**31 + 3
    made = [request for _, cycle in zip(range(params["replay_cycles"]), KIND.cycles(params, seed)) for request in cycle]
    assert sum(len(request.lengths) for request in made) == 24 * params["replay_cycles"]
    assert [r.lengths.tolist() for r in made] == [r.lengths.tolist() for r in take(params, seed, len(made))]
    offered = KIND.replayed(params, seed)
    again = [next(offered) for _ in range(2 * len(made))]
    for a, b in zip(again, made * 2):
        assert np.array_equal(a.audio, b.audio) and np.array_equal(a.lengths, b.lengths)
