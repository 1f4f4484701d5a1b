"""The port's data pipeline against the JAX package's: WAV loading and sinc
resampling, the UCLA corpus, the feature functions, dataset samples and the
Batcher's batches (order, padding, lengths, labels), integer-equal in both
batching modes for two seeds, with and without language oversampling. Both
read the same synthetic UCLA-format corpus written here."""

import wave

import numpy as np
import pytest

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.data import audio as jax_audio
from allophant_tpu.data.preprocessing import FeatureFunction as JaxFeatureFunction
from allophant_tpu.data.speech_corpus import MultilingualSplits as JaxSplits
from allophant_tpu.data.ucla import UCLAPhoneticCorpus as JaxUCLA
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training.run import DatasetManager as JaxDatasetManager
from allophant_tpu.training.run import stack_microbatches as jax_stack_microbatches
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.data import audio
from allophant_tpu_torch.data.batch import LabeledBatch
from allophant_tpu_torch.data.preprocessing import FeatureFunction
from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.training.run import DatasetManager, stack_microbatches

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

PHONEMES = {"spa": ["a", "e", "t", "n", "s", "k"], "ita": ["a", "i", "s", "t", "o", "d"]}


def write_wav(path, samples: np.ndarray, rate: int = 16000):
    data = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as file:
        file.setnchannels(1)
        file.setsampwidth(2)
        file.setframerate(rate)
        file.writeframes(data.tobytes())


def write_ucla_corpus(root, utterances: int, seed: int, rates=(16000, 8000), samples=None):
    """A UCLA-format corpus: per language ``utterances`` WAVs of seeded noise
    (the second language at ``rates[1]``, so it is resampled) of 0.1-0.6 s
    (or ``samples`` each), each transcribed with a seeded phoneme sequence
    from PHONEMES."""
    rng = np.random.default_rng(seed)
    for (language, phonemes), rate in zip(PHONEMES.items(), rates):
        base = root / language
        (base / "audio").mkdir(parents=True)
        with open(base / "inventory", "w", encoding="utf-8") as file:
            file.writelines(f"{phoneme} 5\n" for phoneme in phonemes)
        with open(base / "raw", "w", encoding="utf-8") as raw, open(base / "text", "w", encoding="utf-8") as text:
            for index in range(utterances):
                utterance = f"{language}_{index}"
                raw.write(f"{utterance} rawform\n")
                text.write(f"{utterance} {' '.join(rng.choice(phonemes, int(rng.integers(2, 9))))}\n")
                length = int(rng.integers(rate // 10, 6 * rate // 10)) if samples is None else samples
                write_wav(base / "audio" / f"{utterance}.wav", rng.uniform(-0.5, 0.5, length), rate)
    return root


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    return write_ucla_corpus(tmp_path_factory.mktemp("ucla"), 7, seed=4)


def test_wav_loading_and_resampling_equal_jax(corpus_root):
    for path in sorted(corpus_root.rglob("*.wav"))[::3]:
        for rate in (None, 16000, 22050):
            ours, our_rate = audio.load_audio(str(path), rate)
            theirs, their_rate = jax_audio.load_audio(str(path), rate)
            assert our_rate == their_rate
            np.testing.assert_array_equal(ours, theirs)
        assert audio.probe_duration(str(path)) == jax_audio.probe_duration(str(path))
        duration, file_rate = audio.probe_duration(str(path))
        assert audio.estimated_resampled_length(duration, file_rate, 16000) == jax_audio.estimated_resampled_length(
            duration, file_rate, 16000
        )


def test_ucla_corpus_equals_jax(corpus_root):
    ours = UCLAPhoneticCorpus.load(str(corpus_root), resample=16000)
    theirs = JaxUCLA.load(str(corpus_root), resample=16000)
    assert len(ours) == len(theirs) and ours.languages == theirs.languages
    for index in range(len(ours)):
        a, b = ours[index], theirs[index]
        assert a.language_id == b.language_id and repr(a.entry) == repr(b.entry)
        (audio_a, rate_a), (audio_b, rate_b) = ours.audio(index), theirs.audio(index)
        assert rate_a == rate_b
        np.testing.assert_array_equal(audio_a, audio_b)
    assert [(language, list(lengths)) for language, lengths in ours.read_lengths()] == [
        (language, list(lengths)) for language, lengths in theirs.read_lengths()
    ]
    assert ours.language_id_inventories().inventories == theirs.language_id_inventories().inventories


@pytest.mark.parametrize("feature_type", ["RAW", "MFCC", "FILTERBANKS"])
def test_feature_functions_equal_jax(corpus_root, feature_type):
    config_dict = mini_config_dict(model_type="wav2vec2-pretrained")
    config_dict["preprocessing"] = {"feature_type": feature_type, "resample": 16000}
    if feature_type != "RAW":
        config_dict["preprocessing"]["window"] = {"frame_duration": 25, "frame_stride": 10}
    ours = FeatureFunction.from_config(Config.load(config_dict), 16000)
    theirs = JaxFeatureFunction.from_config(JaxConfig.load(config_dict), 16000)
    assert ours.feature_size == theirs.feature_size
    waveform, _ = audio.load_audio(str(sorted(corpus_root.rglob("*.wav"))[0]), 16000)
    np.testing.assert_array_equal(ours(waveform), theirs(waveform))
    assert ours.frame_count(12345) == theirs.frame_count(12345)


def _managers(corpus_root, **nn):
    config_dict = mini_config_dict(model_type="wav2vec2-pretrained")
    config_dict["nn"].update(nn)
    table = mini_allophoible_csv()
    managers = []
    for config_class, corpus_class, splits_class, indexer_class, manager_class in (
        (Config, UCLAPhoneticCorpus, MultilingualSplits, PhoneticAttributeIndexer, DatasetManager),
        (JaxConfig, JaxUCLA, JaxSplits, JaxIndexer, JaxDatasetManager),
    ):
        config = config_class.load(config_dict)
        corpus = corpus_class.load(str(corpus_root), resample=16000)
        splits = splits_class.single(corpus, "train")
        splits.dev = corpus
        indexer = indexer_class.from_config(config, table)
        managers.append(manager_class.from_config(config, splits, indexer, length_multiple=128, label_multiple=8))
    return managers


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) and len(ours) > 1
    for a, b in zip(ours, theirs):
        assert isinstance(a, LabeledBatch)
        np.testing.assert_array_equal(a.audio_features, b.audio_features)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_array_equal(a.language_ids, b.language_ids)
        assert list(a.attribute_indices) == list(b.attribute_indices)
        for name in a.attribute_indices:
            np.testing.assert_array_equal(a.attribute_indices[name], b.attribute_indices[name], err_msg=name)
            np.testing.assert_array_equal(a.label_lengths[name], b.label_lengths[name], err_msg=name)


@pytest.mark.parametrize(
    "settings",
    [
        {"batching_mode": "utterances", "batch_size": 3},
        {"batching_mode": "frames", "batch_size": 24000},
        {"batching_mode": "utterances", "batch_size": 4, "language_oversampling_factor": 0.5},
    ],
    ids=["utterances", "frames", "oversampling"],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_batches_equal_jax(corpus_root, settings, seed):
    ours, theirs = _managers(corpus_root, **settings)
    assert ours.split_batch_size == theirs.split_batch_size
    np.testing.assert_array_equal(ours.train_lengths, theirs.train_lengths)
    _assert_batches_equal(list(ours.training_batches(seed=seed)), list(theirs.training_batches(seed=seed)))
    _assert_batches_equal(list(ours.training_batches(seed=seed, skip_batches=1)), list(theirs.training_batches(seed=seed, skip_batches=1)))
    _assert_batches_equal(list(ours.validation_batches()), list(theirs.validation_batches()))


def test_stacked_microbatches_equal_jax(corpus_root):
    ours, theirs = _managers(corpus_root, batching_mode="utterances", batch_size=3)
    group, jax_group = list(ours.training_batches(seed=0))[:2], list(theirs.training_batches(seed=0))[:2]
    stacked, jax_stacked = stack_microbatches(group), jax_stack_microbatches(jax_group)
    assert list(stacked) == list(jax_stacked)
    for key, value in jax_stacked.items():
        np.testing.assert_array_equal(stacked[key], value, err_msg=key)
        assert stacked[key].dtype == value.dtype, key


def test_prefetch_thread_gives_the_synchronous_batches(corpus_root):
    ours, _ = _managers(corpus_root, batching_mode="utterances", batch_size=3)
    ours.data_workers = 0
    synchronous = list(ours.training_batches(seed=3))
    ours.data_workers = None
    _assert_batches_equal(list(ours.training_batches(seed=3)), synchronous)
