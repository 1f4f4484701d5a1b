"""The port's Common Voice reading (allophant_tpu_torch/data/common_voice.py,
corpus_loading, MP3 audio) and its batch-building worker processes and
process slices (data/batching.py) against the JAX package's, on the corpus
``tests/fixtures.py:build_cv_corpus`` writes (2 languages, msgpack corpus
files, WAV or MP3 clips): transcriptions, inventories and audio equal;
corpus files read and written byte for byte through the port's codec and
its extension hooks; raw TSV splits loaded as JAX loads them; batches built
by 2 worker processes equal to the synchronous ones and to JAX's, and each
process's slice of a global batch equal to JAX's."""

import csv
import signal

import msgpack
import numpy as np
import pytest

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.data import common_voice as jax_common_voice
from allophant_tpu.data import corpus_loading as jax_corpus_loading
from allophant_tpu.data import csv_validator as jax_csv_validator
from allophant_tpu.data.batching import Batcher as JaxBatcher
from allophant_tpu.native import audio_codecs as jax_audio_codecs
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training.run import DatasetManager as JaxDatasetManager
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.data import batching, common_voice, corpus_loading, csv_validator
from allophant_tpu_torch.data.batching import Batcher
from allophant_tpu_torch.native import audio_codecs
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.training import msgpack_codec
from allophant_tpu_torch.training.run import DatasetManager

from fixtures import build_cv_corpus, mini_allophoible_csv, mini_config_dict
from test_torch_data import _assert_batches_equal

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SPLITS = (("train", 4), ("dev", 2), ("test", 1))


@pytest.fixture(scope="module", params=["wav", "mp3"])
def corpus_root(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"cv-{request.param}")
    build_cv_corpus(str(root), SPLITS, audio_format=request.param)
    return root


def test_corpus_equals_jax(corpus_root):
    ours = corpus_loading.load_corpus(str(corpus_root), "common-voice", 16000, ["es", "it"])
    theirs = jax_corpus_loading.load_corpus(str(corpus_root), "common-voice", 16000, ["es", "it"])
    for split, jax_split in zip(ours, theirs):
        assert type(split).__name__ == "CommonVoiceCorpus" and split.languages == jax_split.languages
        assert len(split) == len(jax_split) > 0
        assert vars(split.audio_info) == vars(jax_split.audio_info)
        for language, jax_language in zip(split, jax_split):
            assert vars(language.info) == vars(jax_language.info)
            for ours_entry, theirs_entry in zip(language.transcribed_samples, jax_language.transcribed_samples):
                assert type(ours_entry).__name__ == type(theirs_entry).__name__ == "Transcription"
                assert ours_entry._fields() == theirs_entry._fields()
                assert ours_entry.phonemes.to_json() == theirs_entry.phonemes.to_json()
        for index in range(len(split)):
            assert split.path(index) == jax_split.path(index)
            waveform, rate = split.audio(index)
            jax_waveform, jax_rate = jax_split.audio(index)
            assert rate == jax_rate
            np.testing.assert_array_equal(waveform, jax_waveform)
        assert [list(lengths) for _, lengths in split.read_lengths()] == [list(lengths) for _, lengths in jax_split.read_lengths()]


def test_single_split_path_and_language_selection(corpus_root):
    ours = corpus_loading.load_corpus(str(corpus_root / "dev_transcriptions.bin"), "common-voice", None, ["it"])
    theirs = jax_corpus_loading.load_corpus(str(corpus_root / "dev_transcriptions.bin"), "common-voice", None, ["it"])
    assert ours.dev.languages == theirs.dev.languages == ["it"]
    assert [entry.utterance_id for entry in ours.dev.monolingual_subset("it")] == [
        entry.utterance_id for entry in theirs.dev.monolingual_subset("it")
    ]
    with pytest.raises(ValueError, match="not a valid transcription path"):
        corpus_loading.load_corpus(str(corpus_root / "train_inventories.json"), "common-voice")


def test_corpus_files_are_written_byte_for_byte(corpus_root, tmp_path):
    """The port rewrites JAX-written corpus files identically, and JAX reads
    what the port writes."""
    for split, _count in SPLITS:
        corpus = common_voice.CommonVoiceCorpus.from_file(str(corpus_root), split)
        corpus.save(str(corpus_root), split, str(tmp_path))
        for pattern in (common_voice.CommonVoiceCorpus.TRANSCRIPTION_PATTERN, common_voice.CommonVoiceCorpus.INVENTORY_PATTERN):
            name = pattern.format(split=split)
            assert (tmp_path / name).read_bytes() == (corpus_root / name).read_bytes(), name
    assert (tmp_path / ".corpus_path").read_text(encoding="utf-8") == str(corpus_root)
    jax_splits = jax_common_voice.CommonVoiceSplits.from_file(str(tmp_path))
    assert jax_splits.train.languages == ["es", "it"]


class _Record:
    def __init__(self, data: bytes):
        self.data = data


def test_codec_extension_hooks_match_msgpack():
    """``packb(default=...)`` and ``unpackb(ext_hook=...)`` write and read
    extension records as msgpack's own hooks do."""
    value = {"items": [1, "x", {"nested": None}], "records": [_Record(b"\x00\x01"), 2.5, b"raw"]}
    packed = msgpack.packb(value, default=lambda record: msgpack.ExtType(4, record.data), use_bin_type=True)
    assert msgpack_codec.packb(value, default=lambda record: msgpack_codec.ExtType(4, record.data)) == packed
    seen = []
    decoded = msgpack_codec.unpackb(packed, ext_hook=lambda code, data: seen.append(code) or data[::-1])
    assert decoded == msgpack.unpackb(packed, ext_hook=lambda code, data: data[::-1], raw=False)
    assert decoded == {"items": [1, "x", {"nested": None}], "records": [b"\x01\x00", 2.5, b"raw"]} and seen == [4]
    with pytest.raises(ValueError, match="Unknown msgpack extension"):
        msgpack_codec.unpackb(packed)
    with pytest.raises(TypeError):
        msgpack_codec.packb(value)


def _write_tsv_corpus(root):
    """Raw Common Voice TSVs: per language a ``train.tsv``, ``dev.tsv``,
    ``test.tsv`` and an ``other.tsv`` whose rows carry votes."""
    header = ["client_id", "path", "sentence", "up_votes", "down_votes", "age", "gender", "accents", "locale", "segment"]
    for language in ("es", "it"):
        (root / language).mkdir(parents=True)
        for split, rows in (("train", 3), ("dev", 2), ("test", 1), ("other", 4)):
            with open(root / language / f"{split}.tsv", "w", encoding="utf-8", newline="") as file:
                writer = csv.writer(file, delimiter="\t", quoting=csv.QUOTE_NONE, lineterminator="\n")
                writer.writerow(header)
                for index in range(rows):
                    writer.writerow(
                        [f"client{index}", f"{language}_{split}_{index}.mp3", f"sentence {index}", index, 1,
                         "" if index % 2 else "twenties", "" if index else "female", "", language, ""]
                    )


def test_raw_splits_load_as_jax_loads_them(tmp_path):
    _write_tsv_corpus(tmp_path)
    for kwargs in ({}, {"include_single_upvote_other": True, "training_limits": 4}):
        ours = common_voice.load_common_voice(str(tmp_path), languages=["es", "it"], **kwargs)
        theirs = jax_common_voice.load_common_voice(str(tmp_path), languages=["es", "it"], **kwargs)
        for split, jax_split in zip(ours, theirs):
            assert split.languages == jax_split.languages
            for language, jax_language in zip(split, jax_split):
                assert vars(language.info) == vars(jax_language.info)
                assert [entry._fields() for entry in language.transcribed_samples] == [
                    entry._fields() for entry in jax_language.transcribed_samples
                ]
    # An object that is no G2P engine fails alike in both packages.
    for module in (common_voice, jax_common_voice):
        with pytest.raises(AttributeError, match="supports"):
            module.load_common_voice(str(tmp_path), g2p_engine=object(), languages=["es"])
    schema, jax_schema = csv_validator.make_schema(common_voice._CommonVoiceEntry), jax_csv_validator.make_schema(jax_common_voice._CommonVoiceEntry)
    cells = ["c", "a.mp3", "s", "3", "0", "", "male", "", "es", ""]
    assert vars(schema.convert_line(cells)) == vars(jax_schema.convert_line(cells))


def test_mp3_decoding_equals_jax(tmp_path):
    samples = np.random.default_rng(1).uniform(-0.3, 0.3, 4000).astype(np.float32)
    path = str(tmp_path / "clip.mp3")
    audio_codecs.encode_mp3(path, samples, 16000)
    jax_path = str(tmp_path / "jax.mp3")
    jax_audio_codecs.encode_mp3(jax_path, samples, 16000)
    assert open(path, "rb").read() == open(jax_path, "rb").read()
    decoded, rate = audio_codecs.decode_mp3(path)
    expected, expected_rate = jax_audio_codecs.decode_mp3(path)
    assert rate == expected_rate == 16000
    np.testing.assert_array_equal(decoded, expected)


def _managers(corpus_root, data_workers):
    config_dict = mini_config_dict(model_type="wav2vec2-pretrained")
    config_dict["nn"].update(batching_mode="utterances", batch_size=3)
    config_dict["data"]["languages"] = ["es", "it"]
    managers = []
    for config_class, indexer_class, manager_class, loading, workers in (
        (Config, PhoneticAttributeIndexer, DatasetManager, corpus_loading, data_workers),
        (JaxConfig, JaxIndexer, JaxDatasetManager, jax_corpus_loading, 0),
    ):
        config = config_class.load(config_dict)
        splits = loading.load_corpus(str(corpus_root), "common-voice", 16000, ["es", "it"])
        indexer = indexer_class.from_config(config, mini_allophoible_csv(), splits.train.language_id_inventories())
        managers.append(manager_class.from_config(config, splits, indexer, 16000, data_workers=workers))
    return managers


def test_worker_processes_build_the_synchronous_batches(corpus_root):
    ours, theirs = _managers(corpus_root, 2)
    pooled = list(ours.training_batches(seed=3))
    ours.data_workers = 0
    _assert_batches_equal(pooled, list(ours.training_batches(seed=3)))
    _assert_batches_equal(pooled, list(theirs.training_batches(seed=3)))
    ours.data_workers = 2
    _assert_batches_equal(list(ours.validation_batches()), list(theirs.validation_batches()))


def test_worker_pool_ends_with_its_generator(corpus_root):
    """Closing the batch generator mid-epoch terminates the workers; they
    run with the default SIGTERM and SIGINT handlers, whatever the parent
    installed."""
    ours, _ = _managers(corpus_root, 2)
    previous = signal.signal(signal.SIGTERM, lambda *_: None)
    try:
        batches = ours.training_batches(seed=3)
        next(batches)
        import multiprocessing

        children = multiprocessing.active_children()
        assert len(children) == 2
        batches.close()
        for child in children:
            child.join(timeout=10)
            assert not child.is_alive()
    finally:
        signal.signal(signal.SIGTERM, previous)
    handlers = {signum: signal.signal(signum, lambda *_: None) for signum in (signal.SIGTERM, signal.SIGINT)}
    try:
        batching._pool_worker_init(None, 1, False, 1)
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL and signal.getsignal(signal.SIGINT) is signal.SIG_DFL
    finally:
        for signum, handler in handlers.items():
            signal.signal(signum, handler)


@pytest.mark.parametrize("process_index", [0, 1])
def test_process_slices_equal_jax(corpus_root, process_index):
    ours, theirs = _managers(corpus_root, 0)
    results = []
    for batcher_class, manager in ((Batcher, ours), (JaxBatcher, theirs)):
        batcher = batcher_class(4, manager.config.nn.batching_mode, data_workers=0, length_multiple=128, label_multiple=8)
        results.append(list(batcher.batches(manager.train_dataset, manager.train_lengths, shuffle=True, seed=5, process_shard=(process_index, 2), shard_multiple=2)))
    _assert_batches_equal(*results)
    assert all(len(batch) == 2 for batch in results[0])
