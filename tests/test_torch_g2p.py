"""The port's transcription plumbing (``data/g2p.py``, Common Voice's writing
half, ``cli/data.py``'s ``transcribe`` and ``download-meta``) against the JAX
package's. eSpeak NG (through phonemizer), Epitran and the stanza tokenizer
are not installed: fake modules are put into ``sys.modules``, where both
packages import them lazily, so the same fake engines run in both. The
transcribed corpus files and inventories must be byte-equal, with and
without the remapping of the inventories onto the feature table; the
release metadata is fetched through a patched ``urlopen``."""

import io
import json
import sys
import types

import pytest

from allophant_tpu.cli import data as jax_cli_data
from allophant_tpu.data import common_voice as jax_common_voice
from allophant_tpu.data import g2p as jax_g2p
from allophant_tpu_torch.cli import data as cli_data
from allophant_tpu_torch.data import common_voice, g2p

from fixtures import mini_allophoible_csv
from test_torch_common_voice import _write_tsv_corpus

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

INVENTORY = ["s", "e", "n", "t", "k", "o", "u", "i", "a", "x", "y", "ʃ"]
# The fake eSpeak's phones of a sentence's characters: phonemes of the test
# feature table's inventories.
PHONES = str.maketrans({"c": "k", "0": "o", "1": "u", "2": "i", "3": "a"})


class _FakeEspeakBackend:
    """Phonemizes a sentence into phones of its characters; sentences ending
    in "1" switch to English for two phones, and the first "s" becomes
    eSpeak's "S", which the replacement table maps to "ʃ"."""

    def __init__(self, language, language_switch=None, with_stress=False, logger=None):
        self.language = language

    @staticmethod
    def supported_languages():
        return {"es": "Spanish", "it": "Italian", "en-us": "English"}

    def phonemize(self, sentences, separator):
        phonemized = []
        for sentence in sentences:
            phones = " ".join(character for character in sentence.translate(PHONES) if character != " ")
            if sentence.endswith("1"):
                phones += " (en)x y"
            phonemized.append(phones.replace("s", "S", 1))
        return phonemized


class _FakeEpitran:
    def __init__(self, code, cedict_file=None, tones=False):
        self.code = code

    def trans_list(self, word):
        return list(word)


class _FakePipeline:
    """stanza's tokenizer: whitespace words."""

    def __init__(self, language, **options):
        self.language = language

    def __call__(self, sentences):
        return types.SimpleNamespace(
            sentences=[
                types.SimpleNamespace(words=[types.SimpleNamespace(text=word) for word in sentence.split()])
                for sentence in sentences
            ]
        )


@pytest.fixture
def fake_engines(monkeypatch):
    modules = {name: types.ModuleType(name) for name in ("phonemizer", "phonemizer.backend", "phonemizer.separator", "epitran", "epitran.backoff", "stanza", "stanza.resources", "stanza.resources.common")}
    modules["phonemizer.backend"].EspeakBackend = _FakeEspeakBackend
    modules["phonemizer.separator"].Separator = lambda word="", phone=" ": types.SimpleNamespace(word=word, phone=phone)
    modules["epitran"].Epitran = _FakeEpitran
    modules["epitran"].meta = types.SimpleNamespace(
        get_default_mode=lambda code: {"spa": "spa-Latn", "ita": "ita-Latn"}.get(code),
        supported_lang=lambda code: code in ("spa", "ita"),
    )
    modules["stanza"].Pipeline = _FakePipeline
    modules["stanza.resources.common"].list_available_languages = lambda: ["es", "it", "en", "multilingual"]
    modules["stanza.resources"].common = modules["stanza.resources.common"]
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
    for module in (g2p, jax_g2p):
        monkeypatch.setattr(module.EspeakNg, "_SUPPORTED_STORAGE", None)


def _files(directory):
    return {path.name: path.read_bytes() for path in sorted(directory.iterdir()) if path.is_file()}


def test_espeak_segments_equal_jax(fake_engines):
    ours = g2p.EspeakNg("es", INVENTORY)._process_batch(["set 1", "sent 0"])
    theirs = jax_g2p.EspeakNg("es", INVENTORY)._process_batch(["set 1", "sent 0"])
    assert [[segment.to_json() for segment in sentence] for sentence in ours] == [
        [segment.to_json() for segment in sentence] for sentence in theirs
    ]
    assert [segment.language for segment in ours[0]] == [None, "en"]
    assert ours[0][0].transcription[0] == "ʃ"


@pytest.mark.parametrize("engines", [["espeak-ng"], ["espeak-ng", "epitran"]], ids=["espeak", "espeak+epitran"])
def test_transcribe_cli_writes_jax_corpus_files(fake_engines, tmp_path, engines):
    corpus = tmp_path / "corpus"
    _write_tsv_corpus(corpus)
    inventory = tmp_path / "inventory.txt"
    inventory.write_text("\n".join(INVENTORY) + "\n", encoding="utf-8")
    outputs = []
    for name, main in (("ours", cli_data.main), ("theirs", jax_cli_data.main)):
        output = tmp_path / name
        output.mkdir()
        arguments = [
            "transcribe", str(corpus), *[flag for engine in engines for flag in ("-e", engine)],
            "-a", str(inventory), "-b", "2", "-u", "-t", "2", "-o", str(output),
        ]
        main(arguments)
        outputs.append(_files(output))
    assert outputs[0].keys() == outputs[1].keys() and "train_transcriptions.bin" in outputs[0]
    for file_name, content in outputs[1].items():
        assert outputs[0][file_name] == content, file_name
    inventories = json.loads(outputs[0]["train_inventories.json"])
    assert set(inventories) == {"es", "it"} and all(inventories.values())


def test_inventories_remapped_onto_the_table_equal_jax(fake_engines, tmp_path):
    """``map_to_allophoible``: each engine's observed inventory is mapped onto
    the feature table's and every stored transcription rewritten through it
    (``_remap_to_indexer_inventory``); the test split keeps its own."""
    corpus = tmp_path / "corpus"
    _write_tsv_corpus(corpus)
    outputs = []
    for name, module, package in (("ours", common_voice, g2p), ("theirs", jax_common_voice, jax_g2p)):
        engine = package.GraphemeToPhonemeEnsemble([package.EspeakNg], INVENTORY, 2)
        output = tmp_path / name
        output.mkdir()
        module.load_common_voice(
            str(corpus), engine, "phoible", batch_size=2, map_to_allophoible=True,
            attribute_table=mini_allophoible_csv(), languages=["es", "it"],
        ).save(str(corpus), str(output))
        outputs.append(_files(output))
    assert outputs[0] == outputs[1]


def test_download_meta_equals_jax(monkeypatch, tmp_path):
    import urllib.request

    requested = []

    def urlopen(url):
        requested.append(url)
        return io.BytesIO(json.dumps({"locales": {"es": {"clips": 3}}, "version": "x"}).encode())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for name, main in (("ours", cli_data.main), ("theirs", jax_cli_data.main)):
        main(["download-meta", str(tmp_path / f"{name}.json"), "-v", "11.0-2022-09-21"])
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    assert requested[0] == requested[1] == common_voice.LANGUAGE_META_URL_TEMPLATE.format("11.0-2022-09-21")
    assert common_voice.download_release_meta("1") == jax_common_voice.download_release_meta("1")
