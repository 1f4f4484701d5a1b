"""The port's phonetics against the JAX package's: the native segmenter and
edit distances (the port's own copy of the C++ core), grapheme clusters, the
pandas-free PhoneticAttributeIndexer (phoneme order, feature tables,
categories, inventories, allophone mappings, composition matrices and state,
integer-equal) on the mini table and the demo table, the attribute graph and
the projection plan with its static tables, and the demo CSV byte for byte."""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import regex

from allophant_tpu import phonemes as jax_phonemes
from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.demo import demo_feature_table_csv as jax_demo_csv
from allophant_tpu.models.allophant import attribute_graph_from_config as jax_graph_from_config
from allophant_tpu.models.projection import build_projection_plan as jax_build_projection_plan
from allophant_tpu.phonetics import features as jax_features
from allophant_tpu.phonetics.segmentation import split_complex_segment as jax_split_complex_segment
from allophant_tpu_torch import phonemes
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.demo import demo_config_dict, demo_feature_table_csv, flagship_data, flagship_plan_data
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.models.projection import ProjectionPlan, build_projection_plan
from allophant_tpu_torch.native.build import library_path
from allophant_tpu_torch.phonetics import features
from allophant_tpu_torch.phonetics.segmentation import grapheme_clusters, split_complex_segment

from fixtures import mini_allophoible_csv, mini_config_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
LANGUAGES = ["es", "it", "de"]


def test_native_core_builds_from_the_ports_sources():
    path = library_path()
    assert path.exists() and "_build" in path.parts
    assert phonemes._load_native() is not None and phonemes.NATIVE_AVAILABLE


def _words():
    rng = np.random.default_rng(5)
    vocabulary = ["a", "t", "ts", "t͡s", "ʃ", "aː", "e", "i̯", "ai̯", "n", "ŋ", "k", "kʰ"]
    return vocabulary, ["".join(rng.choice(vocabulary, size=int(rng.integers(0, 7)))) for _ in range(40)]


def test_segmenter_equals_jax():
    vocabulary, words = _words()
    ours, theirs = phonemes.IpaSegmenter(vocabulary), jax_phonemes.IpaSegmenter(vocabulary)
    for word in words + ["xyz", "atx", ""]:
        assert ours.segment(word) == theirs.segment(word)
        assert ours.segment(word, include_missing=True) == theirs.segment(word, include_missing=True)
        try:
            expected = theirs.segment_checked(word)
        except jax_phonemes.MissingSegmentError:
            with pytest.raises(phonemes.MissingSegmentError):
                ours.segment_checked(word)
        else:
            assert ours.segment_checked(word) == expected
    assert ours.segment_words(words[:5]) == theirs.segment_words(words[:5])


def test_edit_distances_equal_jax():
    rng = np.random.default_rng(9)
    table = rng.integers(0, 3, (6, 4))
    weighting = phonemes.PropertyWeighting(1.0, 1.5, table)
    jax_weighting = jax_phonemes.PropertyWeighting(1.0, 1.5, table)
    for _ in range(20):
        a = rng.integers(0, 6, int(rng.integers(0, 9))).tolist()
        b = rng.integers(0, 6, int(rng.integers(0, 9))).tolist()
        assert phonemes.levensthein(a, b) == jax_phonemes.levensthein(a, b)
        ours, theirs = phonemes.levensthein_statistics(a, b), jax_phonemes.levensthein_statistics(a, b)
        assert (ours.insertions, ours.deletions, ours.substitutions, ours.correct) == (
            theirs.insertions, theirs.deletions, theirs.substitutions, theirs.correct
        )
        operations, cost = phonemes.levensthein_operations(a, b)
        jax_operations, jax_cost = jax_phonemes.levensthein_operations(a, b)
        assert cost == jax_cost
        assert [(int(action), x, y) for action, x, y in operations] == [(int(action), x, y) for action, x, y in jax_operations]
        np.testing.assert_array_equal(phonemes.levensthein_matrix(a, b), jax_phonemes.levensthein_matrix(a, b))
        np.testing.assert_array_equal(weighting.levensthein_matrix(a, b), jax_weighting.levensthein_matrix(a, b))


def _segments_of(csv_text):
    table = features.read_allophoible(csv_text)
    return sorted({value for name in ("Phoneme", "Allophones") for value in table.column(name) if value})


@pytest.mark.parametrize("csv_text", [mini_allophoible_csv(), jax_demo_csv(num_segments=400)], ids=["mini", "demo-400"])
def test_grapheme_clusters_equal_regex(csv_text):
    texts = _segments_of(csv_text)
    texts += ["".join(pair) for pair in itertools.product(texts[:30], repeat=2)]
    for text in texts + ["̃a", "t͡ʃʰ", "a‍b", "ː̃"]:
        assert grapheme_clusters(text) == regex.findall(r"\X", text), text
        assert split_complex_segment(text) == jax_split_complex_segment(text), text


def test_demo_csv_is_byte_equal():
    assert demo_feature_table_csv() == jax_demo_csv()
    assert demo_feature_table_csv(num_languages=5, seed=3, num_segments=300) == jax_demo_csv(num_languages=5, seed=3, num_segments=300)


def _assert_indexers_equal(ours, theirs):
    assert ours.phonemes.tolist() == theirs.phonemes.tolist()
    assert ours.feature_columns == theirs.feature_columns.tolist()
    assert ours.feature_table.tolist() == theirs.feature_table.tolist()
    assert ours._feature_categories == theirs._feature_categories
    assert ours.composition_features == theirs.composition_features
    assert [ours.size(name) for name in ours.feature_columns] == [theirs.size(name) for name in theirs.feature_columns]
    assert ours.state().to_dict() == theirs.state().to_dict()
    for view in ("full_attributes", "full_subset_attributes", "attributes"):
        a, b = getattr(ours, view), getattr(theirs, view)
        assert a.phonemes.tolist() == b.phonemes.tolist(), view
        np.testing.assert_array_equal(a.dense_feature_table, b.dense_feature_table, err_msg=view)
    allophones = ours.allophone_data.inventories
    assert list(allophones.index) == theirs.allophone_data.inventories.index.tolist()
    shared, jax_shared = ours.allophone_data.shared_phone_indexer, theirs.allophone_data.shared_phone_indexer
    assert shared.phonemes.tolist() == jax_shared.phonemes.tolist()
    np.testing.assert_array_equal(shared.dense_feature_table, jax_shared.dense_feature_table)
    inventory = ours.full_attributes.phonemes.tolist()[::2]
    np.testing.assert_array_equal(ours.composition_feature_matrix(inventory), theirs.composition_feature_matrix(inventory))
    if theirs.language_allophones is None:
        assert ours.language_allophones is None
    else:
        assert ours.language_allophones.to_dict() == theirs.language_allophones.to_dict()


def _indexers(csv_text, config_dict, languages):
    jax_bootstrap = jax_features.PhoneticAttributeIndexer("phoible", csv_text)
    bootstrap = features.PhoneticAttributeIndexer("phoible", csv_text)
    for code in languages:
        assert bootstrap.phoneme_inventory(code) == jax_bootstrap.phoneme_inventory(code), code
    assert bootstrap.phoneme_inventory(languages) == jax_bootstrap.phoneme_inventory(languages)
    _assert_indexers_equal(bootstrap, jax_bootstrap)
    inventories = features.LanguageInventories({i: bootstrap.phoneme_inventory(c) for i, c in enumerate(languages)}, languages)
    jax_inventories = jax_features.LanguageInventories(
        {i: jax_bootstrap.phoneme_inventory(c) for i, c in enumerate(languages)}, languages
    )
    ours = features.PhoneticAttributeIndexer.from_config(Config.load(config_dict), csv_text, inventories)
    theirs = jax_features.PhoneticAttributeIndexer.from_config(JaxConfig.load(config_dict), csv_text, jax_inventories)
    return ours, theirs


CASES = {
    "mini-shared": (mini_allophoible_csv, lambda: mini_config_dict(model_type="wav2vec2-pretrained"), LANGUAGES),
    "mini-allophones": (
        mini_allophoible_csv,
        lambda: mini_config_dict("allophones", True, "wav2vec2-pretrained"),
        LANGUAGES,
    ),
    "demo": (jax_demo_csv, demo_config_dict, ["es", "it", "de", "fr"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_indexer_equals_jax(case):
    make_csv, make_config, languages = CASES[case]
    ours, theirs = _indexers(make_csv(), make_config(), languages)
    _assert_indexers_equal(ours, theirs)
    # The state a checkpoint embeds rebuilds the same indexer in both.
    state = ours.state()
    restored = features.PhoneticAttributeIndexer.from_state("phoible", state, ours.feature_columns)
    jax_restored = jax_features.PhoneticAttributeIndexer.from_state(
        "phoible", jax_features.PhoneticIndexerState.from_dict(state.to_dict()), theirs.feature_columns.tolist()
    )
    _assert_indexers_equal(restored, jax_restored)


def test_extract_allophone_inventories_equals_jax():
    csv_text = mini_allophoible_csv()
    table = features.read_allophoible(csv_text)
    jax_table = jax_features.read_allophoible(csv_text)
    for languages in (None, ["spa"], ["deu", "ita"]):
        ours = features.extract_allophone_inventories(table, languages, prefer_default_dialects=True, remove_zero_phoneme=True)
        theirs = jax_features.extract_allophone_inventories(jax_table, languages, prefer_default_dialects=True, remove_zero_phoneme=True)
        assert ours.columns == theirs.columns.tolist()
        expected = [[None if isinstance(cell, float) and np.isnan(cell) else cell for cell in row] for row in theirs.astype(object).where(theirs.notna(), None).values.tolist()]
        assert ours.rows == expected


@pytest.mark.parametrize("case", list(CASES))
def test_attribute_graph_and_projection_plan_equal_jax(case):
    make_csv, make_config, languages = CASES[case]
    config_dict = make_config()
    ours, theirs = _indexers(make_csv(), config_dict, languages)
    config, jax_config = Config.load(config_dict), JaxConfig.load(config_dict)
    graph, jax_graph = attribute_graph_from_config(config, ours), jax_graph_from_config(jax_config, theirs)
    assert graph.to_dict() == jax_graph.to_dict()
    language_allophones = ours.language_allophones if config.nn.projection.phoneme_layer.value != "shared" else None
    jax_allophones = theirs.language_allophones if config.nn.projection.phoneme_layer.value != "shared" else None
    plan, static = build_projection_plan(64, graph, 1, config.nn.projection, language_allophones, ours)
    jax_plan, jax_static = jax_build_projection_plan(64, jax_graph, 1, jax_config.nn.projection, jax_allophones, theirs)
    assert plan == ProjectionPlan.from_dict(dataclasses.asdict(jax_plan))
    assert set(static) == set(jax_static)
    for key, value in jax_static.items():
        np.testing.assert_array_equal(static[key], value, err_msg=key)
        assert static[key].dtype == value.dtype, key


def test_flagship_plan_equals_the_frozen_one():
    document, static = flagship_plan_data()
    frozen_document, frozen_static = flagship_data()
    assert json.dumps(document, sort_keys=True) == json.dumps(frozen_document, sort_keys=True)
    assert set(static) == set(frozen_static)
    for key, value in frozen_static.items():
        np.testing.assert_array_equal(static[key], value, err_msg=key)
