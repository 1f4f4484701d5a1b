"""The port's panphon feature set (phonetics/features.py: ``read_panphon``
and the PANPHON branch of PhoneticAttributeIndexer, on its own ``Frame``)
against the JAX package's on ``tests/test_phonetics.py``'s PANPHON_CSV:
phoneme order (duplicates dropped first-kept, tie-stripped variants added),
feature tables, categories, composition features (``syl`` is one) and
matrices, and the indexer state, integer-equal."""

import numpy as np
import pytest

from allophant_tpu.phonetics import features as jax_features
from allophant_tpu_torch.phonetics import features

from test_phonetics import TestPanphonFeatureSet

PANPHON_CSV = TestPanphonFeatureSet.PANPHON_CSV
# A second "a" row differing only in a later column: the first is kept.
DUPLICATED_CSV = PANPHON_CSV + "\na,+,+,-,+,-,-,-,+,+"


def _assert_equal(ours, theirs):
    assert ours.phonemes.tolist() == theirs.phonemes.tolist()
    assert ours.feature_columns == theirs.feature_columns.tolist()
    assert ours.feature_table.tolist() == theirs.feature_table.tolist()
    assert ours._feature_categories == theirs._feature_categories
    assert ours.composition_features == theirs.composition_features
    assert ours.state().to_dict() == theirs.state().to_dict()
    for view in ("full_attributes", "full_subset_attributes", "attributes"):
        a, b = getattr(ours, view), getattr(theirs, view)
        assert a.phonemes.tolist() == b.phonemes.tolist(), view
        np.testing.assert_array_equal(a.dense_feature_table, b.dense_feature_table, err_msg=view)
    inventory = ["a", "p", "n", "ts"]
    np.testing.assert_array_equal(ours.composition_feature_matrix(inventory), theirs.composition_feature_matrix(inventory))
    assert ours.allophone_data is None and theirs.allophone_data is None


@pytest.mark.parametrize(
    "table, attributes, phonemes",
    [
        (PANPHON_CSV, None, None),
        (PANPHON_CSV, ["syl", "son", "nas", "phoneme"], None),
        (DUPLICATED_CSV, None, ["a", "p", "ts", "t͡s"]),
    ],
    ids=["all", "feature-subset", "duplicates-and-phoneme-subset"],
)
def test_indexer_equals_jax(table, attributes, phonemes):
    ours = features.PhoneticAttributeIndexer("panphon", table, attributes, phonemes)
    theirs = jax_features.PhoneticAttributeIndexer("panphon", table, attributes, phonemes)
    _assert_equal(ours, theirs)
    assert "syl" in ours.composition_features and "ts" in ours.full_attributes.phonemes
    # The state a checkpoint embeds rebuilds the same indexer in both.
    restored = features.PhoneticAttributeIndexer.from_state("panphon", ours.state(), attributes)
    jax_restored = jax_features.PhoneticAttributeIndexer.from_state(
        "panphon", jax_features.PhoneticIndexerState.from_dict(ours.state().to_dict()), attributes
    )
    _assert_equal(restored, jax_restored)


def test_read_panphon_equals_jax():
    table = features.read_panphon(PANPHON_CSV, index_column="ipa")
    jax_table = jax_features.read_panphon(PANPHON_CSV, index_column="ipa")
    assert list(table.index) == jax_table.index.tolist() and table.columns == jax_table.columns.tolist()
    assert table.rows == jax_table.values.tolist()


def test_allophones_and_missing_tables_raise():
    with pytest.raises(NotImplementedError, match="Panphon"):
        features.PhoneticAttributeIndexer("panphon", PANPHON_CSV, allophones_from_allophoible=True)
    try:
        import panphon  # noqa: F401
    except ImportError:
        with pytest.raises(FileNotFoundError):
            features.read_panphon(None)
    else:
        # With the package, its own ipa_all.csv is read.
        assert "syl" in features.read_panphon(None, index_column="ipa").columns
