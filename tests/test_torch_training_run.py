"""The port's training loop (allophant_tpu_torch/training/run.py) against the
JAX package's: the same config, phoneme table and corpus on disk, the same
float32 weights (through ``weights.py``), all dropout 0, 2 epochs of 2 steps
at accumulation 2, through ``Estimator.train`` on each side. Also the
mid-epoch stop and resume, and a port-written checkpoint read by JAX's
``load_native``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from allophant_tpu.config import Config as JaxConfig
from allophant_tpu.data.speech_corpus import MultilingualSplits as JaxSplits
from allophant_tpu.data.ucla import UCLAPhoneticCorpus as JaxUCLA
from allophant_tpu.models.wav2vec2 import Wav2Vec2Architecture as JaxArchitecture
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer as JaxIndexer
from allophant_tpu.training.checkpoint import load_native
from allophant_tpu.training.estimator import Estimator as JaxEstimator
from allophant_tpu.training.run import DatasetManager as JaxDatasetManager
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus
from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer
from allophant_tpu_torch.training.checkpoint import load_native as port_load_native
from allophant_tpu_torch.training.checkpoint import variables_from_model
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.training.run import DatasetManager, TrainingStatus
from allophant_tpu_torch.weights import jax_params_from_state, load_jax_variables, state_dict_from_jax

from fixtures import mini_allophoible_csv, mini_config_dict
from torch_parity import exact_frame_encoder_erf
from test_torch_data import write_ucla_corpus

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TINY = dict(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=96,
    conv_dim=(32, 32, 32),
    conv_kernel=(10, 3, 2),
    conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
    hidden_dropout=0.0,
    activation_dropout=0.0,
    attention_dropout=0.0,
    feat_proj_dropout=0.0,
)
# Losses: f32 on two frameworks, summed in other orders (1e-5 relative for
# the totals; 5e-5 for one head's, a smaller sum that the updates' f32
# differences move by more); parameters after four updates: within 1e-3 of
# each leaf's largest, as tests/test_torch_train_step.py holds one step's
# moments.
LOSS_RTOL, HEAD_LOSS_RTOL, GRAD_NORM_RTOL, PARAMETER_SHARE = 1e-5, 5e-5, 3e-5, 1e-3


def _config_dict(optimizer=None):
    config = mini_config_dict("allophones", True, "wav2vec2-pretrained")
    config["nn"].update(batch_size=4, accumulation_factor=2, maximum_iterations=2, batching_mode="utterances")
    if optimizer is not None:
        config["nn"]["optimizer"] = optimizer
    return config


# The comparison with JAX trains with SGD and momentum: Adam's first update
# is lr * sign(g) for a leaf whose exact gradient is 0 (the key projection's
# bias), where each framework's f32 rounding picks the sign, so two
# correct Adam runs part at 1e-4 of the loss after one step. The Adam step
# itself is held to JAX in tests/test_torch_train_step.py; the resume test
# below runs Adam.
SGD = {"algorithm": "sgd", "learning_rate": 0.01, "momentum": 0.9}


def _setup(corpus_root, config_class, corpus_class, splits_class, indexer_class, manager_class, optimizer=None):
    config = config_class.load(_config_dict(optimizer))
    corpus = corpus_class.load(str(corpus_root), resample=16000)
    splits = splits_class.single(corpus, "train")
    splits.dev = corpus
    # The allophone layer's inventories: the table's own for the corpus
    # languages, in the corpus's language order. A UCLA dataset labels
    # phonemes by their place in the whole table, so every corpus phoneme
    # must be in them.
    table = mini_allophoible_csv()
    bootstrap = indexer_class("phoible", table)
    inventories = {index: bootstrap.phoneme_inventory(language) for index, language in enumerate(corpus.languages)}
    inventory_class = type(corpus.language_id_inventories())
    indexer = indexer_class.from_config(config, table, inventory_class(inventories, list(corpus.languages)))
    manager = manager_class.from_config(config, splits, indexer, length_multiple=128, label_multiple=8)
    return config, indexer, manager


def _port_estimator(corpus_root, seed=0, optimizer=None):
    config, indexer, manager = _setup(
        corpus_root, Config, UCLAPhoneticCorpus, MultilingualSplits, PhoneticAttributeIndexer, DatasetManager, optimizer
    )
    estimator = Estimator.from_config(
        config, manager.feature_size, 16000, manager.attribute_graph(), indexer,
        wav2vec2_architecture=Wav2Vec2Architecture(**TINY), seed=seed, precision="float32", device="cpu",
    )
    return estimator, indexer, manager


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """2 languages x 4 utterances of 0.2 s each (one step shape)."""
    return write_ucla_corpus(tmp_path_factory.mktemp("corpus"), 4, seed=8, rates=(16000, 16000), samples=3200)


@pytest.fixture(scope="module")
def runs(corpus_root):
    """(JAX statistics, JAX final params, port statistics, port estimator).
    JAX's frame encoder runs with the exact erf, as the port's does."""
    config, indexer, manager = _setup(corpus_root, JaxConfig, JaxUCLA, JaxSplits, JaxIndexer, JaxDatasetManager, SGD)
    jax_estimator = JaxEstimator.from_config(
        config, manager.feature_size, 16000, manager.attribute_graph(), indexer,
        wav2vec2_architecture=JaxArchitecture(**TINY), load_pretrained_weights=False, seed=0, precision="float32",
    )
    initial = jax.tree_util.tree_map(np.asarray, jax_estimator.variables)
    with exact_frame_encoder_erf():
        jax_results = list(jax_estimator.train(manager))
    jax_final = jax.tree_util.tree_map(np.asarray, jax_estimator.variables)

    estimator, _indexer, port_manager = _port_estimator(corpus_root, optimizer=SGD)
    load_jax_variables(estimator.model, initial)
    results = list(estimator.train(port_manager))
    return jax_results, jax_final, results, estimator


def _close(ours, theirs, rtol):
    if theirs is None:
        return ours is None
    return abs(ours - theirs) <= rtol * abs(theirs)


def test_statistics_equal_jax(runs):
    jax_results, _final, results, estimator = runs
    assert [status.value for status, _ in results] == [status.value for status, _ in jax_results]
    assert len(results) == 3 and results[-1][0] == TrainingStatus.FINISHED
    for (_, ours), (_, theirs) in zip(results[:-1], jax_results[:-1]):
        assert (ours.epoch, ours.global_step, ours.batch_count, ours.utterance_count) == (
            theirs.epoch, theirs.global_step, theirs.batch_count, theirs.utterance_count
        )
        assert ours.global_step == 2 * ours.epoch  # 2 steps an epoch
        assert _close(ours.train_loss, theirs.train_loss, LOSS_RTOL), (ours.train_loss, theirs.train_loss)
        assert _close(ours.validation_loss, theirs.validation_loss, LOSS_RTOL)
        assert np.float32(ours.learning_rate) == np.float32(theirs.learning_rate)
        assert _close(ours.gradient_norm, theirs.gradient_norm, GRAD_NORM_RTOL)
        assert set(ours.classifier_losses) == set(theirs.classifier_losses)
        for name, value in theirs.classifier_losses.items():
            assert _close(ours.classifier_losses[name], value, HEAD_LOSS_RTOL), (name, ours.classifier_losses[name], value)
            validation = theirs.validation_classifier_losses[name]
            assert _close(ours.validation_classifier_losses[name], validation, HEAD_LOSS_RTOL), (name, validation)
    assert estimator.epoch.epoch == 2 and estimator.epoch.global_step == 4 and len(estimator.history) == 2


def test_parameters_equal_jax(runs):
    _jax_results, jax_final, _results, estimator = runs
    expected = state_dict_from_jax(jax_final, TINY["num_hidden_layers"])
    got = dict(estimator.model.named_parameters())
    assert set(got) <= set(expected)
    for name, parameter in got.items():
        reference = expected[name].float()
        scale = reference.abs().max().item() or 1.0
        error = (parameter.detach() - reference).abs().max().item()
        assert error <= PARAMETER_SHARE * scale, (name, error, scale)


def test_mid_epoch_stop_and_resume_equals_an_uninterrupted_run(corpus_root):
    uninterrupted, _indexer, manager = _port_estimator(corpus_root, seed=1)
    straight = list(uninterrupted.train(manager))

    estimator, _indexer, manager = _port_estimator(corpus_root, seed=1)
    run = estimator.train(manager)
    run.request_stop()
    stopped = list(run)
    assert [status for status, _ in stopped] == [TrainingStatus.INTERRUPTED]
    assert (estimator.epoch.epoch, estimator.epoch.global_step, estimator.epoch.step) == (0, 1, 2)
    estimator.training_state = run.serialized_training_state()
    resumed = list(estimator.train(manager, skip_batches=estimator.epoch.step))

    assert [status for status, _ in resumed] == [status for status, _ in straight]
    assert [stats.validation_loss for _, stats in resumed] == [stats.validation_loss for _, stats in straight]
    assert resumed[-1][1].global_step == straight[-1][1].global_step == 4
    for (name, parameter), other in zip(estimator.model.named_parameters(), uninterrupted.model.parameters()):
        assert torch.equal(parameter, other), name


def test_checkpoint_is_read_by_jax_load_native(runs, tmp_path):
    _jax_results, _final, _results, estimator = runs
    indexer_state = PhoneticAttributeIndexer.from_config(estimator.config, mini_allophoible_csv()).state()
    path = str(tmp_path / "port.ckpt")
    estimator.save(path, optimizer_state=b"port-optimizer", phonetic_indexer_state=indexer_state,
                   additional_parameters={"note": "port"})

    checkpoint = load_native(path)
    assert checkpoint.config.dump() == estimator.config.dump()
    assert checkpoint.attribute_graph.to_dict() == estimator.attribute_graph.to_dict()
    assert dataclasses.asdict(checkpoint.epoch) == dataclasses.asdict(estimator.epoch)
    assert checkpoint.phonetic_indexer_state.to_dict() == indexer_state.to_dict()
    assert checkpoint.history == estimator.history and checkpoint.additional == {"note": "port"}
    assert (checkpoint.feature_size, checkpoint.sample_rate) == (1, 16000)
    assert checkpoint.optimizer_state == b"port-optimizer"

    expected = jax_params_from_state(dict(estimator.model.named_parameters()), estimator.model.architecture)
    leaves = jax.tree_util.tree_leaves_with_path(checkpoint.variables["params"])
    expected_leaves = dict(jax.tree_util.tree_leaves_with_path(expected))
    assert len(leaves) == len(expected_leaves)
    for path_key, value in leaves:
        np.testing.assert_array_equal(value, expected_leaves[path_key], err_msg=jax.tree_util.keystr(path_key))
        assert value.dtype == np.float32
    # The port's own codec reads the same file back.
    contents = port_load_native(path)
    ours = dict(jax.tree_util.tree_leaves_with_path(contents.variables))
    for path_key, value in jax.tree_util.tree_leaves_with_path(variables_from_model(estimator.model)):
        np.testing.assert_array_equal(ours[path_key], value)
    buffers = checkpoint.variables["buffers"]["projection"]
    np.testing.assert_array_equal(buffers["allophone"]["gather_indices"], estimator.model.projection.allophone.gather_indices.numpy())

