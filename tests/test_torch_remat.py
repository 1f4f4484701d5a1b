"""Rematerialisation of the port's wav2vec2 encoder layers
(models/wav2vec2.py: ``rematerialised``, JAX's saved sets): at float32 with
the flagship's dropout on, the gradients with remat equal those without
(the recompute replays each region's ``DropoutRng`` draws) and the
generators end in the same state; a replay that drew new masks differs; the
backward keeps fewer bytes; deterministic forwards are unchanged; the flag
reaches the layers through ``Estimator.from_config``."""

import numpy as np
import pytest
import torch

from allophant_tpu.models import wav2vec2 as jax_wav2vec2
from allophant_tpu_torch.config import Config
from allophant_tpu_torch.demo import build_flagship_for_training, demo_config_dict, demo_indexer
from allophant_tpu_torch.models import wav2vec2
from allophant_tpu_torch.models.allophant import attribute_graph_from_config
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.training import train_step
from allophant_tpu_torch.training.estimator import Estimator
from allophant_tpu_torch.weights import architecture_from_dict

from test_torch_train_step import TINY

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _microbatches(model):
    """A = 2 microbatches of 2 rows of 3000 and 2000 samples, 3 labels a head
    (the phoneme head's from each row's language inventory)."""
    rng = np.random.default_rng(12)
    batch = {
        "audio": torch.from_numpy((0.5 * rng.standard_normal((2, 2, 3000))).astype(np.float32)),
        "lengths": torch.tensor([[3000, 2000]] * 2),
        "language_ids": torch.tensor([[0, 2]] * 2),
    }
    gather = model.projection.allophone.gather_indices
    phonemes = [int((gather[language, 1:] >= 0).any(-1).nonzero()[0]) + 1 for language in (0, 2)]
    for node in model.plan.nodes:
        labels = torch.tensor(phonemes)[None, :, None] if node.has_allophone else torch.ones(1, 1, 1, dtype=torch.long)
        batch[f"labels_{node.name}"] = labels.expand(2, 2, 3)
        batch[f"label_lengths_{node.name}"] = torch.full((2, 2), 3)
    return batch


def _gradients(remat, save_names=wav2vec2.REMAT_SAVE_NAMES_BASE, seed=7):
    """(metrics, gradients, generator states after) of one dropout-on float32
    microbatch accumulation of the tiny training flagship."""
    config, model = build_flagship_for_training(seed=3, architecture=architecture_from_dict(TINY), device="cpu", remat=remat)
    for layer in model.acoustic_model.encoder.layers:
        assert layer.remat == remat
        layer.remat_save_names = save_names
    rng = DropoutRng.from_seed(seed, "cpu")
    metrics = train_step.accumulate_gradients(model, _microbatches(model), train_step.build_loss_plan(config, True), rng)
    gradients = {name: parameter.grad.clone() for name, parameter in model.named_parameters() if parameter.grad is not None}
    return metrics, gradients, [state.clone() for state in rng.get_state()]


def _worst_share(gradients, expected):
    assert gradients.keys() == expected.keys()
    return max((gradients[name] - value).abs().max().item() / max(value.abs().max().item(), 1e-30) for name, value in expected.items())


@pytest.fixture(scope="module")
def plain():
    assert 0 < TINY.get("attention_dropout", 0.1) < 1
    torch.use_deterministic_algorithms(True)
    try:
        yield _gradients(False)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize(
    "save_names", [wav2vec2.REMAT_SAVE_NAMES_BASE, wav2vec2.REMAT_SAVE_NAMES_EXTENDED], ids=["base", "extended"]
)
def test_gradients_with_remat_equal_those_without(plain, save_names):
    """Bit-equal on the CPU (deterministic algorithms); held to 1e-6 of each
    leaf's largest gradient, the limit the card's check uses."""
    torch.use_deterministic_algorithms(True)
    try:
        metrics, gradients, states = _gradients(True, save_names)
    finally:
        torch.use_deterministic_algorithms(False)
    plain_metrics, plain_gradients, plain_states = plain
    assert torch.equal(metrics, plain_metrics)
    assert _worst_share(gradients, plain_gradients) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(states, plain_states))


def test_a_replay_with_new_masks_differs(plain, monkeypatch):
    """The check above can fail: without the replay of the generators'
    states the recompute draws other dropout masks."""
    monkeypatch.setattr(DropoutRng, "set_state", lambda self, state: None)
    _metrics, gradients, _states = _gradients(True)
    assert _worst_share(gradients, plain[1]) > 1e-3


def test_save_sets_are_jaxs():
    assert wav2vec2.REMAT_SAVE_NAMES_BASE == jax_wav2vec2.REMAT_SAVE_NAMES_BASE
    assert wav2vec2.REMAT_SAVE_NAMES_EXTENDED == jax_wav2vec2.REMAT_SAVE_NAMES_EXTENDED


def _saved_bytes(remat):
    """Bytes of the distinct storages autograd keeps for the backward of one
    dropout-on forward of a 4-layer tiny encoder."""
    _config, model = build_flagship_for_training(seed=3, architecture=architecture_from_dict(dict(TINY, num_hidden_layers=4)), device="cpu", remat=remat)
    storages = {}

    def pack(tensor):
        storages[tensor.untyped_storage().data_ptr()] = tensor.untyped_storage().nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        model(torch.randn(2, 16000), torch.tensor([16000, 12000]), torch.tensor([0, 1]), rng=DropoutRng.from_seed(1, "cpu"))
    return sum(storages.values())


def test_remat_keeps_fewer_bytes_for_the_backward():
    assert _saved_bytes(True) < 0.6 * _saved_bytes(False)


def test_deterministic_forward_and_estimators_take_the_flag():
    config = Config.load(demo_config_dict())
    indexer = demo_indexer(config)
    built = {}
    for remat in (False, True):
        estimator = Estimator.from_config(
            config, 1, 16000, attribute_graph_from_config(config, indexer), indexer,
            wav2vec2_architecture=architecture_from_dict(TINY), precision="float32", device="cpu", remat=remat,
        )
        assert all(layer.remat == remat for layer in estimator.model.acoustic_model.encoder.layers)
        built[remat] = estimator
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3200)).astype(np.float32))
    lengths, languages = torch.tensor([3200, 2000]), torch.tensor([0, 1])
    with torch.no_grad():
        outputs = [built[remat].model(audio, lengths, languages).outputs for remat in (False, True)]
    assert all(torch.equal(outputs[0][name], outputs[1][name]) for name in outputs[0])
