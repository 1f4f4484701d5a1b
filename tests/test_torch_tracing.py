"""The port's spans and counters (``allophant_tpu_torch/tracing.py``) on the
CPU, with the demo head over a tiny encoder: off, nothing is dispatched or
counted; on, every ``predict*`` call opens ``estimator.request`` around
``inputs``, ``forward`` and ``decode``, and an update opens ``train.step``
around each microbatch's ``forward``, ``loss`` and ``backward``, then
``optimizer`` and ``metrics``; ``decode_calls``, ``ctc_calls`` and
``host_reads`` count what the code says; outputs are bit-equal either way,
remat included; and ``StepProfiler``'s traces carry the spans."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from allophant_tpu_torch import tracing
from allophant_tpu_torch.config import ProfilingConfig
from allophant_tpu_torch.data.batch import Batch
from allophant_tpu_torch.demo import build_flagship, build_flagship_for_training
from allophant_tpu_torch.models.layers import DropoutRng
from allophant_tpu_torch.training import train_step
from allophant_tpu_torch.training.run import StepProfiler
from allophant_tpu_torch.weights import architecture_from_dict

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TINY = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    conv_dim=(16, 16, 16),
    conv_kernel=(10, 3, 2),
    conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
ACCUMULATION = 2


@pytest.fixture(scope="module")
def estimator():
    return build_flagship(seed=4, architecture=architecture_from_dict(TINY), precision="float32", device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    audio = (0.5 * rng.standard_normal((2, 1500))).astype(np.float32)
    return Batch(audio, np.array([1500, 1100], dtype=np.int32), np.array([0, 2], dtype=np.int32))


def _heads(estimator):
    """Three four-class attribute heads (one stacked beam search) and the phone head."""
    return (*[node.name for node in estimator.model.plan.nodes][:3], "phone")


def _request(estimator, batch, kind):
    heads = _heads(estimator)
    if kind == "predict":
        return estimator.predict(batch)
    if kind == "predict_decoded":
        return estimator.predict_decoded(batch, heads=heads)
    return estimator.predict_beam_decoded(batch, heads=heads, beam_width=3)


def _program_events(profiler):
    """(name without the prefix, start µs, end µs) of the program's spans, by start."""
    return sorted(
        (
            (event.name[len(tracing.PREFIX) :], event.time_range.start, event.time_range.end)
            for event in profiler.events()
            if event.name.startswith(tracing.PREFIX)
        ),
        key=lambda event: event[1],
    )


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_span_is_the_shared_no_op_and_counts_nothing():
    assert not tracing._on
    counts = tracing._counts
    before = dict(counts)
    assert tracing.span("estimator.request") is tracing.span("train.step") is tracing._OFF
    tracing.count("decode_calls", 5)
    assert tracing._counts is counts and counts == before


def test_off_predict_decoded_opens_no_program_range(estimator, batch):
    with profile(activities=[ProfilerActivity.CPU]) as profiler:
        _request(estimator, batch, "predict_decoded")
    names = [event.name for event in profiler.events()]
    assert "aten::argmax" in names
    assert not [name for name in names if name.startswith(tracing.PREFIX)]


def test_recording_yields_its_counts_and_restores_the_outer_state():
    with tracing.recording() as outer:
        tracing.count("host_reads")
        with tracing.recording() as inner:
            tracing.count("host_reads", 3)
            assert tracing.span("train.step") is not tracing._OFF
        tracing.count("decode_calls")
    assert (outer, inner) == ({"host_reads": 1, "decode_calls": 1}, {"host_reads": 3})
    assert not tracing._on and tracing.span("train.step") is tracing._OFF


@pytest.mark.parametrize("kind", ["predict", "predict_decoded", "predict_beam_decoded"])
def test_a_request_encloses_inputs_forward_and_decode(estimator, batch, kind):
    with tracing.recording() as counts, profile(activities=[ProfilerActivity.CPU]) as profiler:
        _request(estimator, batch, kind)
    events = _program_events(profiler)
    assert [name for name, *_ in events] == [
        "estimator.request", "estimator.inputs", "estimator.forward", "estimator.decode"
    ]
    request, *parts = events
    assert all(_inside(part, request) for part in parts)
    assert all(earlier[2] <= later[1] for earlier, later in zip(parts, parts[1:]))
    decoded = {"predict": 0, "predict_decoded": len(_heads(estimator)), "predict_beam_decoded": 1}[kind]
    assert counts.get("decode_calls", 0) == decoded


@pytest.mark.parametrize("kind", ["predict_decoded", "predict_beam_decoded"])
def test_decoded_outputs_are_bit_equal_with_tracing_on(estimator, batch, kind):
    off = _request(estimator, batch, kind)
    with tracing.recording(), profile(activities=[ProfilerActivity.CPU]):
        on = _request(estimator, batch, kind)
    assert len(off) == len(on)
    for expected, got in zip(off, on):
        assert expected.dtype == got.dtype and torch.equal(expected, got)


def _training(seed: int = 3):
    """(step, microbatches, loss plan, model) of the tiny training flagship
    with remat and the flagship's dropout, at A = 2."""
    architecture = architecture_from_dict(TINY)
    assert 0 < architecture.attention_dropout < 1 and 0 < architecture.hidden_dropout < 1
    config, model = build_flagship_for_training(seed=seed, architecture=architecture, device="cpu", remat=True)
    optimizer = train_step.create_optimizer(config, TINY["hidden_size"], model.parameters())
    loss_plan = train_step.build_loss_plan(config, True)
    step = train_step.make_train_step(model, optimizer, loss_plan, train_step.build_freeze_plan(config.acoustic_model))
    rng = np.random.default_rng(12)
    batch = {
        "audio": torch.from_numpy((0.5 * rng.standard_normal((ACCUMULATION, 2, 1500))).astype(np.float32)),
        "lengths": torch.tensor([[1500, 1100]] * ACCUMULATION),
        "language_ids": torch.tensor([[0, 2]] * ACCUMULATION),
    }
    gather = model.projection.allophone.gather_indices
    phonemes = [int((gather[language, 1:] >= 0).any(-1).nonzero()[0]) + 1 for language in (0, 2)]
    for node in model.plan.nodes:
        labels = torch.tensor(phonemes)[None, :, None] if node.has_allophone else torch.ones(1, 1, 1, dtype=torch.long)
        batch[f"labels_{node.name}"] = labels.expand(ACCUMULATION, 2, 3)
        batch[f"label_lengths_{node.name}"] = torch.full((ACCUMULATION, 2), 3)
    return step, batch, loss_plan, model


def _two_updates(traced: bool):
    """Metrics and parameters after two updates, tracing on or off."""
    step, batch, _loss_plan, model = _training()
    assert all(layer.remat for layer in model.acoustic_model.encoder.layers)
    torch.use_deterministic_algorithms(True)
    try:
        with contextlib.ExitStack() as stack:
            if traced:
                stack.enter_context(tracing.recording())
                stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
            metrics = [step(batch, DropoutRng.from_seed(7 + index, "cpu"), index) for index in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    return metrics, {name: parameter.detach().clone() for name, parameter in model.named_parameters()}


def test_an_update_has_its_microbatches_then_optimizer_and_metrics():
    step, batch, loss_plan, model = _training()
    with tracing.recording() as counts, profile(activities=[ProfilerActivity.CPU]) as profiler:
        step(batch, DropoutRng.from_seed(7, "cpu"), 0)
    events = _program_events(profiler)
    root, *parts = events
    assert root[0] == "train.step" and all(_inside(part, root) for part in parts)
    assert [name for name, *_ in parts] == [
        *(["train.forward", "train.loss", "train.backward"] * ACCUMULATION), "train.optimizer", "train.metrics"
    ]
    assert all(earlier[2] <= later[1] for earlier, later in zip(parts, parts[1:]))
    # A CTC call a class count and microbatch; one read of the metrics.
    groups = len({node.output_size for node in model.plan.nodes if node.name in loss_plan.ctc_heads})
    assert groups >= 2
    assert counts == {"ctc_calls": groups * ACCUMULATION, "host_reads": 1}


def test_two_remat_updates_are_bit_equal_with_tracing_on():
    """Spans around the forward and the backward enclose selective
    checkpointing's regions and their recompute."""
    off_metrics, off_parameters = _two_updates(traced=False)
    on_metrics, on_parameters = _two_updates(traced=True)
    assert off_metrics == on_metrics
    assert off_parameters.keys() == on_parameters.keys()
    assert all(torch.equal(off_parameters[name], on_parameters[name]) for name in off_parameters)


def test_step_profiler_traces_carry_the_spans(tmp_path):
    """Tracing is on while the profiler runs; wait 1, warm up 2, record 2:
    the trace holds the spans of the two recorded steps alone."""
    assert not tracing._on
    profiler = StepProfiler(ProfilingConfig(active_steps=2, tensorboard_dir=str(tmp_path)))
    for global_step in range(7):
        assert tracing._on
        with tracing.span("train.step"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        profiler.step(global_step)
    profiler.stop()
    assert not tracing._on
    (path,) = Path(tmp_path).rglob("*.pt.trace.json")
    document = json.loads(path.read_text())
    spans = [event["name"] for event in document["traceEvents"] if event.get("cat") == "user_annotation"]
    assert spans.count("allophant.train.step") == 2
