"""The plain reference against the port's CPU path at a tiny size, and the
judge's numbers on hand-made cases."""

import math

import numpy as np
import pytest
import torch

import tiny_cells
from cardbench.core import port, registry
from cardbench.core.context import Context
from cardbench.reference import judge
from cardbench.reference.model import Numerics, serving_heads
from cardbench.tasks import serve


def test_reference_logits_match_the_port_at_float32():
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.training.estimator import Estimator

    config = tiny_cells.config("xlsr300m-allophant")
    traffic = tiny_cells.traffic("cv-greedy")
    head = registry.head("allophant-demo")
    context = Context("tiny", 7, 1.0, False, {}, config, traffic, head, {}, device="cpu")
    model, _ = port.build(config, head, 7, "cpu", training=False)
    estimator = Estimator(model, "float32", "cpu")
    request = next(registry.traffic_kind("utterances").requests(traffic, 7))
    ours = estimator.predict(Batch(request.audio, request.lengths, request.language_ids), time_major=False)
    reference = serve.build_reference(context, torch.device("cpu"))
    theirs, frames = serve.reference_log_probs(context, reference, request, Numerics())
    assert torch.equal(frames, ours.lengths.long())
    for name in serving_heads(head["plan"]):
        for row, length in enumerate(frames.tolist()):
            difference = (ours.outputs[name][row, :length] - theirs[name][row, :length]).abs().max()
            assert float(difference) < 1e-4, name


@pytest.mark.parametrize("workload", ["xlsr300m-greedy-cv", "xlsr300m-beam4-cv", "xlsr1b-train-cv"])
def test_tiny_cells_are_correct_at_float32(workload):
    line = tiny_cells.run(workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    checks = line["checks"]
    if "loss_gap" in checks:
        assert checks["loss_gap"]["value"] < 1e-5 and checks["first_grad_gap"]["value"] < 1e-4
    elif "beam" in workload:
        # The served search agrees with the reference's own search over the
        # reference's log-probs; a best score lies at or below its
        # hypothesis's likelihood, by the alignments the search pruned (the
        # tiny model's near-uniform outputs prune some on every row).
        assert abs(checks["beam_shortfall_nats"]["value"]) < 1e-3
        assert checks["beam_gap_nats"]["value"] < 1e-3
    else:
        assert abs(checks["greedy_gap_nats"]["value"]) < 1e-3


def test_bottleneck_gap_is_zero_on_the_greedy_path_and_infinite_off_the_lattice():
    log_probs = torch.log_softmax(torch.tensor([[[0.0, 3.0, 0.0], [0.0, 3.0, 0.0], [3.0, 0.0, 0.0], [0.0, 0.0, 3.0]]]), -1)
    frames = torch.tensor([4])
    greedy = judge.greedy_sequences(log_probs, frames)
    assert [list(sequence) for sequence in greedy] == [[1, 2]]
    tokens, counts = judge.pad_sequences(greedy, "cpu")
    assert float(judge.bottleneck_gaps(log_probs, frames, tokens, counts)[0]) == 0.0
    # Class 2 where the reference puts 1: the gap is the frame's 3.0 margin.
    tokens, counts = judge.pad_sequences([np.array([2, 2])], "cpu")
    assert float(judge.bottleneck_gaps(log_probs, frames, tokens, counts)[0]) == pytest.approx(3.0, rel=1e-5)
    # Five tokens do not fit four frames.
    tokens, counts = judge.pad_sequences([np.array([1, 2, 1, 2, 1])], "cpu")
    assert math.isinf(float(judge.bottleneck_gaps(log_probs, frames, tokens, counts)[0]))


def test_leaf_gaps_use_the_median_leaf_below_small_leaves():
    reference = {"a": 1.0, "b": 2.0, "c": 1e-6, "d": 0.0}
    counted = judge.counted_leaves(reference)
    assert counted == ["a", "b"]
    gap, leaf = judge.relative_leaf_gaps({"a": 1.1, "b": 2.0, "c": 1.0, "d": 5.0}, reference, counted)
    assert leaf == "a" and gap == pytest.approx(0.1 / 1.5)
