"""A run with its timed path broken underneath comes out not correct: the
faults each cell can have, planted in the port's path of a tiny run on the
CPU (the card's look is skipped). One card, so no exchange between chips
can be left out."""

import copy

import numpy as np
import pytest

import tiny_cells


def altered_token(host):
    """One served token of the phone layer (the last output) changed to
    another phone, where the program produced it."""
    host = tuple(copy.deepcopy(part) for part in host)
    if host[0].ndim == 3:  # greedy grid [H, B, T + 1]
        grid = host[0]
        row = int(np.argmax(grid[-1, :, 0]))
        grid[-1, row, 1] = grid[-1, row, 1] % 39 + 1 if grid[-1, row, 0] else 1
        grid[-1, row, 0] = max(grid[-1, row, 0], 1)
    else:  # beam: collected [H, T, B, K], scores [H, B, K]
        collected, scores = host[0], host[1]
        best = int(np.argmax(scores[-1, 0]))
        column = collected[-1, :, 0, best]
        emitted = np.flatnonzero(column >= 0)
        position = emitted[0] if len(emitted) else 0
        column[position] = (max(column[position], 0) + 19) % 39 + 1
    return host


@pytest.mark.parametrize("workload", ["xlsr300m-greedy-cv", "xlsr300m-beam4-cv"])
def test_an_altered_token_is_not_correct(workload):
    line = tiny_cells.run(workload, faults={"served": altered_token})
    assert not line["correct"], line["checks"]


def lowered_scores(host):
    """Every beam's score under-reported by 5 nats, its hypotheses kept."""
    collected, scores, lengths = host
    return collected, scores - np.float32(5.0), lengths


def empty_hypotheses(host):
    """The search returns no tokens and a score of -inf for every beam."""
    collected, scores, lengths = host
    return np.full_like(collected, -1), np.full_like(scores, -np.inf), lengths


@pytest.mark.parametrize("fault", [lowered_scores, empty_hypotheses], ids=["lowered_scores", "empty_hypotheses"])
def test_a_search_that_falls_short_is_not_correct(fault):
    line = tiny_cells.run("xlsr300m-beam4-cv", faults={"served": fault})
    shortfall = line["checks"]["beam_shortfall_nats"]
    assert float(shortfall["value"]) > shortfall["limit"], line["checks"]
    assert not line["correct"], line["checks"]


def test_a_sound_tiny_beam_run_is_correct():
    line = tiny_cells.run("xlsr300m-beam4-cv")
    assert line["correct"], line["checks"]


def unchanged_state(step, model, optimizer):
    """A step that returns the model and the optimizer as they were."""

    def run(microbatches, rng=None, global_step=0, extra=()):
        import torch

        saved = {name: value.detach().clone() for name, value in model.named_parameters()}
        state = copy.deepcopy(optimizer.optimizer.state_dict())
        count = optimizer.count
        metrics = step(microbatches, rng, global_step, extra)
        with torch.no_grad():
            for name, value in model.named_parameters():
                value.copy_(saved[name])
        optimizer.optimizer.load_state_dict(state)
        optimizer.count = count
        return metrics

    return run


def half_batch(step, _model, _optimizer):
    """A step over the first half of each microbatch's rows, its mean taken
    over them."""

    def run(microbatches, rng=None, global_step=0, extra=()):
        rows = next(iter(microbatches.values())).shape[1]
        keep = max(1, (rows + 1) // 2)
        return step({name: value[:, :keep] for name, value in microbatches.items()}, rng, global_step, extra)

    return run


@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=["unchanged_state", "half_batch"])
@pytest.mark.parametrize("workload", ["xlsr1b-train-cv"])
def test_a_broken_training_step_is_not_correct(workload, fault):
    line = tiny_cells.run(workload, faults={"step": fault})
    assert not line["correct"], line["checks"]
