"""The numbers that decide ``correct``: how far what the program served lies
from the reference's best.

- Greedy: a served token sequence is the collapse of some frame path. The
  gap of a frame is how far the log-probability of the path's class there
  lies below the reference's best class of that frame; the sequence's gap
  is the least, over every path that collapses to it, of the path's widest
  frame gap (a bottleneck path through CTC's alignment lattice). 0 when the
  reference's own greedy decode gives the sequence; infinite when no path
  gives it.
- Beam, from above: the served best hypothesis's score less the
  reference's CTC log-likelihood of that hypothesis (a beam score sums only
  the alignments the search kept, so it cannot pass the likelihood).
- Beam, from below: how far the served best score falls below the best
  score of the reference's own beam search over its log-probabilities, the
  mean over the sample's rows and outputs of one class count, the largest
  such mean (a search that keeps worse beams, or under-reports its scores).
- Training: the gap between the program's and the reference's norm of a
  leaf, over the larger of the reference's norm of that leaf and of the
  median leaf."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pad_sequences(sequences: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    longest = max([len(sequence) for sequence in sequences] + [1])
    tokens = np.zeros((len(sequences), longest), dtype=np.int64)
    for row, sequence in enumerate(sequences):
        tokens[row, : len(sequence)] = sequence
    counts = np.array([len(sequence) for sequence in sequences], dtype=np.int64)
    return torch.as_tensor(tokens, device=device), torch.as_tensor(counts, device=device)


def bottleneck_gaps(log_probs: torch.Tensor, frames: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """[N] least widest frame gap of a path that collapses to each row's
    sequence (``tokens`` [N, L], first ``counts`` valid) under ``log_probs``
    [N, T, C] with ``frames`` [N] valid frames; inf where none does."""
    rows, time, _classes = log_probs.shape
    device = log_probs.device
    gaps = log_probs.amax(dim=-1, keepdim=True) - log_probs  # [N, T, C]
    states = 2 * tokens.shape[1] + 1
    extended = torch.full((rows, states), blank, dtype=torch.long, device=device)
    extended[:, 1::2] = tokens
    index = torch.arange(states, device=device)
    in_sequence = index[None] < (2 * counts[:, None] + 1)
    skip = (index[None] % 2 == 1) & (index[None] >= 3)
    skip = skip & (extended != torch.roll(extended, 2, dims=1))
    infinity = torch.tensor(math.inf, device=device)
    cost = torch.gather(gaps[:, 0], 1, extended)
    best = torch.where((index[None] <= 1) & in_sequence, cost, infinity)
    for t in range(1, time):
        cost = torch.gather(gaps[:, t], 1, extended)
        stay = best
        step = torch.cat((infinity.expand(rows, 1), best[:, :-1]), dim=1)
        jump = torch.cat((infinity.expand(rows, 2), best[:, :-2]), dim=1)
        reach = torch.minimum(stay, step)
        reach = torch.where(skip, torch.minimum(reach, jump), reach)
        updated = torch.where(in_sequence, torch.maximum(reach, cost), infinity)
        best = torch.where((t < frames)[:, None], updated, best)
    last = 2 * counts
    final = best.gather(1, last[:, None])[:, 0]
    before = best.gather(1, (last - 1).clamp_min(0)[:, None])[:, 0]
    final = torch.where(counts > 0, torch.minimum(final, before), final)
    return torch.where(frames > 0, final, torch.where(counts > 0, infinity, torch.zeros_like(final)))


def ctc_log_likelihoods(log_probs: torch.Tensor, frames: torch.Tensor, sequences: Sequence[np.ndarray]) -> torch.Tensor:
    """[N] float64 log P(sequence | frames) under ``log_probs`` [N, T, C]
    (-inf where the sequence does not fit the frames)."""
    tokens, counts = pad_sequences(sequences, log_probs.device)
    losses = F.ctc_loss(
        log_probs.double().transpose(0, 1), tokens, frames.long(), counts, blank=0, reduction="none", zero_infinity=False
    )
    return -losses


def greedy_sequences(log_probs: torch.Tensor, frames: torch.Tensor, blank: int = 0) -> List[np.ndarray]:
    """Each row's greedy CTC decode: argmax, collapse repeats, drop blanks."""
    best = log_probs.argmax(dim=-1).cpu().numpy()
    out = []
    for row, length in enumerate(frames.cpu().numpy()):
        path = best[row, : max(int(length), 0)]
        keep = np.ones(len(path), dtype=bool)
        keep[1:] = path[1:] != path[:-1]
        collapsed = path[keep]
        out.append(collapsed[collapsed != blank])
    return out


def beam_top_sequences(collected: np.ndarray, scores: np.ndarray) -> List[np.ndarray]:
    """The best-scoring hypothesis of each row: ``collected`` [T, B, K] tokens
    (-1 none), ``scores`` [B, K]."""
    out = []
    for row in range(collected.shape[1]):
        column = collected[:, row, int(np.argmax(scores[row]))]
        out.append(column[column >= 0].astype(np.int64))
    return out


def relative_leaf_gaps(program: Dict[str, float], reference: Dict[str, float], counted: Sequence[str]) -> Tuple[float, str]:
    """(largest gap, its leaf): |program - reference| over max(reference,
    median reference) among the ``counted`` leaves."""
    values = np.array([reference[name] for name in counted], dtype=np.float64)
    median = float(np.median(values)) if len(values) else 0.0
    worst, worst_name = 0.0, ""
    for name in counted:
        gap = abs(program[name] - reference[name]) / max(reference[name], median, 1e-30)
        if not np.isfinite(program[name]):
            gap = math.inf
        if gap > worst or worst_name == "":
            worst, worst_name = gap, name
    return worst, worst_name


def counted_leaves(reference_grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others (frozen, or nought to rounding) move under Adam
    by round-off alone."""
    values = np.array(list(reference_grad_norms.values()), dtype=np.float64)
    median = float(np.median(values[values > 0])) if (values > 0).any() else 0.0
    return [name for name, value in reference_grad_norms.items() if value >= share * median and value > 0]
