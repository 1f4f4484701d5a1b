"""Batched Levenshtein distances and edit statistics on the device
(counterpart of ``allophant_tpu/ops/levenshtein.py``).

With uniform costs the minimal edit distance equals S + D + I and the expected
length S + D + C, so a corpus-level PER is sum(distance) / sum(expected length)
and needs no backtrace. ``batched_levenshtein_distances`` computes the
distances of a whole padded batch, one DP row a step, each row vectorised
over (batch x positions); the insertion chain's serial dependency is a prefix
minimum over ``t[k] - k``:

    row[j] = min_{k<=j} (t[k] + (j - k))  where  t = min(deletion, substitution)

``batched_edit_statistics`` gives the full I/D/S/C counts, one anti-diagonal a
step, with the native engine's backtrace tie-break. Both are PyTorch ops on
the tensors' device; the loops run on the host, one step per row or
anti-diagonal, up to the longest pair of the batch."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from allophant_tpu_torch.device import resolve_device, to_device

#: The cost of a cell outside the DP table.
_BIG = 1e9


def batched_levenshtein_distances(
    sequences_a: torch.Tensor,
    lengths_a: torch.Tensor,
    sequences_b: torch.Tensor,
    lengths_b: torch.Tensor,
) -> torch.Tensor:
    """Uniform-cost Levenshtein distances of a batch of padded int id
    sequences: ``sequences_a`` [B, M], ``sequences_b`` [B, N], lengths [B];
    returns float32 [B]. Padding is ignored through the lengths."""
    batch = sequences_a.shape[0]
    max_n = sequences_b.shape[1]
    positions = torch.arange(max_n + 1, dtype=torch.float32, device=sequences_a.device)
    row = positions.expand(batch, max_n + 1).clone()
    steps = int(lengths_a.max()) if batch else 0
    for index in range(steps):
        symbol = sequences_a[:, index, None]
        substitution_cost = (symbol != sequences_b).to(torch.float32)
        deletion = row + 1.0
        substitution = row[:, :-1] + substitution_cost
        t = torch.cat((deletion[:, :1], torch.minimum(deletion[:, 1:], substitution)), dim=1)
        new_row = torch.cummin(t - positions, dim=1).values + positions
        # Rows beyond a sequence's length leave its DP state unchanged.
        row = torch.where((index < lengths_a)[:, None], new_row, row)
    return row.gather(1, lengths_b.to(torch.int64)[:, None])[:, 0]


def corpus_error_rate(
    expected_ids: np.ndarray,
    expected_lengths: np.ndarray,
    actual_ids: np.ndarray,
    actual_lengths: np.ndarray,
    device=None,
) -> float:
    """Micro (corpus-pooled) error rate on ``device`` (CUDA unless the caller
    asks for the CPU): the sum of distances over the sum of expected lengths.
    ``expected`` is the reference transcript."""
    device = resolve_device(device)
    distances = batched_levenshtein_distances(
        *(to_device(np.asarray(array), device) for array in (expected_ids, expected_lengths, actual_ids, actual_lengths))
    )
    # A float32 sum over an int, as the JAX package computes it.
    return float(distances.cpu().numpy().sum() / max(int(np.asarray(expected_lengths).sum()), 1))


def encode_token_batches(expected: list, actual: list, pad_multiple: int = 8):
    """Host-side: interns string tokens to shared ids and pads both sides into
    dense int32 batches for the device scorer. Returns (a_ids, a_lengths,
    b_ids, b_lengths)."""
    vocabulary: dict = {}

    def intern(sequence):
        ids = np.empty(len(sequence), dtype=np.int32)
        for position, token in enumerate(sequence):
            identifier = vocabulary.get(token)
            if identifier is None:
                identifier = len(vocabulary)
                vocabulary[token] = identifier
            ids[position] = identifier
        return ids

    expected_ids = [intern(sequence) for sequence in expected]
    actual_ids = [intern(sequence) for sequence in actual]

    def pack(rows):
        lengths = np.asarray([len(row) for row in rows], dtype=np.int32)
        width = max(int(lengths.max(initial=1)), 1)
        width = ((width + pad_multiple - 1) // pad_multiple) * pad_multiple
        packed = np.full((len(rows), width), -1, dtype=np.int32)
        for index, row in enumerate(rows):
            packed[index, : len(row)] = row
        return packed, lengths

    a_ids, a_lengths = pack(expected_ids)
    b_ids, b_lengths = pack(actual_ids)
    # Distinct padding ids on each side so padding never matches.
    b_ids[b_ids == -1] = -2
    return a_ids, a_lengths, b_ids, b_lengths


def _shifted(values: torch.Tensor) -> torch.Tensor:
    """values[:, i - 1] at column i, 0 at column 0."""
    return F.pad(values, (1, 0))[:, :-1]


def batched_edit_statistics(
    sequences_a: torch.Tensor,
    lengths_a: torch.Tensor,
    sequences_b: torch.Tensor,
    lengths_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full I/D/S/C edit statistics of a padded batch on its device.

    Anti-diagonal wavefront DP: the cells of diagonal ``d`` (i + j = d) depend
    only on diagonals d-1 and d-2, so each step is vectorised over (batch x
    diagonal). The counters follow the native engine's backtrace
    (``phonemes.py:_python_backtrace``): deletion is taken only when strictly
    cheaper than insertion, and the diagonal (substitution or match) whenever
    its source costs at most that.

    ``sequences_a`` is the expected side [B, M], ``sequences_b`` the actual
    side [B, N]. Returns (insertions, deletions, substitutions, correct),
    int32 [B] each."""
    batch, max_m = sequences_a.shape
    device = sequences_a.device
    if sequences_b.shape[1] == 0:
        sequences_b = torch.full((batch, 1), -2, dtype=sequences_b.dtype, device=device)
    max_n = sequences_b.shape[1]
    rows = max_m + 1  # the cells of a diagonal, by i
    lengths_a = lengths_a.to(torch.int64)
    lengths_b = lengths_b.to(torch.int64)

    index_i = torch.arange(rows, dtype=torch.int64, device=device)[None, :]
    a_at = F.pad(sequences_a, (1, 0), value=-3)  # a_at[:, i] = a[i - 1]
    zeros = torch.zeros((batch, rows), dtype=torch.int32, device=device)
    cost_d1 = torch.full((batch, rows), _BIG, dtype=torch.float32, device=device)
    cost_d1[:, 0] = 0.0  # diagonal 0: cell (0, 0)
    cost_d2 = torch.full((batch, rows), _BIG, dtype=torch.float32, device=device)
    counts_d1 = counts_d2 = (zeros, zeros, zeros, zeros)
    result = [torch.zeros(batch, dtype=torch.int32, device=device) for _ in range(4)]
    target_diagonal = lengths_a + lengths_b
    steps = int(target_diagonal.max()) if batch else 0

    for d in range(1, steps + 1):
        j = d - index_i  # [1, rows]: each cell's column
        valid = (index_i <= min(d, max_m)) & (j >= 0) & (j <= max_n)
        # Sources: deletion (i-1, j) = d1[i-1]; insertion (i, j-1) = d1[i];
        # substitution (i-1, j-1) = d2[i-1].
        del_cost = F.pad(cost_d1, (1, 0), value=_BIG)[:, :rows]
        ins_cost = cost_d1
        sub_cost = F.pad(cost_d2, (1, 0), value=_BIG)[:, :rows]
        b_symbols = sequences_b.gather(1, (j - 1).clamp(0, max_n - 1).expand(batch, rows))
        mismatch = (a_at != b_symbols).to(torch.float32)
        new_cost = torch.minimum(torch.minimum(del_cost + 1.0, ins_cost + 1.0), sub_cost + mismatch)

        del_preferred = del_cost < ins_cost
        take_diagonal = sub_cost <= torch.where(del_preferred, del_cost, ins_cost)
        is_match = take_diagonal & (sub_cost == new_cost)

        ins1, del1, sub1, cor1 = counts_d1
        ins2, del2, sub2, cor2 = counts_d2

        def choose(diagonal, deletion, insertion):
            return torch.where(take_diagonal, diagonal, torch.where(del_preferred, deletion, insertion))

        new_ins = choose(_shifted(ins2), _shifted(ins1), ins1 + 1)
        new_del = choose(_shifted(del2), _shifted(del1) + 1, del1)
        new_sub = choose(_shifted(sub2) + (take_diagonal & ~is_match).to(torch.int32), _shifted(sub1), sub1)
        new_cor = choose(_shifted(cor2) + is_match.to(torch.int32), _shifted(cor1), cor1)

        # Boundary cells: i == 0 -> all insertions; j == 0 -> all deletions.
        top_row = index_i == 0
        left_col = j == 0
        new_cost = torch.where(top_row, j.to(torch.float32), new_cost)
        new_cost = torch.where(left_col, index_i.to(torch.float32), new_cost)
        j32, i32 = j.to(torch.int32), index_i.to(torch.int32)
        new_ins = torch.where(top_row, j32, torch.where(left_col, zeros, new_ins))
        new_del = torch.where(left_col, i32, torch.where(top_row, zeros, new_del))
        new_sub = torch.where(top_row | left_col, zeros, new_sub)
        new_cor = torch.where(top_row | left_col, zeros, new_cor)
        new_cost = torch.where(valid, new_cost, _BIG)

        new_counts = (new_ins, new_del, new_sub, new_cor)
        hit = target_diagonal == d
        for position, counts in enumerate(new_counts):
            result[position] = torch.where(hit, counts.gather(1, lengths_a[:, None])[:, 0], result[position])
        cost_d1, cost_d2 = new_cost, cost_d1
        counts_d1, counts_d2 = new_counts, counts_d1
    # Empty-vs-empty pairs end on diagonal 0, never stepped: all zero is right.
    insertions, deletions, substitutions, correct = result
    return insertions, deletions, substitutions, correct
