"""Greedy CTC decoding on device (counterpart of the greedy part of
``allophant_tpu/ops/decode.py``): argmax -> run-start detection -> prefix-sum
compaction, batched, with no per-utterance host loop."""

from __future__ import annotations

import torch

from allophant_tpu_torch.ops import masking


def greedy_decode_padded(log_emissions: torch.Tensor, lengths: torch.Tensor, blank_index: int = 0):
    """``log_emissions``: [B, T, C]; returns (tokens [B, T], timesteps [B, T],
    token_counts [B], scores [B]) where each row's first ``token_counts[b]``
    entries are the collapsed non-blank tokens (the rest -1)."""
    # torch.argmax returns the first maximal index, as jnp.argmax does.
    best, indices = log_emissions.amax(dim=-1), log_emissions.argmax(dim=-1)
    return _collapse_greedy(indices, best, lengths, blank_index)


def greedy_decode_logits(logits: torch.Tensor, lengths: torch.Tensor, blank_index: int = 0):
    """``greedy_decode_padded`` fed raw logits: the same tokens, timesteps and
    counts (argmax is invariant to log_softmax); per-frame best log-probs come
    from max - logsumexp in f32."""
    logits32 = logits.float()
    best = logits32.amax(dim=-1) - torch.logsumexp(logits32, dim=-1)
    return _collapse_greedy(logits.argmax(dim=-1), best, lengths, blank_index)


def _collapse_greedy(indices: torch.Tensor, best: torch.Tensor, lengths: torch.Tensor, blank_index: int):
    batch, time = indices.shape
    valid = masking.mask_sequence(lengths, time)
    previous = torch.cat((torch.full_like(indices[:, :1], -1), indices[:, :-1]), dim=1)
    keep = (indices != previous) & valid & (indices != blank_index)

    # Each kept position's output slot is its rank among kept positions (the
    # prefix sum is monotone, so time order is preserved); dropped positions
    # write to a spill column that is cut off afterwards.
    slots = torch.where(keep, torch.cumsum(keep, dim=1) - 1, time)
    tokens = torch.full((batch, time + 1), -1, dtype=indices.dtype, device=indices.device)
    tokens.scatter_(1, slots, indices)
    positions = torch.arange(1, time + 1, device=indices.device).expand(batch, time)
    timesteps = torch.zeros((batch, time + 1), dtype=indices.dtype, device=indices.device)
    timesteps.scatter_(1, slots, positions)
    counts = keep.sum(dim=1)
    scores = torch.where(valid, best, torch.zeros((), dtype=best.dtype, device=best.device)).sum(dim=1)
    return tokens[:, :time], timesteps[:, :time], counts, scores
