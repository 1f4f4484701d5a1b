"""A frozen copy of the port's plain CTC prefix beam search (the twin of its
K3 kernel and backtrace, ``ops/decode.py``), which the reference runs on its
own log-probabilities. Lexicon-free, with log-add merging of equal prefixes.
Imports nothing of the program."""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


# Two independent 32-bit rolling-hash multipliers identify prefixes for merging
# (a single 32-bit hash collides too often over 500-step searches).
_HASH_P1 = 1_000_003
_HASH_P2 = 31_337


def _wrap_int32(values: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 to the signed int32 range: the JAX
    package's int32 hash arithmetic wraps, and this reproduces it without
    relying on how torch overflows int32."""
    values = values & 0xFFFFFFFF
    return torch.where(values >= 2**31, values - 2**32, values)


def _rolling_hash(hashes: torch.Tensor, multiplier: int, class_ids: torch.Tensor) -> torch.Tensor:
    """[B, K] hashes extended by every class: ``h * P + (c + 1)`` in wrapping
    int32 arithmetic, as int64 [B, K, C]."""
    return _wrap_int32(hashes[:, :, None] * multiplier + (class_ids[None, None, :] + 1))


def _top_k_small(values: torch.Tensor, k: int):
    """Top-k by k rounds of (argmax, mask with -inf); ties resolve to the
    lowest index first, as in the JAX package."""
    remaining = values
    columns = torch.arange(values.shape[-1], device=values.device)
    tops = []
    indices = []
    for _ in range(k):
        best = remaining.argmax(dim=-1)  # first maximal index on ties
        tops.append(values.gather(1, best[:, None])[:, 0])
        indices.append(best)
        remaining = torch.where(columns[None, :] == best[:, None], -math.inf, remaining)
    return torch.stack(tops, dim=-1), torch.stack(indices, dim=-1)


def beam_search_padded(log_emissions: torch.Tensor, lengths: torch.Tensor, beam_width: int = 4, blank_index: int = 0):
    """Batched lexicon-free CTC prefix beam search with log-add merging: the
    plain PyTorch version of the CUDA kernel, a loop over time on [B, K, C]
    tensors, step for step the JAX package's ``lax.scan`` formulation.

    Prefix merging is sort-free. Live beams hold pairwise-distinct prefixes, so
    the only possible merge is one beam's extension landing on another beam's
    unchanged prefix ("stay"); that pairing is found by comparing two rolling
    hashes of every extension with every beam's, [B, K, C] x [B, K]. A merged
    pair's backpointer follows its best-scoring pre-merge candidate, as
    flashlight keeps the best candidate's backpointers.

    ``log_emissions``: [B, T, C] log probabilities; returns (parents [T, B, K],
    emitted [T, B, K], scores [B, K]) where ``emitted`` is the token added at
    each step per beam (-1 = none) and ``parents`` chains beams backwards."""
    batch, time, classes = log_emissions.shape
    device = log_emissions.device
    k_beams = beam_width
    class_ids = torch.arange(classes, device=device)
    beam_ids = torch.arange(k_beams, device=device)
    lengths = lengths.to(device=device, dtype=torch.int64)

    hash1 = torch.ones(batch, k_beams, dtype=torch.int64, device=device)
    hash2 = torch.ones(batch, k_beams, dtype=torch.int64, device=device)
    last = torch.full((batch, k_beams), -1, dtype=torch.int64, device=device)
    logp_b = torch.full((batch, k_beams), _NEG_INF, dtype=torch.float32, device=device)
    logp_b[:, 0] = 0.0
    logp_nb = torch.full((batch, k_beams), _NEG_INF, dtype=torch.float32, device=device)
    parents = torch.empty(time, batch, k_beams, dtype=torch.int32, device=device)
    emitted = torch.empty(time, batch, k_beams, dtype=torch.int32, device=device)
    identity = beam_ids[None, :].expand(batch, k_beams)
    log_emissions = log_emissions.float()

    for t in range(time):
        emissions = log_emissions[:, t]  # [B, C]
        total = torch.logaddexp(logp_b, logp_nb)  # [B, K]
        alive = total > _NEG_INF / 2

        blank_emission = emissions[:, blank_index, None]  # [B, 1]
        # Emission of each beam's last token (for the repeat-without-growing case).
        last_emission = torch.where(last >= 0, emissions.gather(1, last.clamp_min(0)), _NEG_INF)

        # Candidate grid [B, K, C]; the blank column holds the "stay" candidate
        # (same prefix), every other column extends the prefix with that
        # token. A repeated token only extends via the post-blank path.
        is_repeat = class_ids[None, None, :] == last[:, :, None]
        ext_source = torch.where(is_repeat, logp_b[:, :, None], total[:, :, None])
        ext_nb = ext_source + emissions[:, None, :]
        stay_b = total + blank_emission  # [B, K]
        stay_nb = logp_nb + last_emission

        ext_h1 = _rolling_hash(hash1, _HASH_P1, class_ids)
        ext_h2 = _rolling_hash(hash2, _HASH_P2, class_ids)

        # Extension (k1, c) collides with stay (k2) iff the extended prefix's
        # hashes equal beam k2's. At most one k2 matches each (k1, c) unless
        # two live beams share both hashes; then the last k2 wins, as in the
        # Pallas kernel and the CUDA kernel (the JAX scan sums them).
        match = (
            (ext_h1[:, :, :, None] == hash1[:, None, None, :])
            & (ext_h2[:, :, :, None] == hash2[:, None, None, :])
            & alive[:, None, None, :]
            & alive[:, :, None, None]
            & (class_ids[None, None, :, None] != blank_index)
        )  # [B, K, C, K]
        last_match = torch.where(match, beam_ids, -1).amax(dim=3)  # [B, K, C]
        ext_matched = last_match >= 0
        matched_stay_slot = last_match.clamp_min(0)

        def matched_stay(values):  # [B, K] -> [B, K, C], read where ext_matched
            return values.gather(1, matched_stay_slot.reshape(batch, -1)).reshape(batch, k_beams, classes)

        stay_consumed = match.any(dim=(1, 2))  # [B, K]

        # Merged scores live on the extension slot; the consumed stay slot dies
        # so the prefix cannot enter the next beam set twice.
        merged_nb = torch.where(ext_matched, torch.logaddexp(ext_nb, matched_stay(stay_nb)), ext_nb)
        cand_b = torch.where(ext_matched, matched_stay(stay_b), _NEG_INF)
        cand_b[:, :, blank_index] = torch.where(stay_consumed, _NEG_INF, stay_b)
        cand_nb = merged_nb
        cand_nb[:, :, blank_index] = torch.where(stay_consumed, _NEG_INF, stay_nb)
        cand_total = torch.logaddexp(cand_b, cand_nb).reshape(batch, -1)

        # The merged pair's representative, whose parent/emission chain gives
        # the hypothesis timesteps, is its best-scoring pre-merge candidate.
        pre_stay_total = matched_stay(torch.logaddexp(stay_b, stay_nb))
        ext_is_rep = ~ext_matched | (ext_nb >= pre_stay_total)  # [B, K, C]

        top_total, chosen = _top_k_small(cand_total, k_beams)  # [B, K]
        parent_slot = chosen // classes
        token = chosen % classes
        is_stay = token == blank_index

        def grid_take(grid):  # [B, K, C] -> [B, K] at the chosen candidates
            return grid.reshape(batch, -1).gather(1, chosen)

        dead_new = top_total <= _NEG_INF / 2
        new_b = torch.where(dead_new, _NEG_INF, grid_take(cand_b))
        new_nb = torch.where(dead_new, _NEG_INF, grid_take(cand_nb))
        new_hash1 = torch.where(is_stay, hash1.gather(1, parent_slot), grid_take(ext_h1))
        new_hash2 = torch.where(is_stay, hash2.gather(1, parent_slot), grid_take(ext_h2))
        new_last = torch.where(is_stay, last.gather(1, parent_slot), token)

        # Backtrace records: a merged slot whose representative is the stay
        # points at the stay's beam and emits nothing this step.
        chosen_ext_is_rep = grid_take(ext_is_rep)
        rep_parent = torch.where(is_stay | chosen_ext_is_rep, parent_slot, grid_take(matched_stay_slot))
        emit_token = ~is_stay & chosen_ext_is_rep

        # Freeze state past each utterance's length.
        active = (t < lengths)[:, None]  # [B, 1]
        parents[t] = torch.where(active, rep_parent, identity)
        emitted[t] = torch.where(active & emit_token, token, -1)
        hash1 = torch.where(active, new_hash1, hash1)
        hash2 = torch.where(active, new_hash2, hash2)
        last = torch.where(active, new_last, last)
        logp_b = torch.where(active, new_b, logp_b)
        logp_nb = torch.where(active, new_nb, logp_nb)

    return parents, emitted, torch.logaddexp(logp_b, logp_nb)


def backtrace_beams_device(parents: torch.Tensor, emitted: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """n-best prefix reconstruction where the search ran: one reverse loop
    over time threading per-(row, beam) parent cursors (the plain version of
    the backtrace kernel; the JAX package's reverse ``lax.scan``). Returns
    ``collected [T, B, K]``: the token emitted at step t by hypothesis k of row
    b, -1 = none."""
    time_steps, batch, k_beams = emitted.shape
    lengths = lengths.to(device=emitted.device, dtype=torch.int64)
    cursor = torch.arange(k_beams, device=emitted.device)[None, :].repeat(batch, 1)
    collected = torch.empty_like(emitted)
    for t in range(time_steps - 1, -1, -1):
        valid = t < lengths[:, None]
        collected[t] = torch.where(valid, emitted[t].gather(1, cursor), -1)
        cursor = torch.where(valid, parents[t].gather(1, cursor).long(), cursor)
    return collected


