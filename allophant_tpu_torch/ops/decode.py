"""CTC decoding (counterpart of ``allophant_tpu/ops/decode.py``): batched greedy
decoding on device, the batched CTC prefix beam search with its backtrace, the
decoders built on them, and the host-side prefix beam search.

Greedy decoding is argmax -> run-start detection -> prefix-sum compaction, with
no per-utterance host loop. The batched beam search is a lexicon-free CTC
prefix beam with log-add merging (flashlight's configuration in the reference:
no lexicon or LM, silence == blank). ``beam_search_device`` runs its plain
PyTorch version ``beam_search_padded`` for CPU tensors and launches the CUDA
kernel ``csrc/beam_search.cu`` for CUDA tensors; the backtrace is routed the
same way by ``backtrace_on_device``."""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from allophant_tpu_torch import tracing
from allophant_tpu_torch.device import resolve_device, to_device
from allophant_tpu_torch.ops import masking
from allophant_tpu_torch.ops.beam_kernel import MAX_CLASSES, backtrace_cuda


class CTCHypothesis(NamedTuple):
    """flashlight-compatible hypothesis: token ids, words (unused), score, 1-based
    run-start timesteps."""

    tokens: np.ndarray
    words: List[str]
    score: float
    timesteps: np.ndarray


def greedy_decode_padded(log_emissions: torch.Tensor, lengths: torch.Tensor, blank_index: int = 0):
    """``log_emissions``: [B, T, C]; returns (tokens [B, T], timesteps [B, T],
    token_counts [B], scores [B]) where each row's first ``token_counts[b]``
    entries are the collapsed non-blank tokens (the rest -1)."""
    tracing.count("decode_calls")
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


class GreedyCTCDecoder:
    """Greedy decoder with the reference's call contract: batch-first log
    emissions + lengths -> per-utterance single-hypothesis lists. Emissions
    given as numpy arrays are moved to ``device`` (CUDA unless asked
    otherwise)."""

    def __init__(self, blank_index: int = 0, device=None):
        self._blank_index = blank_index
        self._device = resolve_device(device)

    def __call__(self, log_emissions, lengths) -> List[List[CTCHypothesis]]:
        return self.collect(self.dispatch(log_emissions, lengths))

    def dispatch(self, log_emissions, lengths):
        """Enqueues the device decode without synchronising; ``collect`` (or
        ``collect_many`` over several heads) copies the results to the host."""
        log_emissions = torch.as_tensor(log_emissions, device=self._device)
        lengths = torch.as_tensor(lengths, device=self._device)
        return greedy_decode_padded(log_emissions, lengths, self._blank_index)

    @staticmethod
    def collect(dispatched) -> List[List[CTCHypothesis]]:
        tokens, timesteps, counts, scores = (part.cpu().numpy() for part in dispatched)
        return _hypotheses_from_host(tokens, timesteps, counts, scores)

    @staticmethod
    def collect_many(dispatched_by_name, with_timesteps: bool = True) -> dict:
        """Fused ``collect`` over several dispatched heads with identical [B, T]
        result shapes: the components stack on the device and copy to the host
        together.

        ``with_timesteps=False`` is the serving drain: token ids are clamped
        non-negative and packed with the per-row counts and the two uint16
        halves of each f32 score (low half first, as the score lies in
        little-endian memory) into one uint16 grid [H, B, T+3], so the wave
        copies in one transfer. Hypotheses then carry empty ``timesteps``."""
        names = list(dispatched_by_name)
        if not names:
            return {}
        if with_timesteps:
            if len(names) == 1:
                return {names[0]: GreedyCTCDecoder.collect(dispatched_by_name[names[0]])}
            stacked = [
                torch.stack([dispatched_by_name[name][part] for name in names]).cpu().numpy() for part in range(4)
            ]
            return {
                name: _hypotheses_from_host(stacked[0][head], stacked[1][head], stacked[2][head], stacked[3][head])
                for head, name in enumerate(names)
            }

        lanes = []
        for name in names:
            tokens, _timesteps, counts, scores = dispatched_by_name[name]
            score_halves = scores.float().contiguous().view(torch.uint16).view(-1, 2).to(torch.int32)
            lanes.append(torch.cat((counts[:, None].to(torch.int32), score_halves, tokens.clamp_min(0).to(torch.int32)), dim=1))
        grid = torch.stack(lanes).to(torch.uint16).cpu().numpy()
        empty_timesteps = np.zeros(0, np.int64)
        results = {}
        for head, name in enumerate(names):
            lane = grid[head]
            counts = lane[:, 0]
            scores = np.ascontiguousarray(lane[:, 1:3]).view(np.float32).ravel()
            tokens = lane[:, 3:]
            results[name] = [
                [CTCHypothesis(tokens[row, : counts[row]].astype(np.int64), [], float(scores[row]), empty_timesteps)]
                for row in range(lane.shape[0])
            ]
        return results


def _hypotheses_from_host(
    tokens: np.ndarray, timesteps: np.ndarray, counts: np.ndarray, scores: np.ndarray
) -> List[List[CTCHypothesis]]:
    outputs = []
    for row in range(tokens.shape[0]):
        count = int(counts[row])
        outputs.append([CTCHypothesis(tokens[row, :count], [], float(scores[row]), timesteps[row, :count])])
    return outputs


def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    return float(np.logaddexp(a, b))


class BeamCTCDecoder:
    """Lexicon-free CTC prefix beam search with log-add merging, on the host
    in numpy and Python (flashlight's configuration in the reference: no
    lexicon or LM, silence == blank, n-best output)."""

    def __init__(self, tokens: List[str], beam_width: int, n_best: int = 1, blank_index: int = 0):
        self._tokens = tokens
        self._beam_width = beam_width
        self._n_best = n_best
        self._blank_index = blank_index

    def _decode_single(self, log_probs: np.ndarray) -> List[CTCHypothesis]:
        time, classes = log_probs.shape
        # prefix -> [log_blank, log_non_blank, timesteps, best_path_score]; the
        # timesteps of a merged prefix follow its highest-scoring contributing
        # path (flashlight keeps the best candidate's backpointers on merge).
        beams = {(): [0.0, -math.inf, (), 0.0]}
        for t in range(time):
            frame = log_probs[t]
            # Prune classes for speed: top candidates per frame.
            candidates = np.argsort(frame)[::-1][: max(self._beam_width, 8)]
            next_beams: dict = {}

            def merge(prefix, log_blank, log_non_blank, timesteps):
                contribution = _log_add(log_blank, log_non_blank)
                entry = next_beams.get(prefix)
                if entry is None:
                    next_beams[prefix] = [log_blank, log_non_blank, timesteps, contribution]
                else:
                    entry[0] = _log_add(entry[0], log_blank)
                    entry[1] = _log_add(entry[1], log_non_blank)
                    if contribution > entry[3]:
                        entry[2] = timesteps
                        entry[3] = contribution

            candidate_set = set(int(token) for token in candidates)
            for prefix, (log_blank, log_non_blank, timesteps, _best) in beams.items():
                total = _log_add(log_blank, log_non_blank)
                # "Stay" transition: blank extension and (for non-empty prefixes)
                # a repeat of the last token both keep the prefix — they form ONE
                # merged candidate, so their combined mass is this path's
                # contribution when competing for the merged prefix's timesteps
                # (mirrors the device search's blank-column candidate).
                stay_blank = (
                    total + float(frame[self._blank_index]) if self._blank_index in candidate_set else -math.inf
                )
                stay_non_blank = (
                    log_non_blank + float(frame[prefix[-1]]) if prefix and prefix[-1] in candidate_set else -math.inf
                )
                if stay_blank > -math.inf or stay_non_blank > -math.inf:
                    merge(prefix, stay_blank, stay_non_blank, timesteps)
                for token in candidates:
                    token_log = float(frame[token])
                    if token == self._blank_index:
                        continue  # handled as part of the stay candidate
                    new_prefix = prefix + (token,)
                    if prefix and token == prefix[-1]:
                        # Growing by a repeated token requires an intervening
                        # blank, so only the blank-ending mass extends.
                        merge(new_prefix, -math.inf, log_blank + token_log, timesteps + (t + 1,))
                    else:
                        merge(new_prefix, -math.inf, total + token_log, timesteps + (t + 1,))

            # Keep the best `beam_width` prefixes.
            scored = sorted(
                next_beams.items(), key=lambda item: _log_add(item[1][0], item[1][1]), reverse=True
            )[: self._beam_width]
            beams = dict(scored)

        hypotheses = []
        for prefix, (log_blank, log_non_blank, timesteps, _best) in sorted(
            beams.items(), key=lambda item: _log_add(item[1][0], item[1][1]), reverse=True
        )[: self._n_best]:
            hypotheses.append(
                CTCHypothesis(
                    np.asarray(prefix, dtype=np.int64),
                    [],
                    _log_add(log_blank, log_non_blank),
                    np.asarray(timesteps, dtype=np.int64),
                )
            )
        return hypotheses

    def __call__(self, log_emissions, lengths=None) -> List[List[CTCHypothesis]]:
        log_emissions = np.asarray(log_emissions)
        batch = log_emissions.shape[0]
        outputs = []
        for row in range(batch):
            length = int(lengths[row]) if lengths is not None else log_emissions.shape[1]
            outputs.append(self._decode_single(log_emissions[row, :length]))
        return outputs

    # Same two-phase contract as GreedyCTCDecoder so callers can treat all
    # decoders uniformly; the host search finishes in dispatch, so collect is
    # the identity.
    def dispatch(self, log_emissions, lengths=None):
        return self(log_emissions, lengths)

    @staticmethod
    def collect(dispatched):
        return dispatched


# ---------------------------------------------------------------------------
# Batched device beam search
# ---------------------------------------------------------------------------

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


def beam_search_device(log_emissions: torch.Tensor, lengths: torch.Tensor, beam_width: int = 4, blank_index: int = 0):
    """The batched prefix beam search where its inputs lie, with the contract
    of :func:`beam_search_padded`, through the custom op
    ``allophant_torch::beam_search`` (``kernels/library.py``): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors
    (``beam_search_cuda.launches`` counts its launches), and an error on any
    other device.

    The JAX package routes by a VMEM plan (``plan_beam_kernel``) and by
    measured TPU timings between its Pallas kernel and the ``lax.scan``. The
    CUDA kernel streams the emissions step by step and takes every T and every
    class count up to ``MAX_CLASSES``, so neither the plan nor the router has
    a counterpart here. Class counts above ``MAX_CLASSES`` raise on both
    paths: decoded tokens leave the device as int16."""
    from allophant_tpu_torch.kernels import library

    classes = log_emissions.shape[-1]
    if classes > MAX_CLASSES:
        raise ValueError(f"beam search takes at most {MAX_CLASSES} classes (int16 tokens), got {classes}")
    if log_emissions.device.type not in ("cpu", "cuda"):
        raise ValueError(f"beam search runs on CPU or CUDA tensors, not {log_emissions.device}")
    return library.beam_search(log_emissions, lengths, int(beam_width), int(blank_index))


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


def backtrace_on_device(parents: torch.Tensor, emitted: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """:func:`backtrace_beams_device` for CPU tensors; the backtrace kernel
    for CUDA tensors (``backtrace_cuda.launches`` counts its launches); an
    error on any other device."""
    if emitted.device.type == "cpu":
        return backtrace_beams_device(parents, emitted, lengths)
    if emitted.device.type == "cuda":
        return backtrace_cuda(parents, emitted, lengths)
    raise ValueError(f"beam backtrace runs on CPU or CUDA tensors, not {emitted.device}")


def backtrace_beams(parents, emitted, scores, lengths):
    """Vectorized n-best prefix reconstruction on the host: one backward pass
    over time on [B, K] int arrays. Returns ``(collected [T, B, K], scores
    [B, K])`` where ``collected[t, b, k]`` is the token hypothesis ``k`` of row
    ``b`` emitted at step ``t`` (-1 = none); a hypothesis's token sequence is
    its column's non-negative entries in time order."""
    time_steps, batch_rows, k_beams = emitted.shape
    rows = np.arange(batch_rows)[:, None]
    cursor = np.tile(np.arange(k_beams, dtype=np.int64)[None, :], (batch_rows, 1))
    collected = np.full((time_steps, batch_rows, k_beams), -1, np.int64)
    lengths = np.asarray(lengths)
    for t in range(time_steps - 1, -1, -1):
        valid = t < lengths[:, None]
        token = emitted[t, rows, cursor]
        collected[t] = np.where(valid, token, -1)
        cursor = np.where(valid, parents[t, rows, cursor], cursor)
    return collected, np.asarray(scores)


def beam_search_heads(
    log_probs: Sequence[torch.Tensor], lengths: torch.Tensor, beam_width: int = 4, blank_index: int = 0
):
    """Beam search + backtrace of several heads over the same frames
    ([B, T, C_h] each): returns ``collected`` int16 [H, T, B, K] and ``scores``
    f32 [H, B, K] in the order of ``log_probs``.

    Rows are independent, so heads of equal class count are stacked along the
    batch axis and searched by one launch (and backtraced by one more): the
    flagship's 36 four-class attribute heads make one [36·B, T, 4] search,
    its phone and phoneme outputs one or two more."""
    if not log_probs:
        raise ValueError("beam_search_heads needs at least one head")
    tracing.count("decode_calls")
    batch, time = log_probs[0].shape[:2]
    device = log_probs[0].device
    collected = torch.empty(len(log_probs), time, batch, beam_width, dtype=torch.int16, device=device)
    scores = torch.empty(len(log_probs), batch, beam_width, dtype=torch.float32, device=device)
    groups: dict = {}
    for head, values in enumerate(log_probs):
        groups.setdefault(values.shape[-1], []).append(head)
    for members in groups.values():
        stacked = torch.cat([log_probs[head] for head in members]) if len(members) > 1 else log_probs[members[0]]
        stacked_lengths = lengths.repeat(len(members))
        parents, emitted, group_scores = beam_search_device(stacked, stacked_lengths, beam_width, blank_index)
        group_collected = backtrace_on_device(parents, emitted, stacked_lengths)
        index = to_device(torch.tensor(members), device)
        collected[index] = group_collected.view(time, len(members), batch, beam_width).transpose(0, 1).to(torch.int16)
        scores[index] = group_scores.view(len(members), batch, beam_width)
    return collected, scores


class DeviceBeamCTCDecoder:
    """Batched beam decoder, with scoring and backtrace on the device and the
    n-best assembly on the host; the same call contract as
    :class:`BeamCTCDecoder`. Emissions given as numpy arrays are moved to
    ``device`` (CUDA unless asked otherwise)."""

    def __init__(self, tokens: List[str], beam_width: int, n_best: int = 1, blank_index: int = 0, device=None):
        self._tokens = tokens
        self._beam_width = beam_width
        self._n_best = min(n_best, beam_width)
        self._blank_index = blank_index
        self._device = resolve_device(device)

    def __call__(self, log_emissions, lengths=None) -> List[List[CTCHypothesis]]:
        return self.collect(self.dispatch(log_emissions, lengths))

    def dispatch(self, log_emissions, lengths=None):
        """Enqueues the search and the backtrace without synchronising;
        ``collect`` copies the token grid to the host."""
        log_emissions = torch.as_tensor(log_emissions, device=self._device)
        batch, time, _classes = log_emissions.shape
        if lengths is None:
            lengths_tensor = torch.full((batch,), time, dtype=torch.int32, device=self._device)
        else:
            lengths_tensor = torch.as_tensor(lengths, device=self._device).to(torch.int32)
        parents, emitted, scores = beam_search_device(log_emissions, lengths_tensor, self._beam_width, self._blank_index)
        collected = backtrace_on_device(parents, emitted, lengths_tensor)
        return collected, scores, lengths_tensor

    def collect(self, dispatched) -> List[List[CTCHypothesis]]:
        collected, scores, _lengths = dispatched
        return self._assemble(collected.cpu().numpy(), scores.cpu().numpy())

    @staticmethod
    def collect_many(dispatched_by_name, decoders) -> dict:
        """Fused ``collect`` over several dispatched beam heads with identical
        [T, B, K] grids: token grids and scores stack on the device and copy to
        the host in two transfers."""
        names = list(dispatched_by_name)
        if not names:
            return {}
        if len(names) == 1:
            name = names[0]
            return {name: decoders[name].collect(dispatched_by_name[name])}
        grids = (
            torch.stack([dispatched_by_name[name][0].to(torch.int16) for name in names]).cpu().numpy().astype(np.int64)
        )
        scores = torch.stack([dispatched_by_name[name][1] for name in names]).cpu().numpy()
        return {name: decoders[name]._assemble(grids[head], scores[head]) for head, name in enumerate(names)}

    def _assemble(self, collected: np.ndarray, scores: np.ndarray) -> List[List[CTCHypothesis]]:
        batch = collected.shape[1]
        outputs: List[List[CTCHypothesis]] = []
        for row in range(batch):
            order = np.argsort(scores[row])[::-1][: self._n_best]
            # Dead beam slots (score pinned at _NEG_INF) are padding, not real
            # hypotheses: flashlight returns only live beams. Keep at least the
            # best slot so every utterance yields one hypothesis.
            live = [beam for beam in order if scores[row, beam] > _NEG_INF / 2]
            order = live if live else list(order[:1])
            hypotheses = []
            for beam in order:
                sequence = collected[:, row, beam]
                mask = sequence >= 0
                timesteps = np.nonzero(mask)[0] + 1
                hypotheses.append(
                    CTCHypothesis(sequence[mask].astype(np.int64), [], float(scores[row, beam]), timesteps.astype(np.int64))
                )
            outputs.append(hypotheses)
        return outputs
