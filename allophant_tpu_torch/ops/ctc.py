"""Loss functions: CTC and mean-pooled sequence cross entropy (counterpart of
``allophant_tpu/ops/ctc.py``).

No Pallas kernel computes CTC in the JAX package (its recurrence is a
``lax.scan``), so the recurrence here is PyTorch's ``F.ctc_loss``
(``reduction="none"``), one call per group of heads with the same class
count, over the heads' rows stacked as one batch.

JAX's zeroing rule (the reference's ``zero_infinity``) is kept and applied
here rather than by ``zero_infinity=True``: a row is zeroed when it is
infeasible (label_length + repeats > frames) or its loss is not finite, and
rows are weighted by ``row_weights``. ``F.ctc_loss``'s backward returns the
gradient for log_softmax outputs, so it is always fed
``log_softmax(logits.float())``, never raw logits.

The recursion runs in float64: the f32 log-probs are cast up before
``F.ctc_loss`` (ATen's own kernels, on the CPU and on CUDA; cuDNN's CTC takes
float32 only) and the gradient is cast back to float32 on its way to the
log_softmax. In float32 the recursion's gradient drifts with the frame count
(1.4e-3 from the exact one at 500 frames, where JAX's float32 ``lax.scan``
stays at 1.2e-4); in float64 it stays at the float32 rounding of the result."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from allophant_tpu_torch import tracing
from allophant_tpu_torch.ops import masking


def _degenerate_rows(labels, label_lengths, logit_lengths) -> torch.Tensor:
    """Rows JAX's rule zeroes whatever their loss: infeasible ones (one frame
    per label plus a blank between equal neighbours exceeds the frames), and
    zero-frame rows (0 when feasible: no labels, nothing to align)."""
    label_valid = masking.mask_sequence(label_lengths, labels.shape[1])
    repeats = ((labels[:, 1:] == labels[:, :-1]) & label_valid[:, 1:]).sum(dim=-1)
    return (label_lengths + repeats > logit_lengths) | (logit_lengths == 0)


def _ctc_rows(log_probs, labels, logit_lengths, label_lengths, blank_id: int) -> torch.Tensor:
    """Per-row f32 CTC losses [R] of f32 log-probs [R, T, C], zeroed by JAX's
    rule; the recursion runs in float64. A degenerate row runs as one frame with no labels (a finite loss and
    gradient) and is zeroed after: its true loss is +inf, whose gradient would
    be NaN even under a zero cotangent."""
    degenerate = _degenerate_rows(labels, label_lengths, logit_lengths)
    tracing.count("ctc_calls")
    losses = F.ctc_loss(
        log_probs.transpose(0, 1).double(),
        labels.long(),
        torch.where(degenerate, torch.ones_like(logit_lengths), logit_lengths).long(),
        torch.where(degenerate, torch.zeros_like(label_lengths), label_lengths).long(),
        blank=blank_id,
        reduction="none",
        zero_infinity=False,
    ).float()
    return torch.where(degenerate | ~torch.isfinite(losses), 0.0, losses)


def _weighted_sum(per_row: torch.Tensor, row_weights: Optional[torch.Tensor]) -> torch.Tensor:
    if row_weights is not None:
        per_row = per_row * row_weights
    return per_row.sum()


def ctc_loss_sum(logits, logit_lengths, labels, label_lengths, blank_id: int = 0, row_weights=None) -> torch.Tensor:
    """Summed CTC loss over a batch: ``logits`` [B, T, K] raw (log_softmax
    taken here in f32), ``labels`` [B, N] padded ids (blank offset applied),
    ``row_weights`` [B] 0/1 excluding batch-padding filler rows."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return _weighted_sum(_ctc_rows(log_probs, labels, logit_lengths, label_lengths, blank_id), row_weights)


def ctc_loss_sum_heads(
    heads: Sequence[Tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]],
    logit_lengths: torch.Tensor,
    blank_id: int = 0,
    row_weights: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Summed CTC losses of several heads over one batch: ``heads`` holds
    (name, logits [B, T, C_head], labels [B, N_head], label_lengths [B]),
    ``logit_lengths`` [B] is shared. Returns {name: summed loss}, each equal to
    ``ctc_loss_sum`` of that head. Heads of equal class count share one
    ``F.ctc_loss`` call over their stacked rows (labels padded to the
    group's widest)."""
    if not heads:
        return {}
    time = heads[0][1].shape[1]
    if any(logits.shape[1] != time for _name, logits, _labels, _lengths in heads):
        raise ValueError("All fused CTC heads must share the same frame count")
    groups = defaultdict(list)
    for head in heads:
        groups[head[1].shape[-1]].append(head)
    batch = heads[0][1].shape[0]
    losses: Dict[str, torch.Tensor] = {}
    for group in groups.values():
        width = max(labels.shape[1] for _name, _logits, labels, _lengths in group)
        log_probs = torch.cat([torch.log_softmax(logits.float(), dim=-1) for _name, logits, _labels, _lengths in group])
        labels = torch.cat([F.pad(labels, (0, width - labels.shape[1])) for _name, _logits, labels, _lengths in group])
        label_lengths = torch.cat([lengths for _name, _logits, _labels, lengths in group])
        per_row = _ctc_rows(log_probs, labels, logit_lengths.repeat(len(group)), label_lengths, blank_id)
        for index, (name, *_rest) in enumerate(group):
            losses[name] = _weighted_sum(per_row[index * batch : (index + 1) * batch], row_weights)
    return {name: losses[name] for name, *_rest in heads}


def sequence_cross_entropy_sum(
    logits, logit_lengths, labels, label_lengths=None, label_smoothing: float = 0.0, row_weights=None
) -> torch.Tensor:
    """Summed cross entropy over mean-pooled (masked) frame logits; one label
    per utterance. The pooling denominator is clamped at 1 so a zero-frame
    filler row gives 0/1, not NaN."""
    mask = masking.mask_sequence(logit_lengths, logits.shape[1]).to(logits.dtype)
    pooled = (logits * mask[:, :, None]).sum(dim=1) / logit_lengths[:, None].clamp_min(1).to(logits.dtype)
    num_classes = pooled.shape[-1]
    log_probs = torch.log_softmax(pooled.float(), dim=-1)
    targets = labels.squeeze(-1) if labels.ndim > 1 else labels
    one_hot = F.one_hot(targets.long(), num_classes).float()
    if label_smoothing > 0:
        one_hot = one_hot * (1.0 - label_smoothing) + label_smoothing / num_classes
    return _weighted_sum(-(one_hot * log_probs).sum(dim=-1), row_weights)
