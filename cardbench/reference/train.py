"""The reference's training steps: allophant's multi-task objective and update,
in float32 (CTC in float64), one microbatch's forward and backward at a time.

Per microbatch: the sum over the 37 heads of each head's CTC loss summed
over the real rows, divided by the microbatch's label count, plus
``allophone_l2_alpha`` times the allophone matrices' summed Frobenius
distance from their start. The update: the mean of the microbatches'
gradients (the frozen extractor gets none), the global norm, clipping to
``clip_norm``, then Adam at the warmup schedule's learning rate."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.reference.dropout import DropoutDraws
from cardbench.reference.layers import Sites
from cardbench.reference.model import Numerics, ReferenceAllophant


def learning_rate(schedule: dict, model_size: int, count: int) -> float:
    """The warmup schedule at update ``count`` (0-based), in float32 as
    allophant computes it: factor / sqrt(d) times step * warmup^-1.5 during
    warmup, warmup^-0.5 on the plateau, then (step - constant)^-0.5."""
    scale = np.float32(schedule["factor"] * model_size**-0.5)
    warmup, constant = schedule["warmup_steps"], schedule["constant_steps"]
    step = count + 1
    if step < warmup:
        phase = np.float32(step) * np.float32(warmup**-1.5)
    elif step < warmup + constant:
        phase = np.float32(warmup**-0.5)
    else:
        phase = np.float32(max(step - constant, 1)) ** np.float32(-0.5)
    return float(scale * phase)


@dataclass
class Microbatch:
    """One microbatch as the program's step got it: the port's padded
    [rows, samples] and the real rows' data."""

    audio: np.ndarray  # float32 [r, s] real rows, cut to their longest
    lengths: np.ndarray  # [r]
    language_ids: np.ndarray  # [r]
    labels: Dict[str, np.ndarray]  # head -> [r, n]
    label_lengths: Dict[str, np.ndarray]  # head -> [r]
    padded_rows: int
    padded_samples: int


@dataclass
class StepResult:
    mean_loss: float
    grad_norms: Dict[str, float]  # per leaf, the clipped gradient the optimizer got


def _ctc_sum(logits: torch.Tensor, frames: torch.Tensor, labels: np.ndarray, label_lengths: np.ndarray) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1).double().transpose(0, 1)
    device = logits.device
    losses = F.ctc_loss(
        log_probs, torch.as_tensor(labels, dtype=torch.long, device=device), frames.long(),
        torch.as_tensor(label_lengths, dtype=torch.long, device=device), blank=0, reduction="none",
    )
    return losses.sum().float()


class ReferenceTrainer:
    """Adam state and the step of the reference model."""

    def __init__(self, model: ReferenceAllophant, config: dict, numerics: Numerics = Numerics()):
        self.model = model
        self.config = config
        self.numerics = numerics
        self.count = 0
        frozen = ("acoustic_model.feature_extractor.",) if config["training"]["freeze_feature_encoder"] else ()
        self.trained = {
            name: parameter for name, parameter in model.named_parameters() if not name.startswith(frozen)
        }
        for name, parameter in model.named_parameters():
            parameter.requires_grad_(name in self.trained)
        self.moments = {name: (torch.zeros_like(p), torch.zeros_like(p)) for name, p in self.trained.items()}

    def step(self, microbatches: List[Microbatch], dropout_seed: int, dtypes) -> StepResult:
        model, training = self.model, self.config["training"]
        device = next(model.parameters()).device
        draws = DropoutDraws(dropout_seed, device)
        for parameter in self.trained.values():
            parameter.grad = None
        loss_sum, label_total = 0.0, 0.0
        for microbatch in microbatches:
            frames_padded = int(
                model.frame_lengths(torch.tensor([microbatch.padded_samples])).item()
            )
            sites = Sites(draws, microbatch.padded_rows, frames_padded, dtypes[0], dtypes[1])
            audio = torch.as_tensor(microbatch.audio, device=device)
            lengths = torch.as_tensor(microbatch.lengths, dtype=torch.long, device=device)
            languages = torch.as_tensor(microbatch.language_ids, dtype=torch.long, device=device)
            outputs, frames = model(audio, lengths, languages, self.numerics, sites, serve=False)
            total = sum(
                _ctc_sum(outputs[name], frames, microbatch.labels[name], microbatch.label_lengths[name])
                for name in microbatch.labels
            )
            count = float(sum(int(values.sum()) for values in microbatch.label_lengths.values()))
            objective = total / max(count, 1.0) + training["allophone_l2_alpha"] * model.l2_penalty()
            (objective / len(microbatches)).backward()
            loss_sum += float(total.detach())
            label_total += count
            del outputs, total, objective
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p) for name, p in self.trained.items()}
        norm = torch.linalg.vector_norm(torch.stack([g.double().norm() for g in grads.values()])).float()
        clip = training["clip_norm"]
        factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        optimizer = training["optimizer"]
        beta1, beta2, eps = optimizer["beta_1"], optimizer["beta_2"], optimizer["eps"]
        self.count += 1
        rate = learning_rate(training["lr_schedule"], self.config["architecture"]["hidden_size"], self.count - 1)
        grad_norms = {}
        with torch.no_grad():
            for name, parameter in self.trained.items():
                grad = grads[name] * factor
                grad_norms[name] = float(grad.norm())
                first, second = self.moments[name]
                first.mul_(beta1).add_(grad, alpha=1 - beta1)
                second.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
                denominator = (second.sqrt() / (1 - beta2**self.count) ** 0.5).add_(eps)
                parameter.addcdiv_(first, denominator, value=-rate / (1 - beta1**self.count))
                parameter.grad = None
        return StepResult(loss_sum / max(label_total, 1.0), grad_norms)
