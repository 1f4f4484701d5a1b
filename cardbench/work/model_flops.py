"""Floating-point operations of the model's products and convolutions, by the
type they are multiplied in, counted from each utterance's real samples and
frames (padding is not work). 2 operations a multiply-add.

- The encoder's: its port-facing file's ``encoder_flops``
  (``encoders/<encoder>.py``), for the configuration's ``encoder``.
- The head's products in the head's type: the classifiers, and the phoneme
  layer's composed product. Training counts each three times (forward,
  input gradient, weight gradient); remat's recomputation is not counted.
Layer norms, softmax, GELU, CTC and the optimizer are not counted."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

from cardbench.core import registry


def utterance_flops(config: dict, plan: dict, samples: int, encoder: str, head: str, training: bool) -> Dict[str, float]:
    """Operations by type of one utterance of ``samples`` real samples."""
    out: Dict[str, float] = defaultdict(float)
    frames, encoder_ops = registry.encoder(config["encoder"]).encoder_flops(config["architecture"], samples, encoder, training)
    for dtype, value in encoder_ops.items():
        out[dtype] += value
    width = config["architecture"]["hidden_size"]
    head_products = 0.0
    for node in plan["nodes"]:
        head_products += 2.0 * frames * width * node["projection_size"]
        if node.get("has_composition"):
            head_products += 2.0 * frames * node["projection_size"] * node["output_size"]
    out[head] += (3.0 if training else 1.0) * head_products
    return dict(out)


def total_flops(config: dict, plan: dict, lengths: Sequence[int], encoder: str, head: str, training: bool) -> Dict[str, float]:
    """Operations by type of utterances of the given real lengths."""
    out: Dict[str, float] = defaultdict(float)
    for samples in lengths:
        for dtype, value in utterance_flops(config, plan, int(samples), encoder, head, training).items():
            out[dtype] += value
    return dict(out)
