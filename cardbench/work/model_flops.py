"""Floating-point operations of the model's products and convolutions, by the
type they are multiplied in, counted from each utterance's real samples and
frames (padding is not work). 2 operations a multiply-add.

- Serving runs the forward: the extractor's first convolution in float32
  (the fused frame encoder reads float32 weights), every other encoder
  product in the encoder's type, the head's products in the head's type.
- Training counts a trained product three times (forward, input gradient,
  weight gradient) and the first trained product, the feature projection,
  twice (its input needs no gradient: the extractor is frozen); the frozen
  extractor's forward once; remat's recomputation is not counted.
Layer norms, softmax, GELU, CTC and the optimizer are not counted."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence


def _frames_after(samples: int, kernels: Sequence[int], strides: Sequence[int]) -> list:
    lengths = []
    for kernel, stride in zip(kernels, strides):
        samples = (samples - kernel) // stride + 1
        lengths.append(max(samples, 0))
    return lengths


def utterance_flops(arch: dict, plan: dict, samples: int, encoder: str, head: str, training: bool) -> Dict[str, float]:
    """Operations by type of one utterance of ``samples`` real samples."""
    out: Dict[str, float] = defaultdict(float)
    kernels, strides, channels = arch["conv_kernel"], arch["conv_stride"], [1] + list(arch["conv_dim"])
    lengths = _frames_after(samples, kernels, strides)
    for index, length in enumerate(lengths):
        dtype = "float32" if index == 0 else encoder
        out[dtype] += 2.0 * length * channels[index] * channels[index + 1] * kernels[index]
    frames = lengths[-1]
    width, inner = arch["hidden_size"], arch["intermediate_size"]
    trained = 3.0 if training else 1.0
    out[encoder] += (2.0 if training else 1.0) * 2.0 * frames * channels[-1] * width
    groups, positional = arch["num_conv_pos_embedding_groups"], arch["num_conv_pos_embeddings"]
    per_layer = 2.0 * frames * width * (3 * width + width + 2 * inner) + 4.0 * frames * frames * width
    out[encoder] += trained * (2.0 * frames * width * (width // groups) * positional + arch["num_hidden_layers"] * per_layer)
    head_products = 0.0
    for node in plan["nodes"]:
        head_products += 2.0 * frames * width * node["projection_size"]
        if node.get("has_composition"):
            head_products += 2.0 * frames * node["projection_size"] * node["output_size"]
    out[head] += trained * head_products
    return dict(out)


def total_flops(arch: dict, plan: dict, lengths: Sequence[int], encoder: str, head: str, training: bool) -> Dict[str, float]:
    """Operations by type of utterances of the given real lengths."""
    out: Dict[str, float] = defaultdict(float)
    for samples in lengths:
        for dtype, value in utterance_flops(arch, plan, int(samples), encoder, head, training).items():
            out[dtype] += value
    return dict(out)
