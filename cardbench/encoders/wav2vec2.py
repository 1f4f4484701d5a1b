"""wav2vec2 / XLS-R as the port runs it (``allophant_tpu_torch.models.wav2vec2``):
what the harness knows of this encoder and nothing of the head or the
decode, which every encoder shares.

- ``port_architecture``: the port's ``Wav2Vec2Architecture`` of a
  configuration's ``architecture``;
- ``frame_lengths``: frames after the convolutional extractor;
- ``encoder_flops``: the encoder's products and convolutions of one
  utterance, by the type they are multiplied in (``work/model_flops.py``
  adds the head's);
- ``serve_launches`` and ``train_launches``: the launches one request, or
  one microbatch, makes of each kernel of the encoder;
- ``TINY``: the widths of the CPU tests' tiny cells.

The reference of the same encoder is ``reference/encoders/wav2vec2.py``."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np


def port_architecture(arch: dict):
    """The port's architecture object; raises on a key that it lacks."""
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture

    names = {field.name for field in dataclasses.fields(Wav2Vec2Architecture)}
    unknown = sorted(set(arch) - names)
    if unknown:
        raise KeyError(f"the port's Wav2Vec2Architecture has no field {unknown}")
    return Wav2Vec2Architecture(**{key: tuple(value) if isinstance(value, list) else value for key, value in arch.items()})


def frame_lengths(arch: dict, lengths) -> np.ndarray:
    lengths = np.asarray(lengths, dtype=np.int64)
    for kernel, stride in zip(arch["conv_kernel"], arch["conv_stride"]):
        lengths = (lengths - kernel) // stride + 1
    return lengths


def encoder_flops(arch: dict, samples: int, encoder: str, training: bool) -> Tuple[int, Dict[str, float]]:
    """(frames, operations by type) of one utterance of ``samples`` real
    samples. Serving: the extractor's first convolution in float32 (the fused
    frame encoder reads float32 weights), every other product in the
    encoder's type. Training: a trained product three times (forward, input
    gradient, weight gradient), the feature projection twice (its input
    needs no gradient: the extractor is frozen), the frozen extractor's
    forward once."""
    out: Dict[str, float] = defaultdict(float)
    kernels, strides, channels = arch["conv_kernel"], arch["conv_stride"], [1] + list(arch["conv_dim"])
    lengths = []
    for kernel, stride in zip(kernels, strides):
        samples = (samples - kernel) // stride + 1
        lengths.append(max(samples, 0))
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
    return frames, out


def serve_launches(arch: dict) -> Dict[str, int]:
    """Launches of each kernel a serving request makes: K1 once an encoder
    layer, K2 once."""
    return {"K1": arch["num_hidden_layers"], "K2": 1}


def train_launches(arch: dict) -> Dict[str, int]:
    """A training microbatch's: K2 once, K5 (forward) and K4 (backward) once
    an encoder layer."""
    return {"K2": 1, "K4": arch["num_hidden_layers"], "K5": arch["num_hidden_layers"]}


#: The tiny cells' widths (``cardbench/tests/tiny_cells.py``).
TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64, "conv_dim": [16] * 7}
