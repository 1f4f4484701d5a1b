"""w2v-BERT 2.0 as the port runs it (``allophant_tpu_torch.models.w2v_bert``):
what the harness knows of this encoder and nothing of the head or the
decode, which every encoder shares.

- ``port_architecture``: the port's ``Wav2Vec2BertArchitecture`` of a
  configuration's ``architecture``;
- ``frame_lengths``: encoder frames, whole pairs of filterbank frames;
- ``encoder_flops``: the front end's and the encoder's products of one
  utterance, by the type they are multiplied in (``work/model_flops.py``
  adds the head's);
- ``serve_launches``: the launches one request makes of each kernel: K7
  once a layer;
- ``TINY``: the widths of the CPU tests' tiny cells.

The reference of the same encoder is ``reference/encoders/w2v_bert.py``."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

FRAME_LENGTH, HOP_LENGTH, FFT_LENGTH = 400, 160, 512


def port_architecture(arch: dict):
    """The port's architecture object; raises on a key that it lacks."""
    from allophant_tpu_torch.models.w2v_bert import Wav2Vec2BertArchitecture

    names = {field.name for field in dataclasses.fields(Wav2Vec2BertArchitecture)}
    unknown = sorted(set(arch) - names)
    if unknown:
        raise KeyError(f"the port's Wav2Vec2BertArchitecture has no field {unknown}")
    return Wav2Vec2BertArchitecture(**arch)


def _filterbank_frames(lengths):
    return np.maximum((np.asarray(lengths, dtype=np.int64) - FRAME_LENGTH) // HOP_LENGTH + 1, 0)


def frame_lengths(arch: dict, lengths) -> np.ndarray:
    return _filterbank_frames(lengths) // arch["stride"]


def encoder_flops(arch: dict, samples: int, encoder: str, training: bool) -> Tuple[int, Dict[str, float]]:
    """(frames, operations by type) of one utterance of ``samples`` real
    samples. The front end in float32: a 512-point real FFT a filterbank
    frame (2.5 N log2 N) and the mel product. In the encoder's type: the
    feature projection, and a layer's two FFNs, fused QKV and output
    projections, 1x1 convolutions (D -> 2D, D -> D), depthwise convolution,
    q.k and p.v over valid keys (4 T^2 D) and the relative-key products
    (2 T D a distance). Training would count a trained product three times;
    the port serves this encoder only."""
    out: Dict[str, float] = defaultdict(float)
    filterbank = int(_filterbank_frames(samples))
    frames = filterbank // arch["stride"]
    fft = 2.5 * FFT_LENGTH * np.log2(FFT_LENGTH)
    out["float32"] += filterbank * (fft + 2.0 * (FFT_LENGTH // 2 + 1) * arch["num_mel_bins"])
    width, inner = arch["hidden_size"], arch["intermediate_size"]
    positions = arch["left_max_position_embeddings"] + arch["right_max_position_embeddings"] + 1
    per_layer = (
        2.0 * frames * 2 * (2 * width * inner)
        + 2.0 * frames * width * 4 * width
        + 2.0 * frames * width * 3 * width
        + 2.0 * frames * width * arch["conv_depthwise_kernel_size"]
        + 4.0 * frames * frames * width
        + 2.0 * frames * positions * width
    )
    trained = 3.0 if training else 1.0
    projection = 2.0 * frames * arch["feature_projection_input_dim"] * width
    out[encoder] += trained * (projection + arch["num_hidden_layers"] * per_layer)
    return frames, dict(out)


def serve_launches(arch: dict) -> Dict[str, int]:
    """Launches of each kernel a serving request makes: K7 once an encoder
    layer (no K1, no K2)."""
    return {"K7": arch["num_hidden_layers"]}


#: The tiny cells' widths (``cardbench/tests/tiny_cells.py``).
TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64}
