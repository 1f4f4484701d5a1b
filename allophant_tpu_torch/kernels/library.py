"""The hand-written kernels of the serving path as ``torch.library`` custom
ops, so that ``torch.export`` records each as one node of its graph (a
ctypes launch through a raw pointer cannot be traced):

- ``allophant_torch::oneshot_attention`` (K1, ``csrc/oneshot_attention.cu``);
- ``allophant_torch::frame_conv`` (K2, ``csrc/frame_encoder.cu``);
- ``allophant_torch::beam_search`` (K3, ``csrc/beam_search.cu``).

Each op's CPU implementation is its plain twin; its CUDA implementation is
the kernel's launch (``launch_*`` in ``ops/``), which raises on inputs the
kernel does not take and never runs the twin; its fake rule allocates what
the launch allocates. The public wrappers (``ops.oneshot_attention.
oneshot_attention``, ``ops.frame_encoder.fused_frame_conv``,
``ops.beam_kernel.beam_search_cuda`` and ``ops.decode.beam_search_device``)
call these ops, so the live path and an exported program launch the same
code, and the wrappers' ``.launches`` counters, incremented inside the CUDA
implementations, count both.

A process that loads an exported program imports this module first
(``serving.load_transcriber``): the ops must be registered before the graph
is read. The other kernels (K4, K5, K6 and the beam backtrace) stay plain
ctypes calls: no exported path reaches them."""

from __future__ import annotations

from typing import Tuple

import torch

from allophant_tpu_torch.ops import beam_kernel as _beam_kernel
from allophant_tpu_torch.ops import decode as _decode
from allophant_tpu_torch.ops import frame_encoder as _frame_encoder
from allophant_tpu_torch.ops import oneshot_attention as _attention

NAMESPACE = "allophant_torch"


@torch.library.custom_op(f"{NAMESPACE}::oneshot_attention", mutates_args=(), device_types="cpu")
def oneshot_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, key_bias: torch.Tensor, sm_scale: float, heads: int
) -> torch.Tensor:
    """K1: q/k/v [B, T, H*hd] (strided views allowed) and an f32 key bias
    [B, T] -> [B, T, H*hd] in the query's dtype."""
    return _attention.reference_oneshot(query, key, value, key_bias, sm_scale, heads)


@oneshot_attention.register_kernel("cuda")
def _oneshot_attention_cuda(query, key, value, key_bias, sm_scale, heads):
    return _attention.launch_oneshot_attention(query, key, value, key_bias, sm_scale, heads)


@oneshot_attention.register_fake
def _oneshot_attention_fake(query, key, value, key_bias, sm_scale, heads):
    return query.new_empty(query.shape)


@torch.library.custom_op(f"{NAMESPACE}::frame_conv", mutates_args=(), device_types="cpu")
def frame_conv(
    audio: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    eps: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """K2: raw f32 audio [B, S] and a [10, C] kernel -> [B, S//5 - 1, C] in
    ``out_dtype``."""
    return _frame_encoder.reference_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps, out_dtype)


@frame_conv.register_kernel("cuda")
def _frame_conv_cuda(audio, kernel, bias, ln_scale, ln_bias, eps, out_dtype):
    return _frame_encoder.launch_frame_conv(audio, kernel, bias, ln_scale, ln_bias, eps, out_dtype)


@frame_conv.register_fake
def _frame_conv_fake(audio, kernel, bias, ln_scale, ln_bias, eps, out_dtype):
    frames = _frame_encoder.frame_count(audio.shape[1])
    return audio.new_empty((audio.shape[0], frames, kernel.shape[1]), dtype=out_dtype)


@torch.library.custom_op(f"{NAMESPACE}::beam_search", mutates_args=(), device_types="cpu")
def beam_search(
    log_emissions: torch.Tensor, lengths: torch.Tensor, beam_width: int, blank_index: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: [B, T, C] log-probabilities and [B] lengths -> (parents [T, B, K]
    int32, emitted [T, B, K] int32, scores [B, K] f32)."""
    return _decode.beam_search_padded(log_emissions, lengths, beam_width, blank_index)


@beam_search.register_kernel("cuda")
def _beam_search_cuda(log_emissions, lengths, beam_width, blank_index):
    return _beam_kernel.launch_beam_search(log_emissions, lengths, beam_width, blank_index)


@beam_search.register_fake
def _beam_search_fake(log_emissions, lengths, beam_width, blank_index):
    batch, time, _classes = log_emissions.shape
    parents = log_emissions.new_empty((time, batch, beam_width), dtype=torch.int32)
    emitted = log_emissions.new_empty((time, batch, beam_width), dtype=torch.int32)
    return parents, emitted, log_emissions.new_empty((batch, beam_width), dtype=torch.float32)
