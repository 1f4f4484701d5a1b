"""K3, the CTC prefix beam search (``csrc/beam_search.cu``): bytes and
operations of one launch over [rows, time, classes] at beam width K.

The emission rows of valid steps and the lengths read once, parents and
emitted tokens [T, B, K] int32 written over all T and the scores once; per
valid step each of the K * C candidates takes one add and one log-add
(max, subtract, abs, exp, log1p, add: 8 f32 operations in all)."""

from __future__ import annotations

from typing import Sequence, Tuple


def launch_work(time: int, classes: int, beams: int, lengths: Sequence[int]) -> Tuple[float, float]:
    steps = sum(min(max(int(length), 0), time) for length in lengths)
    rows = len(lengths)
    bytes_moved = steps * classes * 4 + rows * 4 + 2 * time * rows * beams * 4 + rows * beams * 4
    return float(bytes_moved), float(steps * beams * classes * 8)


KERNEL = "K3"
COUNTER = ("allophant_tpu_torch.ops.beam_kernel", "beam_search_cuda")
TWINS = (("allophant_tpu_torch.ops.decode", "beam_search_padded"),)
KERNEL_NAMES = ("beam_search_kernel", "beam_search_warp_kernel", "beam_search_wide_kernel")
