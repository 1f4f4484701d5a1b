"""K4, the fused attention backward (``csrc/attention_backward.cu``): bytes
and operations of one launch. It reads q, k, v and the output's gradient
and writes dq, dk and dv for each valid frame (the key bias read whole);
from those inputs it needs five products over valid queries times valid
keys: the scores again, dV = P^T g, dP = g V^T, dQ = dS K and dK = dS^T Q."""

from __future__ import annotations

from typing import Sequence, Tuple


def launch_work(time: int, heads: int, head_dim: int, lengths: Sequence[int], item_bytes: int) -> Tuple[float, float]:
    valid = [min(max(int(length), 0), time) for length in lengths]
    width = heads * head_dim
    bytes_moved = 7 * sum(valid) * width * item_bytes + len(valid) * time * 4
    operations = 10 * width * sum(length * length for length in valid)
    return float(bytes_moved), float(operations)


KERNEL = "K4"
COUNTER = ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_attention_backward")
TWINS = (("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot_backward"),)
KERNEL_NAMES = (
    "attention_backward_query_kernel",
    "attention_backward_query_mma_kernel",
    "attention_backward_key_kernel",
    "attention_backward_key_mma_kernel",
)
