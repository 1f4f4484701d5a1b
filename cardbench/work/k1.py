"""K1, the one-shot attention forward (``csrc/oneshot_attention.cu``): bytes
and operations of one launch over [rows, time, heads * head_dim].

What these inputs need: q, k and v read for each valid frame and the
output written for it, the key bias read whole; q.k and p.v over each
row's valid queries times its valid keys (2 operations a multiply-add,
two products). Padded frames need nothing."""

from __future__ import annotations

from typing import Sequence, Tuple


def launch_work(time: int, heads: int, head_dim: int, lengths: Sequence[int], item_bytes: int) -> Tuple[float, float]:
    valid = [min(max(int(length), 0), time) for length in lengths]
    width = heads * head_dim
    bytes_moved = 4 * sum(valid) * width * item_bytes + len(valid) * time * 4
    operations = 4 * width * sum(length * length for length in valid)
    return float(bytes_moved), float(operations)


KERNEL = "K1"
COUNTER = ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_attention")
TWINS = (("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot"),)
KERNEL_NAMES = ("oneshot_attention_kernel", "oneshot_attention_mma_kernel")
