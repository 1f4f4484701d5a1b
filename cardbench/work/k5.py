"""K5, the attention forward with dropout on the weights
(``csrc/attention_dropout.cu``): K1's bytes and products per launch; the
mask is drawn inside the kernel from two seeds and moves no bytes."""

from __future__ import annotations

from typing import Sequence, Tuple

from cardbench.work import k1


def launch_work(time: int, heads: int, head_dim: int, lengths: Sequence[int], item_bytes: int) -> Tuple[float, float]:
    return k1.launch_work(time, heads, head_dim, lengths, item_bytes)


KERNEL = "K5"
COUNTER = ("allophant_tpu_torch.ops.oneshot_attention", "oneshot_dropout_attention")
#: The twin of the forward with dropout, and of the mask it draws (K6's).
TWINS = (
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_oneshot_dropout"),
    ("allophant_tpu_torch.ops.oneshot_attention", "reference_dropout_mask_bits"),
)
KERNEL_NAMES = ("attention_dropout_kernel", "attention_dropout_mma_kernel")
