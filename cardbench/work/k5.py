"""K5, the attention forward with dropout on the weights
(``csrc/attention_dropout.cu``): K1's bytes and products per launch; the
mask is drawn inside the kernel from two seeds and moves no bytes."""

from __future__ import annotations

from typing import Sequence, Tuple

from cardbench.work import k1


def launch_work(time: int, heads: int, head_dim: int, lengths: Sequence[int], item_bytes: int) -> Tuple[float, float]:
    return k1.launch_work(time, heads, head_dim, lengths, item_bytes)


KERNEL_NAMES = ("attention_dropout_kernel", "attention_dropout_mma_kernel")
