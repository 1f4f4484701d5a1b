"""K7, relative-key one-shot attention (``csrc/relkey_attention.cu``): bytes
and operations of one launch over [rows, time, heads * head_dim] with a
table of ``positions`` distance embeddings.

What these inputs need: q, k and v read for each valid frame and the output
written for it, the key bias read whole and the table once (bf16); q.k and
p.v over each row's valid queries times its valid keys (2 operations a
multiply-add, two products) and each valid query's product with every row
of the table. Padded frames need nothing.

A program from before w2v-BERT came to the port has no K7: this file then
names no kernel, and the harness counts, bars and times the others as it
did, while ``metrics/k7_roofline.serve.py`` finds nothing to read."""

from __future__ import annotations

import importlib.util
from typing import Sequence, Tuple


def launch_work(
    time: int, heads: int, head_dim: int, positions: int, lengths: Sequence[int], item_bytes: int
) -> Tuple[float, float]:
    valid = [min(max(int(length), 0), time) for length in lengths]
    width = heads * head_dim
    bytes_moved = 4 * sum(valid) * width * item_bytes + len(valid) * time * 4 + positions * head_dim * item_bytes
    operations = 4 * width * sum(length * length for length in valid) + 2 * positions * width * sum(valid)
    return float(bytes_moved), float(operations)


if importlib.util.find_spec("allophant_tpu_torch.ops.relkey_attention") is not None:
    KERNEL = "K7"
    COUNTER = ("allophant_tpu_torch.ops.relkey_attention", "relkey_attention")
    TWINS = (("allophant_tpu_torch.ops.relkey_attention", "reference_relkey_attention"),)
    KERNEL_NAMES = ("relkey_attention_kernel",)
