"""The dropout masks of a training forward, worked out from the step's
dropout seed as the port's contract defines them.

- Elementwise sites draw a Bernoulli keep mask from a torch generator on the
  device seeded with ``seed + 1``, each over the site's whole tensor, in the
  order of the forward; the reference draws each at the port's padded shape
  and dtype and cuts out the rows and frames it computes.
- Attention weights: two int32 seeds drawn on the host from a CPU generator
  seeded with ``seed``; weight (b, h, row, col) is kept when word ``col % 4``
  of Philox4x32-10 (Random123's constants) at counter (col // 4, row,
  b * heads + h, 0) under key (seed0, seed1) lies below
  round((1 - rate) 2^32); kept weights are scaled by 2^32 / that threshold.

The Philox arithmetic is a frozen copy of the port's plain twin."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
_PHILOX_WEYL = (0x9E3779B9, 0xBB67AE85)


def keep_threshold(rate: float) -> int:
    return min(2**32 - 1, int(round((1.0 - rate) * 2**32)))


def _mulhilo(multiplier: int, value: torch.Tensor):
    product_low = (value & 0xFFFF) * multiplier
    product_high = (value >> 16) * multiplier
    middle = product_low + ((product_high & 0xFFFF) << 16)
    return (product_high >> 16) + (middle >> 32), middle & _MASK32


def philox4x32(counter: Sequence[torch.Tensor], key: Sequence[int]):
    word0, word1, word2, word3 = counter
    key0, key1 = (int(value) & _MASK32 for value in key)
    for round_index in range(10):
        if round_index:
            key0 = (key0 + _PHILOX_WEYL[0]) & _MASK32
            key1 = (key1 + _PHILOX_WEYL[1]) & _MASK32
        high0, low0 = _mulhilo(_PHILOX_MULTIPLIERS[0], word0)
        high1, low1 = _mulhilo(_PHILOX_MULTIPLIERS[1], word2)
        word0, word1, word2, word3 = high1 ^ word1 ^ key0, low1, high0 ^ word3 ^ key1, low0
    return word0, word1, word2, word3


def attention_scale(seeds: Tuple[int, int], rows: int, heads: int, time: int, rate: float, device) -> torch.Tensor:
    """f32 [rows, heads, time, time]: 0 for a dropped weight, 2^32 / threshold
    for a kept one, for batch rows 0 .. rows - 1."""
    quads = (time + 3) // 4

    def axis(size: int, position: int) -> torch.Tensor:
        shape = [1, 1, 1]
        shape[position] = size
        return torch.arange(size, dtype=torch.int64, device=device).reshape(shape)

    mask_heads = (axis(rows, 0) * heads + axis(heads, 1).reshape(1, heads, 1)).reshape(rows * heads, 1, 1)
    words = torch.broadcast_tensors(
        *philox4x32((axis(quads, 2), axis(time, 1), mask_heads, torch.zeros((), dtype=torch.int64, device=device)), seeds)
    )
    bits = torch.stack(words, dim=-1).reshape(rows, heads, time, quads * 4)[..., :time]
    threshold = keep_threshold(rate)
    return torch.where(bits < threshold, 2**32 / threshold, 0.0).to(torch.float32)


class DropoutDraws:
    """The two generators of one training step, as the port seeds them."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator(device="cpu").manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)
        self.device_type = torch.device(device)

    def keep(self, shape, dtype: torch.dtype, rate: float) -> torch.Tensor:
        """The f32 0/1 keep mask of one elementwise site over the port's whole
        tensor ``shape`` of ``dtype``; none at rate 0."""
        return torch.empty(shape, dtype=dtype, device=self.device_type).bernoulli_(1.0 - rate, generator=self.device).float()

    def attention_seeds(self) -> Tuple[int, int]:
        seeds = torch.randint(-(2**31), 2**31 - 1, (2,), generator=self.host, dtype=torch.int64)
        return int(seeds[0]), int(seeds[1])
