"""One-shot attention over the projection layout [B, T, H*hd] with an additive
f32 key bias (counterpart of ``allophant_tpu/ops/oneshot_attention.py``):
the forward without dropout (K1), the forward with dropout on the softmaxed
weights (K5), their fused backward (K4) and the dropout-mask draws (K6).

Each ``*_attention*`` / ``dropout_mask_bits`` wrapper launches its CUDA kernel
(``csrc/oneshot_attention.cu``, ``csrc/attention_dropout.cu``,
``csrc/attention_backward.cu``) for CUDA tensors and runs its plain twin
(``reference_*``) for CPU tensors; a shape or dtype a kernel does not take
raises. K1's wrapper reaches its kernel through the custom op
``allophant_torch::oneshot_attention`` (``kernels/library.py``), so that
``torch.export`` can record it; ``launch_oneshot_attention`` is the op's CUDA
implementation. The training kernels are plain ctypes calls. The kernels serve every sequence length and every head width
(``head_plan``): a width that is not a multiple of 8 is zero-padded to one in
the wrapper, which is exact, and a width above ``MAX_TILE_HEAD_DIM`` runs the
chunked route (``csrc/attention_wide.cuh``), so the TPU's plan tables
(bounded by VMEM) have no counterpart. ``OneshotAttention`` and
``OneshotDropoutAttention`` are the autograd functions the encoder calls.

The dropout mask is the port's own: Mosaic's PRNG stream cannot be reproduced
on CUDA, so the mask is Philox4x32-10 (Random123's constants), a pure function
of two int32 seeds and (b, h, row, col):

- key = (seed0, seed1) as u32;
- counter = (col // 4, row, b * total_heads + head_offset + h, 0);
- the draw is output word col % 4;

and a weight is kept iff its draw is below ``keep_threshold(rate)``. A call
over the model's heads has ``total_heads = H`` and ``head_offset = 0`` (the
defaults); a tensor-parallel rank holding heads ``head_offset ..
head_offset + H - 1`` of ``total_heads`` draws the one-device mask of its
heads. The backward regenerates the mask from the seeds instead of storing
it."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from allophant_tpu_torch.device import resolve_device
from allophant_tpu_torch.kernels.build import check_launch, load_kernel

NEG_INF = -1e9
LOG2E = 1.4426950408889634
# Softmax denominator clamp: a fully padded (zero-length) row stays finite.
TINY_TOTAL = 1e-30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The widest head of one tile (XLS-R 2B's 120-wide heads run as 128); wider
#: heads run the chunked route, one block for each 128 output columns.
MAX_TILE_HEAD_DIM = 128
_HEAD_ALIGNMENT = 8  # columns: the kernels copy 16-byte (8 bf16) pieces of a row
_ROW_ALIGNMENT = 16  # bytes: the bf16 kernels copy and read 16-byte rows

_MASK32 = 0xFFFFFFFF
_PHILOX_MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
_PHILOX_WEYL = (0x9E3779B9, 0xBB67AE85)

Seeds = Tuple[int, int]


def keep_threshold(rate: float) -> int:
    """Attention-dropout keep threshold: a weight survives when its uniform u32
    draw is strictly below ``round((1 - rate) * 2^32)`` (resolution 2^-32)."""
    return min(2**32 - 1, int(round((1.0 - rate) * 2**32)))


def _keep_probability(rate: float) -> float:
    return keep_threshold(rate) / 2**32


def _mulhilo(multiplier: int, value: torch.Tensor):
    """(high, low) 32-bit halves of ``multiplier * value`` for u32 values held
    in int64, split into 16-bit limbs so no product leaves int64."""
    product_low = (value & 0xFFFF) * multiplier  # < 2^48
    product_high = (value >> 16) * multiplier  # < 2^48
    middle = product_low + ((product_high & 0xFFFF) << 16)
    return (product_high >> 16) + (middle >> 32), middle & _MASK32


def philox4x32(counter: Sequence[torch.Tensor], key: Sequence[int]):
    """Philox4x32-10 over int64 tensors holding u32 values (broadcastable
    counter words); returns the four output words. Computes the same bits on
    every device: the plain version of ``csrc/philox.cuh``."""
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


def _total_heads(heads: int, total_heads: Optional[int], head_offset: int) -> int:
    """The model's head count of a call over heads ``head_offset ..
    head_offset + heads - 1``; raises when they do not lie inside it."""
    total = heads if total_heads is None else total_heads
    if head_offset < 0 or head_offset + heads > total:
        raise ValueError(f"heads {head_offset} .. {head_offset + heads - 1} do not lie among {total} heads")
    return total


def reference_dropout_mask_bits(
    seeds: Seeds, batch: int, heads: int, time: int, device="cpu", total_heads: Optional[int] = None, head_offset: int = 0
) -> torch.Tensor:
    """Plain twin of K6: the u32 draws [B, H, T, T] of the attention-dropout
    mask of heads ``head_offset ..`` of ``total_heads`` (see the module
    docstring for the layout)."""
    total = _total_heads(heads, total_heads, head_offset)
    quads = (time + 3) // 4

    def axis(size, position):
        shape = [1, 1, 1]
        shape[position] = size
        return torch.arange(size, dtype=torch.int64, device=device).reshape(shape)

    mask_heads = (axis(batch, 0) * total + head_offset + axis(heads, 1).reshape(1, heads, 1)).reshape(batch * heads, 1, 1)
    words = philox4x32(
        (axis(quads, 2), axis(time, 1), mask_heads, torch.zeros((), dtype=torch.int64, device=device)),
        seeds,
    )
    words = torch.broadcast_tensors(*words)
    bits = torch.stack(words, dim=-1).reshape(batch, heads, time, quads * 4)[..., :time]
    return bits.to(torch.uint32)


def dropout_mask_bits(
    seeds: Seeds, batch: int, heads: int, time: int, device=None, total_heads: Optional[int] = None, head_offset: int = 0
) -> torch.Tensor:
    """K6: u32 [B, H, T, T] draws on ``device`` (CUDA unless the caller asks for
    the CPU, where the twin runs; raises without a CUDA device).
    ``dropout_mask_bits.launches`` counts launches."""
    device = resolve_device(device)
    total = _total_heads(heads, total_heads, head_offset)
    if device.type == "cpu":
        return reference_dropout_mask_bits(seeds, batch, heads, time, device, total, head_offset)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask_bits runs on the CPU or a CUDA device, not {device}")
    out = torch.empty(batch, heads, time, time, dtype=torch.uint32, device=device)
    if out.numel() == 0:
        return out
    kernel = load_kernel("dropout_mask")
    seed0, seed1 = (int(seed) & _MASK32 for seed in seeds)
    with torch.cuda.device(device):
        status = kernel(
            out.data_ptr(), batch, heads, time, seed0, seed1, total, head_offset,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch("dropout_mask", status)
    dropout_mask_bits.launches += 1
    return out


dropout_mask_bits.launches = 0


def _keep_mask(
    seeds: Seeds, batch: int, heads: int, time: int, rate: float, device, total_heads: Optional[int] = None, head_offset: int = 0
) -> torch.Tensor:
    bits = reference_dropout_mask_bits(seeds, batch, heads, time, device, total_heads, head_offset)
    return bits.to(torch.int64) < keep_threshold(rate)


def _split_heads(tensor: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, H*hd] -> f32 [B, H, T, hd]."""
    batch, time, model_dim = tensor.shape
    return tensor.reshape(batch, time, heads, model_dim // heads).float().transpose(1, 2)


def _merge_heads(tensor: torch.Tensor, dtype) -> torch.Tensor:
    """f32 [B, H, T, hd] -> [B, T, H*hd] in ``dtype``."""
    batch, heads, time, head_dim = tensor.shape
    return tensor.transpose(1, 2).reshape(batch, time, heads * head_dim).to(dtype)


def _exponentials(query, key, key_bias, sm_scale: float, heads: int):
    """The kernels' base-2 softmax numerator [B, H, T, T] and its clamped total
    [B, H, T, 1]: biased peak, (s - peak) + bias exponent, 1e-30 clamp."""
    scores = _split_heads(query, heads) @ _split_heads(key, heads).transpose(-1, -2) * (sm_scale * LOG2E)
    bias = (key_bias.float() * LOG2E)[:, None, None, :]
    peak = (scores + bias).amax(dim=-1, keepdim=True)
    exponentials = torch.exp2((scores - peak) + bias)
    return exponentials, exponentials.sum(dim=-1, keepdim=True).clamp_min(TINY_TOTAL)


def reference_oneshot(query, key, value, key_bias, sm_scale: float, heads: int) -> torch.Tensor:
    """Plain twin of K1: the same base-2 softmax, biased peak, (s - peak) + bias
    exponent, bf16 rounding of the unnormalised weights and 1e-30 clamp on the
    denominator, divided after P.V."""
    exponentials, total = _exponentials(query, key, key_bias, sm_scale, heads)
    weights = exponentials.to(value.dtype).float()
    return _merge_heads(weights @ _split_heads(value, heads) / total, query.dtype)


def reference_oneshot_dropout(
    query, key, value, key_bias, seeds: Seeds, sm_scale: float, heads: int, rate: float,
    total_heads: Optional[int] = None, head_offset: int = 0,
):
    """Plain twin of K5: K1's arithmetic with the Philox mask (of heads
    ``head_offset ..`` of ``total_heads``) on the unnormalised weights; the
    total sums the unmasked weights and the masked sum is divided by total *
    keep_prob."""
    batch, time, _ = query.shape
    exponentials, total = _exponentials(query, key, key_bias, sm_scale, heads)
    keep = _keep_mask(seeds, batch, heads, time, rate, query.device, total_heads, head_offset)
    weights = torch.where(keep, exponentials, 0.0).to(value.dtype).float()
    return _merge_heads(weights @ _split_heads(value, heads) / (total * _keep_probability(rate)), query.dtype)


def reference_oneshot_backward(
    query, key, value, grad, key_bias, seeds: Optional[Seeds], sm_scale: float, heads: int, rate: Optional[float],
    total_heads: Optional[int] = None, head_offset: int = 0,
):
    """Plain twin of K4: (dq, dk, dv) of K5 (``rate=None``: of K1), with
    p = softmax, mscale = mask / keep_prob (the mask of heads ``head_offset ..``
    of ``total_heads``):

        dv = (mscale o p)^T g,  dp = mscale o (g v^T),
        ds = p o (dp - <dp, p>_row),  dq = ds k s,  dk = ds^T q s.

    For bf16 inputs ``mscale o p`` and ``ds`` are rounded to bf16 before their
    products, as the TPU kernel casts them."""
    batch, time, _ = query.shape
    dtype = query.dtype
    exponentials, total = _exponentials(query, key, key_bias, sm_scale, heads)
    probabilities = exponentials / total
    g, v = _split_heads(grad, heads), _split_heads(value, heads)
    d_probabilities = g @ v.transpose(-1, -2)
    if rate is None:
        dropped = probabilities
    else:
        keep = _keep_mask(seeds, batch, heads, time, rate, query.device, total_heads, head_offset)
        scale = torch.where(keep, 2**32 / keep_threshold(rate), 0.0)
        dropped = probabilities * scale
        d_probabilities = d_probabilities * scale
    d_value = dropped.to(dtype).float().transpose(-1, -2) @ g
    row = (d_probabilities * probabilities).sum(dim=-1, keepdim=True)
    d_scores = (probabilities * (d_probabilities - row)).to(dtype).float()
    d_query = d_scores @ _split_heads(key, heads) * sm_scale
    d_key = d_scores.transpose(-1, -2) @ _split_heads(query, heads) * sm_scale
    return tuple(_merge_heads(tensor, dtype) for tensor in (d_query, d_key, d_value))


def check_row_alignment(name: str, shape, strides, storage_offset: int, item_size: int) -> None:
    """Raises unless every head row of a [B, T, H*hd] view starts on a 16-byte
    boundary, as the bf16 kernels' cp.async copies and ldmatrix reads need,
    given a storage that does (PyTorch's CUDA allocator aligns to 256 bytes):
    the storage offset and the batch and time strides (of axes longer than 1)
    must be multiples of 16 bytes. The encoder's q, k and v, column blocks of
    one fused [B, T, 3*H*hd] projection, pass."""
    if storage_offset * item_size % _ROW_ALIGNMENT:
        raise ValueError(f"{name}: a storage offset of {storage_offset} elements is not a multiple of {_ROW_ALIGNMENT} bytes")
    for axis, label in ((1, "time"), (0, "batch")):
        if shape[axis] > 1 and strides[axis] * item_size % _ROW_ALIGNMENT:
            raise ValueError(f"{name}: a {label} stride of {strides[axis]} elements is not a multiple of {_ROW_ALIGNMENT} bytes")


def kernel_head_dim(name: str, model_dim: int, heads: int) -> int:
    """The head width of [B, T, H*hd] inputs. The kernels take every width;
    raises a ValueError only when ``model_dim`` does not split into ``heads``."""
    if heads < 1 or model_dim % heads:
        raise ValueError(f"{name}: a width of {model_dim} does not split into {heads} heads")
    return model_dim // heads


def head_plan(head_dim: int) -> Tuple[int, int]:
    """How the kernels run a head of ``head_dim`` columns: (the width they are
    launched at, the head zero-padded to the next multiple of 8; the number of
    128-column chunks a block of the chunked route owns, 1 up to
    ``MAX_TILE_HEAD_DIM``). Zero columns add nothing to q.k^T and their output
    columns are cut off, so the padding is exact."""
    if head_dim < 1:
        raise ValueError(f"a head needs at least one column, got {head_dim}")
    padded = -(-head_dim // _HEAD_ALIGNMENT) * _HEAD_ALIGNMENT
    return padded, -(-padded // MAX_TILE_HEAD_DIM)


def _pad_heads(tensor: torch.Tensor, heads: int, padded: int) -> torch.Tensor:
    """[B, T, H*hd] -> [B, T, H*padded], each head's extra columns zero."""
    batch, time, model_dim = tensor.shape
    return F.pad(tensor.reshape(batch, time, heads, model_dim // heads), (0, padded - model_dim // heads)).reshape(
        batch, time, heads * padded
    )


def _unpad_heads(tensor: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """[B, T, H*padded] -> [B, T, H*hd], each head's first ``head_dim`` columns."""
    batch, time, model_dim = tensor.shape
    return tensor.reshape(batch, time, heads, model_dim // heads)[..., :head_dim].reshape(batch, time, heads * head_dim)


def _check_kernel_inputs(name: str, query, others, key_bias, heads: int):
    """Raises on what the CUDA kernels do not take; returns the inputs as the
    kernel takes them (each head zero-padded to a multiple of 8 where it is
    not one), the true head width and the launched one."""
    if query.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {query.device}")
    batch, time, model_dim = query.shape
    if query.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes f32 or bf16, not {query.dtype}")
    head_dim = kernel_head_dim(name, model_dim, heads)
    for tensor in (query, *others):
        if tensor.shape != query.shape or tensor.dtype != query.dtype or tensor.device != query.device:
            raise ValueError(f"{name}: every input must match query in shape, dtype and device")
    if key_bias.shape != (batch, time) or key_bias.dtype != torch.float32 or key_bias.device != query.device:
        raise ValueError(f"{name}: key_bias must be f32 [B, T] on the query's device")
    padded, _ = head_plan(head_dim)
    tensors = [query, *others]
    if padded != head_dim:
        tensors = [_pad_heads(tensor, heads, padded) for tensor in tensors]
    for tensor in tensors:
        if tensor.stride(2) != 1:
            raise ValueError(f"{name} kernel needs a contiguous feature axis")
        if tensor.dtype == torch.bfloat16:
            check_row_alignment(name, tensor.shape, tensor.stride(), tensor.storage_offset(), tensor.element_size())
            if tensor.data_ptr() % _ROW_ALIGNMENT:
                raise ValueError(f"{name}: the bf16 kernels need a {_ROW_ALIGNMENT}-byte-aligned data pointer")
    return tensors, head_dim, padded


def _strides(*tensors) -> ctypes.Array:
    values = [value for tensor in tensors for value in (tensor.stride(0), tensor.stride(1))]
    return (ctypes.c_longlong * len(values))(*values)


def _u32_seeds(seeds: Seeds):
    return tuple(int(seed) & _MASK32 for seed in seeds)


def _check_rate(rate: float) -> None:
    if not 0.0 < rate < 1.0:
        raise ValueError(f"attention dropout rate must lie in (0, 1), got {rate}")


def oneshot_attention(query, key, value, key_bias, sm_scale: float, heads: int) -> torch.Tensor:
    """K1: [B, T, H*hd] attention with additive key bias [B, T] f32, through
    the custom op ``allophant_torch::oneshot_attention``
    (``kernels/library.py``), which ``torch.export`` records as one node.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and raise on
    anything it does not take). ``oneshot_attention.launches`` counts launches."""
    from allophant_tpu_torch.kernels import library

    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"oneshot_attention runs on CPU or CUDA tensors, not {query.device}")
    return library.oneshot_attention(query, key, value, key_bias, float(sm_scale), int(heads))


oneshot_attention.launches = 0


def launch_oneshot_attention(query, key, value, key_bias, sm_scale: float, heads: int) -> torch.Tensor:
    """The CUDA implementation of K1's custom op: launches the kernel on CUDA
    tensors and raises on anything it does not take; returns a new contiguous
    tensor."""
    (query, key, value), head_dim, padded = _check_kernel_inputs(
        "oneshot_attention", query, (key, value), key_bias, heads
    )
    batch, time, model_dim = query.shape
    key_bias = key_bias.contiguous()
    out = torch.empty(batch, time, model_dim, dtype=query.dtype, device=query.device)
    if batch == 0 or time == 0:
        return _unpad_heads(out, heads, head_dim).contiguous()
    forward = load_kernel("oneshot_attention")
    with torch.cuda.device(query.device):
        status = forward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            batch, time, heads, padded, ctypes.cast(_strides(query, key, value, out), ctypes.c_void_p),
            sm_scale * LOG2E, LOG2E, _DTYPE_CODES[query.dtype],
            torch.cuda.current_stream(query.device).cuda_stream,
        )
    check_launch("oneshot_attention", status)
    oneshot_attention.launches += 1
    return out if padded == head_dim else _unpad_heads(out, heads, head_dim).contiguous()


def oneshot_dropout_attention(
    query, key, value, key_bias, seeds: Seeds, sm_scale: float, heads: int, rate: float,
    total_heads: Optional[int] = None, head_offset: int = 0,
):
    """K5: [B, T, H*hd] attention with dropout on the softmaxed weights at
    ``rate`` (0 < rate < 1), mask drawn from ``seeds`` (two int32) for heads
    ``head_offset .. head_offset + H - 1`` of ``total_heads`` (default: H, 0).
    ``oneshot_dropout_attention.launches`` counts launches."""
    _check_rate(rate)
    total = _total_heads(heads, total_heads, head_offset)
    if query.device.type == "cpu":
        return reference_oneshot_dropout(query, key, value, key_bias, seeds, sm_scale, heads, rate, total, head_offset)
    (query, key, value), head_dim, padded = _check_kernel_inputs(
        "oneshot_dropout_attention", query, (key, value), key_bias, heads
    )
    batch, time, model_dim = query.shape
    key_bias = key_bias.contiguous()
    out = torch.empty(batch, time, model_dim, dtype=query.dtype, device=query.device)
    if batch == 0 or time == 0:
        return _unpad_heads(out, heads, head_dim)
    forward = load_kernel("attention_dropout")
    with torch.cuda.device(query.device):
        status = forward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            batch, time, heads, padded, ctypes.cast(_strides(query, key, value, out), ctypes.c_void_p),
            sm_scale * LOG2E, LOG2E, *_u32_seeds(seeds), keep_threshold(rate), _keep_probability(rate),
            total, head_offset, _DTYPE_CODES[query.dtype], torch.cuda.current_stream(query.device).cuda_stream,
        )
    check_launch("attention_dropout", status)
    oneshot_dropout_attention.launches += 1
    return out if padded == head_dim else _unpad_heads(out, heads, head_dim)


oneshot_dropout_attention.launches = 0


def oneshot_attention_backward(
    query, key, value, grad, key_bias, seeds: Optional[Seeds], sm_scale: float, heads: int, rate: Optional[float],
    total_heads: Optional[int] = None, head_offset: int = 0,
):
    """K4: (dq, dk, dv) [B, T, H*hd] of K5 with the mask regenerated from
    ``seeds`` (for heads ``head_offset ..`` of ``total_heads``, as K5 drew
    it), or of K1 with ``rate=None``. Nothing [T, T] is stored: a
    query-tile kernel writes f32 row statistics [3, B, H, T] and dq, a key-tile
    kernel dk and dv. ``oneshot_attention_backward.launches`` counts launches
    (one per call, for the pair)."""
    if rate is not None:
        _check_rate(rate)
    total = _total_heads(heads, total_heads, head_offset)
    if query.device.type == "cpu":
        return reference_oneshot_backward(
            query, key, value, grad, key_bias, seeds, sm_scale, heads, rate, total, head_offset
        )
    (query, key, value, grad), head_dim, padded = _check_kernel_inputs(
        "oneshot_attention_backward", query, (key, value, grad), key_bias, heads
    )
    batch, time, model_dim = query.shape
    key_bias = key_bias.contiguous()
    outputs = [torch.empty(batch, time, model_dim, dtype=query.dtype, device=query.device) for _ in range(3)]
    if batch == 0 or time == 0:
        return tuple(_unpad_heads(tensor, heads, head_dim) for tensor in outputs)
    stats = torch.empty(3, batch, heads, time, dtype=torch.float32, device=query.device)
    seed0, seed1 = _u32_seeds(seeds) if rate is not None else (0, 0)
    threshold = keep_threshold(rate) if rate is not None else 0
    inverse_keep = 2**32 / threshold if rate is not None else 1.0
    backward = load_kernel("attention_backward")
    with torch.cuda.device(query.device):
        status = backward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(), key_bias.data_ptr(),
            *(tensor.data_ptr() for tensor in outputs), stats.data_ptr(),
            batch, time, heads, padded,
            ctypes.cast(_strides(query, key, value, grad, *outputs), ctypes.c_void_p),
            sm_scale * LOG2E, LOG2E, sm_scale, seed0, seed1, threshold, inverse_keep, int(rate is not None),
            total, head_offset, _DTYPE_CODES[query.dtype], torch.cuda.current_stream(query.device).cuda_stream,
        )
    check_launch("attention_backward", status)
    oneshot_attention_backward.launches += 1
    if padded == head_dim:
        return tuple(outputs)
    return tuple(_unpad_heads(tensor, heads, head_dim) for tensor in outputs)


oneshot_attention_backward.launches = 0


class OneshotAttention(torch.autograd.Function):
    """K1 forward, K4 (``rate=None``) backward."""

    @staticmethod
    def forward(ctx, query, key, value, key_bias, sm_scale: float, heads: int):
        ctx.save_for_backward(query, key, value, key_bias)
        ctx.sm_scale, ctx.heads = sm_scale, heads
        return oneshot_attention(query, key, value, key_bias, sm_scale, heads)

    @staticmethod
    def backward(ctx, grad):
        query, key, value, key_bias = ctx.saved_tensors
        gradients = oneshot_attention_backward(
            query, key, value, grad.contiguous(), key_bias, None, ctx.sm_scale, ctx.heads, None
        )
        return (*gradients, None, None, None)


class OneshotDropoutAttention(torch.autograd.Function):
    """K5 forward, K4 backward with the mask regenerated from the seeds, for
    heads ``head_offset ..`` of ``total_heads``."""

    @staticmethod
    def forward(
        ctx, query, key, value, key_bias, seeds: Seeds, sm_scale: float, heads: int, rate: float,
        total_heads: Optional[int] = None, head_offset: int = 0,
    ):
        ctx.save_for_backward(query, key, value, key_bias)
        ctx.seeds, ctx.sm_scale, ctx.heads, ctx.rate = seeds, sm_scale, heads, rate
        ctx.total_heads, ctx.head_offset = total_heads, head_offset
        return oneshot_dropout_attention(query, key, value, key_bias, seeds, sm_scale, heads, rate, total_heads, head_offset)

    @staticmethod
    def backward(ctx, grad):
        query, key, value, key_bias = ctx.saved_tensors
        gradients = oneshot_attention_backward(
            query, key, value, grad.contiguous(), key_bias, ctx.seeds, ctx.sm_scale, ctx.heads, ctx.rate,
            ctx.total_heads, ctx.head_offset,
        )
        return (*gradients, None, None, None, None, None, None, None)
