"""The whole CTC prefix beam search in one CUDA launch, and the backtrace of
its backpointers in another (counterpart of ``allophant_tpu/ops/beam_kernel.py``).

``beam_search_cuda`` launches one of the three search kernels of
``csrc/beam_search.cu``, which its C entry point picks by shape alone
(``beam_search_warp_kernel`` for K <= 8 and C <= 64, ``beam_search_kernel``
for wider rows up to K = 16, ``beam_search_wide_kernel`` for every K above),
and ``backtrace_cuda`` launches ``beam_backtrace_kernel`` from the same
source. Both take CUDA tensors only; ``ops/decode.py`` routes
CPU tensors to the plain versions ``beam_search_padded`` and
``backtrace_beams_device``.

The TPU kernel holds a whole [b, T, C_pad] emission block in VMEM, so a plan
(``plan_beam_kernel``) picks how many batch rows fit and the caller falls
back to the ``lax.scan`` search when none does. The CUDA kernels give each
batch row one warp or one thread block and stream the emissions one time step
at a time, so they take every T, every beam width and every class count up to
``MAX_CLASSES``: there is no plan and no fallback. Their outputs are the
unpacked (parents, emitted, scores) contract of ``beam_search_padded``."""

from __future__ import annotations

import torch

from allophant_tpu_torch.kernels.build import check_launch, load_kernel

#: Decoded tokens leave the device as int16.
MAX_CLASSES = 32_767


def _check_cuda(name: str, tensor: torch.Tensor, device) -> None:
    if tensor.device.type != "cuda" or (device is not None and tensor.device != device):
        raise ValueError(f"{name} must be a CUDA tensor on the kernel's device, not on {tensor.device}")


def beam_search_cuda(log_emissions: torch.Tensor, lengths: torch.Tensor, beam_width: int = 4, blank_index: int = 0):
    """[B, T, C] log-probabilities (cast to f32) + [B] lengths -> (parents
    [T, B, K] int32, emitted [T, B, K] int32, scores [B, K] f32), the contract
    of ``beam_search_padded``. ``beam_search_cuda.launches`` counts launches."""
    _check_cuda("log_emissions", log_emissions, None)
    _check_cuda("lengths", lengths, log_emissions.device)
    if log_emissions.ndim != 3 or lengths.shape != log_emissions.shape[:1]:
        raise ValueError(f"beam search takes [B, T, C] emissions and [B] lengths, got {tuple(log_emissions.shape)}, {tuple(lengths.shape)}")
    batch, time, classes = log_emissions.shape
    if not 1 <= classes <= MAX_CLASSES:
        raise ValueError(f"beam search kernel takes 1 to {MAX_CLASSES} classes, got {classes}")
    if beam_width < 1:
        raise ValueError(f"beam search takes a beam width of at least 1, got {beam_width}")
    if not 0 <= blank_index < classes:
        raise ValueError(f"blank index {blank_index} is outside the {classes} classes")
    emissions = log_emissions.float().contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    device = emissions.device
    parents = torch.empty(time, batch, beam_width, dtype=torch.int32, device=device)
    emitted = torch.empty(time, batch, beam_width, dtype=torch.int32, device=device)
    scores = torch.empty(batch, beam_width, dtype=torch.float32, device=device)
    if batch == 0:
        return parents, emitted, scores
    forward = load_kernel("beam_search")
    # The wide kernel's per-row workspace, where it exceeds shared memory.
    workspace_bytes = load_kernel("beam_search_workspace_bytes")(classes, beam_width)
    workspace = torch.empty(batch * workspace_bytes, dtype=torch.uint8, device=device) if workspace_bytes else None
    with torch.cuda.device(device):
        status = forward(
            emissions.data_ptr(), lengths.data_ptr(), parents.data_ptr(), emitted.data_ptr(), scores.data_ptr(),
            batch, time, classes, beam_width, blank_index, None if workspace is None else workspace.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch("beam_search", status)
    beam_search_cuda.launches += 1
    return parents, emitted, scores


beam_search_cuda.launches = 0


def backtrace_cuda(parents: torch.Tensor, emitted: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """parents, emitted [T, B, K] int32 + [B] lengths -> collected [T, B, K]
    int32, the contract of ``backtrace_beams_device``: one block per row,
    whose chase of the parents is cut into segments chased in parallel and
    then joined. ``backtrace_cuda.launches`` counts launches."""
    _check_cuda("emitted", emitted, None)
    _check_cuda("parents", parents, emitted.device)
    _check_cuda("lengths", lengths, emitted.device)
    if emitted.ndim != 3 or parents.shape != emitted.shape or lengths.shape != emitted.shape[1:2]:
        raise ValueError("backtrace takes parents and emitted [T, B, K] and lengths [B]")
    if parents.dtype != torch.int32 or emitted.dtype != torch.int32:
        raise ValueError("backtrace kernel takes int32 parents and emitted tokens")
    time, batch, beams = emitted.shape
    parents, emitted = parents.contiguous(), emitted.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    collected = torch.empty_like(emitted)
    if time == 0 or batch == 0:
        return collected
    forward = load_kernel("beam_backtrace")
    with torch.cuda.device(emitted.device):
        status = forward(
            parents.data_ptr(), emitted.data_ptr(), lengths.data_ptr(), collected.data_ptr(),
            batch, time, beams, torch.cuda.current_stream(emitted.device).cuda_stream,
        )
    check_launch("beam_backtrace", status)
    backtrace_cuda.launches += 1
    return collected


backtrace_cuda.launches = 0
