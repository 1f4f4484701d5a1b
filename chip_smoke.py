#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (allophant_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel from csrc/ (one nvcc per source, in parallel),
     then the count of tensor-core instructions (HMMA, HGMMA) in the SASS
     (cuobjdump) of K1's, K5's and K4's libraries, which must not be 0, and
     the SASS instructions of K2's frame loop per output element;
  3. kernels: each kernel against its plain PyTorch twin on the card, in bf16
     and f32, at the serving shapes and beyond (one-shot attention at
     T = 511, 512, 1536 and 6400 frames with a zero-length and a ragged row,
     and at T = 512 with rows ending on each side of the 64-key tile edges;
     bit-equal over two calls), with kernel, twin and library times (medians
     of three rounds) and the roofline bound;
     K2 also at C = 100, 64, 1024 and 1, with its time per request and per
     training step;
     Beam kernels: the CTC prefix beam search (K3) and its backtrace against
     their plain versions, integer-equal, at the serving shapes (B = 8,
     T = 511, C = 4 and 40), the stacked heads of one request, a 30 s
     request, a 2400-class inventory, T = 2 and 37, K = 1, 2 and 8, the
     widest class count (32767), a blank index of 3, exact ties (uniform and
     quantised emissions) and each side of the warp kernel's limits; the
     wide kernel at K = 17, 32, 64 and 100 on C = 4 and 40 with ties, and
     with its workspace in global memory (2400 and 32767 classes), scores
     bit-equal; every case naming the kernel its shape routes to;
     Training kernels: the attention-dropout forward (K5) and the fused
     attention backward (K4, with dropout and without) against their twins
     in bf16 and f32 at the training shape (B = 8, T = 499, H = 16, strided
     q/k/v), at T = 512, 1535 and 2 with a ragged and a zero-length row and
     at T = 512 with rows ending on each side of the 64-key tile edges, K4
     also against autograd of the forward twins, each bit-equal over two
     calls; the dropout-mask kernel (K6) integer-equal to its twin;
     Head widths: K1, K5 and K4 at 32, 80, 120 and 128 in bf16 and f32
     against their twins (K5 and K4 bit-equal over two calls), widths 136
     and 100 raising, and bf16 times at 16 heads of each width; library
     times (scaled_dot_product_attention) with the backend pinned and named;
  4. serve: the full-width flagship (XLS-R 300M + hierarchical head, seeded
     random weights) under the default "mixed" preset answers three requests
     through Estimator.predict_decoded, with the kernel launch counters read
     around each request;
  5. serve beam: the same three requests through
     Estimator.predict_beam_decoded (all 38 heads, beam width 4), launch
     counters read around each; the first request's log-probs from the card
     are searched on the CPU, and the grids must be equal;
  6. wide heads: the flagship head on a 2-layer encoder of XLS-R 1B's width
     (16 heads of 80) answers one greedy request and the same request at
     beam widths 17, 32, 64 and 100, launch counters read around each; each
     beam grid equals the CPU search of the card's log-probs;
  7. float32: one 2 s request in "float32" on the card and on the CPU (twins),
     greedy and beam grids equal;
  8. train: the full-width training flagship ("mixed", f32 master weights,
     the flagship's dropout, Adam, schedule, clipping and frozen feature
     extractor) takes three steps through make_train_step at A = 2, B = 8,
     10 s, all 37 CTC heads, with launch counters read around each step and
     the plain twins forbidden; the step time, audio-s/s and peak memory are
     printed, then one make_eval_step call;
  9. train float32: one deterministic step of a full-width 4-layer flagship
     on the card and on the CPU: metrics, gradients and parameters compared.
Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without that line when no CUDA
device is present or the port's package is not beside this script."""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth, bf16
# tensor-core and f32 CUDA-core arithmetic. A card set below 700 W runs slower.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SAMPLE_RATE = 16_000


class SmokeFailure(RuntimeError):
    pass


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def cuda_ms(function, iterations: int) -> float:
    """Mean device time of ``function`` over ``iterations`` back-to-back calls,
    after one warm-up call, from CUDA events."""
    function()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        function()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iterations


def median_ms(function, iterations: int, rounds: int = 3) -> float:
    """Median of ``rounds`` cuda_ms readings: one call's reading can stray
    (SDPA's backward read 0.1792, 0.2106 and 1.2204 ms in three calls at one
    shape on an H100 80GB HBM3 at 700 W)."""
    return float(np.median([cuda_ms(function, iterations) for _ in range(rounds)]))


def pinned_library_ms(make, iterations: int):
    """(median ms of three cuda_ms readings, backend name, the readings) of
    the call that ``make()`` returns, with scaled_dot_product_attention's
    backend pinned by torch.nn.attention.sdpa_kernel: the memory-efficient
    one, else cuDNN's, else the math one, whichever runs first. ``make`` runs
    under the pin too, so that a backward is timed on the forward's backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call = make()
                readings = [cuda_ms(call, iterations) for _ in range(3)]
        except RuntimeError:
            continue
        return float(np.median(readings)), backend.name, readings
    raise SmokeFailure("no scaled_dot_product_attention backend ran")


def readings_text(readings) -> str:
    return ", ".join(f"{value:.4f}" for value in readings)


def bound_ms(bytes_moved: float, operations: float, dtype_name: str):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    operation_ms = operations / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (byte_ms, "bytes") if byte_ms >= operation_ms else (operation_ms, "operations")


def phase_card() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    line = result.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> float:
    from allophant_tpu_torch.kernels.build import build_all, build_directory

    seconds = build_all()
    print(f"build: {seconds:.2f} s into {build_directory().relative_to(HERE)}", flush=True)
    return seconds


def phase_tensor_cores() -> None:
    """Counts the tensor-core instructions (HMMA, HGMMA) in the SASS of the
    libraries whose bf16 kernels run on them (K1, K5, K4); fails if one has
    none."""
    from allophant_tpu_torch.kernels.build import cuda_tool, library_path

    for library in ("oneshot_attention", "attention_dropout", "attention_backward"):
        sass = subprocess.run(
            [cuda_tool("cuobjdump"), "-sass", str(library_path(library))],
            capture_output=True, text=True, check=True, timeout=120,
        ).stdout
        counts = {name: len(re.findall(rf"\b{name}\.", sass)) for name in ("HMMA", "HGMMA")}
        print(f"tensor cores: lib{library}.so SASS holds {counts['HMMA']} HMMA and {counts['HGMMA']} HGMMA instructions", flush=True)
        check(sum(counts.values()) > 0, f"lib{library}.so has no tensor-core instruction")


def phase_frame_encoder_sass() -> None:
    """The SASS of K2's bf16 kernel at 16 channels a lane (C = 512): the
    instructions of its frame loop (every inner loop is unrolled, and both
    sides of erff's branch are counted, since a warp nearly always takes
    both) over the 2 frames x 16 channels a lane computes in one pass, and
    the main kinds among them. Prints what it can read; never fails."""
    from allophant_tpu_torch.kernels.build import cuda_tool, library_path

    sass = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", str(library_path("frame_encoder"))], capture_output=True, text=True, timeout=120
    ).stdout
    functions = re.split(r"\n\s*Function : ", sass)
    body = next((text for text in functions if "frame_encoder_kernel" in text.splitlines()[0] and "bfloat16" in text.splitlines()[0] and "Li16E" in text.splitlines()[0]), None)
    if body is None:
        print("sass frame_encoder: kernel not found", flush=True)
        return
    instructions = [(int(address, 16), text.strip()) for address, text in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    backward = [
        (int(match.group(1), 16), address)
        for address, text in instructions
        for match in [re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)]
        if match and int(match.group(1), 16) < address
    ]
    if not backward:
        print(f"sass frame_encoder: {len(instructions)} instructions, frame loop not found", flush=True)
        return
    start, end = max(backward, key=lambda pair: pair[1] - pair[0])
    loop = [text for address, text in instructions if start <= address <= end]
    kinds = {kind: sum(bool(re.search(rf"\b{kind}\b", text)) for text in loop) for kind in ("FFMA", "FMUL", "FADD", "MUFU", "SHFL", "LDS", "LDG", "STG", "F2FP")}
    print(
        f"sass frame_encoder bf16 C=512: {len(instructions)} instructions, frame loop {len(loop)}"
        f" for 32 elements a lane: {len(loop) / 32:.1f} a element; {kinds}",
        flush=True,
    )


def frame_encoder_inputs(batch: int, samples: int, channels: int = 512):
    generator = torch.Generator(device="cuda").manual_seed(11)

    def normal(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=generator, device="cuda") * scale + shift

    return (
        normal(batch, samples),
        normal(10, channels, scale=10**-0.5),
        normal(channels, scale=0.1),
        normal(channels, scale=0.1, shift=1.0),
        normal(channels, scale=0.1),
    )


def phase_frame_encoder(serve_batch: int, serve_samples: int) -> dict:
    """K2 against its twin in bf16 and f32 at the 10 s serving bucket, at the
    smallest bucket (1024 samples, whose 1024 % 5 tail the kernel drops) and
    at other channel counts (odd, narrow, the widest, one channel); returns
    the kernel's JSON entry (serving bucket, bf16: the "mixed" dtype), with
    its time per request (one launch) and per training step (one launch per
    microbatch of TRAIN_ACCUMULATION at [TRAIN_BATCH, 10 s])."""
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv, reference_frame_conv

    entry = None
    # f32: exact erff in both, differing only in summation order (1e-4); bf16:
    # one rounding of O(4) values (2e-2).
    shapes = [(serve_batch, serve_samples, 512), (2, 1024, 512), (2, 5 * 300 + 3, 100), (3, 2003, 64), (2, 4000, 1024), (2, 1500, 1)]
    cases = [
        (batch, samples, channels, dtype, tolerance)
        for batch, samples, channels in shapes
        for dtype, tolerance in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
    ]
    for batch, samples, channels, dtype, tolerance in cases:
        inputs = frame_encoder_inputs(batch, samples, channels)
        got = fused_frame_conv(*inputs, eps=1e-5, out_dtype=dtype)
        expected = reference_frame_conv(*inputs, 1e-5, dtype)
        torch.cuda.synchronize()
        error = (got.float() - expected.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        dtype_name = str(dtype).removeprefix("torch.")
        print(
            f"kernel frame_encoder {dtype_name} B={batch} S={samples} C={channels} -> {got.shape[1]} frames:"
            f" max_abs_err {error:.3e} (tolerance {tolerance:.0e}), finite {finite}",
            flush=True,
        )
        check(got.shape == expected.shape and finite and error <= tolerance, f"frame_encoder {dtype_name} C={channels} disagrees: {error}")
        if entry is None:
            frames, channels = got.shape[1], got.shape[2]
            kernel_ms = median_ms(lambda: fused_frame_conv(*inputs, eps=1e-5, out_dtype=dtype), 20)
            plain_ms = cuda_ms(lambda: reference_frame_conv(*inputs, 1e-5, dtype), 5)
            bytes_moved = batch * samples * 4 + 13 * channels * 4 + batch * frames * channels * got.element_size()
            # The conv's multiply-adds alone (10 per output element, f32).
            operations = 2 * 10 * batch * frames * channels
            bound, bound_by = bound_ms(bytes_moved, operations, "float32")
            train_inputs = frame_encoder_inputs(TRAIN_BATCH, TRAIN_SECONDS * SAMPLE_RATE, channels)
            step_ms = TRAIN_ACCUMULATION * median_ms(lambda: fused_frame_conv(*train_inputs, eps=1e-5, out_dtype=dtype), 20)
            print(
                f"time frame_encoder {dtype_name} B={batch} S={samples}: kernel {kernel_ms:.4f} ms,"
                f" twin {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); per request {kernel_ms:.4f} ms (1 launch),"
                f" per training step {step_ms:.4f} ms ({TRAIN_ACCUMULATION} launches at [{TRAIN_BATCH}, {TRAIN_SECONDS * SAMPLE_RATE}])",
                flush=True,
            )
            entry = {
                "name": "frame_encoder",
                "route": "cuda",
                "source": "allophant_tpu_torch/csrc/frame_encoder.cu",
                "replaces": "allophant_tpu/ops/frame_encoder.py:47",
                "max_abs_err": error,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,
                "shape": f"audio [{batch}, {samples}] f32 -> [{batch}, {frames}, {channels}] {dtype_name}",
            }
    return entry


def attention_inputs(lengths, time_steps, heads, head_dim, dtype, fused_qkv: bool):
    """q, k, v [B, T, H*hd] and the additive key bias for the given lengths.
    With ``fused_qkv`` they are the three column blocks of one [B, T, 3*H*hd]
    tensor, as the encoder's fused projection produces them (time stride
    3*H*hd); otherwise three contiguous tensors."""
    generator = torch.Generator(device="cuda").manual_seed(time_steps)
    batch, model_dim = len(lengths), heads * head_dim
    if fused_qkv:
        qkv = torch.randn(batch, time_steps, 3 * model_dim, generator=generator, device="cuda").to(dtype)
        q, k, v = qkv.split(model_dim, dim=-1)
    else:
        q, k, v = (torch.randn(batch, time_steps, model_dim, generator=generator, device="cuda").to(dtype) for _ in range(3))
    lengths = torch.as_tensor(lengths, device="cuda").clamp_min(0)
    bias = torch.zeros(batch, time_steps, device="cuda")
    bias.masked_fill_(torch.arange(time_steps, device="cuda")[None] >= lengths[:, None], -1e9)
    return q, k, v, bias, lengths


def attention_work(batch, time_steps, heads, head_dim, lengths, item_bytes):
    """Bytes (q, k, v read, out written, bias read) and operations (q.k and p.v
    over the keys each row needs: its valid keys, or all of them for a
    zero-length row, whose output averages every value)."""
    keys = sum(int(length) if int(length) > 0 else time_steps for length in lengths.tolist())
    bytes_moved = 4 * batch * time_steps * heads * head_dim * item_bytes + batch * time_steps * 4
    operations = 4 * heads * head_dim * time_steps * keys
    return bytes_moved, operations


def twin_by_rows(reference, q, k, v, bias, scale, heads):
    """The twin one batch row at a time: its [H, T, T] f32 score tensor for
    all rows at once would not fit in device memory at T = 6400."""
    return torch.cat([reference(q[i : i + 1], k[i : i + 1], v[i : i + 1], bias[i : i + 1], scale, heads) for i in range(q.shape[0])])


def phase_attention(serve_lengths, serve_time) -> dict:
    """K1 against its twin at the serving shape (the first request's frame
    lengths) and at T = 512, 1536 and 6400; returns the JSON entry of the
    serving shape in bf16."""
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention, reference_oneshot

    batch, heads, head_dim = 8, 16, 64
    scale = head_dim**-0.5
    entry = None
    # Two limits on valid rows, both scaled by RMS(twin), since the output's
    # scale falls as 1/sqrt(T) (about 0.02 at T = 6400 with N(0, 1) inputs):
    # RMS(kernel - twin) <= rms_tolerance * RMS(twin), which a dropped key tile
    # breaks; and per element, |kernel - twin| <= rtol * |twin| +
    # scale_tolerance * RMS(twin), which a wrong query tile breaks. f32: plain
    # f32 in both, differing in the online rescaling and the summation order
    # (1e-5; 0, 1e-4). bf16: both round the weights to bf16, the kernel
    # against the running peak and the twin against the final one, and both
    # round the output, whose ulp is up to 2^-7 of it (5e-3; 2^-6, 5e-2).
    # The serving case reads q/k/v as strided views of the fused projection,
    # as the encoder does; the others are contiguous, with a zero-length and a
    # ragged row. The tile-skip case puts a row's last valid key on each side
    # of the 64-key tile edges where the bf16 kernel stops.
    cases = (
        [(serve_time, list(serve_lengths), "serve")]
        + [(t, [0, t - 123] + [t] * (batch - 2), "ragged") for t in (512, 1536, 6400)]
        # The smallest bucket (1024 samples) gives 2 frames; 37 is one ragged tile.
        + [(2, [0, 1] + [2] * (batch - 2), "short"), (37, [0, 5] + [37] * (batch - 2), "short")]
        + [(512, [0, 1, 63, 64, 65, 128, 512 - 123, 512], "tile-skip")]
    )
    for time_steps, row_lengths, label in cases:
        for dtype, rms_tolerance, rtol, scale_tolerance in (
            (torch.bfloat16, 5e-3, 2**-6, 5e-2),
            (torch.float32, 1e-5, 0.0, 1e-4),
        ):
            q, k, v, bias, lengths = attention_inputs(
                row_lengths, time_steps, heads, head_dim, dtype, fused_qkv=label == "serve"
            )
            got = oneshot_attention(q, k, v, bias, scale, heads)
            again = oneshot_attention(q, k, v, bias, scale, heads)
            expected = twin_by_rows(reference_oneshot, q, k, v, bias, scale, heads)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"oneshot_attention T={time_steps}: two calls differ")
            valid = torch.arange(time_steps, device="cuda")[None] < lengths[:, None]
            difference = (got.float() - expected.float())[valid].abs()
            twin = expected.float()[valid]
            rms = twin.square().mean().sqrt().item()
            error = difference.max().item()
            rms_ratio = difference.square().mean().sqrt().item() / rms
            # Worst share of the per-element limit; the check needs <= 1.
            worst = (difference / (rtol * twin.abs() + scale_tolerance * rms)).max().item()
            finite = bool(torch.isfinite(got).all().item())
            dtype_name = str(dtype).removeprefix("torch.")
            print(
                f"kernel oneshot_attention {dtype_name} B={batch} T={time_steps} H={heads} hd={head_dim}"
                f" {'strided' if label == 'serve' else 'contiguous'} lengths={lengths.tolist()}:"
                f" max_abs_err {error:.3e}, twin rms {rms:.3e}, error rms / twin rms {rms_ratio:.3e}"
                f" (tolerance {rms_tolerance:.0e}), worst share of the per-element limit {worst:.3f}"
                f" ({rtol:.2e} * |twin| + {scale_tolerance:.0e} * twin rms), finite {finite}, two calls bit-equal",
                flush=True,
            )
            check(
                finite and rms_ratio <= rms_tolerance and worst <= 1.0,
                f"oneshot_attention {dtype_name} T={time_steps} disagrees: rms ratio {rms_ratio}, share {worst}",
            )
            if label == "serve" and dtype == torch.bfloat16:
                kernel_readings = [cuda_ms(lambda: oneshot_attention(q, k, v, bias, scale, heads), 20) for _ in range(3)]
                kernel_ms = float(np.median(kernel_readings))
                plain_ms = cuda_ms(lambda: reference_oneshot(q, k, v, bias, scale, heads), 5)
                shape4 = (batch, time_steps, heads, head_dim)
                q4, k4, v4 = (tensor.view(shape4).transpose(1, 2) for tensor in (q, k, v))
                mask = bias.to(dtype)[:, None, None, :]
                library_ms, backend, library_readings = pinned_library_ms(
                    lambda: lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), 20
                )
                bytes_moved, operations = attention_work(batch, time_steps, heads, head_dim, lengths, 2)
                bound, bound_by = bound_ms(bytes_moved, operations, dtype_name)
                print(
                    f"time oneshot_attention {dtype_name} B={batch} T={time_steps}: kernel {kernel_ms:.4f} ms"
                    f" (readings {readings_text(kernel_readings)}), twin {plain_ms:.4f} ms,"
                    f" scaled_dot_product_attention [{backend}] {library_ms:.4f} ms (readings {readings_text(library_readings)}),"
                    f" bound {bound:.4f} ms ({bound_by})",
                    flush=True,
                )
                entry = {
                    "name": "oneshot_attention",
                    "route": "cuda",
                    "source": "allophant_tpu_torch/csrc/oneshot_attention.cu",
                    "replaces": "allophant_tpu/ops/oneshot_attention.py:402",
                    "max_abs_err": error,
                    "ms": kernel_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                    "shape": f"q/k/v [{batch}, {time_steps}, {heads * head_dim}] {dtype_name}",
                }
    return entry


TRAIN_BATCH, TRAIN_TIME, HEADS, HEAD_DIM = 8, 499, 16, 64
# (time steps, row lengths, label): the training shape reads q/k/v as strided
# views of the fused projection, as the encoder does; the others are
# contiguous, with a zero-length and a ragged row. T = 2 is one ragged tile.
# The tile-skip case puts a row's last valid key on each side of the 64-key
# tile edges where the bf16 kernels stop.
DROPOUT_CASES = (
    [(TRAIN_TIME, [TRAIN_TIME] * TRAIN_BATCH, "train")]
    + [(t, [0, t - 123] + [t] * (TRAIN_BATCH - 2), "ragged") for t in (512, 1535)]
    + [(2, [0, 1] + [2] * (TRAIN_BATCH - 2), "short")]
    + [(512, [0, 1, 63, 64, 65, 128, 512 - 123, 512], "tile-skip")]
)
# Limits in the style of K1's, both scaled by RMS(twin): RMS(kernel - twin) <=
# rms_tolerance * RMS(twin), and per element |kernel - twin| <= rtol * |twin| +
# scale_tolerance * RMS(twin). f32: plain f32 in both, differing in the online
# rescaling and the summation order. bf16: both round the masked weights (and
# in the backward ds) to bf16, the kernel against the running peak and the twin
# against the final one, and both round the output.
KERNEL_LIMITS = {torch.bfloat16: (5e-3, 2**-6, 5e-2), torch.float32: (1e-5, 0.0, 1e-4)}
DROPOUT_SEEDS = (1_234_567, -89_101_112)


def compare(label: str, pairs, limits) -> float:
    """Holds every entry of each (name, got, expected) in ``pairs`` to
    ``limits``; prints one line with the worst of them and returns the max abs
    error."""
    rms_tolerance, rtol, scale_tolerance = limits
    error = ratio = worst = 0.0
    for name, got, expected in pairs:
        difference = (got.float() - expected.float()).abs()
        twin = expected.float()
        rms = twin.square().mean().sqrt().item()
        part_ratio = difference.square().mean().sqrt().item() / rms
        part_worst = (difference / (rtol * twin.abs() + scale_tolerance * rms)).max().item()
        finite = bool(torch.isfinite(got).all().item())
        check(finite and part_ratio <= rms_tolerance and part_worst <= 1.0, f"{label} {name} disagrees: rms ratio {part_ratio}, share {part_worst}")
        error, ratio, worst = max(error, difference.max().item()), max(ratio, part_ratio), max(worst, part_worst)
    print(
        f"  {label}: max_abs_err {error:.3e}, error rms / twin rms {ratio:.3e} (tolerance {rms_tolerance:.0e}),"
        f" worst share of the per-element limit {worst:.3f} ({rtol:.2e} * |twin| + {scale_tolerance:.0e} * twin rms), finite",
        flush=True,
    )
    return error


def phase_dropout_mask() -> dict:
    """K6 integer-equal to its twin at the training shape, its keep rate at
    rate 0.1 within 5e-3 of keep_prob, and two calls bit-equal."""
    from allophant_tpu_torch.ops.oneshot_attention import dropout_mask_bits, keep_threshold, reference_dropout_mask_bits

    shape = (TRAIN_BATCH, HEADS, TRAIN_TIME)
    got = dropout_mask_bits(DROPOUT_SEEDS, *shape, device="cuda")
    again = dropout_mask_bits(DROPOUT_SEEDS, *shape, device="cuda")
    expected = reference_dropout_mask_bits(DROPOUT_SEEDS, *shape, device="cuda")
    torch.cuda.synchronize()
    got64, expected64 = got.to(torch.int64), expected.to(torch.int64)
    differing = int((got64 != expected64).sum().item())
    repeat_differing = int((got64 != again.to(torch.int64)).sum().item())
    threshold = keep_threshold(0.1)
    keep_rate = (got64 < threshold).double().mean().item()
    keep_prob = threshold / 2**32
    print(
        f"kernel dropout_mask B={TRAIN_BATCH} H={HEADS} T={TRAIN_TIME}: {differing} of {got.numel()} draws differ from the twin,"
        f" {repeat_differing} between two calls; keep rate at 0.1 {keep_rate:.6f} vs keep_prob {keep_prob:.6f}",
        flush=True,
    )
    check(differing == 0 and repeat_differing == 0, "dropout_mask disagrees with its twin or itself")
    check(abs(keep_rate - keep_prob) <= 5e-3, f"keep rate {keep_rate} is off keep_prob {keep_prob}")
    other = dropout_mask_bits((DROPOUT_SEEDS[0] + 1, DROPOUT_SEEDS[1]), *shape, device="cuda")
    check(not torch.equal(other.view(torch.int32), got.view(torch.int32)), "another seed gave the same draws")
    kernel_ms = median_ms(lambda: dropout_mask_bits(DROPOUT_SEEDS, *shape, device="cuda"), 20)
    plain_ms = cuda_ms(lambda: reference_dropout_mask_bits(DROPOUT_SEEDS, *shape, device="cuda"), 3)
    bound, bound_by = bound_ms(got.numel() * 4, 0, "float32")
    print(f"time dropout_mask: kernel {kernel_ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    return {
        "name": "dropout_mask",
        "route": "cuda",
        "source": "allophant_tpu_torch/csrc/attention_dropout.cu",
        "replaces": "allophant_tpu/ops/oneshot_attention.py:227",
        "max_abs_err": 0.0,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": f"u32 [{TRAIN_BATCH}, {HEADS}, {TRAIN_TIME}, {TRAIN_TIME}]",
        "note": "the oracle of K4 and K5: launched by their checks, not by the training step",
    }


def phase_dropout_attention() -> list:
    """K5 and K4 against their twins in bf16 and f32 at every DROPOUT_CASES
    shape (K5 at rates 0.1 and 0.5, K4 at 0.1 and None, every entry of dq,
    dk and dv held), K4 also against the autograd of the forward twins in
    f32, and each kernel bit-equal over two calls. Returns the JSON entries of
    K5 and K4 at the training shape in bf16 (the "mixed" encoder dtype)."""
    from allophant_tpu_torch.ops.oneshot_attention import (
        oneshot_attention_backward,
        oneshot_dropout_attention,
        reference_oneshot,
        reference_oneshot_backward,
        reference_oneshot_dropout,
    )

    scale = HEAD_DIM**-0.5
    entries = {}
    for time_steps, row_lengths, label in DROPOUT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dtype_name = str(dtype).removeprefix("torch.")
            q, k, v, bias, lengths = attention_inputs(row_lengths, time_steps, HEADS, HEAD_DIM, dtype, fused_qkv=label == "train")
            generator = torch.Generator(device="cuda").manual_seed(time_steps + 1)
            grad = torch.randn(q.shape, generator=generator, device="cuda").to(dtype)
            layout = "strided" if label == "train" else "contiguous"
            shape = f"{dtype_name} B={TRAIN_BATCH} T={time_steps} H={HEADS} hd={HEAD_DIM} {layout} lengths={lengths.tolist()}"
            rates = (0.1, 0.5) if time_steps in (TRAIN_TIME, 512) else (0.1,)
            for rate in rates:
                print(f"kernel attention_dropout {shape} rate={rate}:", flush=True)
                got = oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate)
                again = oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate)
                expected = reference_oneshot_dropout(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate)
                torch.cuda.synchronize()
                error = compare("against the twin", [("out", got, expected)], KERNEL_LIMITS[dtype])
                check(torch.equal(got, again), "attention_dropout: two calls differ")
                if label == "train" and dtype == torch.bfloat16 and rate == 0.1:
                    entries["attention_dropout"] = time_dropout_forward(q, k, v, bias, lengths, scale, rate, error)
            for rate in (0.1, None):
                seeds = DROPOUT_SEEDS if rate is not None else None
                print(f"kernel attention_backward {shape} rate={rate}:", flush=True)
                got = oneshot_attention_backward(q, k, v, grad, bias, seeds, scale, HEADS, rate)
                again = oneshot_attention_backward(q, k, v, grad, bias, seeds, scale, HEADS, rate)
                expected = reference_oneshot_backward(q, k, v, grad, bias, seeds, scale, HEADS, rate)
                torch.cuda.synchronize()
                error = compare("dq, dk, dv against the twin", list(zip(("dq", "dk", "dv"), got, expected)), KERNEL_LIMITS[dtype])
                check(all(torch.equal(a, b) for a, b in zip(got, again)), "attention_backward: two calls differ")
                if dtype == torch.float32:
                    inputs = [tensor.detach().clone().requires_grad_() for tensor in (q, k, v)]
                    if rate is None:
                        out = reference_oneshot(*inputs, bias, scale, HEADS)
                    else:
                        out = reference_oneshot_dropout(*inputs, bias, seeds, scale, HEADS, rate)
                    autograd = torch.autograd.grad(out, inputs, grad)
                    compare("dq, dk, dv against autograd of the forward twin", list(zip(("dq", "dk", "dv"), got, autograd)), KERNEL_LIMITS[dtype])
                if label == "train" and dtype == torch.bfloat16 and rate == 0.1:
                    entries["attention_backward"] = time_backward(q, k, v, grad, bias, lengths, scale, rate, error)
    return [entries["attention_dropout"], entries["attention_backward"]]


# Head widths other than 64: XLS-R 1B's 80 and 2B's 120 (which runs as the
# 128 instantiation, zero-padded), 128 itself and 32.
HEAD_WIDTHS = (32, 80, 120, 128)


def phase_head_widths() -> None:
    """K1, K5 and K4 at each of HEAD_WIDTHS, in bf16 and f32, against their
    twins at the limits of the 64-wide cases (q/k/v strided views of a fused
    projection, a ragged, a one-key and a zero-length row), K5 and K4 each
    bit-equal over two calls; a width above 128 or not a multiple of 8 must
    raise; then the bf16 times at XLS-R 1B / 2B-like shapes ([8, 499], 16
    heads)."""
    from allophant_tpu_torch.ops.oneshot_attention import (
        oneshot_attention,
        oneshot_attention_backward,
        oneshot_dropout_attention,
        reference_oneshot,
        reference_oneshot_backward,
        reference_oneshot_dropout,
    )

    batch, time_steps, heads, rate = 4, 200, 4, 0.1
    lengths = [time_steps, time_steps - 37, 1, 0]
    for head_dim in HEAD_WIDTHS:
        scale = head_dim**-0.5
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias, _ = attention_inputs(lengths, time_steps, heads, head_dim, dtype, fused_qkv=True)
            grad = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(head_dim), device="cuda").to(dtype)
            limits = KERNEL_LIMITS[dtype]
            label = f"{str(dtype).removeprefix('torch.')} B={batch} T={time_steps} H={heads} hd={head_dim} strided lengths={lengths}"
            print(f"kernel head width {label}:", flush=True)
            got = oneshot_attention(q, k, v, bias, scale, heads)
            compare("oneshot_attention against the twin", [("out", got, reference_oneshot(q, k, v, bias, scale, heads))], limits)
            got = oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, heads, rate)
            again = oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, heads, rate)
            expected = reference_oneshot_dropout(q, k, v, bias, DROPOUT_SEEDS, scale, heads, rate)
            compare(f"attention_dropout rate={rate} against the twin", [("out", got, expected)], limits)
            check(torch.equal(got, again), f"attention_dropout hd={head_dim}: two calls differ")
            for seeds, backward_rate in ((DROPOUT_SEEDS, rate), (None, None)):
                got = oneshot_attention_backward(q, k, v, grad, bias, seeds, scale, heads, backward_rate)
                again = oneshot_attention_backward(q, k, v, grad, bias, seeds, scale, heads, backward_rate)
                expected = reference_oneshot_backward(q, k, v, grad, bias, seeds, scale, heads, backward_rate)
                compare(f"attention_backward rate={backward_rate} dq, dk, dv against the twin", list(zip(("dq", "dk", "dv"), got, expected)), limits)
                check(all(torch.equal(a, b) for a, b in zip(got, again)), f"attention_backward hd={head_dim}: two calls differ")
    for head_dim in (136, 100):
        q, k, v, bias, _ = attention_inputs([8, 8], 8, 2, head_dim, torch.bfloat16, fused_qkv=False)
        for name, call in (
            ("oneshot_attention", lambda: oneshot_attention(q, k, v, bias, 1.0, 2)),
            ("attention_dropout", lambda: oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, 1.0, 2, rate)),
            ("attention_backward", lambda: oneshot_attention_backward(q, k, v, q, bias, None, 1.0, 2, None)),
        ):
            try:
                call()
            except ValueError as error:
                check("multiples of 8 up to 128" in str(error), f"{name} hd={head_dim}: {error}")
            else:
                raise SmokeFailure(f"{name} took a head width of {head_dim}")
    print("kernel head width 136 and 100: every kernel raises ValueError naming the limit", flush=True)
    for head_dim in (64, *HEAD_WIDTHS):
        scale = head_dim**-0.5
        q, k, v, bias, lengths_tensor = attention_inputs([TRAIN_TIME] * TRAIN_BATCH, TRAIN_TIME, HEADS, head_dim, torch.bfloat16, fused_qkv=True)
        grad = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
        forward_ms = median_ms(lambda: oneshot_attention(q, k, v, bias, scale, HEADS), 10)
        dropout_ms = median_ms(lambda: oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate), 10)
        backward_ms = median_ms(lambda: oneshot_attention_backward(q, k, v, grad, bias, DROPOUT_SEEDS, scale, HEADS, rate), 10)
        bytes_moved, operations = attention_work(TRAIN_BATCH, TRAIN_TIME, HEADS, head_dim, lengths_tensor, 2)
        print(
            f"time head width bf16 B={TRAIN_BATCH} T={TRAIN_TIME} H={HEADS} hd={head_dim}: oneshot_attention {forward_ms:.4f} ms"
            f" (bound {bound_ms(bytes_moved, operations, 'bfloat16')[0]:.4f}), attention_dropout {dropout_ms:.4f} ms,"
            f" attention_backward {backward_ms:.4f} ms (bound {bound_ms(7 * q.numel() * 2, operations * 5 / 2, 'bfloat16')[0]:.4f})",
            flush=True,
        )


def time_dropout_forward(q, k, v, bias, lengths, scale, rate, error) -> dict:
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_dropout_attention, reference_oneshot_dropout

    batch, time_steps, _ = q.shape
    kernel_ms = median_ms(lambda: oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate), 20)
    plain_ms = cuda_ms(lambda: reference_oneshot_dropout(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate), 3)
    q4, k4, v4 = (tensor.view(batch, time_steps, HEADS, HEAD_DIM).transpose(1, 2) for tensor in (q, k, v))
    mask = bias.to(q.dtype)[:, None, None, :]
    library_ms, backend, readings = pinned_library_ms(
        lambda: lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, dropout_p=rate), 20
    )
    bytes_moved, operations = attention_work(batch, time_steps, HEADS, HEAD_DIM, lengths, q.element_size())
    bound, bound_by = bound_ms(bytes_moved, operations, str(q.dtype).removeprefix("torch."))
    print(
        f"time attention_dropout B={batch} T={time_steps} rate={rate}: kernel {kernel_ms:.4f} ms, twin {plain_ms:.4f} ms,"
        f" scaled_dot_product_attention(dropout_p={rate}) [{backend}] {library_ms:.4f} ms (its own mask; readings"
        f" {readings_text(readings)}), bound {bound:.4f} ms ({bound_by})",
        flush=True,
    )
    return {
        "name": "attention_dropout",
        "route": "cuda",
        "source": "allophant_tpu_torch/csrc/attention_dropout.cu",
        "replaces": "allophant_tpu/ops/oneshot_attention.py:180",
        "max_abs_err": error,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": f"q/k/v [{batch}, {time_steps}, {HEADS * HEAD_DIM}] {q.dtype}, rate {rate}",
    }


def time_backward(q, k, v, grad, bias, lengths, scale, rate, error) -> dict:
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention_backward, reference_oneshot_backward

    batch, time_steps, _ = q.shape
    kernel_readings = [
        cuda_ms(lambda: oneshot_attention_backward(q, k, v, grad, bias, DROPOUT_SEEDS, scale, HEADS, rate), 10) for _ in range(3)
    ]
    kernel_ms = float(np.median(kernel_readings))
    plain_ms = cuda_ms(lambda: reference_oneshot_backward(q, k, v, grad, bias, DROPOUT_SEEDS, scale, HEADS, rate), 3)
    inputs = [tensor.detach().view(batch, time_steps, HEADS, HEAD_DIM).transpose(1, 2).requires_grad_() for tensor in (q, k, v)]
    mask = bias.to(q.dtype)[:, None, None, :]
    grad4 = grad.view(batch, time_steps, HEADS, HEAD_DIM).transpose(1, 2)

    def make_backward():
        out = F.scaled_dot_product_attention(*inputs, attn_mask=mask, dropout_p=rate)
        return lambda: torch.autograd.grad(out, inputs, grad4, retain_graph=True)

    library_ms, backend, library_readings = pinned_library_ms(make_backward, 10)
    _, operations = attention_work(batch, time_steps, HEADS, HEAD_DIM, lengths, q.element_size())
    # q, k, v, g and the bias read, dq, dk, dv written; five products per
    # (query, key) pair (s, dp, dv, dq, dk) against the forward's two.
    bytes_moved = 7 * q.numel() * q.element_size() + bias.numel() * 4
    bound, bound_by = bound_ms(bytes_moved, operations * 5 / 2, str(q.dtype).removeprefix("torch."))
    print(
        f"time attention_backward B={batch} T={time_steps} rate={rate}: kernel {kernel_ms:.4f} ms (readings"
        f" {readings_text(kernel_readings)}), twin {plain_ms:.4f} ms, scaled_dot_product_attention(dropout_p={rate}) [{backend}]"
        f" backward {library_ms:.4f} ms (its own mask; readings {readings_text(library_readings)}), bound {bound:.4f} ms ({bound_by})",
        flush=True,
    )
    return {
        "name": "attention_backward",
        "route": "cuda",
        "source": "allophant_tpu_torch/csrc/attention_backward.cu",
        "replaces": "allophant_tpu/ops/oneshot_attention.py:255",
        "max_abs_err": error,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": f"q/k/v/g [{batch}, {time_steps}, {HEADS * HEAD_DIM}] {q.dtype}, rate {rate}",
    }


def beam_inputs(batch, time_steps, classes, lengths, seed, scale=2.0, quantised=False):
    """Seeded log-softmax emissions [B, T, C] f32 and int32 lengths on the card.
    Scale 0 makes every emission of a step equal; ``quantised`` rounds the
    logits to integers, so a step's emissions take a few levels: both make
    exact ties between candidates."""
    generator = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(batch, time_steps, classes, generator=generator, device="cuda") * scale
    if quantised:
        logits = logits.round()
    return torch.log_softmax(logits, dim=-1), torch.as_tensor(lengths, dtype=torch.int32, device="cuda")


def beam_route(classes: int, beams: int) -> str:
    """Which search kernel the library's C entry point launches for this
    shape (its own beam_search_route)."""
    from allophant_tpu_torch.kernels.build import library_path

    route = ctypes.CDLL(str(library_path("beam_search"))).beam_search_route
    route.argtypes = [ctypes.c_int, ctypes.c_int]
    route.restype = ctypes.c_int
    names = ("block kernel", "warp kernel, one candidate a lane", "warp kernel, sorted lists", "wide kernel, radix select")
    return names[route(classes, beams)]


def valid_steps(lengths, time_steps) -> int:
    """The (row, step) pairs within the rows' lengths: the steps a search
    and a backtrace read."""
    return int(lengths.clamp(0, time_steps).sum().item())


def beam_work(batch, time_steps, classes, beams, lengths):
    """(bytes, operations) of one beam search: the emission rows of valid
    steps and the lengths read once (a row stops at its length), parents and
    emitted [T, B, K] int32 over all T and scores written once; per valid
    step each of the K * C candidates takes one add and one log-add (max,
    subtract, abs, exp, log1p, add: 7 f32 operations)."""
    steps = valid_steps(lengths, time_steps)
    bytes_moved = steps * classes * 4 + batch * 4 + 2 * time_steps * batch * beams * 4 + batch * beams * 4
    return bytes_moved, steps * beams * classes * 8


def check_search(label, got, expected, collected, expected_collected, bit_equal=False):
    """Parents, emitted tokens and collected grids integer-equal; scores
    within a relative 1e-5, or bit-equal with ``bit_equal`` (the kernel's
    log-add is PyTorch's, built without fast math). Returns the count of
    scores that are not bit-equal and the largest relative score difference."""
    parents, emitted, scores = got
    want_parents, want_emitted, want_scores = expected
    check(torch.equal(parents, want_parents), f"{label}: parents differ in {int((parents != want_parents).sum())} cells")
    check(torch.equal(emitted, want_emitted), f"{label}: emitted tokens differ in {int((emitted != want_emitted).sum())} cells")
    check(torch.equal(collected, expected_collected), f"{label}: collected grids differ")
    relative = ((scores - want_scores).abs() / want_scores.abs().clamp_min(1e-30)).max().item()
    check(relative <= 1e-5, f"{label}: scores differ by a relative {relative}")
    absolute = (scores - want_scores).abs().max().item() if scores.numel() else 0.0
    not_bit_equal = int((scores != want_scores).sum().item())
    check(not bit_equal or not_bit_equal == 0, f"{label}: {not_bit_equal} scores are not bit-equal")
    return not_bit_equal, relative, absolute


def phase_beam_kernels(serve_lengths, serve_time) -> list:
    """K3 (beam_search) and the backtrace kernel against their plain versions
    on the card, each case naming the search kernel its shape routes to;
    returns their JSON entries, timed at the two launches a serving request
    of the first shape makes: the 36 four-class attribute heads stacked as
    [36·8, 511, 4] and the phone and phoneme heads as [2·8, 511, 40]."""
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda
    from allophant_tpu_torch.ops.decode import backtrace_beams_device, beam_search_padded

    serve = list(serve_lengths)
    cases = [
        # (label, B, T, C, K, lengths, scale, blank)
        ("serve C=4", 8, serve_time, 4, 4, serve, 1.0, 0),
        ("serve C=40", 8, serve_time, 40, 4, serve, 2.0, 0),
        ("stacked attribute heads", 36 * 8, serve_time, 4, 4, serve * 36, 1.0, 0),
        ("stacked phone + phoneme", 2 * 8, serve_time, 40, 4, serve * 2, 2.0, 0),
        ("30 s request", 1, 1535, 40, 4, [1535], 2.0, 0),
        ("full inventory", 16, 512, 2400, 4, [0, 389] + [512] * 14, 2.0, 0),
        ("short T=2", 8, 2, 40, 4, [0, 1] + [2] * 6, 2.0, 0),
        ("short T=37", 8, 37, 40, 4, [0, 5] + [37] * 6, 2.0, 0),
        ("K=1", 8, serve_time, 40, 1, serve, 2.0, 0),
        ("K=8", 8, serve_time, 40, 8, serve, 0.5, 0),
        ("near-uniform merging", 8, serve_time, 40, 4, serve, 0.3, 0),
        # Wider than the kernel stages in shared memory: read from global memory.
        ("widest classes", 3, 37, 32767, 4, [0, 23, 37], 2.0, 0),
        # A blank other than 0: the stay column, the merges that skip it.
        ("blank 3", 8, serve_time, 40, 4, serve, 0.5, 3),
        ("blank 3 C=4", 8, serve_time, 4, 4, serve, 0.5, 3),
        ("K=2", 8, serve_time, 40, 2, serve, 0.5, 0),
        # Exact ties: every emission of a step equal (scale 0), or logits
        # rounded to a few levels; the winners must follow the twin's order.
        ("uniform emissions C=4", 8, serve_time, 4, 4, serve, 0.0, 0),
        ("uniform emissions C=40", 8, serve_time, 40, 4, serve, 0.0, 0),
        ("quantised emissions C=4", 8, serve_time, 4, 4, serve, 1.0, 0),
        ("quantised emissions C=40", 8, serve_time, 40, 4, serve, 1.0, 0),
        # Each side of the warp kernel's limits (K <= 8, C <= 64).
        ("warp limit, inside", 8, serve_time, 64, 8, serve, 0.5, 0),
        ("warp limit, C outside", 8, serve_time, 65, 8, serve, 0.5, 0),
        ("warp limit, K outside", 8, serve_time, 40, 9, serve, 0.5, 0),
        # Each side of the block kernel's limit (K <= 16), then the wide
        # kernel at the widths CTC decoders commonly search, on both flagship
        # class counts, with ties; scores must be bit-equal there.
        ("block limit, inside", 4, 128, 40, 16, [128, 97, 1, 0], 0.5, 0),
        *[
            (f"wide K={beams} C={classes}", 4, 128, classes, beams, [128, 97, 1, 0], 1.0 if classes == 4 else 2.0, 0)
            for beams in (17, 32, 64, 100)
            for classes in (4, 40)
        ],
        ("wide uniform emissions K=32 C=40", 4, 128, 40, 32, [128, 97, 1, 0], 0.0, 0),
        ("wide uniform emissions K=100 C=4", 4, 128, 4, 100, [128, 97, 1, 0], 0.0, 0),
        ("wide quantised emissions K=64 C=40", 4, 128, 40, 64, [128, 97, 1, 0], 1.0, 0),
        ("wide quantised emissions K=100 C=4", 4, 128, 4, 100, [128, 97, 1, 0], 1.0, 0),
        ("wide near-uniform merging K=32 C=40", 4, 128, 40, 32, [128, 97, 1, 0], 0.3, 0),
        ("wide blank 3 K=17 C=40", 4, 128, 40, 17, [128, 97, 1, 0], 0.5, 3),
        # Workspaces too large for shared memory live in global scratch; the
        # widest rows are also read from global memory.
        ("wide K=17 full inventory", 2, 64, 2400, 17, [64, 40], 2.0, 0),
        ("wide K=100 full inventory", 1, 32, 2400, 100, [32], 2.0, 0),
        ("wide K=17 widest classes", 2, 16, 32767, 17, [16, 9], 2.0, 0),
    ]
    # One request's work: both launches of each kernel, summed.
    totals = dict.fromkeys(("ms", "plain_ms", "bytes", "operations", "backtrace_ms", "backtrace_plain_ms", "backtrace_bytes"), 0.0)
    search_error = backtrace_error = 0.0
    for index, (label, batch, time_steps, classes, beams, lengths, scale, blank) in enumerate(cases):
        quantised = "quantised" in label
        emissions, lengths = beam_inputs(batch, time_steps, classes, lengths, 100 + index, scale, quantised)
        route = beam_route(classes, beams)
        got = beam_search_cuda(emissions, lengths, beams, blank)
        expected = beam_search_padded(emissions, lengths, beams, blank)
        collected = backtrace_cuda(got[0], got[1], lengths)
        torch.cuda.synchronize()
        # The backtrace kernel on the kernel's own backpointers against its
        # plain version on the same input, then the two whole searches.
        backtrace_twin = backtrace_beams_device(got[0], got[1], lengths)
        if collected.numel():
            backtrace_error = max(backtrace_error, float((collected - backtrace_twin).abs().max().item()))
        check(torch.equal(collected, backtrace_twin), f"{label}: backtrace differs")
        expected_collected = backtrace_beams_device(expected[0], expected[1], lengths)
        not_bit_equal, relative, absolute = check_search(
            label, got, expected, collected, expected_collected, bit_equal=label.startswith("wide")
        )
        search_error = max(search_error, absolute)
        live = int((got[2] > -5e29).sum().item())
        print(
            f"kernel beam_search B={batch} T={time_steps} C={classes} K={beams} blank={blank} {label} ({route}): parents,"
            f" emitted and collected integer-equal; scores not bit-equal {not_bit_equal} of {got[2].numel()}"
            f" (largest relative difference {relative:.3e}, tolerance 1e-5), live slots {live}",
            flush=True,
        )
        if label.startswith("stacked"):
            search_ms = median_ms(lambda: beam_search_cuda(emissions, lengths, beams), 20)
            search_plain_ms = cuda_ms(lambda: beam_search_padded(emissions, lengths, beams), 1)
            backtrace_ms = median_ms(lambda: backtrace_cuda(got[0], got[1], lengths), 20)
            backtrace_plain_ms = cuda_ms(lambda: backtrace_beams_device(got[0], got[1], lengths), 2)
            bytes_moved, operations = beam_work(batch, time_steps, classes, beams, lengths)
            # The backtrace: parents and emitted read at valid steps, lengths
            # read once, collected [T, B, K] written once.
            backtrace_bytes = valid_steps(lengths, time_steps) * beams * 8 + batch * 4 + time_steps * batch * beams * 4
            for key, value in zip(totals, (search_ms, search_plain_ms, bytes_moved, operations, backtrace_ms, backtrace_plain_ms, backtrace_bytes)):
                totals[key] += value
            print(
                f"time beam_search {label} B={batch} T={time_steps} C={classes} K={beams} ({route}): kernel {search_ms:.4f} ms"
                f" ({search_ms * 1e3 / time_steps:.3f} us per step), twin {search_plain_ms:.4f} ms,"
                f" bound {bound_ms(bytes_moved, operations, 'float32')[0]:.6f} ms;"
                f" backtrace kernel {backtrace_ms:.4f} ms, twin {backtrace_plain_ms:.4f} ms,"
                f" bound {bound_ms(backtrace_bytes, 0, 'float32')[0]:.6f} ms",
                flush=True,
            )
    search_bound, search_bound_by = bound_ms(totals["bytes"], totals["operations"], "float32")
    backtrace_bound, backtrace_bound_by = bound_ms(totals["backtrace_bytes"], 0, "float32")
    shape = f"per request: [{36 * 8}, {serve_time}, 4] + [{2 * 8}, {serve_time}, 40] f32, K=4"
    return [
        {
            "name": "beam_search",
            "route": "cuda",
            "source": "allophant_tpu_torch/csrc/beam_search.cu",
            "replaces": "allophant_tpu/ops/beam_kernel.py:43",
            "max_abs_err": search_error,
            "ms": totals["ms"],
            "plain_ms": totals["plain_ms"],
            "bound_ms": search_bound,
            "bound_by": search_bound_by,
            "library_ms": None,
            "shape": shape,
        },
        {
            "name": "beam_backtrace",
            "route": "cuda",
            "source": "allophant_tpu_torch/csrc/beam_search.cu",
            "replaces": "allophant_tpu/ops/decode.py:544",
            "max_abs_err": backtrace_error,
            "ms": totals["backtrace_ms"],
            "plain_ms": totals["backtrace_plain_ms"],
            "bound_ms": backtrace_bound,
            "bound_by": backtrace_bound_by,
            "library_ms": None,
            "shape": shape,
        },
    ]


def serving_requests():
    """(name, predict_decoded keyword arguments) of the three serving requests,
    with audio drawn from a fixed seed."""
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.demo import flagship_zero_shot_table

    rng = np.random.default_rng(7)

    def batch(lengths, language_ids):
        lengths = np.asarray(lengths, dtype=np.int32)
        audio = np.zeros((len(lengths), max(int(lengths.max()), 1)), dtype=np.float32)
        for row, length in enumerate(lengths):
            audio[row, :length] = rng.standard_normal(length).astype(np.float32) * 0.1
        return Batch(audio, lengths, np.asarray(language_ids))

    seconds = SAMPLE_RATE
    return [
        (
            "8 x 2-10 s with a zero-length filler row",
            dict(batch=batch([10 * seconds, 2 * seconds, 95_000, 0, 8 * seconds, 56_000, 144_000, 77_000], [0, 1, 2, 3, 0, 1, 2, 3])),
        ),
        ("1 x 30 s", dict(batch=batch([30 * seconds], [2]))),
        (
            "4 utterances, zero-shot inventory, map_allophones",
            dict(
                batch=batch([3 * seconds, 5 * seconds, 4 * seconds, 2 * seconds], [0, 1, 2, 3]),
                target_feature_indices=flagship_zero_shot_table(),
                map_allophones=True,
            ),
        ),
    ]


def check_grid(grid, lengths, heads, widths):
    frames = lengths.clamp_min(0).cpu()
    grid = grid.cpu().to(torch.int32)
    check(grid.shape[:2] == (len(heads), len(frames)), f"grid shape {tuple(grid.shape)}")
    counts = grid[:, :, 0]
    check(bool((counts <= frames[None]).all()), "a token count exceeds its row's frames")
    columns = torch.arange(grid.shape[2] - 1)[None, None]
    in_count = columns < counts[:, :, None]
    for index, name in enumerate(heads):
        tokens = grid[index, :, 1:]
        check(bool((tokens[in_count[index]] < widths[name]).all()), f"head {name}: token >= its {widths[name]} classes")
        check(bool((tokens[~in_count[index]] == 0).all()), f"head {name}: non-zero past the count")


def build_serving_flagship():
    from allophant_tpu_torch.demo import build_flagship

    start = time.perf_counter()
    estimator = build_flagship(seed=0, precision="mixed", device="cuda")
    torch.cuda.synchronize()
    layers = estimator.model.architecture.num_hidden_layers
    print(f"serve: flagship built in {time.perf_counter() - start:.2f} s ({layers} layers, mixed)", flush=True)
    return estimator


def request_log_probs(estimator, name, request):
    """(batch, keyword arguments, predictions, heads, class count of each
    decoded head) of one serving request; ``predict`` doubles as its warm-up."""
    from allophant_tpu_torch.models.projection import PHONEME_LAYER

    batch = request["batch"]
    kwargs = {key: value for key, value in request.items() if key != "batch"}
    predictions = estimator.predict(batch, kwargs.get("target_feature_indices"), time_major=False)
    heads = tuple(sorted(predictions.outputs))
    widths = {head: value.shape[-1] for head, value in predictions.outputs.items()}
    if kwargs.get("map_allophones"):
        widths[PHONEME_LAYER] = estimator.model.plan.allophone_shape[2]
    finite = all(bool(torch.isfinite(value).all().item()) for value in predictions.outputs.values())
    check(finite, f"request {name!r}: non-finite log-probs")
    return batch, kwargs, predictions, heads, widths


def phase_serve(estimator, results: dict) -> None:
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    layers = estimator.model.architecture.num_hidden_layers
    for name, request in serving_requests():
        batch, kwargs, predictions, heads, widths = request_log_probs(estimator, name, request)
        # Warm-up done by predict above; the launch window covers exactly one
        # predict_decoded call.
        torch.cuda.synchronize()
        oneshot_attention.launches = 0
        fused_frame_conv.launches = 0
        request_start = time.perf_counter()
        grid, lengths = estimator.predict_decoded(batch, heads=heads, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - request_start
        launches = {"oneshot_attention": oneshot_attention.launches, "frame_encoder": fused_frame_conv.launches}
        for kernel, count in launches.items():
            results[kernel] += count
        check(launches == {"oneshot_attention": layers, "frame_encoder": 1}, f"request {name!r}: launches {launches}")
        check_grid(grid, lengths, heads, widths)
        audio_seconds = float(np.sum(batch.lengths)) / SAMPLE_RATE
        print(
            f"serve request {name!r}: grid {tuple(grid.shape)} {grid.dtype}, frames {lengths.tolist()},"
            f" launches {launches}, {seconds * 1e3:.1f} ms, {audio_seconds / seconds:.1f} audio-s/s, log-probs finite",
            flush=True,
        )
    # Throughput of the first request's shape, steady state, for information.
    batch = serving_requests()[0][1]["batch"]
    torch.cuda.synchronize()
    repeats = 5
    start = time.perf_counter()
    for _ in range(repeats):
        grid, _ = estimator.predict_decoded(batch, heads=heads)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / repeats
    audio_seconds = float(np.sum(batch.lengths)) / SAMPLE_RATE
    print(
        f"serve throughput: 8 x 2-10 s request, {repeats} repeats: {seconds * 1e3:.1f} ms per request,"
        f" {audio_seconds / seconds:.1f} audio-s/s",
        flush=True,
    )


def check_beam_grid(collected, scores, lengths, heads, widths, beams):
    """int16 [H, T, B, K] tokens within each head's classes, never the blank,
    -1 past each row's frames; every row's best beam live; scores finite."""
    frames = lengths.clamp_min(0).cpu()
    collected = collected.cpu().to(torch.int32)
    scores = scores.cpu()
    check(
        collected.shape[0] == len(heads) and collected.shape[2:] == (len(frames), beams),
        f"collected shape {tuple(collected.shape)}",
    )
    check(scores.shape == (len(heads), len(frames), beams), f"scores shape {tuple(scores.shape)}")
    past = torch.arange(collected.shape[1])[:, None] >= frames[None, :]  # [T, B]
    for index, name in enumerate(heads):
        tokens = collected[index]
        check(bool((tokens[past] == -1).all()), f"head {name}: a token past its row's frames")
        check(bool(((tokens >= -1) & (tokens < widths[name]) & (tokens != 0)).all()), f"head {name}: a token outside 1..{widths[name] - 1}")
    check(bool(torch.isfinite(scores).all()), "non-finite beam scores")
    check(bool((scores.amax(dim=-1) > -5e29).all()), "a row without a live beam")


def phase_serve_beam(estimator, results: dict) -> None:
    """The three requests through predict_beam_decoded over all 38 heads at
    beam width 4, with every launch counter read around each call; then the
    first request's log-probs from the card searched by the plain versions
    on the CPU, whose grid must equal the kernels'."""
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda
    from allophant_tpu_torch.ops.decode import beam_search_heads
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    layers = estimator.model.architecture.num_hidden_layers
    beams = 4
    first = None
    for name, request in serving_requests():
        batch, kwargs, predictions, heads, widths = request_log_probs(estimator, name, request)
        searches = len({widths[head] for head in heads})  # one launch per distinct class count
        torch.cuda.synchronize()
        for counter in (oneshot_attention, fused_frame_conv, beam_search_cuda, backtrace_cuda):
            counter.launches = 0
        request_start = time.perf_counter()
        collected, scores, lengths = estimator.predict_beam_decoded(batch, heads=heads, beam_width=beams, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - request_start
        launches = {
            "oneshot_attention": oneshot_attention.launches,
            "frame_encoder": fused_frame_conv.launches,
            "beam_search": beam_search_cuda.launches,
            "beam_backtrace": backtrace_cuda.launches,
        }
        for kernel, count in launches.items():
            results[kernel] += count
        expected = {"oneshot_attention": layers, "frame_encoder": 1, "beam_search": searches, "beam_backtrace": searches}
        check(launches == expected, f"beam request {name!r}: launches {launches}, expected {expected}")
        check_beam_grid(collected, scores, lengths, heads, widths, beams)
        audio_seconds = float(np.sum(batch.lengths)) / SAMPLE_RATE
        print(
            f"serve beam request {name!r}: collected {tuple(collected.shape)} {collected.dtype}, scores"
            f" {tuple(scores.shape)}, launches {launches}, {seconds * 1e3:.1f} ms, {audio_seconds / seconds:.1f} audio-s/s",
            flush=True,
        )
        if first is None:
            first = (batch, heads, predictions, collected, scores)

    batch, heads, predictions, collected, scores = first
    cpu_collected, cpu_scores = beam_search_heads(
        [predictions.outputs[head].cpu() for head in heads], predictions.lengths.cpu(), beams
    )
    mismatched = int((cpu_collected != collected.cpu()).sum().item())
    live = cpu_scores > -5e29
    score_error = (cpu_scores[live] - scores.cpu()[live]).abs().max().item()
    print(
        f"serve beam: the card's log-probs of the first request searched on the CPU: collected {tuple(cpu_collected.shape)}"
        f" cells differing {mismatched}, live-score max_abs_err {score_error:.3e}",
        flush=True,
    )
    check(mismatched == 0, "the CPU search of the card's log-probs disagrees with the kernels")

    torch.cuda.synchronize()
    repeats = 5
    start = time.perf_counter()
    for _ in range(repeats):
        estimator.predict_beam_decoded(batch, heads=heads, beam_width=beams)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / repeats
    audio_seconds = float(np.sum(batch.lengths)) / SAMPLE_RATE
    print(
        f"serve beam throughput: 8 x 2-10 s request, {repeats} repeats: {seconds * 1e3:.1f} ms per request,"
        f" {audio_seconds / seconds:.1f} audio-s/s",
        flush=True,
    )


WIDE_BEAMS = (17, 32, 64, 100)


def phase_wide_encoder(results: dict) -> None:
    """The flagship head on a 2-layer encoder of XLS-R 1B's width (1280, 16
    heads of 80), "mixed": one greedy request through predict_decoded, then
    the same request through predict_beam_decoded over all heads at each of
    WIDE_BEAMS, launch counters read around each call; each beam grid must
    equal the CPU search (the plain versions) of the card's log-probs."""
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.demo import build_flagship
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda
    from allophant_tpu_torch.ops.decode import beam_search_heads
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    architecture = dataclasses.replace(
        Wav2Vec2Architecture(), hidden_size=1280, num_attention_heads=16, intermediate_size=5120, num_hidden_layers=2
    )
    estimator = build_flagship(seed=2, architecture=architecture, precision="mixed", device="cuda")
    rng = np.random.default_rng(5)
    lengths = np.array([2 * SAMPLE_RATE, 19_000], dtype=np.int32)
    audio = (0.1 * rng.standard_normal((2, int(lengths.max())))).astype(np.float32)
    batch = Batch(audio, lengths, np.array([0, 2]))
    predictions = estimator.predict(batch, time_major=False)
    heads = tuple(sorted(predictions.outputs))
    widths = {head: value.shape[-1] for head, value in predictions.outputs.items()}
    layers = architecture.num_hidden_layers
    counters = {
        "oneshot_attention": oneshot_attention,
        "frame_encoder": fused_frame_conv,
        "beam_search": beam_search_cuda,
        "beam_backtrace": backtrace_cuda,
    }

    def run(call):
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.launches = 0
        start = time.perf_counter()
        result = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = {name: counter.launches for name, counter in counters.items()}
        for name, count in launches.items():
            results[name] += count
        return result, launches, seconds

    (grid, frames), launches, seconds = run(lambda: estimator.predict_decoded(batch, heads=heads))
    expected = {"oneshot_attention": layers, "frame_encoder": 1, "beam_search": 0, "beam_backtrace": 0}
    check(launches == expected, f"80-wide heads greedy request: launches {launches}, expected {expected}")
    check_grid(grid, frames, heads, widths)
    print(
        f"serve 80-wide heads (hidden 1280, 16 heads, {layers} layers): greedy grid {tuple(grid.shape)}, frames"
        f" {frames.tolist()}, launches {launches}, {seconds * 1e3:.1f} ms",
        flush=True,
    )
    searches = len(set(widths.values()))
    # What predict_beam_decoded searches: f32 log_softmax of each head, on the card.
    cpu_log_probs = [torch.log_softmax(predictions.outputs[head].float(), dim=-1).cpu() for head in heads]
    for beams in WIDE_BEAMS:
        (collected, scores, frames), launches, seconds = run(
            lambda: estimator.predict_beam_decoded(batch, heads=heads, beam_width=beams)
        )
        expected = {"oneshot_attention": layers, "frame_encoder": 1, "beam_search": searches, "beam_backtrace": searches}
        check(launches == expected, f"80-wide heads beam request K={beams}: launches {launches}, expected {expected}")
        check_beam_grid(collected, scores, frames, heads, widths, beams)
        cpu_collected, cpu_scores = beam_search_heads(cpu_log_probs, predictions.lengths.cpu(), beams)
        mismatched = int((cpu_collected != collected.cpu()).sum().item())
        live = cpu_scores > -5e29
        score_error = (cpu_scores[live] - scores.cpu()[live]).abs().max().item()
        routes = sorted({beam_route(width, beams) for width in widths.values()})
        print(
            f"serve 80-wide heads beam width {beams} ({', '.join(routes)}): collected {tuple(collected.shape)}, launches"
            f" {launches}, {seconds * 1e3:.1f} ms; the CPU search of the card's log-probs: cells differing {mismatched},"
            f" live-score max_abs_err {score_error:.3e}",
            flush=True,
        )
        check(mismatched == 0, f"beam width {beams}: the CPU search of the card's log-probs disagrees with the kernels")


def phase_float32() -> None:
    """One 2 s request in "float32" on the card and on the CPU (plain twins),
    with the same weights."""
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.demo import build_flagship
    from allophant_tpu_torch.models.allophant import AllophantModel
    from allophant_tpu_torch.training.estimator import Estimator

    gpu = build_flagship(seed=1, precision="float32", device="cuda")
    model = gpu.model
    cpu_model = AllophantModel(model.architecture, model.plan, torch.float32, None, device="cpu")
    cpu_model.load_state_dict({key: value.cpu() for key, value in model.state_dict().items()})
    cpu = Estimator(cpu_model, "float32", device="cpu")
    rng = np.random.default_rng(3)
    batch = Batch(rng.standard_normal((1, 2 * SAMPLE_RATE)).astype(np.float32) * 0.1, [2 * SAMPLE_RATE], [1])
    on_card = gpu.predict(batch, time_major=False)
    on_cpu = cpu.predict(batch, time_major=False)
    heads = tuple(sorted(on_card.outputs))
    error = max((on_card.outputs[name].cpu() - on_cpu.outputs[name]).abs().max().item() for name in heads)
    grid_card = gpu.predict_decoded(batch, heads=heads)[0].cpu().to(torch.int32)
    grid_cpu = cpu.predict_decoded(batch, heads=heads)[0].to(torch.int32)
    mismatched = int((grid_card != grid_cpu).sum().item())
    # Tolerance: 24 layers of f32 on two devices with different summation
    # orders. The grids must be equal: the seeded inputs hold no argmax tie
    # within that error.
    tolerance = 1e-3
    print(
        f"float32 card vs cpu, 2 s: log-prob max_abs_err {error:.3e} (tolerance {tolerance:.0e}),"
        f" grid {tuple(grid_card.shape)} cells differing {mismatched} over {len(heads)} heads",
        flush=True,
    )
    check(error <= tolerance and mismatched == 0, "float32 card and CPU disagree")
    beam_card = gpu.predict_beam_decoded(batch, heads=heads, beam_width=4)[0].cpu()
    beam_cpu = cpu.predict_beam_decoded(batch, heads=heads, beam_width=4)[0]
    beam_mismatched = int((beam_card != beam_cpu).sum().item())
    print(
        f"float32 card vs cpu, 2 s, beam width 4: collected {tuple(beam_card.shape)} cells differing {beam_mismatched}",
        flush=True,
    )
    check(beam_mismatched == 0, "float32 beam grids on the card and the CPU disagree")


TRAIN_ACCUMULATION, TRAIN_SECONDS, TRAIN_LABELS, TRAIN_STEPS = 2, 10, 30, 3
# Per-leaf gradient limit of the float32 card-vs-CPU step, as in the CPU
# parity test (tests/test_torch_train_step.py): the allophone layer's max
# can route a nearly tied phoneme's gradient to another allophone under
# other f32 rounding, and the 37 heads' contributions cancel in the
# encoder's gradients; a leaf that is zero in exact arithmetic is held to
# 1e-6 of the largest of all.
GRAD_SHARE, ZERO_FLOOR = 1e-3, 1e-6


def training_microbatches(model, accumulation: int, batch: int, samples: int, device, seed: int = 0) -> dict:
    """[A, B, ...] tensors on ``device``: seeded audio of full length, the four
    languages in turn, TRAIN_LABELS labels per head, the phoneme head's drawn
    from each row's language inventory (the phonemes the allophone gather
    table maps; outside it a label is a hard-masked class)."""
    rng = np.random.default_rng(seed)
    gather = model.projection.allophone.gather_indices.cpu().numpy()  # [L, P, K]
    pools = [np.flatnonzero((gather[language, 1:] >= 0).any(axis=-1)) + 1 for language in range(gather.shape[0])]
    language_ids = np.tile(np.arange(batch) % len(pools), (accumulation, 1))
    arrays = {
        "audio": (0.1 * rng.standard_normal((accumulation, batch, samples))).astype(np.float32),
        "lengths": np.full((accumulation, batch), samples),
        "language_ids": language_ids,
    }
    for node in model.plan.nodes:
        if node.has_allophone:
            labels = np.stack([np.stack([rng.choice(pools[language], TRAIN_LABELS) for language in row]) for row in language_ids])
        else:
            labels = rng.integers(1, node.output_size, (accumulation, batch, TRAIN_LABELS))
        arrays[f"labels_{node.name}"] = labels
        arrays[f"label_lengths_{node.name}"] = np.full((accumulation, batch), TRAIN_LABELS)
    return {key: torch.from_numpy(np.asarray(value)).to(device) for key, value in arrays.items()}


class TwinsForbidden:
    """Within the block, any plain twin of a kernel on the path raises, so a
    run shows that no twin ran on the card."""

    def __enter__(self):
        import allophant_tpu_torch.ops.frame_encoder as frame_encoder
        import allophant_tpu_torch.ops.oneshot_attention as attention

        names = ("reference_oneshot", "reference_oneshot_dropout", "reference_oneshot_backward", "reference_dropout_mask_bits")
        self.saved = [(attention, name, getattr(attention, name)) for name in names]
        self.saved.append((frame_encoder, "reference_frame_conv", frame_encoder.reference_frame_conv))
        for module, name, _ in self.saved:
            setattr(module, name, self.forbidden(name))
        return self

    @staticmethod
    def forbidden(name):
        def raise_on_call(*_args, **_kwargs):
            raise SmokeFailure(f"the plain twin {name} ran on the card's path")

        return raise_on_call

    def __exit__(self, *_exc):
        for module, name, function in self.saved:
            setattr(module, name, function)
        return False


def kernel_counters() -> dict:
    """Launch-counted wrappers by their JSON names."""
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import (
        dropout_mask_bits,
        oneshot_attention,
        oneshot_attention_backward,
        oneshot_dropout_attention,
    )

    return {
        "oneshot_attention": oneshot_attention,
        "attention_dropout": oneshot_dropout_attention,
        "attention_backward": oneshot_attention_backward,
        "dropout_mask": dropout_mask_bits,
        "frame_encoder": fused_frame_conv,
    }


def counted(run):
    """(run's result, launches of each counted kernel during it)."""
    counters = kernel_counters()
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    result = run()
    torch.cuda.synchronize()
    return result, {name: counter.launches for name, counter in counters.items()}


def phase_train(results: dict) -> None:
    """The full-width training flagship ("mixed": bf16 encoder, f32 head, f32
    master weights) takes TRAIN_STEPS steps through make_train_step at A = 2,
    B = 8, 10 s, with the flagship's dropout (seeds from its config), Adam,
    schedule, clipping and frozen feature extractor; launch counters read
    around each step, the plain twins forbidden. Then one make_eval_step call
    on the first microbatch."""
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.training.train_step import (
        build_freeze_plan,
        build_loss_plan,
        create_optimizer,
        make_eval_step,
        make_train_step,
    )

    start = time.perf_counter()
    config, model = build_flagship_for_training(seed=0, precision="mixed", device="cuda")
    optimizer = create_optimizer(config, model.architecture.hidden_size, model.parameters())
    loss_plan = build_loss_plan(config, model.plan.allophone_shape is not None)
    step = make_train_step(model, optimizer, loss_plan, build_freeze_plan(config.acoustic_model))
    samples = TRAIN_SECONDS * SAMPLE_RATE
    microbatches = training_microbatches(model, TRAIN_ACCUMULATION, TRAIN_BATCH, samples, "cuda")
    rng = DropoutRng.from_seed(config.seed, "cuda")
    layers = model.architecture.num_hidden_layers
    before = {name: parameter.detach().clone() for name, parameter in model.named_parameters()}
    torch.cuda.synchronize()
    print(
        f"train: flagship built in {time.perf_counter() - start:.2f} s ({layers} layers, mixed, f32 parameters,"
        f" frozen prefix {model.acoustic_model.frozen_prefix}, dropout {model.architecture.attention_dropout}/"
        f"{model.architecture.hidden_dropout}/{model.architecture.activation_dropout}, taps {model.plan.acoustic_model_dropout})",
        flush=True,
    )
    expected = {
        "oneshot_attention": 0,
        "attention_dropout": TRAIN_ACCUMULATION * layers,
        "attention_backward": TRAIN_ACCUMULATION * layers,
        "dropout_mask": 0,
        "frame_encoder": TRAIN_ACCUMULATION,
    }
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    with TwinsForbidden():
        for index in range(TRAIN_STEPS):
            step_start = time.perf_counter()
            metrics, launches = counted(lambda: step(microbatches, rng))
            seconds.append(time.perf_counter() - step_start)
            for name, count in launches.items():
                results[name] += count
            check(launches == expected, f"train step {index}: launches {launches}, expected {expected}")
            finite = all(np.isfinite(metrics[key]) for key in ("loss_sum", "mean_loss", "grad_norm"))
            check(finite, f"train step {index}: non-finite metrics {metrics}")
            print(
                f"train step {index}: mean_loss {metrics['mean_loss']:.6f}, grad_norm {metrics['grad_norm']:.6f},"
                f" label_count {metrics['label_count']:.0f}, launches {launches}, {seconds[-1] * 1e3:.1f} ms",
                flush=True,
            )
    peak = torch.cuda.max_memory_allocated()
    groups = ("acoustic_model.feature_extractor", "acoustic_model.feature_projection", "acoustic_model.encoder", "projection")
    moved = {
        group: sum(not torch.equal(before[name], parameter) for name, parameter in model.named_parameters() if name.startswith(group))
        for group in groups
    }
    sizes = {group: sum(name.startswith(group) for name in before) for group in groups}
    print(f"train: parameters moved per group {moved} of {sizes}", flush=True)
    check(moved[groups[0]] == 0, "the frozen feature extractor moved")
    check(all(moved[group] > 0 for group in groups[1:]), "a trainable group did not move")
    steady = float(np.mean(seconds[1:]))
    audio_seconds = TRAIN_ACCUMULATION * TRAIN_BATCH * TRAIN_SECONDS
    print(
        f"train throughput: A={TRAIN_ACCUMULATION} B={TRAIN_BATCH} {TRAIN_SECONDS} s, steps 2-{TRAIN_STEPS}:"
        f" {steady * 1e3:.1f} ms per step, {audio_seconds / steady:.1f} audio-s/s,"
        f" peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)",
        flush=True,
    )
    eval_step = make_eval_step(model, loss_plan)
    with TwinsForbidden():
        eval_metrics, launches = counted(lambda: eval_step({key: value[0] for key, value in microbatches.items()}))
    for name, count in launches.items():
        results[name] += count
    expected = {"oneshot_attention": layers, "attention_dropout": 0, "attention_backward": 0, "dropout_mask": 0, "frame_encoder": 1}
    check(launches == expected, f"eval step: launches {launches}, expected {expected}")
    check(np.isfinite(eval_metrics["loss_sum"]), "eval step: non-finite loss")
    print(f"eval step: loss_sum {eval_metrics['loss_sum']:.3f}, label_count {eval_metrics['label_count']:.0f}, launches {launches}", flush=True)


def phase_train_float32() -> None:
    """One deterministic step (every dropout off) of a full-width, 4-layer
    training flagship in "float32" on the card and on the CPU (plain twins)
    from the same weights and microbatches: metrics, gradients and the
    updated parameters compared."""
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.models.allophant import AllophantModel
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.training.train_step import build_freeze_plan, build_loss_plan, create_optimizer, make_train_step

    architecture = dataclasses.replace(Wav2Vec2Architecture(), num_hidden_layers=4)
    config, card_model = build_flagship_for_training(seed=1, architecture=architecture, precision="float32", device="cuda")
    cpu_model = AllophantModel(
        card_model.architecture, card_model.plan, torch.float32, None, "cpu", param_dtype=torch.float32,
        frozen_prefix=card_model.acoustic_model.frozen_prefix,
    )
    cpu_model.load_state_dict({key: value.cpu() for key, value in card_model.state_dict().items()})
    before = {name: parameter.detach().cpu().clone() for name, parameter in cpu_model.named_parameters()}
    results = {}
    for label, model, device in (("card", card_model, "cuda"), ("cpu", cpu_model, "cpu")):
        optimizer = create_optimizer(config, architecture.hidden_size, model.parameters())
        loss_plan = build_loss_plan(config, True)
        step = make_train_step(model, optimizer, loss_plan, build_freeze_plan(config.acoustic_model))
        microbatches = training_microbatches(model, 2, 2, 2 * SAMPLE_RATE, device, seed=4)
        metrics = step(microbatches, None)
        parameters = {name: parameter.detach().cpu() for name, parameter in model.named_parameters()}
        gradients = {name: parameter.grad.detach().cpu() for name, parameter in model.named_parameters()}
        results[label] = (metrics, parameters, gradients)
    (card, card_parameters, card_grads), (cpu, cpu_parameters, cpu_grads) = results["card"], results["cpu"]
    relative = {key: abs(card[key] - cpu[key]) / abs(cpu[key]) for key in ("mean_loss", "grad_norm")}
    floor = ZERO_FLOOR * max(value.abs().max().item() for value in cpu_grads.values())
    grad_share = max(
        (card_grads[name] - value).abs().max().item() / max(value.abs().max().item(), floor / GRAD_SHARE)
        for name, value in cpu_grads.items()
    )
    # Adam's first update is lr * g / (|g| + 1e-8): each parameter is held to
    # two f32 spacings of the largest value it can round to (twice itself, or
    # of the learning rate near 0) and eight of the learning rate, plus the
    # gradient limit carried through the update (2 lr where the gradient's
    # sign is within its limit).
    learning_rate = float(config.lr_schedule.schedule(architecture.hidden_size)(0))
    parameter_share = 0.0
    for name, value in cpu_parameters.items():
        grad = cpu_grads[name].abs()
        grad_error = max(GRAD_SHARE * grad.max().item(), floor)
        carried = torch.where(grad > 2 * grad_error, learning_rate * 1e-8 * grad_error / (grad - grad_error + 1e-8) ** 2, 2 * learning_rate)
        spacing = torch.from_numpy(np.spacing(2 * np.maximum(before[name].abs().numpy(), np.float32(learning_rate))))
        limit = 2 * spacing + 8 * float(np.spacing(np.float32(learning_rate))) + carried
        parameter_share = max(parameter_share, ((card_parameters[name] - value).abs() / limit).max().item())
    print(
        f"train float32 card vs cpu (4 layers, A=2 B=2 2 s): mean_loss {card['mean_loss']:.6f} vs {cpu['mean_loss']:.6f},"
        f" grad_norm {card['grad_norm']:.6f} vs {cpu['grad_norm']:.6f}, relative differences {relative} (tolerance 1e-4);"
        f" worst gradient difference {grad_share:.3e} of its leaf's largest (tolerance {GRAD_SHARE:.0e});"
        f" worst share of the parameter limit {parameter_share:.3f}",
        flush=True,
    )
    check(all(value <= 1e-4 for value in relative.values()), "float32 train step: card and CPU metrics disagree")
    check(grad_share <= GRAD_SHARE and parameter_share <= 1.0, "float32 train step: card and CPU gradients or parameters disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "allophant_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: allophant_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from allophant_tpu_torch.device import set_float32_precision

    overall = time.perf_counter()
    phase_card()
    phase_build()
    phase_tensor_cores()
    phase_frame_encoder_sass()
    set_float32_precision("highest")
    launches = dict.fromkeys(
        ("oneshot_attention", "frame_encoder", "beam_search", "beam_backtrace", "attention_backward", "attention_dropout", "dropout_mask"),
        0,
    )

    # The first serving request's frames set the attention kernel's serving
    # shape: 10 s buckets to 163840 samples, 511 frames.
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.training.estimator import _bucket_length

    first_batch = serving_requests()[0][1]["batch"]
    samples = _bucket_length(first_batch.audio_features.shape[1])
    architecture = Wav2Vec2Architecture()
    serve_time = int(architecture.downsampled_lengths(samples))
    serve_lengths = [int(architecture.downsampled_lengths(int(length))) for length in first_batch.lengths]

    entries = [
        phase_attention(serve_lengths, serve_time),
        phase_frame_encoder(len(first_batch), samples),
        *phase_beam_kernels(serve_lengths, serve_time),
    ]
    dropout_forward, backward = phase_dropout_attention()
    entries += [backward, dropout_forward, phase_dropout_mask()]
    phase_head_widths()
    estimator = build_serving_flagship()
    phase_serve(estimator, launches)
    phase_serve_beam(estimator, launches)
    del estimator
    torch.cuda.empty_cache()
    phase_wide_encoder(launches)
    torch.cuda.empty_cache()
    phase_float32()
    phase_train(launches)
    torch.cuda.empty_cache()
    phase_train_float32()
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    print(f"total: {time.perf_counter() - overall:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
