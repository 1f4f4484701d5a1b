#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (allophant_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. kernels: each kernel against its plain PyTorch twin on the card, in bf16
     and f32, at the serving shapes and beyond (one-shot attention at
     T = 511, 512, 1536 and 6400 frames with a zero-length and a ragged row),
     with kernel, twin and library times and the roofline bound;
  4. serve: the full-width flagship (XLS-R 300M + hierarchical head, seeded
     random weights) under the default "mixed" preset answers three requests
     through Estimator.predict_decoded, with the kernel launch counters read
     around each request;
  5. float32: one 2 s request in "float32" on the card and on the CPU (twins).
Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without that line when no CUDA
device is present or the port's package is not beside this script."""

from __future__ import annotations

import json
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
    """K2 against its twin in bf16 and f32 at the 10 s serving bucket and at the
    smallest bucket (1024 samples, whose 1024 % 5 tail the kernel drops);
    returns the kernel's JSON entry (serving bucket, bf16: the "mixed" dtype)."""
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv, reference_frame_conv

    entry = None
    # f32: exact erff in both, differing only in summation order (1e-4); bf16:
    # one rounding of O(4) values (2e-2).
    cases = [
        (batch, samples, dtype, tolerance)
        for batch, samples in ((serve_batch, serve_samples), (2, 1024))
        for dtype, tolerance in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
    ]
    for batch, samples, dtype, tolerance in cases:
        inputs = frame_encoder_inputs(batch, samples)
        got = fused_frame_conv(*inputs, eps=1e-5, out_dtype=dtype)
        expected = reference_frame_conv(*inputs, 1e-5, dtype)
        torch.cuda.synchronize()
        error = (got.float() - expected.float()).abs().max().item()
        dtype_name = str(dtype).removeprefix("torch.")
        print(
            f"kernel frame_encoder {dtype_name} B={batch} S={samples} C=512 -> {got.shape[1]} frames:"
            f" max_abs_err {error:.3e} (tolerance {tolerance:.0e})",
            flush=True,
        )
        check(got.shape == expected.shape and error <= tolerance, f"frame_encoder {dtype_name} disagrees: {error}")
        if entry is None:
            frames, channels = got.shape[1], got.shape[2]
            kernel_ms = cuda_ms(lambda: fused_frame_conv(*inputs, eps=1e-5, out_dtype=dtype), 20)
            plain_ms = cuda_ms(lambda: reference_frame_conv(*inputs, 1e-5, dtype), 5)
            bytes_moved = batch * samples * 4 + 13 * channels * 4 + batch * frames * channels * got.element_size()
            # The conv's multiply-adds alone (10 per output element, f32).
            operations = 2 * 10 * batch * frames * channels
            bound, bound_by = bound_ms(bytes_moved, operations, "float32")
            print(
                f"time frame_encoder {dtype_name} B={batch} S={samples}: kernel {kernel_ms:.4f} ms,"
                f" twin {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})",
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
    # ragged row.
    cases = (
        [(serve_time, list(serve_lengths), "serve")]
        + [(t, [0, t - 123] + [t] * (batch - 2), "ragged") for t in (512, 1536, 6400)]
        # The smallest bucket (1024 samples) gives 2 frames; 37 is one ragged tile.
        + [(2, [0, 1] + [2] * (batch - 2), "short"), (37, [0, 5] + [37] * (batch - 2), "short")]
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
            expected = twin_by_rows(reference_oneshot, q, k, v, bias, scale, heads)
            torch.cuda.synchronize()
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
                f" ({rtol:.2e} * |twin| + {scale_tolerance:.0e} * twin rms), finite {finite}",
                flush=True,
            )
            check(
                finite and rms_ratio <= rms_tolerance and worst <= 1.0,
                f"oneshot_attention {dtype_name} T={time_steps} disagrees: rms ratio {rms_ratio}, share {worst}",
            )
            if label == "serve" and dtype == torch.bfloat16:
                kernel_ms = cuda_ms(lambda: oneshot_attention(q, k, v, bias, scale, heads), 20)
                plain_ms = cuda_ms(lambda: reference_oneshot(q, k, v, bias, scale, heads), 5)
                shape4 = (batch, time_steps, heads, head_dim)
                q4, k4, v4 = (tensor.view(shape4).transpose(1, 2) for tensor in (q, k, v))
                mask = bias.to(dtype)[:, None, None, :]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), 20)
                bytes_moved, operations = attention_work(batch, time_steps, heads, head_dim, lengths, 2)
                bound, bound_by = bound_ms(bytes_moved, operations, dtype_name)
                print(
                    f"time oneshot_attention {dtype_name} B={batch} T={time_steps}: kernel {kernel_ms:.4f} ms,"
                    f" twin {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms,"
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


def phase_serve(results: dict) -> None:
    from allophant_tpu_torch.demo import build_flagship
    from allophant_tpu_torch.models.projection import PHONEME_LAYER
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    start = time.perf_counter()
    estimator = build_flagship(seed=0, precision="mixed", device="cuda")
    torch.cuda.synchronize()
    layers = estimator.model.architecture.num_hidden_layers
    print(f"serve: flagship built in {time.perf_counter() - start:.2f} s ({layers} layers, mixed)", flush=True)
    allophone_phonemes = estimator.model.plan.allophone_shape[2]
    for name, request in serving_requests():
        batch = request["batch"]
        kwargs = {key: value for key, value in request.items() if key != "batch"}
        predictions = estimator.predict(batch, kwargs.get("target_feature_indices"), time_major=False)
        heads = tuple(sorted(predictions.outputs))
        widths = {head: value.shape[-1] for head, value in predictions.outputs.items()}
        if kwargs.get("map_allophones"):
            widths[PHONEME_LAYER] = allophone_phonemes
        finite = all(bool(torch.isfinite(value).all().item()) for value in predictions.outputs.values())
        check(finite, f"request {name!r}: non-finite log-probs")
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
            f" launches {launches}, {seconds * 1e3:.1f} ms, {audio_seconds / seconds:.1f} audio-s/s, finite {finite}",
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
    del estimator
    torch.cuda.empty_cache()


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
    set_float32_precision("highest")
    launches = {"oneshot_attention": 0, "frame_encoder": 0}

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
    ]
    phase_serve(launches)
    phase_float32()
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
