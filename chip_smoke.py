#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (allophant_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi-gpu   # the build and phase 18 alone
    python3 chip_smoke.py --w2v-bert    # the build, K7's kernel phase and w2v-BERT's serving phase

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
     K2 also at C = 100, 64, 1024, 1280, 2048 and 1, with its time per
     request and per training step (and at 1280 and 2048, the chunked
     kernel's);
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
     Head offsets: K5, K4 and K6 over heads 8-15 of 16 (total_heads 16,
     head_offset 8) bit-equal to those heads of the 16-head call, in bf16
     and f32, at the training shape and at heads of 192 (the chunked route);
     Relative-key attention (K7, w2v-BERT 2.0's 16 heads of 64, distances
     -64 .. 8) against its twin in bf16 at the serving shape (strided q/k/v),
     at T = 100 (both clamps), 2, 37, 512 (the tile edges) and 2048, with
     a zero-length and a ragged row, bit-equal over two calls and, with a
     zero table, equal to K1; kernel, twin and library times
     (scaled_dot_product_attention given the materialised [B, H, T, T] bias);
     Head widths: K1, K5 and K4 at 12, 20, 32, 80, 120, 128, 136, 192 and
     256 in bf16 and f32 against their twins (K5 and K4 bit-equal over two
     calls; 12 and 20 zero-padded to 16 and 24, above 128 the chunked
     route), and bf16 times at 16 heads of several widths; library
     times (scaled_dot_product_attention) with the backend pinned and named;
  4. serve: the full-width flagship (XLS-R 300M + hierarchical head, seeded
     random weights) under the default "mixed" preset answers three requests
     through Estimator.predict_decoded, with the kernel launch counters read
     around each request;
  5. serve beam: the same three requests through
     Estimator.predict_beam_decoded (all 38 heads, beam width 4), launch
     counters read around each; the first request's log-probs from the card
     are searched on the CPU, and the grids must be equal;
     w2v-BERT serve: the full-width w2v-BERT 2.0 flagship answers the same
     three requests, each shape's first call capturing its Conformer layers
     as a CUDA graph (the memory it reserved printed) and the second
     replaying it: each graph recording K7 24 times, a replay's encoder
     output bit-equal to the eager layer stack's, K7 24 times a request,
     twins forbidden, host and wall ms of the stack eager and replayed;
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
     on the card and on the CPU: metrics, gradients and parameters compared;
 10. train loop: the training loop from user inputs (the demo config, the
     demo phoneme table, a synthetic UCLA corpus written to disk) through
     Config, PhoneticAttributeIndexer, DatasetManager and
     Estimator.from_config on the card: 4 steps and one step-based
     validation with the twins forbidden, launches counted, then save, the
     checkpoint decoded and held to the master parameters bit for bit; the
     loop's time a step, its host share, validation time and peak memory;
 11. train loop float32: 2 steps of a 2-layer full-width flagship through the
     loop on the card and on the CPU, losses compared;
 12. predict: Estimator.restore of the loop phase's checkpoint on the card,
     held bit for bit to the saved f32 master parameters, then the port's CLI
     in this process on a synthetic UCLA corpus (4 languages x 16 WAVs of
     2-10 s): predict greedily with --language-phonemes and at -b 4 -n 2,
     twins forbidden and launches counted, every utterance a line and every
     head a candidate; evaluate -j of each file with the device scorer on the
     card and with --host-scorer, reports equal; the restore and evaluate
     seconds and the CLI's steady audio-s/s beside predict_decoded /
     predict_beam_decoded alone on the same batches;
 13. predict float32: a 2-layer full-width checkpoint through predict on the
     card and with --cpu, greedy and at -b 4 -n 2, JSONL lines equal;
 14. remat: the full-width training flagship with its encoder layers
     rematerialised, at A = 2, B = 8 and at A = 1, B = 24 (the reference
     recipe's microbatch), 10 s: step time, peak memory and launches (K5 and
     K4 once a layer and microbatch, as without remat), twins forbidden;
 15. remat float32: a 4-layer full-width step with dropout on, with and
     without remat from one DropoutRng seed: gradients within 1e-6 of each
     leaf's largest, generators in the same state after;
 16. transformer: the from-scratch transformer (d_model 512, 8 heads of 64,
     FFN 2048, 6 layers, 80 filterbanks) under the flagship's head: a
     greedy "mixed" request and a dropout training step, launches counted,
     twins forbidden; float32 greedy grids and a training step, card
     against CPU;
 17. train CLI: ``allophant_tpu_torch.cli.run train`` on a Common Voice
     corpus written with the port's codec (2 languages x 16 WAVs of 2-10 s,
     4 dev clips each), the full-width flagship, ``-d -s DIR -w 2``, in a
     child process (this script with --train-cli-child): SIGTERM after the
     first statistics line (exit 0, interrupted.ckpt with optimizer state),
     then --restore (picks interrupted.ckpt, resumes at the recorded batch,
     reaches the last epoch); launches counted in each child, twins
     forbidden; an MP3 round trip of one clip if the system libraries are
     there;
 18. multi-GPU: the CTC gradient at 500 and 1,000 frames against float64
     (no farther than JAX's float32 CTC), then two ranks, one process each
     (parallel/: NCCL over two cards, or gloo with both on card 0, said on
     its own line; the kernels built before they start): the full-width
     "mixed" flagship at dp = 2 (A = 2, 4 rows x 10 s a rank; K5 and K4 48
     times a step and K2 twice on each rank, twins forbidden; step ms,
     gradient all-reduce ms, peak GiB), a float32 4-layer step at dp = 2 and
     at tp = 2 held to this process's one-device step, a tp = 2 step with
     every dropout on held to the one-device step of the same seed (the
     ranks key K5/K4's masks by the global head and cut the FFN's mask from
     the whole), the same of the transformer (6 layers, d_model 512, an
     8-head attention classifier on its phoneme head, every dropout on),
     ``use_data_parallel`` float32 greedy and beam-4
     predictions of the serving requests held to one device on the same
     rows (their distance from one device on the whole batches must equal
     one device's on the same rows), and ``train`` over two ranks on the
     train CLI phase's corpus at 2 layers: SIGTERM to rank 1 alone, both
     stop after the same step, one ``interrupted.ckpt``, ``--restore`` to
     the last epoch; on two or more cards also a plain full-width
     ``train`` that spawns a rank a card, stopped by SIGTERM to it, and a
     plain 2-layer transformer ``train`` at dropout 0 to its end and
     ``--restore`` for one more epoch, its parameters held to the same two
     runs in one process;
 19. pretrained: the full-width XLS-R 300M written as the hub keeps it
     (``config.json`` and a ``Wav2Vec2ForPreTraining`` ``pytorch_model.bin``
     of seeded values, about 1.27 GB) into a temporary ``HF_HUB_CACHE``;
     ``Estimator.from_config`` on the card loads it (every encoder leaf
     bit-equal to the file's converted values; the load seconds), one
     "mixed" step at A = 2, B = 8, 10 s with the twins forbidden (K2 twice,
     K5 and K4 48 times), then the same with the cache emptied: the seeded
     weights and one log line;
 20. data CLI: the port's ``allophant-data`` ``save-lengths``,
     ``preprocess`` (80 filterbanks, ragged and ``--zarr``) and ``stats`` on
     the train CLI phase's corpus; ``train -f`` of the 6-layer transformer
     for an epoch (K5 and K4 a layer and microbatch, K1 in validation,
     twins forbidden); a float32 2-layer ``train -f`` against the same run
     on features computed on the fly (the store's features bit-equal to the
     feature function of every clip; the runs' parameter distances printed
     beside that run again, the card's run-to-run floor); the full-width flagship ``train -f`` from a
     raw-sample store for 2 steps (K2 once, K5 and K4 24 times a
     microbatch); each CLI's seconds;
 21. export: ``serving.export_transcriber`` of the full-width "mixed"
     flagship at 8 x 163,840 samples (the first serving request's batch in
     its live length bucket) for greedy and beam4, ``save_transcriber``, and
     the artifact loaded in a fresh process (this script with
     --serve-artifact-child) that imports no model, training or data module
     and runs the batch with the twins forbidden (K1 24 times, K2 once, K3
     once a beam call); greedy grids integer-equal to the live
     ``predict_decoded``, the beam n-best to ``predict_beam_decoded``;
     export, save and load seconds, artifact size, request wall time beside
     the live call's; K1 through its custom op against its launch called
     directly;
 22. orbax (run after phase 12, on its files): the full-width "mixed"
     flagship written by the port's ``save_orbax`` (OCDBT and zarr, about
     1.2 GiB), read back by ``load_checkpoint`` with every leaf bit-equal,
     and ``Estimator.restore`` of the directory on the card: greedy grids
     and beam-4 n-best of the three serving requests integer-equal to the
     in-memory estimator's (K1 24 times and K2 once a request, K3 once a
     class count of a beam request, twins forbidden); the committed
     fixture tests/data/orbax_mini/ (written by tensorstore: zstd, several
     chunks a kernel) decoded by the port's zstd decoder bit-equal to its
     .npz (MB/s printed), and tests/data/zstd_timing/'s frame of 32 MiB
     timed (MB/s on this host), the fixture restored on the card and one
     request through K1
     equal to the CPU's grid; ``predict`` with an Orbax copy of phase 12's
     checkpoint, its JSONL equal to phase 12's greedy output. Save and load
     seconds and sizes beside the card's name and power limit.
Each phase prints its seconds. Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without that line when no CUDA
device is present or the port's package is not beside this script."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
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
        # The chunked route's bf16 kernels (attention_wide.cuh, namespace wide).
        wide_bf16 = [
            text for text in re.split(r"\n\s*Function : ", sass)[1:]
            if "4wide" in text.splitlines()[0] and "bfloat16" in text.splitlines()[0]
        ]
        wide_hmma = sum(len(re.findall(r"\bHMMA\.", text)) for text in wide_bf16)
        print(
            f"tensor cores: lib{library}.so SASS holds {counts['HMMA']} HMMA and {counts['HGMMA']} HGMMA instructions,"
            f" {wide_hmma} HMMA in its {len(wide_bf16)} bf16 kernels of the chunked route",
            flush=True,
        )
        check(sum(counts.values()) > 0, f"lib{library}.so has no tensor-core instruction")
        check(len(wide_bf16) > 0 and wide_hmma > 0, f"lib{library}.so: the chunked route's bf16 kernels use no tensor core")


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
    shapes = [
        (serve_batch, serve_samples, 512), (2, 1024, 512), (2, 5 * 300 + 3, 100), (3, 2003, 64), (2, 4000, 1024),
        (2, 4000, 1280), (2, 4003, 2048), (2, 1500, 1),
    ]
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
        if channels > 1024:
            chunked_ms = median_ms(lambda: fused_frame_conv(*inputs, eps=1e-5, out_dtype=dtype), 10)
            moved = batch * samples * 4 + 13 * channels * 4 + got.numel() * got.element_size()
            chunked_bound, chunked_by = bound_ms(moved, 2 * 10 * got.numel(), "float32")
            print(
                f"time frame_encoder chunked {dtype_name} B={batch} S={samples} C={channels}: kernel {chunked_ms:.4f} ms,"
                f" bound {chunked_bound:.4f} ms ({chunked_by})",
                flush=True,
            )
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
    from allophant_tpu_torch.ops.oneshot_attention import launch_oneshot_attention, oneshot_attention, reference_oneshot

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
                # The kernel's launch, as the custom op's CUDA implementation
                # makes it; the op's own cost is the export phase's line.
                kernel_readings = [cuda_ms(lambda: launch_oneshot_attention(q, k, v, bias, scale, heads), 20) for _ in range(3)]
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


def relkey_work(time_steps, heads, head_dim, positions, lengths, item_bytes):
    """K7's bytes (K1's, and the table once) and operations (K1's, and each
    query's product with the table) over the keys each row needs."""
    bytes_moved, operations = attention_work(len(lengths), time_steps, heads, head_dim, lengths, item_bytes)
    queries = sum(int(length) if int(length) > 0 else time_steps for length in lengths.tolist())
    return bytes_moved + positions * head_dim * item_bytes, operations + 2 * positions * heads * head_dim * queries


def phase_relkey_attention(serve_lengths, serve_time) -> dict:
    """K7 (relative-key attention, w2v-BERT 2.0's 16 heads of 64, distances
    -64 .. 8) against its twin in bf16: at the serving shape (strided q/k/v of
    the fused projection), at T = 100 (both clamps inside one row) with a
    zero-length and a ragged row, at T = 2 and 37 (one ragged tile), at T =
    512 with rows ending on each side of the 64-key tile edges, and at 2048;
    each bit-equal over two calls. With a zero table it computes K1 (the
    relative term adds an exact 0 before K1's scale): held to K1 within the
    twin's per-element scale limit, and whether the two are bit-equal printed. Times at the
    serving shape: kernel, twin, and scaled_dot_product_attention given the
    relative term materialised as a [B, H, T, T] bf16 bias (not counted: the
    time to form it); returns the JSON entry."""
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention
    from allophant_tpu_torch.ops.relkey_attention import reference_relkey_attention, relative_distances, relkey_attention

    batch, heads, head_dim, left, right = 8, 16, 64, 64, 8
    scale = head_dim**-0.5
    generator = torch.Generator(device="cuda").manual_seed(73)
    table = (torch.randn(left + right + 1, head_dim, generator=generator, device="cuda") * head_dim**-0.5).to(torch.bfloat16)
    rms_tolerance, rtol, scale_tolerance = KERNEL_LIMITS[torch.bfloat16]
    cases = (
        [(serve_time, list(serve_lengths), "serve"), (100, [0, 77] + [100] * (batch - 2), "ragged")]
        + [(2, [0, 1] + [2] * (batch - 2), "short"), (37, [0, 5] + [37] * (batch - 2), "short")]
        + [(512, [0, 1, 63, 64, 65, 128, 512 - 123, 512], "tile-skip"), (2048, [2048, 1500] + [0] * 6, "long")]
    )
    entry = None
    for time_steps, row_lengths, label in cases:
        q, k, v, bias, lengths = attention_inputs(row_lengths, time_steps, heads, head_dim, torch.bfloat16, label == "serve")
        got = relkey_attention(q, k, v, bias, table, scale, heads, left, right)
        again = relkey_attention(q, k, v, bias, table, scale, heads, left, right)
        expected = torch.cat([
            reference_relkey_attention(q[i : i + 1], k[i : i + 1], v[i : i + 1], bias[i : i + 1], table, scale, heads, left, right)
            for i in range(batch)
        ])
        plain = relkey_attention(q, k, v, bias, torch.zeros_like(table), scale, heads, left, right)
        k1 = oneshot_attention(q, k, v, bias, scale, heads)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"relkey_attention T={time_steps}: two calls differ")
        from_k1 = (plain.float() - k1.float()).abs().max().item()
        check(from_k1 <= scale_tolerance * k1.float().square().mean().sqrt().item(), f"relkey_attention T={time_steps}: a zero table is not K1 ({from_k1})")
        valid = torch.arange(time_steps, device="cuda")[None] < lengths[:, None]
        difference = (got.float() - expected.float())[valid].abs()
        twin = expected.float()[valid]
        rms = twin.square().mean().sqrt().item()
        rms_ratio = difference.square().mean().sqrt().item() / rms
        worst = (difference / (rtol * twin.abs() + scale_tolerance * rms)).max().item()
        finite = bool(torch.isfinite(got).all().item())
        print(
            f"kernel relkey_attention bfloat16 B={batch} T={time_steps} H={heads} hd={head_dim} distances -{left}..{right}"
            f" {'strided' if label == 'serve' else 'contiguous'} lengths={lengths.tolist()}:"
            f" max_abs_err {difference.max().item():.3e}, twin rms {rms:.3e}, error rms / twin rms {rms_ratio:.3e}"
            f" (tolerance {rms_tolerance:.0e}), worst share of the per-element limit {worst:.3f}, finite {finite},"
            f" two calls bit-equal; with a zero table {'bit-equal to K1' if from_k1 == 0 else f'{from_k1:.3e} from K1'}",
            flush=True,
        )
        check(finite and rms_ratio <= rms_tolerance and worst <= 1.0, f"relkey_attention T={time_steps} disagrees: rms ratio {rms_ratio}, share {worst}")
        if label != "serve":
            continue
        kernel_readings = [cuda_ms(lambda: relkey_attention(q, k, v, bias, table, scale, heads, left, right), 20) for _ in range(3)]
        kernel_ms = float(np.median(kernel_readings))
        plain_ms = cuda_ms(lambda: reference_relkey_attention(q, k, v, bias, table, scale, heads, left, right), 5)
        shape4 = (batch, time_steps, heads, head_dim)
        q4, k4, v4 = (tensor.view(shape4).transpose(1, 2) for tensor in (q, k, v))
        distances = relative_distances(time_steps, left, right, "cuda")
        relative = torch.einsum("bhld,lrd->bhlr", q4.float(), table.float()[distances]) * scale
        mask = (relative + bias[:, None, None, :]).to(torch.bfloat16)
        library_ms, backend, library_readings = pinned_library_ms(
            lambda: lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), 20
        )
        bytes_moved, operations = relkey_work(time_steps, heads, head_dim, left + right + 1, lengths, 2)
        bound, bound_by = bound_ms(bytes_moved, operations, "bfloat16")
        print(
            f"time relkey_attention bfloat16 B={batch} T={time_steps}: kernel {kernel_ms:.4f} ms"
            f" (readings {readings_text(kernel_readings)}), twin {plain_ms:.4f} ms,"
            f" scaled_dot_product_attention [{backend}] with the [B, H, T, T] bias {library_ms:.4f} ms"
            f" (readings {readings_text(library_readings)}), bound {bound:.4f} ms ({bound_by})",
            flush=True,
        )
        entry = {
            "name": "relkey_attention",
            "route": "cuda",
            "source": "allophant_tpu_torch/csrc/relkey_attention.cu",
            "replaces": "none: w2v-BERT's relative-key attention (transformers Wav2Vec2BertSelfAttention)",
            "max_abs_err": difference.max().item(),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"q/k/v [{batch}, {time_steps}, {heads * head_dim}] bfloat16, table [{left + right + 1}, {head_dim}]",
        }
    return entry


def phase_w2v_bert_serve(results: dict) -> None:
    """The full-width w2v-BERT 2.0 flagship ("mixed", seeded weights) answers
    the serving requests: ``predict`` first, whose Conformer layers run
    eagerly and capture the request's shape as a CUDA graph (the device
    memory the capture reserved, and the call's ms, are printed), then
    greedily through Estimator.predict_decoded, which replays the graph.
    Each graph records K7 once a layer; the replayed request counts K7 24
    times and no K1 or K2, the twins forbidden; the replay's encoder output
    is bit-equal to the eager layer stack's (``encoder._run``) on the same
    inputs. Host (enqueue) and wall ms of the layer stack eager and
    replayed."""
    from allophant_tpu_torch.demo import build_flagship
    from allophant_tpu_torch.models.w2v_bert import Wav2Vec2BertArchitecture
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention
    from allophant_tpu_torch.ops.relkey_attention import relkey_attention

    estimator = build_flagship(seed=0, architecture=Wav2Vec2BertArchitecture(), precision="mixed", device="cuda")
    encoder = estimator.model.acoustic_model.encoder
    layers = len(encoder.layers)
    counters = {"relkey_attention": relkey_attention, "oneshot_attention": oneshot_attention, "frame_encoder": fused_frame_conv}
    seen = {}
    hook = encoder.register_forward_hook(lambda _module, args, output: seen.update(args=args, output=output))
    for name, request in serving_requests():
        torch.cuda.synchronize()
        graphs, kept = len(encoder._captured), encoder._graph_bytes
        start = time.perf_counter()
        batch, kwargs, _predictions, heads, widths = request_log_probs(estimator, name, request)
        capture_ms = (time.perf_counter() - start) * 1e3
        args = seen["args"]
        shape = (tuple(args[0].shape), args[0].dtype)
        check(shape in encoder._captured and len(encoder._captured) == graphs + 1, f"w2v-BERT {name!r}: predict captured no graph of {shape}")
        kept = encoder._graph_bytes - kept
        recorded = encoder._captured[shape].launches
        check(recorded == layers, f"w2v-BERT {name!r}: the graph recorded {recorded} K7 launches, not {layers}")
        before = {kernel: counter.launches for kernel, counter in counters.items()}
        with TwinsForbidden():
            grid, frames = estimator.predict_decoded(batch, heads=heads, **kwargs)
            grid = grid.cpu()
        launches = {kernel: counter.launches - before[kernel] for kernel, counter in counters.items()}
        check(launches == {"relkey_attention": layers, "oneshot_attention": 0, "frame_encoder": 0}, f"w2v-BERT {name!r} replayed: launches {launches}")
        results["relkey_attention"] += launches["relkey_attention"]
        check_grid(grid, frames, heads, widths)
        timings = {}
        with torch.inference_mode():
            replayed = seen["output"][-1]
            inputs = encoder.inputs(*args)
            check(torch.equal(encoder._run(*inputs)[-1], replayed), f"w2v-BERT {name!r}: a replay's encoder output differs from the eager one")
            for label, call in (("eager", lambda: encoder._run(*inputs)), ("replayed", lambda: encoder(*args))):
                torch.cuda.synchronize()
                start = time.perf_counter()
                call()
                enqueued = time.perf_counter()
                torch.cuda.synchronize()
                timings[label] = ((enqueued - start) * 1e3, (time.perf_counter() - start) * 1e3)
        print(
            f"w2v-BERT request {name!r}: encoder input {list(shape[0])}; the capturing predict {capture_ms:.1f} ms,"
            f" the graph reserved {kept / 2**20:.1f} MiB (all graphs {encoder._graph_bytes / 2**20:.1f} MiB,"
            f" allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB);"
            f" K7 {recorded} recorded, {layers} a replayed request, K1 and K2 0; replay bit-equal to eager;"
            " layer stack host / wall ms: " + ", ".join(f"{label} {host:.1f} / {wall:.1f}" for label, (host, wall) in timings.items()),
            flush=True,
        )
    hook.remove()
    del estimator
    torch.cuda.empty_cache()


def w2v_bert_serving_shape():
    """(frame lengths, padded frames) of the first serving request under
    w2v-BERT 2.0's front end: 10 s buckets to 163840 samples, 511 frames."""
    from allophant_tpu_torch.models.w2v_bert import Wav2Vec2BertArchitecture
    from allophant_tpu_torch.training.estimator import _bucket_length

    first_batch = serving_requests()[0][1]["batch"]
    architecture = Wav2Vec2BertArchitecture()
    serve_time = int(architecture.downsampled_lengths(_bucket_length(first_batch.audio_features.shape[1])))
    return [int(architecture.downsampled_lengths(int(length))) for length in first_batch.lengths], serve_time


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


# (heads, head width, first head of the call) of the head-offset checks: the
# training shape's second half, and a chunked-route width above 128.
HEAD_OFFSET_CASES = ((HEADS, HEAD_DIM, HEADS // 2), (4, 192, 2))


def phase_head_offset() -> None:
    """K5, K4 and K6 over a tensor-parallel rank's heads: a call over heads
    ``offset ..`` of the model's, given ``total_heads`` and ``head_offset``,
    is bit-equal to those heads of the call over all of them, in bf16 and
    f32, at the training shape and at a width of the chunked route."""
    from allophant_tpu_torch.ops.oneshot_attention import dropout_mask_bits, oneshot_attention_backward, oneshot_dropout_attention

    rate = 0.1
    for heads, head_dim, offset in HEAD_OFFSET_CASES:
        count = heads - offset
        scale = head_dim**-0.5
        full_bits = dropout_mask_bits(DROPOUT_SEEDS, TRAIN_BATCH, heads, TRAIN_TIME, "cuda")
        bits = dropout_mask_bits(DROPOUT_SEEDS, TRAIN_BATCH, count, TRAIN_TIME, "cuda", heads, offset)
        check(torch.equal(bits.view(torch.int32), full_bits[:, offset:].view(torch.int32)), "dropout_mask with a head offset differs")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias, _lengths = attention_inputs([TRAIN_TIME - 37] + [TRAIN_TIME] * (TRAIN_BATCH - 1), TRAIN_TIME, heads, head_dim, dtype, fused_qkv=True)
            grad = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(11), device="cuda").to(dtype)
            columns = slice(offset * head_dim, None)
            full_out = oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, heads, rate)
            out = oneshot_dropout_attention(q[..., columns], k[..., columns], v[..., columns], bias, DROPOUT_SEEDS, scale, count, rate, heads, offset)
            full_grads = oneshot_attention_backward(q, k, v, grad, bias, DROPOUT_SEEDS, scale, heads, rate)
            grads = oneshot_attention_backward(
                q[..., columns], k[..., columns], v[..., columns], grad[..., columns].contiguous(), bias, DROPOUT_SEEDS, scale,
                count, rate, heads, offset,
            )
            torch.cuda.synchronize()
            check(torch.equal(out, full_out[..., columns]), f"attention_dropout over heads {offset}.. differs from the full call")
            for name, got, expected in zip(("dq", "dk", "dv"), grads, full_grads):
                check(torch.equal(got, expected[..., columns]), f"attention_backward {name} over heads {offset}.. differs from the full call")
            print(
                f"head offset {str(dtype).removeprefix('torch.')} B={TRAIN_BATCH} T={TRAIN_TIME} heads {offset}..{heads - 1} of {heads}"
                f" (hd={head_dim}): K5, K4 (dq, dk, dv) and K6 bit-equal to the full call's heads",
                flush=True,
            )


# Head widths other than 64: XLS-R 1B's 80 and 2B's 120 (which runs as the
# 128 instantiation, zero-padded), 128 itself and 32; widths that are not a
# multiple of 8 (12, 20: zero-padded by the wrappers) and widths above 128
# (136, 192, 256: the chunked route of csrc/attention_wide.cuh).
HEAD_WIDTHS = (12, 20, 32, 80, 120, 128, 136, 192, 256)
TIMED_HEAD_WIDTHS = (64, 20, 80, 120, 128, 136, 256)


def phase_head_widths() -> None:
    """K1, K5 and K4 at each of HEAD_WIDTHS, in bf16 and f32, against their
    twins at the limits of the 64-wide cases (q/k/v strided views of a fused
    projection, a ragged, a one-key and a zero-length row), K5 and K4 each
    bit-equal over two calls; kernel_head_dim raising only for a width that
    does not split into the heads; then the bf16 times at XLS-R 1B / 2B-like
    shapes ([8, 499], 16 heads) of TIMED_HEAD_WIDTHS."""
    from allophant_tpu_torch.ops.oneshot_attention import (
        head_plan,
        kernel_head_dim,
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
        check(kernel_head_dim("check", heads * head_dim, heads) == head_dim, f"kernel_head_dim refuses {head_dim}")
        padded, chunks = head_plan(head_dim)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias, _ = attention_inputs(lengths, time_steps, heads, head_dim, dtype, fused_qkv=True)
            grad = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(head_dim), device="cuda").to(dtype)
            limits = KERNEL_LIMITS[dtype]
            label = (
                f"{str(dtype).removeprefix('torch.')} B={batch} T={time_steps} H={heads} hd={head_dim}"
                f" (launched at {padded}, {chunks} chunk{'s' if chunks > 1 else ''}) strided lengths={lengths}"
            )
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
    try:
        kernel_head_dim("check", 100, 3)
    except ValueError as error:
        check("does not split" in str(error), f"kernel_head_dim(100, 3): {error}")
    else:
        raise SmokeFailure("kernel_head_dim took a width of 100 in 3 heads")
    print(f"kernel head widths {HEAD_WIDTHS} taken; a width of 100 in 3 heads raises ValueError", flush=True)
    for head_dim in TIMED_HEAD_WIDTHS:
        scale = head_dim**-0.5
        q, k, v, bias, lengths_tensor = attention_inputs([TRAIN_TIME] * TRAIN_BATCH, TRAIN_TIME, HEADS, head_dim, torch.bfloat16, fused_qkv=True)
        grad = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
        forward_ms = median_ms(lambda: oneshot_attention(q, k, v, bias, scale, HEADS), 10)
        dropout_ms = median_ms(lambda: oneshot_dropout_attention(q, k, v, bias, DROPOUT_SEEDS, scale, HEADS, rate), 10)
        backward_ms = median_ms(lambda: oneshot_attention_backward(q, k, v, grad, bias, DROPOUT_SEEDS, scale, HEADS, rate), 10)
        bytes_moved, operations = attention_work(TRAIN_BATCH, TRAIN_TIME, HEADS, head_dim, lengths_tensor, 2)
        print(
            f"time head width bf16 B={TRAIN_BATCH} T={TRAIN_TIME} H={HEADS} hd={head_dim} (launched at {head_plan(head_dim)[0]}):"
            f" oneshot_attention {forward_ms:.4f} ms"
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
        import allophant_tpu_torch.ops.decode as decode
        import allophant_tpu_torch.ops.frame_encoder as frame_encoder
        import allophant_tpu_torch.ops.oneshot_attention as attention
        import allophant_tpu_torch.ops.relkey_attention as relkey

        names = ("reference_oneshot", "reference_oneshot_dropout", "reference_oneshot_backward", "reference_dropout_mask_bits")
        self.saved = [(attention, name, getattr(attention, name)) for name in names]
        self.saved.append((relkey, "reference_relkey_attention", relkey.reference_relkey_attention))
        self.saved.append((frame_encoder, "reference_frame_conv", frame_encoder.reference_frame_conv))
        self.saved += [(decode, name, getattr(decode, name)) for name in ("beam_search_padded", "backtrace_beams_device")]
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


def phase_train(results: dict) -> float:
    """The full-width training flagship ("mixed": bf16 encoder, f32 head, f32
    master weights) takes TRAIN_STEPS steps through make_train_step at A = 2,
    B = 8, 10 s, with the flagship's dropout (seeds from its config), Adam,
    schedule, clipping and frozen feature extractor; launch counters read
    around each step, the plain twins forbidden. Then one make_eval_step call
    on the first microbatch. Returns the steady seconds a step."""
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
    return steady


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


LOOP_STEPS, LOOP_TRAIN_UTTERANCES, LOOP_DEV_UTTERANCES = 4, 8, 2
# The corpus's languages: UCLA directory (ISO 639-3) -> the demo table's code.
# The four of the flagship, so its allophone layer has its four languages.
LOOP_LANGUAGES = {"deu": "de", "fra": "fr", "ita": "it", "spa": "es"}


def write_ucla_corpus(root: Path, inventories: dict, utterances: int, seconds: tuple, seed: int) -> Path:
    """A UCLA-format corpus under ``root``: for each language directory of
    ``inventories`` (UCLA code -> phoneme list), ``utterances`` 16-bit WAVs of
    seeded noise, ``seconds`` (low, high) long, each transcribed with 5-30
    seeded phonemes of the inventory."""
    import wave

    rng = np.random.default_rng(seed)
    for language, phonemes in inventories.items():
        base = root / language
        (base / "audio").mkdir(parents=True)
        (base / "inventory").write_text("".join(f"{phoneme} 1\n" for phoneme in phonemes), encoding="utf-8")
        raw, text = [], []
        for index in range(utterances):
            utterance = f"{language}_{index}"
            raw.append(f"{utterance} noise\n")
            text.append(f"{utterance} {' '.join(rng.choice(phonemes, int(rng.integers(5, 31))))}\n")
            samples = int(rng.uniform(*seconds) * SAMPLE_RATE)
            audio = (np.clip(0.1 * rng.standard_normal(samples), -1, 1) * 32767).astype("<i2")
            with wave.open(str(base / "audio" / f"{utterance}.wav"), "wb") as file:
                file.setnchannels(1)
                file.setsampwidth(2)
                file.setframerate(SAMPLE_RATE)
                file.writeframes(audio.tobytes())
        (base / "raw").write_text("".join(raw), encoding="utf-8")
        (base / "text").write_text("".join(text), encoding="utf-8")
    return root


def loop_inventories(indexer) -> dict:
    """UCLA code -> phoneme list of each of LOOP_LANGUAGES, in the corpus's
    language order: the table's phonemes at the places of the language's own
    inventory's classes (a UCLA dataset labels a phoneme by its place in the
    whole table)."""
    table_order = indexer.full_subset_attributes.phonemes
    return {
        code: [table_order[indexer.phoneme_index(phoneme)] for phoneme in indexer.phoneme_inventory(LOOP_LANGUAGES[code])]
        for code in sorted(LOOP_LANGUAGES)
    }


def loop_setup(root: Path, config_dict: dict, utterances, dev_utterances, seconds, seed):
    """(config, indexer, manager) of a training run over a synthetic UCLA
    corpus of LOOP_LANGUAGES written under ``root``. The indexer takes the
    demo table's inventories in the corpus's language order (sorted
    directories), so language ids agree. A UCLA dataset labels a phoneme by
    its place in the whole table, the model's phoneme classes are the sorted
    training inventory: each language's transcriptions use the table's
    phonemes at the places of its own inventory's classes, so every label is
    a class its allophone layer allows."""
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.data.speech_corpus import MultilingualSplits
    from allophant_tpu_torch.data.ucla import UCLAPhoneticCorpus
    from allophant_tpu_torch.demo import demo_indexer
    from allophant_tpu_torch.training.run import DatasetManager

    config = Config.load(config_dict)
    indexer = demo_indexer(config, languages=[LOOP_LANGUAGES[code] for code in sorted(LOOP_LANGUAGES)])
    inventories = loop_inventories(indexer)
    train = UCLAPhoneticCorpus.load(str(write_ucla_corpus(root / "train", inventories, utterances, seconds, seed)), resample=SAMPLE_RATE)
    splits = MultilingualSplits.single(train, "train")
    if dev_utterances:
        splits.dev = UCLAPhoneticCorpus.load(
            str(write_ucla_corpus(root / "dev", inventories, dev_utterances, seconds, seed + 1)), resample=SAMPLE_RATE
        )
    return config, indexer, DatasetManager.from_config(config, splits, indexer)


def tree_leaves(tree: dict, prefix=()):
    """(path, leaf) of every leaf of a nested dict."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from tree_leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), value


def parameter_groups(model) -> dict:
    groups = ("acoustic_model.feature_extractor", "acoustic_model.feature_projection", "acoustic_model.encoder", "projection")
    return {group: [name for name, _ in model.named_parameters() if name.startswith(group)] for group in groups}


def phase_train_loop(results: dict, step_phase_seconds: float, root: Path) -> dict:
    """The training loop from user inputs: the demo config (batch capped so a
    microbatch holds at most TRAIN_BATCH x TRAIN_SECONDS, accumulation
    TRAIN_ACCUMULATION, validation every LOOP_STEPS steps) through the port's
    Config, PhoneticAttributeIndexer, DatasetManager over a synthetic UCLA
    corpus on disk (4 languages x LOOP_TRAIN_UTTERANCES WAVs of 2-10 s, and
    LOOP_DEV_UTTERANCES each for validation) and Estimator.from_config on the
    card (the full-width flagship, "mixed"); ``train`` runs LOOP_STEPS steps
    and one step-based validation with the twins forbidden, then ``save``.
    Checks the launches (48 K5 and K4 a step, K2 once a microbatch and a
    validation batch, K1 24 a validation batch), finite losses, a
    bit-unchanged frozen extractor, moved trainable groups, and the
    checkpoint decoded by the port's codec against the f32 master
    parameters bit for bit. The corpus and the checkpoint stay in ``root``
    (``train/``, ``dev/``, ``flagship.ckpt``); returns the saved f32 master
    parameters as the JAX package's ``params`` tree."""
    from allophant_tpu_torch.demo import demo_config_dict
    from allophant_tpu_torch.training.checkpoint import load_native
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.run import TrainingStatus
    from allophant_tpu_torch.weights import jax_params_from_state

    start = time.perf_counter()
    config_dict = demo_config_dict()
    config_dict["nn"].update(
        batch_size=TRAIN_ACCUMULATION * TRAIN_BATCH * TRAIN_SECONDS * SAMPLE_RATE,
        accumulation_factor=TRAIN_ACCUMULATION,
        step_size=LOOP_STEPS,
    )
    config, indexer, manager = loop_setup(root, config_dict, LOOP_TRAIN_UTTERANCES, LOOP_DEV_UTTERANCES, (2, 10), seed=5)
    estimator = Estimator.from_config(config, manager.feature_size, SAMPLE_RATE, manager.attribute_graph(), indexer, device="cuda")
    model = estimator.model
    layers = model.architecture.num_hidden_layers
    validation_batches = sum(1 for _ in manager.validation_batches())
    before = {name: parameter.detach().clone() for name, parameter in model.named_parameters()}
    torch.cuda.synchronize()
    print(
        f"train loop: setup {time.perf_counter() - start:.2f} s (corpus of {len(manager.splits.train)} + {len(manager.splits.dev)}"
        f" WAVs written and read, indexer, {layers}-layer flagship from the config, {estimator.precision});"
        f" {validation_batches} validation batches",
        flush=True,
    )

    run = estimator.train(manager)
    step_spans, validation_spans = [], []

    def timed(function, spans):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            begin = time.perf_counter()
            value = function(*args, **kwargs)
            torch.cuda.synchronize()
            spans.append((begin, time.perf_counter()))
            return value

        return call

    run._train_step = timed(run._train_step, step_spans)
    run._validate = timed(run._validate, validation_spans)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    loop_start = time.perf_counter()
    statistics = []
    iterator = iter(run)
    with TwinsForbidden():
        for status, stats in iterator:
            statistics.append((status, stats))
            if status in (TrainingStatus.STEP, TrainingStatus.IMPROVED):
                break
        iterator.close()
    torch.cuda.synchronize()
    loop_seconds = time.perf_counter() - loop_start
    launches = {name: counter.launches for name, counter in counters.items()}
    for name, count in launches.items():
        results[name] += count
    peak = torch.cuda.max_memory_allocated()
    check(len(step_spans) == LOOP_STEPS and len(validation_spans) == 1, f"loop ran {len(step_spans)} steps, {len(validation_spans)} validations")
    expected = {
        "oneshot_attention": layers * validation_batches,
        "attention_dropout": TRAIN_ACCUMULATION * layers * LOOP_STEPS,
        "attention_backward": TRAIN_ACCUMULATION * layers * LOOP_STEPS,
        "dropout_mask": 0,
        "frame_encoder": TRAIN_ACCUMULATION * LOOP_STEPS + validation_batches,
    }
    check(launches == expected, f"train loop: launches {launches}, expected {expected}")
    (status, stats), = statistics
    check(np.isfinite(stats.train_loss) and np.isfinite(stats.validation_loss), f"train loop: non-finite losses {stats}")
    check(all(np.isfinite(value) for value in stats.classifier_losses.values()), "train loop: a head's loss is not finite")
    groups = parameter_groups(model)
    parameters = dict(model.named_parameters())
    moved = {group: sum(not torch.equal(before[name], parameters[name]) for name in names) for group, names in groups.items()}
    print(f"train loop: {status.value} at step {stats.global_step}: train loss {stats.train_loss:.6f}, validation loss"
          f" {stats.validation_loss:.6f}, grad_norm {stats.gradient_norm:.6f}, lr {stats.learning_rate:.3e};"
          f" parameters moved per group {moved} of { {group: len(names) for group, names in groups.items()} }; launches {launches}",
          flush=True)
    frozen, *trainable = groups
    check(moved[frozen] == 0, "train loop: the frozen feature extractor moved")
    check(all(moved[group] > 0 for group in trainable), "train loop: a trainable group did not move")

    step_seconds = [end - begin for begin, end in step_spans]
    first_start, last_end = step_spans[0][0], step_spans[-1][1]
    between = sum(end - begin for begin, end in validation_spans if first_start <= begin <= last_end)
    steps_wall = last_end - first_start - between
    host = steps_wall - sum(step_seconds)
    print(
        f"train loop time: {loop_seconds:.3f} s for {LOOP_STEPS} steps and one validation; from the first step's start"
        f" to the last step's end {steps_wall / LOOP_STEPS * 1e3:.1f} ms a step, of which the step itself"
        f" {np.mean(step_seconds) * 1e3:.1f} ms (steps 2-{LOOP_STEPS}: {np.mean(step_seconds[1:]) * 1e3:.1f} ms) and"
        f" the host's batching, stacking and copy between steps {host / (LOOP_STEPS - 1) * 1e3:.1f} ms"
        f" ({host / steps_wall:.3f} of that wall time), beside {step_phase_seconds * 1e3:.1f} ms a step of the step"
        f" phase (8 x 10 s microbatches); validation {validation_spans[0][1] - validation_spans[0][0]:.3f} s"
        f" ({validation_batches} batches); peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)",
        flush=True,
    )

    save_start = time.perf_counter()
    path = root / "flagship.ckpt"
    estimator.save(str(path), phonetic_indexer_state=indexer.state())
    save_seconds = time.perf_counter() - save_start
    contents = load_native(str(path))
    expected_params = jax_params_from_state(dict(model.named_parameters()), model.architecture)
    saved = dict(tree_leaves(contents.variables["params"]))
    wanted = dict(tree_leaves(expected_params))
    check(saved.keys() == wanted.keys(), "checkpoint: parameter tree differs")
    differing = [key for key, value in wanted.items() if value.dtype != np.float32 or not np.array_equal(saved[key], value)]
    check(not differing, f"checkpoint: {len(differing)} leaves differ from the master parameters, e.g. {differing[:3]}")
    check(
        contents.epoch.to_dict() == estimator.epoch.to_dict()
        and json.loads(json.dumps(contents.config.dump())) == json.loads(json.dumps(config.dump())),
        "checkpoint: metadata differs",
    )
    print(
        f"train loop save: {path.stat().st_size / 2**20:.1f} MiB in {save_seconds:.2f} s; decoded by the port's codec,"
        f" {len(saved)} parameter leaves bit-equal to the f32 master parameters",
        flush=True,
    )
    return expected_params


def phase_train_loop_float32() -> None:
    """The loop on the card and on the CPU (plain twins) from the same weights:
    a full-width 2-layer flagship in "float32", every dropout off, SGD with
    momentum, 2 steps (A = 2, B = 1, 2 s), train losses compared at the float32
    step phase's limit (1e-4 relative). SGD because Adam's first update is
    lr * sign(g) for a leaf whose exact gradient is 0, where each device's f32
    rounding picks the sign."""
    from allophant_tpu_torch.demo import demo_config_dict
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.training.estimator import Estimator

    architecture = dataclasses.replace(
        Wav2Vec2Architecture(), num_hidden_layers=2, hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0,
    )
    config_dict = demo_config_dict()
    config_dict["nn"].update(
        batch_size=2, batching_mode="utterances", accumulation_factor=2, maximum_iterations=1, mixed_precision=False,
        optimizer={"algorithm": "sgd", "learning_rate": 0.01, "momentum": 0.9},
    )
    config_dict["nn"]["projection"]["acoustic_model_dropout"] = 0.0
    losses = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop32_") as directory:
        card = None
        for device in ("cuda", "cpu"):
            config, indexer, manager = loop_setup(Path(directory) / device, config_dict, 1, 0, (1.9, 2.0), seed=6)
            estimator = Estimator.from_config(
                config, manager.feature_size, SAMPLE_RATE, manager.attribute_graph(), indexer,
                wav2vec2_architecture=architecture, precision="float32", device=device, seed=3,
            )
            if card is None:
                card = estimator
            else:
                estimator.model.load_state_dict({key: value.cpu() for key, value in card.model.state_dict().items()})
            (status, stats), _finished = list(estimator.train(manager))
            check(stats.global_step == 2, f"float32 loop on {device}: {stats.global_step} steps")
            losses[device] = stats.train_loss
    relative = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(
        f"train loop float32 card vs cpu (2 layers, A=2 B=1 2 s, 2 steps): train loss {losses['cuda']:.6f} vs"
        f" {losses['cpu']:.6f}, relative difference {relative:.3e} (tolerance 1e-4)",
        flush=True,
    )
    check(relative <= 1e-4, "float32 loop: card and CPU losses disagree")


PREDICT_UTTERANCES, PREDICT_BATCH, PREDICT_BEAMS, PREDICT_CANDIDATES = 16, 8, 4, 2
PREDICT_TIMING = re.compile(r"\[predict-timing\] batch ([0-9.]+) audio-s in ([0-9.]+)s")


def run_cli(arguments: list, counters: dict):
    """(launches of each counted kernel, the CLI's per-batch (audio seconds,
    wall seconds) timing lines, wall seconds) of one in-process call of the
    port's CLI with the plain twins forbidden."""
    from allophant_tpu_torch.cli.run import main as cli_main

    stderr = io.StringIO()
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    start = time.perf_counter()
    with TwinsForbidden(), contextlib.redirect_stderr(stderr):
        cli_main(arguments)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    batches = [(float(audio), float(wall)) for audio, wall in PREDICT_TIMING.findall(stderr.getvalue())]
    return {name: counter.launches for name, counter in counters.items()}, batches, seconds


def read_predictions(path: Path):
    lines = path.read_text(encoding="utf-8").splitlines()
    return json.loads(lines[0]), [json.loads(line) for line in lines[1:]]


def device_seconds(call, batches) -> float:
    """Wall seconds of ``call`` over ``batches`` queued back to back (after one
    warm-up call), ending in a synchronise."""
    call(*batches[0])
    torch.cuda.synchronize()
    start = time.perf_counter()
    for batch in batches:
        call(*batch)
    torch.cuda.synchronize()
    return time.perf_counter() - start


def phase_predict(results: dict, root: Path, master_params: dict) -> None:
    """Serving from a checkpoint: ``Estimator.restore`` of the loop phase's
    24-layer flagship on the card, held bit for bit to the saved f32 master
    parameters; then the port's CLI in this process on a synthetic UCLA
    corpus (4 languages x PREDICT_UTTERANCES WAVs of 2-10 s): ``predict``
    greedily with ``--language-phonemes``, then at ``-b 4 -n 2`` (the phone
    head recomposed over each language's inventory, batches split by
    language), with the twins forbidden and the launches counted; every
    utterance a line, every head a candidate; ``evaluate -j`` of each file
    with the device scorer on the card and with ``--host-scorer``, equal
    edit statistics. Prints the restore and evaluate seconds and the CLI's
    steady audio-s/s beside predict_decoded / predict_beam_decoded alone on
    the same batches."""
    from allophant_tpu_torch.cli.run import _dataset_from_data, _filter_split_raw_batches_by_language
    from allophant_tpu_torch.cli.run import main as cli_main
    from allophant_tpu_torch.config import BatchingMode
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.data.batching import Batcher
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.weights import jax_params_from_state

    checkpoint = root / "flagship.ckpt"
    torch.cuda.synchronize()
    start = time.perf_counter()
    with TwinsForbidden():
        estimator, indexer = Estimator.restore(str(checkpoint), device="cuda")
    torch.cuda.synchronize()
    restore_seconds = time.perf_counter() - start
    model = estimator.model
    layers = model.architecture.num_hidden_layers
    restored = dict(tree_leaves(jax_params_from_state(dict(model.named_parameters()), model.architecture)))
    wanted = dict(tree_leaves(master_params))
    check(restored.keys() == wanted.keys(), "restore: parameter tree differs from the saved one")
    differing = [key for key, value in wanted.items() if restored[key].dtype != value.dtype or not np.array_equal(restored[key], value)]
    check(not differing, f"restore: {len(differing)} leaves differ from the saved master parameters, e.g. {differing[:3]}")
    check(layers == 24 and estimator.precision == "mixed", f"restore: {layers} layers, {estimator.precision}")
    print(
        f"predict: Estimator.restore of the {layers}-layer flagship ({checkpoint.stat().st_size / 2**20:.1f} MiB,"
        f" {estimator.precision}) on the card in {restore_seconds:.2f} s; {len(wanted)} parameter leaves bit-equal"
        " to the saved f32 master parameters",
        flush=True,
    )

    inventories = loop_inventories(indexer)
    corpus = write_ucla_corpus(root / "predict", inventories, PREDICT_UTTERANCES, (2, 10), seed=7)
    counters = {**kernel_counters(), "beam_search": beam_search_cuda, "beam_backtrace": backtrace_cuda}
    widths = {node.name: node.output_size for node in model.plan.nodes}
    # The corpus order: languages sorted, utterances in file order; the CLI
    # splits each batch of the beam run into runs of one language.
    corpus_languages = [code for code in sorted(inventories) for _ in range(PREDICT_UTTERANCES)]
    runs_of_one_language = [
        language
        for start in range(0, len(corpus_languages), PREDICT_BATCH)
        for index, language in enumerate(corpus_languages[start : start + PREDICT_BATCH])
        if index == 0 or language != corpus_languages[start + index - 1]
    ]
    batches = (len(corpus_languages) + PREDICT_BATCH - 1) // PREDICT_BATCH
    common = ["predict", str(corpus), str(checkpoint), "--no-progress", "-m", "utterances", "-s", str(PREDICT_BATCH)]
    previous_timing = os.environ.get("ALLOPHANT_PREDICT_TIMING")
    os.environ["ALLOPHANT_PREDICT_TIMING"] = "1"
    try:
        outputs = {}
        for name, extra in (("greedy", ["--language-phonemes"]), ("beam", ["-b", str(PREDICT_BEAMS), "-n", str(PREDICT_CANDIDATES)])):
            output = root / f"predict-{name}.jsonl"
            launches, timing, seconds = run_cli([*common, *extra, "-o", str(output)], counters)
            for kernel, count in launches.items():
                results[kernel] += count
            metadata, entries = read_predictions(output)
            heads = metadata["classifiers"]
            expected = dict.fromkeys(launches, 0)
            if name == "greedy":
                expected.update(oneshot_attention=layers * batches, frame_encoder=batches)
            else:
                searches = sum(
                    len({widths[head] for head in heads if head != "phone"} | {len(inventories[language]) + 1})
                    for language in runs_of_one_language
                )
                expected.update(
                    oneshot_attention=layers * len(runs_of_one_language), frame_encoder=len(runs_of_one_language),
                    beam_search=searches, beam_backtrace=searches,
                )
            check(launches == expected, f"predict {name}: launches {launches}, expected {expected}")
            check(
                sorted((entry["language"], entry["utterance_id"]) for entry in entries)
                == sorted((code, f"{code}_{index}") for code in inventories for index in range(PREDICT_UTTERANCES)),
                f"predict {name}: the lines do not cover the corpus once each",
            )
            most = PREDICT_CANDIDATES if name == "beam" else 1
            check(
                all(set(entry["predictions"]) == set(heads) for entry in entries)
                and all(1 <= len(candidates) <= most for entry in entries for candidates in entry["predictions"].values()),
                f"predict {name}: an utterance lacks a head's candidates",
            )
            tokens = sum(len(candidates[0]) for entry in entries for candidates in entry["predictions"].values())
            steady_audio = sum(audio for audio, _ in timing[1:])
            steady_wall = sum(wall for _, wall in timing[1:])
            outputs[name] = (output, heads, steady_audio, steady_wall, len(timing))
            print(
                f"predict {name}: {len(entries)} utterances of {len(heads)} heads ({tokens} top-candidate tokens) in"
                f" {seconds:.2f} s with the restore; {len(timing)} batches; steady (batches 2-{len(timing)})"
                f" {steady_audio:.1f} audio-s in {steady_wall:.3f} s = {steady_audio / steady_wall:.1f} audio-s/s;"
                f" launches {launches}",
                flush=True,
            )
    finally:
        if previous_timing is None:
            del os.environ["ALLOPHANT_PREDICT_TIMING"]
        else:
            os.environ["ALLOPHANT_PREDICT_TIMING"] = previous_timing

    # predict_decoded / predict_beam_decoded alone on the CLI's batches.
    test_data = corpus_loading.load_corpus(str(corpus), "ucla-phonetic", SAMPLE_RATE).test
    dataset = _dataset_from_data(test_data, estimator.config, indexer)
    plain = list(Batcher(PREDICT_BATCH, BatchingMode.UTTERANCES, data_workers=0).batches(dataset))
    split = list(_filter_split_raw_batches_by_language(iter(plain), test_data, set()))
    # The feature matrices of the CLI's per-language decoders.
    matrices = {
        language: indexer.full_attributes.subset(test_data.inventory(language), indexer.composition_features).dense_feature_table.astype(np.int64)
        for language in test_data.languages
    }
    _output, heads, steady_audio, steady_wall, count = outputs["greedy"]
    check(count == len(plain), f"predict greedy: {count} timing lines for {len(plain)} batches")
    greedy_heads = tuple(sorted(heads))
    alone = device_seconds(
        lambda batch: estimator.predict_decoded(batch, None, heads=greedy_heads, map_allophones=True), [(batch,) for batch in plain[1:]]
    )
    readings = {"greedy": ("predict_decoded", steady_audio, steady_wall, alone)}
    _output, heads, steady_audio, steady_wall, count = outputs["beam"]
    check(count == len(split), f"predict beam: {count} timing lines for {len(split)} batches")
    beam_heads = tuple(sorted(heads))
    alone = device_seconds(
        lambda batch, language: estimator.predict_beam_decoded(batch, matrices[language], heads=beam_heads, beam_width=PREDICT_BEAMS),
        [(batch, languages[0]) for batch, languages in split[1:]],
    )
    readings["beam"] = ("predict_beam_decoded", steady_audio, steady_wall, alone)
    for name, (call, audio, cli_wall, alone) in readings.items():
        print(
            f"predict {name} readings: the CLI {audio / cli_wall:.1f} audio-s/s, {call} alone on the same batches"
            f" {audio / alone:.1f} audio-s/s ({alone:.3f} s against the CLI's {cli_wall:.3f} s);"
            f" host share between batches {1 - alone / cli_wall:.3f}",
            flush=True,
        )
    del estimator, model
    torch.cuda.empty_cache()

    for name, (output, *_rest) in outputs.items():
        reports, seconds = {}, {}
        for scorer, extra in (("device", []), ("host", ["--host-scorer"])):
            target = root / f"results-{name}-{scorer}.json"
            torch.cuda.synchronize()
            start = time.perf_counter()
            cli_main(["evaluate", str(output), "-j", "--no-progress", *extra, "-o", str(target)])
            torch.cuda.synchronize()
            seconds[scorer] = time.perf_counter() - start
            reports[scorer] = json.loads(target.read_text(encoding="utf-8"))["results"]
        check(reports["device"] == reports["host"], f"evaluate {name}: the device and host scorers disagree")
        total = reports["device"]["total"]
        print(
            f"evaluate {name}: device scorer (card) {seconds['device']:.3f} s, host scorer {seconds['host']:.3f} s,"
            f" reports equal; total phone error rate {total['error_rates']['phone']:.4f}"
            f" ({total['error_statistics']['phone']})",
            flush=True,
        )


ORBAX_FIXTURE = HERE / "tests" / "data" / "orbax_mini"
ZSTD_TIMING = HERE / "tests" / "data" / "zstd_timing"


def serving_outputs(estimator, results: dict, label: str) -> list:
    """Greedy grid and beam-4 n-best of each serving request from
    ``estimator``, with the plain twins forbidden and the launches of each
    call counted into ``results`` and checked."""
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    counters = {
        "oneshot_attention": oneshot_attention, "frame_encoder": fused_frame_conv,
        "beam_search": beam_search_cuda, "beam_backtrace": backtrace_cuda,
    }
    layers = estimator.model.architecture.num_hidden_layers
    outputs = []
    for name, request in serving_requests():
        batch, kwargs, _predictions, heads, widths = request_log_probs(estimator, name, request)
        searches = len({widths[head] for head in heads})
        for mode in ("greedy", "beam"):
            torch.cuda.synchronize()
            for counter in counters.values():
                counter.launches = 0
            with TwinsForbidden():
                if mode == "greedy":
                    grid, lengths = estimator.predict_decoded(batch, heads=heads, **kwargs)
                    output = (grid.cpu(), lengths.cpu())
                else:
                    collected, scores, lengths = estimator.predict_beam_decoded(batch, heads=heads, beam_width=4, **kwargs)
                    output = (collected.cpu(), scores.cpu(), lengths.cpu())
            torch.cuda.synchronize()
            launches = {kernel: counter.launches for kernel, counter in counters.items()}
            expected = {"oneshot_attention": layers, "frame_encoder": 1, "beam_search": 0, "beam_backtrace": 0}
            if mode == "beam":
                expected.update(beam_search=searches, beam_backtrace=searches)
            check(launches == expected, f"orbax {label} {mode} request {name!r}: launches {launches}, expected {expected}")
            for kernel, count in launches.items():
                results[kernel] += count
            outputs.append((name, mode, output))
    return outputs


def phase_orbax(results: dict, root: Path, card: str) -> None:
    """Orbax checkpoints through the port's own reader and writer (no orbax,
    tensorstore or zstd package on this machine): the full-width flagship
    saved, loaded and restored on the card with its serving outputs equal
    to the in-memory model's; the committed tensorstore-written fixture
    decoded and served; ``predict`` from an Orbax directory."""
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_config_dict, demo_indexer
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config
    from allophant_tpu_torch.native import zstd
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention
    from allophant_tpu_torch.training import checkpoint as checkpoint_module
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.ocdbt import OcdbtReader
    from allophant_tpu_torch.training.orbax_arrays import read_tree

    # 1. The serving flagship through save_orbax -> load_checkpoint -> restore.
    estimator = build_serving_flagship()
    config = Config.load(demo_config_dict())
    indexer = demo_indexer(config)
    checkpoint = checkpoint_module.Checkpoint(
        config=config,
        feature_size=1,
        sample_rate=SAMPLE_RATE,
        attribute_graph=attribute_graph_from_config(config, indexer),
        epoch=checkpoint_module.EpochPosition(),
        phonetic_indexer_state=indexer.state(),
        variables=checkpoint_module.variables_from_model(estimator.model),
    )
    directory = root / "flagship-orbax"
    start = time.perf_counter()
    checkpoint_module.save_orbax(checkpoint, str(directory))
    save_seconds = time.perf_counter() - start
    size = sum(path.stat().st_size for path in directory.rglob("*") if path.is_file())
    start = time.perf_counter()
    loaded = checkpoint_module.load_checkpoint(str(directory))
    load_seconds = time.perf_counter() - start
    wanted, got = dict(tree_leaves(checkpoint.variables)), dict(tree_leaves(loaded.variables))
    check(wanted.keys() == got.keys(), "orbax: the loaded tree differs from the saved one")
    differing = [key for key, value in wanted.items() if got[key].dtype != value.dtype or not np.array_equal(got[key], value)]
    check(not differing, f"orbax: {len(differing)} leaves differ after the round trip, e.g. {differing[:3]}")
    del loaded, got
    torch.cuda.synchronize()
    start = time.perf_counter()
    with TwinsForbidden():
        restored, _indexer = Estimator.restore(str(directory), device="cuda")
    torch.cuda.synchronize()
    restore_seconds = time.perf_counter() - start
    check(restored.precision == "mixed" and restored.model.architecture.num_hidden_layers == 24, "orbax: restored preset")
    print(
        f"orbax flagship ({card}): save_orbax {save_seconds:.2f} s, {size / 2**30:.3f} GiB in {sum(1 for _ in directory.rglob('*'))}"
        f" files; load_checkpoint {load_seconds:.2f} s ({size / load_seconds / 1e6:.0f} MB/s), {len(wanted)} leaves bit-equal;"
        f" Estimator.restore on the card {restore_seconds:.2f} s",
        flush=True,
    )
    expected = serving_outputs(estimator, results, "in-memory")
    del estimator
    torch.cuda.empty_cache()
    outputs = serving_outputs(restored, results, "restored")
    del restored
    torch.cuda.empty_cache()
    for (name, mode, want), (_name, _mode, have) in zip(expected, outputs):
        cells = sum(int((a != b).sum().item()) for a, b in zip(want, have))
        check(cells == 0, f"orbax {mode} request {name!r}: {cells} cells differ from the in-memory estimator's")
    print(f"orbax flagship: {len(outputs)} calls (greedy, beam 4) integer-equal to the in-memory estimator's", flush=True)

    # 2. The fixture tensorstore wrote: zstd chunks, several a kernel.
    leaves = np.load(ORBAX_FIXTURE / "leaves.npz")
    fixture = checkpoint_module.load_checkpoint(str(ORBAX_FIXTURE / "checkpoint"))
    trees = {"checkpoint": fixture.variables, "extras": read_tree(str(ORBAX_FIXTURE / "extras"))}
    compared = 0
    for prefix, tree in trees.items():
        for path, value in tree_leaves(tree):
            if isinstance(value, dict):
                continue
            want = leaves["/".join((prefix, *path))]
            check(value.dtype == want.dtype and np.array_equal(value, want), f"orbax fixture: {prefix}/{'/'.join(path)} differs")
            compared += 1
    check(compared == sum(1 for key in leaves.files), f"orbax fixture: {compared} of {len(leaves.files)} leaves read")
    frames = []
    for sub in ("checkpoint/variables", "extras"):
        reader = OcdbtReader(str(ORBAX_FIXTURE / sub))
        frames += [reader.read(key) for key in reader.list() if not key.endswith(".zarray")]
    decoded = sum(len(zstd.decompress(frame)) for frame in frames)
    rounds = 0
    start = time.perf_counter()
    while time.perf_counter() - start < 0.5:
        for frame in frames:
            zstd.decompress(frame)
        rounds += 1
    rate = decoded * rounds / (time.perf_counter() - start) / 1e6
    # One frame that decodes to 32 MiB (tools/write_zstd_timing_frame.py):
    # long matches between short literals, at a checkpoint chunk's size.
    long_frame = (ZSTD_TIMING / "long_matches.zst").read_bytes()
    long_meta = json.loads((ZSTD_TIMING / "long_matches.json").read_text(encoding="utf-8"))
    long_output = np.empty(long_meta["decoded_bytes"], np.uint8)
    long_seconds = []
    for _ in range(5):
        start = time.perf_counter()
        written = zstd.decompress_into(long_frame, long_output)
        long_seconds.append(time.perf_counter() - start)
    check(
        written == long_output.size and hashlib.sha256(long_output).hexdigest() == long_meta["sha256"],
        "orbax: the 32 MiB timing frame decodes to other bytes than tools/write_zstd_timing_frame.py made",
    )
    long_rate = long_output.size / min(long_seconds) / 1e6
    del long_output
    cpu_estimator, _ = Estimator.restore(str(ORBAX_FIXTURE / "checkpoint"), precision="float32", device="cpu")
    card_estimator, _ = Estimator.restore(str(ORBAX_FIXTURE / "checkpoint"), precision="float32", device="cuda")
    from allophant_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((3, 1600)) * 0.5).astype(np.float32)
    batch = Batch(audio, np.array([1600, 1600, 1100], dtype=np.int32), np.zeros(3, dtype=np.int32))
    heads = tuple(sorted(cpu_estimator.predict(batch, time_major=False).outputs))
    cpu_grid, _ = cpu_estimator.predict_decoded(batch, heads=heads)
    card_estimator.predict_decoded(batch, heads=heads)  # warm-up
    torch.cuda.synchronize()
    oneshot_attention.launches = 0
    with TwinsForbidden():
        card_grid, _ = card_estimator.predict_decoded(batch, heads=heads)
    torch.cuda.synchronize()
    layers = fixture.config.nn.acoustic_model.transformer.num_layers
    check(oneshot_attention.launches == layers, f"orbax fixture: K1 launched {oneshot_attention.launches} times, {layers} layers")
    results["oneshot_attention"] += oneshot_attention.launches
    cells = int((card_grid.cpu().to(torch.int32) != cpu_grid.to(torch.int32)).sum().item())
    check(cells == 0, f"orbax fixture: {cells} grid cells differ between the card and the CPU")
    print(
        f"orbax fixture: {compared} leaves bit-equal to leaves.npz ({len(frames)} zstd frames, {decoded} bytes);"
        f" zstd decoder {rate:.1f} MB/s on this host over them, {long_rate:.1f} MB/s on a {len(long_frame)}-byte frame of"
        f" {long_meta['decoded_bytes']} bytes (best of 5: {', '.join(f'{t * 1e3:.2f}' for t in long_seconds)} ms);"
        f" restored float32 on the card, one request: grid {tuple(card_grid.shape)}"
        f" equal to the CPU's, K1 {layers} launches",
        flush=True,
    )
    del card_estimator, cpu_estimator

    # 3. predict from an Orbax copy of phase 12's checkpoint.
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda

    native = checkpoint_module.load_checkpoint(str(root / "flagship.ckpt"))
    converted = root / "flagship-loop-orbax"
    checkpoint_module.save_orbax(native, str(converted))
    del native
    output = root / "predict-greedy-orbax.jsonl"
    counters = {**kernel_counters(), "beam_search": beam_search_cuda, "beam_backtrace": backtrace_cuda}
    arguments = [
        "predict", str(root / "predict"), str(converted), "--no-progress", "-m", "utterances", "-s", str(PREDICT_BATCH),
        "--language-phonemes", "-o", str(output),
    ]
    launches, _timing, seconds = run_cli(arguments, counters)
    for kernel, count in launches.items():
        results[kernel] += count
    native_lines = (root / "predict-greedy.jsonl").read_text(encoding="utf-8").splitlines()
    orbax_lines = output.read_text(encoding="utf-8").splitlines()
    # The header differs only in the arguments' text, which names the paths.
    headers = [{**json.loads(lines[0]), "prediction_arguments": None} for lines in (native_lines, orbax_lines)]
    check(headers[0] == headers[1], "orbax predict: the JSONL header differs from the native checkpoint's")
    differing = sum(a != b for a, b in zip(native_lines[1:], orbax_lines[1:]))
    check(len(native_lines) == len(orbax_lines) and differing == 0, f"orbax predict: {differing} JSONL lines differ from the native checkpoint's")
    check(launches["oneshot_attention"] > 0 and launches["frame_encoder"] > 0, f"orbax predict: launches {launches}")
    print(
        f"orbax predict: {len(orbax_lines) - 1} utterance lines from the Orbax directory equal to the native checkpoint's;"
        f" {seconds:.2f} s with the restore; launches {launches}",
        flush=True,
    )


def phase_predict_float32(root: Path) -> None:
    """``predict`` of a 2-layer full-width flagship checkpoint ("float32";
    every class on the second layer's output, so the restored encoder is cut
    to 2 layers) on the card and with ``--cpu``, greedy and at ``-b 4 -n 2``:
    the JSONL utterance lines must be equal."""
    from allophant_tpu_torch.cli.run import main as cli_main
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_config_dict, demo_indexer
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config
    from allophant_tpu_torch.training.estimator import Estimator

    config_dict = demo_config_dict()
    for entry in config_dict["nn"]["projection"]["classes"]:
        entry["dependencies"] = ["OUTPUT_1"]
    config = Config.load(config_dict)
    indexer = demo_indexer(config, languages=[LOOP_LANGUAGES[code] for code in sorted(LOOP_LANGUAGES)])
    estimator = Estimator.from_config(
        config, 1, SAMPLE_RATE, attribute_graph_from_config(config, indexer), indexer, precision="float32", device="cuda", seed=8
    )
    layers = estimator.model.architecture.num_hidden_layers
    check(layers == 2, f"float32 predict: {layers} encoder layers")
    checkpoint = root / "flagship32.ckpt"
    estimator.save(str(checkpoint), phonetic_indexer_state=indexer.state())
    del estimator
    corpus = write_ucla_corpus(root / "predict32", loop_inventories(indexer), 2, (2, 4), seed=9)
    common = ["predict", str(corpus), str(checkpoint), "--precision", "float32", "--no-progress", "-m", "utterances", "-s", "8"]
    for name, extra in (("greedy", []), ("beam", ["-b", str(PREDICT_BEAMS), "-n", str(PREDICT_CANDIDATES)])):
        lines = {}
        for device, flag in (("card", []), ("cpu", ["--cpu"])):
            output = root / f"predict32-{name}-{device}.jsonl"
            cli_main([*common, *extra, *flag, "-o", str(output)])
            lines[device] = output.read_text(encoding="utf-8").splitlines()
        differing = sum(card != cpu for card, cpu in zip(lines["card"][1:], lines["cpu"][1:]))
        print(
            f"predict float32 card vs cpu ({name}, {layers} layers, {len(lines['card']) - 1} utterances of 2-4 s):"
            f" {differing} utterance lines differ",
            flush=True,
        )
        check(len(lines["card"]) == len(lines["cpu"]) == 9 and differing == 0, f"float32 predict {name}: card and CPU lines differ")


REMAT_BATCH, REMAT_STEPS = 24, 2


def remat_step(model, config, accumulation: int, batch: int, label: str, results: dict) -> dict:
    """REMAT_STEPS steps of make_train_step at A x B x 10 s on ``model``
    (twins forbidden, launches counted and checked); returns the steady step
    seconds, the peak memory and the launches of one step."""
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.training.train_step import build_freeze_plan, build_loss_plan, create_optimizer, make_train_step

    optimizer = create_optimizer(config, model.architecture.hidden_size, model.parameters())
    step = make_train_step(model, optimizer, build_loss_plan(config, True), build_freeze_plan(config.acoustic_model))
    microbatches = training_microbatches(model, accumulation, batch, TRAIN_SECONDS * SAMPLE_RATE, "cuda")
    rng = DropoutRng.from_seed(config.seed, "cuda")
    layers = model.architecture.num_hidden_layers
    expected = {
        "oneshot_attention": 0,
        "attention_dropout": accumulation * layers,
        "attention_backward": accumulation * layers,
        "dropout_mask": 0,
        "frame_encoder": accumulation,
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    with TwinsForbidden():
        for index in range(REMAT_STEPS):
            start = time.perf_counter()
            metrics, launches = counted(lambda: step(microbatches, rng))
            seconds.append(time.perf_counter() - start)
            for name, count in launches.items():
                results[name] += count
            check(launches == expected, f"{label} step {index}: launches {launches}, expected {expected}")
            check(np.isfinite(metrics["mean_loss"]) and np.isfinite(metrics["grad_norm"]), f"{label}: non-finite metrics {metrics}")
    peak = torch.cuda.max_memory_allocated()
    del optimizer, step, microbatches
    return {"seconds": seconds[-1], "first_seconds": seconds[0], "peak": peak, "launches": expected}


def phase_remat(results: dict, step_seconds: float) -> None:
    """Rematerialised training of the full-width flagship ("mixed"): A = 2,
    B = 8, 10 s (the step phase's shape, which ran without remat) and the
    reference recipe's microbatch, A = 1, B = 24, 10 s; step time (the last
    of REMAT_STEPS), peak memory and launches a step (K5 and K4 once a layer
    and microbatch: the attention's Function stays outside the recomputed
    regions, so the backward does not rerun it)."""
    from allophant_tpu_torch.demo import build_flagship_for_training

    start = time.perf_counter()
    config, model = build_flagship_for_training(seed=0, precision="mixed", device="cuda", remat=True)
    print(f"remat: flagship built in {time.perf_counter() - start:.2f} s (remat, base save set)", flush=True)
    for accumulation, batch in ((TRAIN_ACCUMULATION, TRAIN_BATCH), (1, REMAT_BATCH)):
        reading = remat_step(model, config, accumulation, batch, f"remat A={accumulation} B={batch}", results)
        audio_seconds = accumulation * batch * TRAIN_SECONDS
        print(
            f"remat step: A={accumulation} B={batch} {TRAIN_SECONDS} s ({audio_seconds} audio-s), remat on:"
            f" {reading['seconds'] * 1e3:.1f} ms a step (first {reading['first_seconds'] * 1e3:.1f} ms),"
            f" {audio_seconds / reading['seconds']:.1f} audio-s/s, peak memory {reading['peak'] / 2**30:.2f} GiB"
            f" (max_memory_allocated); launches a step {reading['launches']}"
            + (f"; without remat (step phase) {step_seconds * 1e3:.1f} ms a step" if batch == TRAIN_BATCH else ""),
            flush=True,
        )
        torch.cuda.empty_cache()


def phase_remat_float32() -> None:
    """The same float32 step of a full-width 4-layer flagship with dropout on
    (the flagship's rates), with and without remat, from one DropoutRng seed:
    the gradients agree within 1e-6 of each leaf's largest (a recompute that
    drew other dropout masks would differ by far more), and both runs leave
    the generators in the same state. The step without remat runs twice, to
    print the card's run-to-run floor beside the remat difference."""
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.training.train_step import accumulate_gradients, build_loss_plan

    architecture = dataclasses.replace(Wav2Vec2Architecture(), num_hidden_layers=4)
    readings = {}
    state = None
    for remat in (False, True, False):
        config, model = build_flagship_for_training(seed=1, architecture=architecture, precision="float32", device="cuda", remat=remat)
        if state is None:
            state = {key: value.clone() for key, value in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        microbatches = training_microbatches(model, 2, 2, 2 * SAMPLE_RATE, "cuda", seed=4)
        rng = DropoutRng.from_seed(11, "cuda")
        with TwinsForbidden():
            metrics = accumulate_gradients(model, microbatches, build_loss_plan(config, True), rng).cpu()
        gradients = {name: parameter.grad.detach().cpu() for name, parameter in model.named_parameters() if parameter.grad is not None}
        readings.setdefault(remat, []).append((metrics, gradients, [generator_state.clone() for generator_state in rng.get_state()]))
        del model
    (plain_metrics, plain, plain_state), (_metrics, repeat, _state) = readings[False]
    (remat_metrics, remat, remat_state), = readings[True]

    def worst_share(gradients):
        return max((gradients[name] - value).abs().max().item() / max(value.abs().max().item(), 1e-30) for name, value in plain.items())

    share, floor = worst_share(remat), worst_share(repeat)
    same_state = all(torch.equal(a, b) for a, b in zip(plain_state, remat_state))
    print(
        f"remat float32 (4 layers, A=2 B=2 2 s, dropout on): loss {remat_metrics[0].item():.6f} vs {plain_metrics[0].item():.6f}"
        f" without remat; worst gradient difference {share:.3e} of its leaf's largest over {len(plain)} leaves"
        f" (tolerance 1e-6; the same step without remat run twice: {floor:.3e}); generator states equal: {same_state}",
        flush=True,
    )
    check(remat.keys() == plain.keys() and share <= 1e-6, "remat: gradients differ from the step without remat")
    check(same_state, "remat: the dropout generators end in another state")


TRANSFORMER_FEATURES, TRANSFORMER_BATCH, TRANSFORMER_FRAMES_PER_SECOND = 80, 8, 100


def transformer_config_dict(dropout_rate: float) -> dict:
    """The demo config with the from-scratch transformer as its acoustic
    model: a linear frontend to d_model 512, 6 layers of 8 heads of 64, FFN
    2048, on 80 log-mel filterbank features (no published width is in the
    repo; this is a correctness check, not a measurement)."""
    from allophant_tpu_torch.demo import demo_config_dict

    config = demo_config_dict()
    config["nn"]["acoustic_model"] = {
        "type": "pre-ln-transformer",
        "transformer": {"feedforward_neurons": 2048, "heads": 8, "num_layers": 6, "dropout_rate": dropout_rate},
        "frontend": {"architecture": "linear", "neurons": 512},
    }
    config["preprocessing"] = {
        "feature_type": "FILTERBANKS", "window": {"frame_duration": 25, "frame_stride": 10},
        "resample": SAMPLE_RATE, "num_filters": TRANSFORMER_FEATURES,
    }
    config["nn"]["projection"]["acoustic_model_dropout"] = dropout_rate
    return config


def transformer_estimator(dropout_rate: float, precision: str, device):
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_indexer
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config
    from allophant_tpu_torch.training.estimator import Estimator

    config = Config.load(transformer_config_dict(dropout_rate))
    indexer = demo_indexer(config)
    return Estimator.from_config(
        config, TRANSFORMER_FEATURES, SAMPLE_RATE, attribute_graph_from_config(config, indexer), indexer,
        seed=4, precision=precision, device=device,
    )


def transformer_microbatches(model, accumulation: int, device, seed: int, seconds=(2, 10)) -> dict:
    """training_microbatches with [A, B, T, 80] features of ``seconds`` (low,
    high; 100 frames a second) in place of audio."""
    rng = np.random.default_rng(seed)
    low, high = (int(value * TRANSFORMER_FRAMES_PER_SECOND) for value in seconds)
    lengths = rng.integers(low, high + 1, (accumulation, TRANSFORMER_BATCH))
    frames = int(lengths.max())
    arrays = training_microbatches(model, accumulation, TRANSFORMER_BATCH, 1, "cpu", seed=seed)
    arrays["audio"] = torch.from_numpy(rng.standard_normal((accumulation, TRANSFORMER_BATCH, frames, TRANSFORMER_FEATURES)).astype(np.float32))
    arrays["lengths"] = torch.from_numpy(lengths)
    return {key: value.to(device) for key, value in arrays.items()}


def phase_transformer(results: dict) -> None:
    """The from-scratch transformer acoustic model (transformer_config_dict)
    under the flagship's head, on 8 feature sequences of 2-10 s: a greedy
    "mixed" request and a "mixed" training step with dropout 0.1 (twins
    forbidden, launches counted: K1 once a layer when serving, K5 and K4 once
    a layer and microbatch when training); then, in "float32" with dropout
    off, greedy serving on the card against the CPU (grids equal) and one
    training step on 1-2 s sequences (metrics within 1e-4, gradients within
    GRAD_SHARE of each leaf's largest; over longer sequences the CPU's f32
    CTC gradient drifts from the exact one by more than that)."""
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.training.train_step import build_freeze_plan, build_loss_plan, create_optimizer, make_train_step

    rng = np.random.default_rng(9)
    lengths = rng.integers(2 * TRANSFORMER_FRAMES_PER_SECOND, 10 * TRANSFORMER_FRAMES_PER_SECOND + 1, TRANSFORMER_BATCH)
    features = rng.standard_normal((TRANSFORMER_BATCH, int(lengths.max()), TRANSFORMER_FEATURES)).astype(np.float32)
    batch = Batch(features, lengths, np.arange(TRANSFORMER_BATCH) % 4)

    estimator = transformer_estimator(0.1, "mixed", "cuda")
    model = estimator.model
    layers = model.architecture.num_hidden_layers
    heads = tuple(sorted(model.classes))
    with TwinsForbidden():
        (grid, frame_lengths), launches = counted(lambda: estimator.predict_decoded(batch, heads=heads))
    for name, count in launches.items():
        results[name] += count
    expected = {"oneshot_attention": layers, "attention_dropout": 0, "attention_backward": 0, "dropout_mask": 0, "frame_encoder": 0}
    check(launches == expected, f"transformer serve: launches {launches}, expected {expected}")
    check(np.array_equal(frame_lengths.cpu().numpy(), lengths), "transformer serve: frame lengths changed")
    print(
        f"transformer (d_model {model.architecture.hidden_size}, {layers} layers, 8 heads of 64, FFN 2048, 80 filterbanks), mixed:"
        f" greedy request of {TRANSFORMER_BATCH} x {lengths.min()}-{lengths.max()} frames, grid {tuple(grid.shape)}, launches {launches}",
        flush=True,
    )
    config = estimator.config.nn
    optimizer = create_optimizer(config, model.architecture.hidden_size, model.parameters())
    step = make_train_step(model, optimizer, build_loss_plan(config, True), build_freeze_plan(config.acoustic_model))
    microbatches = transformer_microbatches(model, TRAIN_ACCUMULATION, "cuda", seed=5)
    with TwinsForbidden():
        metrics, launches = counted(lambda: step(microbatches, DropoutRng.from_seed(3, "cuda")))
    for name, count in launches.items():
        results[name] += count
    expected = {
        "oneshot_attention": 0,
        "attention_dropout": TRAIN_ACCUMULATION * layers,
        "attention_backward": TRAIN_ACCUMULATION * layers,
        "dropout_mask": 0,
        "frame_encoder": 0,
    }
    check(launches == expected, f"transformer train step: launches {launches}, expected {expected}")
    check(np.isfinite(metrics["mean_loss"]) and np.isfinite(metrics["grad_norm"]), f"transformer train step: {metrics}")
    print(
        f"transformer train step (mixed, dropout 0.1, A={TRAIN_ACCUMULATION} B={TRANSFORMER_BATCH}): mean_loss"
        f" {metrics['mean_loss']:.6f}, grad_norm {metrics['grad_norm']:.6f}, launches {launches}",
        flush=True,
    )
    del estimator, model, optimizer, step, microbatches
    torch.cuda.empty_cache()

    card = transformer_estimator(0.0, "float32", "cuda")
    cpu = transformer_estimator(0.0, "float32", "cpu")
    cpu.model.load_state_dict({key: value.cpu() for key, value in card.model.state_dict().items()})
    grids = [estimator.predict_decoded(batch, heads=heads)[0].cpu().to(torch.int32) for estimator in (card, cpu)]
    mismatched = int((grids[0] != grids[1]).sum().item())
    readings = {}
    for label, estimator, device in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        config = estimator.config.nn
        optimizer = create_optimizer(config, estimator.model.architecture.hidden_size, estimator.model.parameters())
        step = make_train_step(estimator.model, optimizer, build_loss_plan(config, True), build_freeze_plan(config.acoustic_model))
        with TwinsForbidden() if device == "cuda" else contextlib.nullcontext():
            metrics, launches = counted(lambda: step(transformer_microbatches(estimator.model, 1, device, seed=6, seconds=(1, 2)), None))
        gradients = {name: parameter.grad.detach().cpu() for name, parameter in estimator.model.named_parameters()}
        readings[label] = (metrics, gradients, launches)
    (card_metrics, card_grads, card_launches), (cpu_metrics, cpu_grads, _) = readings["card"], readings["cpu"]
    for name, count in card_launches.items():
        results[name] += count
    relative = {key: abs(card_metrics[key] - cpu_metrics[key]) / abs(cpu_metrics[key]) for key in ("mean_loss", "grad_norm")}
    floor = ZERO_FLOOR * max(value.abs().max().item() for value in cpu_grads.values())
    grad_share = max(
        (card_grads[name] - value).abs().max().item() / max(value.abs().max().item(), floor / GRAD_SHARE)
        for name, value in cpu_grads.items()
    )
    print(
        f"transformer float32 card vs cpu: greedy grid {tuple(grids[0].shape)} cells differing {mismatched};"
        f" train step (A=1 B={TRANSFORMER_BATCH}) mean_loss {card_metrics['mean_loss']:.6f} vs {cpu_metrics['mean_loss']:.6f},"
        f" on 1-2 s, relative differences {relative} (tolerance 1e-4), worst gradient difference {grad_share:.3e} of its leaf's"
        f" largest (tolerance {GRAD_SHARE:.0e}); card launches {card_launches}",
        flush=True,
    )
    check(mismatched == 0, "transformer float32: card and CPU grids differ")
    check(all(value <= 1e-4 for value in relative.values()) and grad_share <= GRAD_SHARE, "transformer float32: card and CPU steps disagree")
    check(card_launches["oneshot_attention"] == layers and card_launches["attention_backward"] == layers, f"transformer float32 launches {card_launches}")


CLI_LANGUAGES = ("es", "it")
CLI_CLIPS = {"train": 16, "dev": 4, "test": 1}
CLI_EPOCHS = 3
CHILD_FLAG = "--train-cli-child"


def write_common_voice_corpus(root: Path, inventories: dict, seconds: tuple, seed: int) -> Path:
    """A Common Voice corpus under ``root`` written with the port's codec:
    per split of CLI_CLIPS and language of ``inventories`` (code -> phoneme
    list), 16-bit WAV clips of seeded noise ``seconds`` (low, high) long
    under ``<language>/clips``, each transcribed with 5-30 seeded phonemes of
    the inventory, and the split's ``*_transcriptions.bin`` and
    ``*_inventories.json``."""
    import wave

    from allophant_tpu_torch.data.common_voice import CommonVoiceCorpus, CommonVoiceCorpusMeta, Transcription
    from allophant_tpu_torch.data.g2p import PhonemeTranscription, TaggedTranscription
    from allophant_tpu_torch.data.speech_corpus import LanguageData, LanguageInfo

    rng = np.random.default_rng(seed)
    for split, count in CLI_CLIPS.items():
        languages = []
        for language, phonemes in inventories.items():
            clips = root / language / "clips"
            clips.mkdir(parents=True, exist_ok=True)
            transcriptions = []
            for index in range(count):
                utterance = f"{language}_{split}_{index}"
                sequence = [str(phoneme) for phoneme in rng.choice(phonemes, int(rng.integers(5, 31)))]
                transcriptions.append(
                    Transcription(
                        "noise", utterance, "client", None, None, None,
                        PhonemeTranscription(["noise"], [[TaggedTranscription(sequence)]]),
                    )
                )
                samples = int(rng.uniform(*seconds) * SAMPLE_RATE)
                audio = (np.clip(0.1 * rng.standard_normal(samples), -1, 1) * 32767).astype("<i2")
                with wave.open(str(clips / f"{utterance}.wav"), "wb") as file:
                    file.setnchannels(1)
                    file.setsampwidth(2)
                    file.setframerate(SAMPLE_RATE)
                    file.writeframes(audio.tobytes())
            languages.append(LanguageData(LanguageInfo(language, sorted(phonemes), [{}]), transcriptions))
        CommonVoiceCorpus(str(root), languages, CommonVoiceCorpusMeta("cv-smoke", audio_format="wav")).save(str(root), split)
    return root


def train_cli_child(arguments: list) -> int:
    """The child of the train CLI phase: runs ``allophant_tpu_torch.cli.run
    main(arguments)`` in this process (its own signal handlers), with the
    plain twins forbidden on the card, then prints one JSON line: the
    launches of each counted kernel, the seconds of each ``Estimator.save``
    and of ``Estimator.restore``, and each training step's logged metrics
    (``steps``: step, loss, gradient_norm, ...). ``--layers N`` first cuts the
    encoder of every model it builds to N layers."""
    import logging

    sys.path.insert(0, str(HERE))
    from allophant_tpu_torch.cli.run import main as cli_main
    from allophant_tpu_torch.phonetics.features import SingletonFeatureWarning
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.run import MetricsLogger

    warnings.simplefilter("ignore", SingletonFeatureWarning)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(name)s %(message)s")
    saves, restores = [], []
    save, restore = Estimator.save, Estimator.restore.__func__

    def timed_save(self, path, *args, **kwargs):
        start = time.perf_counter()
        save(self, path, *args, **kwargs)
        saves.append([os.path.basename(path), time.perf_counter() - start])

    def timed_restore(cls, *args, **kwargs):
        start = time.perf_counter()
        value = restore(cls, *args, **kwargs)
        restores.append(time.perf_counter() - start)
        return value

    Estimator.save, Estimator.restore = timed_save, classmethod(timed_restore)
    steps, log_step = [], MetricsLogger.log_step

    def recorded_log_step(self, step, metrics, prefix="training"):
        if prefix == "training":
            steps.append({"step": int(step), **{name: float(value) for name, value in metrics.items()}})
        log_step(self, step, metrics, prefix)

    MetricsLogger.log_step = recorded_log_step
    if arguments[:1] == ["--layers"]:
        from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture

        shallow = Wav2Vec2Architecture(num_hidden_layers=int(arguments[1]))
        arguments = arguments[2:]
        from_config = Estimator.from_config.__func__

        def shallow_from_config(cls, config, feature_size, sample_rate, graph, indexer=None, architecture=None, *rest, **kwargs):
            return from_config(cls, config, feature_size, sample_rate, graph, indexer, architecture or shallow, *rest, **kwargs)

        Estimator.from_config = classmethod(shallow_from_config)
    on_cpu = "--cpu" in arguments
    counters = kernel_counters()
    for counter in counters.values():
        counter.launches = 0
    with contextlib.nullcontext() if on_cpu else TwinsForbidden():
        cli_main(arguments)
    if not on_cpu:
        torch.cuda.synchronize()
    report = {
        "launches": {name: counter.launches for name, counter in counters.items()}, "saves": saves, "restores": restores, "steps": steps,
    }
    print("train-cli-child " + json.dumps(report), flush=True)
    return 0


def run_train_cli(arguments: list, log: Path, interrupt: bool, timeout: float):
    """Runs the train CLI in a child process (``chip_smoke.py CHILD_FLAG
    ...``); with ``interrupt``, sends SIGTERM once its first statistics line
    ("epoch N step M: ...") is out. Returns (exit code, stdout lines, the
    child's report, seconds from the signal to the exit or None)."""
    import signal

    command = [sys.executable, str(HERE / "chip_smoke.py"), CHILD_FLAG, *arguments]
    lines, signalled = [], None
    with open(log, "w", encoding="utf-8") as errors:
        process = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=errors, text=True, cwd=str(HERE))
        deadline = time.perf_counter() + timeout
        try:
            for line in process.stdout:
                lines.append(line.rstrip("\n"))
                if interrupt and signalled is None and re.match(r"epoch \d+ step \d+:", line):
                    process.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter()
                check(time.perf_counter() < deadline, f"train CLI child ran past {timeout} s")
            code = process.wait(timeout=max(deadline - time.perf_counter(), 1))
        finally:
            if process.poll() is None:
                process.kill()
                process.wait()
    reports = [json.loads(line.split(" ", 1)[1]) for line in lines if line.startswith("train-cli-child ")]
    stopped = None if signalled is None else time.perf_counter() - signalled
    return code, lines, reports[0] if reports else None, stopped


def write_train_cli_inputs(root: Path):
    """The train CLI phase's inputs under ``root``: a Common Voice corpus of
    2 languages x 16 WAV clips of 2-10 s plus 4 dev clips each (``cv``), the
    demo table (``table.csv``) and the demo config at microbatches of at most
    TRAIN_BATCH x 10 s, A = TRAIN_ACCUMULATION, CLI_EPOCHS epochs
    (``train_cli_config.json``). Returns (corpus, table path, config)."""
    from allophant_tpu_torch.demo import demo_config_dict, demo_feature_table_csv
    from allophant_tpu_torch.phonetics.features import PhoneticAttributeIndexer

    table = PhoneticAttributeIndexer("phoible", demo_feature_table_csv())
    corpus = write_common_voice_corpus(
        root / "cv", {language: table.phoneme_inventory(language) for language in CLI_LANGUAGES}, (2, 10), seed=7
    )
    table_path = root / "table.csv"
    table_path.write_text(demo_feature_table_csv(), encoding="utf-8")
    config = demo_config_dict()
    # Microbatches of TRAIN_BATCH clips of at most 10 s: 2 steps an epoch.
    config["nn"].update(
        batching_mode="utterances",
        batch_size=TRAIN_ACCUMULATION * TRAIN_BATCH,
        accumulation_factor=TRAIN_ACCUMULATION,
        maximum_iterations=CLI_EPOCHS,
    )
    config["data"]["languages"] = list(CLI_LANGUAGES)
    (root / "train_cli_config.json").write_text(json.dumps(config), encoding="utf-8")
    return corpus, table_path, config


def phase_train_cli(results: dict, root: Path) -> None:
    """``allophant_tpu_torch.cli.run train`` on a Common Voice corpus, as a
    user runs it, in child processes so that the signal, the handlers and the
    exit code are real: the full-width flagship from the demo config
    (microbatches of at most 8 x 10 s at A = 2, validation at each epoch's
    end, CLI_EPOCHS epochs), the demo table, a corpus of 2
    languages x 16 WAV clips of 2-10 s plus 4 dev clips each, ``-d -s DIR -w 2``.
    SIGTERM after the first statistics line: exit 0 and ``interrupted.ckpt``
    with optimizer state. Then ``--restore``: it picks ``interrupted.ckpt``,
    resumes at the recorded batch and reaches the last epoch, ending at the
    step count of an uninterrupted run. Launches are counted in each child,
    twins forbidden. If the system MP3 libraries are present, one clip is
    encoded, decoded and compared with its WAV."""
    from allophant_tpu_torch.training.checkpoint import load_checkpoint

    start = time.perf_counter()
    corpus, table_path, config = write_train_cli_inputs(root)
    save_path = root / "checkpoints"
    arguments = [
        "train", str(corpus), "-t", "common-voice", "-j", json.dumps(config), "-a", str(table_path),
        "-d", "-s", str(save_path), "-w", "2",
    ]
    print(f"train CLI: corpus of {sum(CLI_CLIPS.values()) * len(CLI_LANGUAGES)} WAV clips written in {time.perf_counter() - start:.2f} s", flush=True)
    phase_mp3(corpus / CLI_LANGUAGES[0] / "clips" / f"{CLI_LANGUAGES[0]}_train_0.wav")

    readings = []
    for interrupt in (True, False):
        run_arguments = arguments if interrupt else [*arguments, "--restore"]
        started = time.perf_counter()
        code, lines, report, stopped = run_train_cli(run_arguments, root / f"train_cli_{len(readings)}.log", interrupt, timeout=900)
        wall = time.perf_counter() - started
        log = (root / f"train_cli_{len(readings)}.log").read_text(encoding="utf-8", errors="replace")
        statistics = [line for line in lines if re.match(r"epoch \d+ step \d+:", line)]
        if code != 0 or report is None:
            print(log[-4000:], flush=True)
        check(code == 0 and report is not None, f"train CLI run {len(readings) + 1}: exit code {code}")
        readings.append((lines, report, statistics, wall, stopped, log))
        for name, count in report["launches"].items():
            results[name] += count
        print(
            f"train CLI run {len(readings)} ({'SIGTERM after the first statistics line' if interrupt else '--restore'}):"
            f" exit {code} in {wall:.1f} s{'' if stopped is None else f' ({stopped:.1f} s from the signal to the exit)'};"
            f" statistics {statistics}; launches {report['launches']}; saves {report['saves']}; restores {report['restores']}",
            flush=True,
        )

    interrupted_path = save_path / "interrupted.ckpt"
    check(interrupted_path.exists(), "train CLI: no interrupted.ckpt after SIGTERM")
    interrupted = load_checkpoint(str(interrupted_path))
    check(bool(interrupted.optimizer_state), "train CLI: interrupted.ckpt has no optimizer state")
    final = load_checkpoint(str(save_path / f"epoch-{CLI_EPOCHS}.ckpt"))
    (_lines, first, first_statistics, _w, _s, _log), (_lines2, second, second_statistics, _w2, _s2, second_log) = readings
    check(any(line.endswith(str(interrupted_path)) and "Restoring from" in line for line in second_log.splitlines()),
          "train CLI: --restore did not pick interrupted.ckpt")
    check("Training interrupted" in "\n".join(_lines), "train CLI: the first run did not report its interrupted save")
    steps_first, steps_second = int(interrupted.epoch.global_step), int(final.epoch.global_step) - int(interrupted.epoch.global_step)
    # One uninterrupted epoch's steps, from the first run's epoch-1 statistics line.
    per_epoch = int(re.match(r"epoch \d+ step (\d+):", first_statistics[0]).group(1))
    check(int(final.epoch.epoch) == CLI_EPOCHS and int(final.epoch.global_step) == CLI_EPOCHS * per_epoch,
          f"train CLI: resumed run ended at {final.epoch}, expected {CLI_EPOCHS} epochs of {per_epoch} steps")
    check(int(interrupted.epoch.step) > 0 and int(interrupted.epoch.epoch) == 1, f"train CLI: interrupted at {interrupted.epoch}")
    layers = 24
    for label, report, steps in (("first", first, steps_first), ("second", second, steps_second)):
        launches = report["launches"]
        validation_batches = launches["frame_encoder"] - TRAIN_ACCUMULATION * steps
        expected = {
            "oneshot_attention": layers * validation_batches,
            "attention_dropout": TRAIN_ACCUMULATION * layers * steps,
            "attention_backward": TRAIN_ACCUMULATION * layers * steps,
            "dropout_mask": 0,
            "frame_encoder": TRAIN_ACCUMULATION * steps + validation_batches,
        }
        check(validation_batches > 0 and launches == expected, f"train CLI {label} run: launches {launches}, expected {expected}")
    print(
        f"train CLI: interrupted at {interrupted.epoch} with {len(interrupted.optimizer_state)} bytes of optimizer state;"
        f" resumed to {final.epoch}; {per_epoch} steps an epoch; steps {steps_first} + {steps_second}",
        flush=True,
    )


def phase_mp3(wav: Path) -> None:
    """Encodes one WAV clip to MP3 and decodes it with the system libraries
    (libmp3lame, libmpg123) if this machine has them, and compares the two:
    the decoded clip, aligned by its encoder delay, at an SNR of at least
    6 dB (white noise is MP3's worst case, about 10 dB at 128 kbit/s; a
    decode at the wrong rate or layout gives about 0 dB)."""
    from allophant_tpu_torch.data.audio import load_audio
    from allophant_tpu_torch.native import audio_codecs

    if not (audio_codecs.LAME_AVAILABLE and audio_codecs.MPG123_AVAILABLE):
        print(
            f"mp3: skipped, libmp3lame found: {audio_codecs.LAME_AVAILABLE}, libmpg123 found:"
            f" {audio_codecs.MPG123_AVAILABLE}",
            flush=True,
        )
        return
    original, rate = load_audio(str(wav))
    original = original[0]
    path = wav.with_suffix(".mp3")
    audio_codecs.encode_mp3(str(path), original, rate)
    decoded, decoded_rate = audio_codecs.decode_mp3(str(path))
    decoded = decoded[0]
    # The encoder delays and pads the clip: align by the best lag.
    window = min(len(original), len(decoded))
    lags = range(0, max(len(decoded) - window, 0) + 1)
    delay = max(lags, key=lambda lag: float(np.dot(original[:window], decoded[lag : lag + window])))
    aligned = decoded[delay : delay + len(original)]
    count = min(len(aligned), len(original))
    snr = 10 * np.log10(np.sum(original[:count] ** 2) / np.sum((original[:count] - aligned[:count]) ** 2))
    print(f"mp3: {len(original)} samples encoded and decoded at {decoded_rate} Hz, delay {delay}, SNR {snr:.1f} dB", flush=True)
    check(decoded_rate == rate and snr >= 6, "mp3: the decoded clip differs from its WAV")


# The multi-GPU phase: two ranks; the full-width "mixed" steps; the float32
# comparisons' 4-layer depth and audio; the CLI's depth (its checkpoints hold
# Adam's moments: 3.5 GiB at 24 layers).
MULTI_RANKS, MULTI_STEPS, MULTI_F32_LAYERS, MULTI_F32_SAMPLES, MULTI_CLI_LAYERS = 2, 2, 4, 4 * SAMPLE_RATE, 2
# JAX's float32 CTC gradient's largest distance from the float64 one at 500
# and 1,000 frames (tools/torch_ctc_precision.py; logits N(0, 3^2) of
# [2, T, 40], 30 labels a row).
CTC_JAX_DISTANCE = {500: 1.217e-4, 1000: 2.748e-4}
# float32 card limits: metrics 1e-5 relative (grad_norm 3e-5), gradients and
# Adam's first moment within 1e-3 of each leaf's largest (second moment
# 2e-3; a leaf that is zero in exact arithmetic within 1e-6 of the largest of
# all), log-probs 1e-4.
MULTI_METRIC_RTOL, MULTI_NORM_RTOL, MULTI_SHARE, MULTI_SECOND_SHARE, MULTI_FLOOR, MULTI_LOG_PROB_ATOL = (
    1e-5, 3e-5, 1e-3, 2e-3, 1e-6, 1e-4,
)
# The tp = 2 step with every dropout on against the one-device step of the same
# seed: the ranks draw its masks, so only the row-parallel sums' order parts
# them: gradients and Adam's first moment within 1e-5 of each leaf's largest,
# the second moment (squares) within 2e-5.
MULTI_DROPOUT_SEED, MULTI_DROPOUT_SHARE, MULTI_DROPOUT_SECOND_SHARE = 5, 1e-5, 2e-5


def multi_gpu_route():
    """(the two ranks' devices, their group's backend): two cards (NCCL), or
    card 0 twice (gloo: NCCL refuses two ranks on one card)."""
    from allophant_tpu_torch.parallel.mesh import backend

    cards = min(torch.cuda.device_count(), MULTI_RANKS)
    devices = [f"cuda:{rank % cards}" for rank in range(MULTI_RANKS)]
    return devices, backend(devices)


# The tensor-parallel transformer step: the transformer phase's model
# (d_model 512, 8 heads of 64, FFN 2048, 6 layers, 80 filterbanks) with an
# attention classifier of 8 heads on the composed phoneme head, float32, on
# A = 2 microbatches of 8 sequences of 2-4 s.
MULTI_TRANSFORMER_SECONDS, MULTI_TRANSFORMER_HEAD_HEADS = (2, 4), 8


def multi_gpu_transformer_inputs() -> tuple:
    """(``dryrun.config_model``'s inputs, numpy microbatches) of the
    tensor-parallel transformer step, every dropout at 0.1."""
    from allophant_tpu_torch.demo import FLAGSHIP_LANGUAGES, demo_feature_table_csv
    from allophant_tpu_torch.parallel import dryrun
    from allophant_tpu_torch.phonetics.features import LanguageInventories, PhoneticAttributeIndexer

    config = transformer_config_dict(0.1)
    config["nn"]["mixed_precision"] = False
    for entry in config["nn"]["projection"]["classes"]:
        if entry["name"] == "phoneme":
            entry["time_layer"] = {"type": "multi-head-attention", "num_heads": MULTI_TRANSFORMER_HEAD_HEADS, "positional_embeddings": True}
    table = demo_feature_table_csv()
    bootstrap = PhoneticAttributeIndexer("phoible", table)
    codes = list(FLAGSHIP_LANGUAGES[:4])
    inventories = LanguageInventories({index: bootstrap.phoneme_inventory(code) for index, code in enumerate(codes)}, codes)
    model_inputs = {"config": config, "table": table, "inventories": inventories, "feature_size": TRANSFORMER_FEATURES}
    _config, template = dryrun.config_model("cpu", None, model_inputs)
    arrays = transformer_microbatches(template, TRAIN_ACCUMULATION, "cpu", seed=8, seconds=MULTI_TRANSFORMER_SECONDS)
    return model_inputs, {key: value.numpy() for key, value in arrays.items()}


@contextlib.contextmanager
def relu_masks(recorded=None, replayed=None, flips=None):
    """Within it, ``torch.relu`` (which only the transformer's FFN calls)
    either appends each call's mask, ``input > 0`` bit-packed along the last
    axis, to ``recorded``; or multiplies each call's input by the next mask of
    ``replayed`` in place of its own, so that the forward and its gradient
    follow that mask, and appends to ``flips`` (elements whose sign parts from
    the mask, the largest ``|input|`` among them, the largest of all)."""
    relu = torch.relu
    masks = iter(replayed or ())

    def patched(features):
        positive = features > 0
        if recorded is not None:
            recorded.append(np.packbits(positive.cpu().numpy(), axis=-1))
            return relu(features)
        width = features.shape[-1]
        mask = torch.from_numpy(np.unpackbits(next(masks), axis=-1, count=width).astype(bool)).to(features.device)
        flipped = positive != mask
        magnitude = features.detach().abs()
        flips.append((int(flipped.sum()), float(magnitude[flipped].max()) if flipped.any() else 0.0, float(magnitude.max())))
        return features * mask.to(features.dtype)

    torch.relu = patched
    try:
        yield
    finally:
        torch.relu = relu


def transformer_tp_rank_step(mesh, device, inputs: dict, keep_tensors: bool) -> dict:
    """This rank's share of the float32 tp = 2 transformer step with every
    dropout on (seed MULTI_DROPOUT_SEED), twins forbidden, launches counted;
    with this rank's FFN ReLU masks (``relu_masks``: its columns)."""
    from allophant_tpu_torch.parallel import dryrun

    masks = []
    with TwinsForbidden(), relu_masks(recorded=masks):
        (metrics, tensors), launches = counted(
            lambda: dryrun.config_step(mesh, device, inputs["transformer"], inputs["transformer_microbatches"], None, MULTI_DROPOUT_SEED)
        )
    return {"metrics": metrics, "launches": launches, "tensors": tensors if keep_tensors else None, "relu_masks": masks}


def check_transformer_tp(ranks: list, transformer_inputs: dict, transformer_batches: dict, reference: tuple, floor: float) -> dict:
    """The ranks' tp = 2 transformer step (``transformer_tp_rank_step``)
    against this process's one-device step of the same seed (``reference``:
    its metrics and whole tensors; ``floor``: that step's own run-to-run
    distance). ReLU's kink parts the two: the row-parallel sums round
    otherwise, and a pre-activation within that rounding of zero takes the
    other sign, which moves a whole term of its ``linear1`` row's gradient.
    So the one device runs the step again with the ranks' ReLU masks (their
    columns joined), which leaves only the sums' rounding: metrics and every
    leaf are held to it at the wav2vec2 dropout step's limits, and each
    flipped pre-activation to within MULTI_METRIC_RTOL of its call's largest
    ``|h|`` (a rounding-level crossing of 0); against the plain one-device
    step the metrics at the float32 limits, the leaves printed. Returns the
    launches of rank 0."""
    from allophant_tpu_torch.parallel import dryrun

    got = ranks[0]["transformer_tp"]
    metrics, plain = reference
    for key, value in metrics.items():
        rtol = MULTI_NORM_RTOL if key == "grad_norm" else MULTI_METRIC_RTOL
        check(abs(got["metrics"][key] - value) <= rtol * abs(value), f"multi-GPU transformer tp: {key} {got['metrics'][key]} vs one device {value}")
    rank_masks = [result["transformer_tp"]["relu_masks"] for result in ranks]
    check(len({len(masks) for masks in rank_masks}) == 1, "multi-GPU transformer tp: the ranks made other ReLU calls")
    joined = [np.concatenate(calls, axis=-1) for calls in zip(*rank_masks)]
    flips = []
    with relu_masks(replayed=joined, flips=flips):
        replay_metrics, replay = dryrun.config_step(None, "cuda", transformer_inputs, transformer_batches, None, MULTI_DROPOUT_SEED)
    check(len(flips) == len(joined), f"multi-GPU transformer tp: {len(flips)} ReLU calls on one device, {len(joined)} on the ranks")
    for key, value in replay_metrics.items():
        rtol = MULTI_NORM_RTOL if key == "grad_norm" else MULTI_METRIC_RTOL
        check(abs(got["metrics"][key] - value) <= rtol * abs(value),
              f"multi-GPU transformer tp: {key} {got['metrics'][key]} vs one device with the ranks' ReLU masks {value}")
    worst = {
        kind: check_leaves(
            got["tensors"][kind], replay[kind], MULTI_DROPOUT_SECOND_SHARE if kind == "exp_avg_sq" else MULTI_DROPOUT_SHARE,
            f"multi-GPU transformer tp {kind} (one device with the ranks' ReLU masks)",
        )
        for kind in ("grads", "exp_avg", "exp_avg_sq")
    }
    plain_shares = leaf_shares(got["tensors"]["grads"], plain["grads"], MULTI_SHARE)
    plain_leaf = max(plain_shares, key=plain_shares.get)
    flipped = sum(count for count, _largest, _scale in flips)
    kink = max((largest / scale for count, largest, scale in flips if count), default=0.0)
    check(kink <= MULTI_METRIC_RTOL, f"multi-GPU transformer tp: a ReLU pre-activation {kink:.3e} of its call's largest took the other sign")
    layers = transformer_inputs["config"]["nn"]["acoustic_model"]["transformer"]["num_layers"]
    print(
        f"multi-GPU tp = 2 float32 transformer step (d_model 512, {layers} layers of 8 heads, FFN 2048, an attention classifier of"
        f" {MULTI_TRANSFORMER_HEAD_HEADS} heads on the phoneme head; every dropout 0.1; K5 and K4 at heads 4..7 of 8 on rank 1),"
        f" seed {MULTI_DROPOUT_SEED}: against one device with the ranks' ReLU masks: loss {got['metrics']['mean_loss']:.6f} vs"
        f" {replay_metrics['mean_loss']:.6f}, grad_norm {got['metrics']['grad_norm']:.6f} vs {replay_metrics['grad_norm']:.6f},"
        f" worst share of a leaf's largest {worst} (limits {MULTI_DROPOUT_SHARE}, second moment {MULTI_DROPOUT_SECOND_SHARE});"
        f" ReLU pre-activations of another sign than one device's: {flipped} of {sum(mask.size * 8 for mask in joined)} over"
        f" {len(flips)} calls (per call {[count for count, _largest, _scale in flips]}), the largest |pre-activation| among them"
        f" {kink:.3e} of its call's largest; against the plain one-device step: loss {metrics['mean_loss']:.6f}, gradients"
        f" {plain_shares[plain_leaf]:.3e} of a leaf's largest at {plain_leaf} (the one-device step twice: {floor:.3e});"
        f" launches {got['launches']}",
        flush=True,
    )
    return got["launches"]


# Batch axis of each prediction array: grids [H, B, T'+1], beam tokens
# [H, T, B, K], beam scores [H, B, K], log-probs [B, T, C].
MULTI_BATCH_AXES = {"grid": 1, "beam_tokens": 2, "beam_scores": 1}


def multi_gpu_requests(estimator, share=None) -> dict:
    """Float32 greedy grids, beam-4 tokens and scores and batch-first
    log-probs of the serving requests, on the host. With ``share=(rank,
    ranks)``: of the rows ``Estimator.use_data_parallel`` gives that data
    rank (the batch padded with copies of its last row), alone."""
    from allophant_tpu_torch.data.batch import Batch

    heads = tuple(estimator.classes)
    results = {}
    for index, (_name, request) in enumerate(serving_requests()):
        batch, features = request["batch"], request.get("target_feature_indices")
        if share is not None:
            rank, ranks = share
            size = len(batch.lengths)
            local = -(-size // ranks)
            rows = np.minimum(np.arange(rank * local, (rank + 1) * local), size - 1)
            language_ids = np.broadcast_to(np.asarray(batch.language_ids), (size,))
            batch = Batch(np.asarray(batch.audio_features)[rows], np.asarray(batch.lengths)[rows], language_ids[rows])
        allophones = request.get("map_allophones", False)
        grid, _lengths = estimator.predict_decoded(batch, features, heads=heads, map_allophones=allophones)
        collected, scores, _lengths = estimator.predict_beam_decoded(batch, features, heads=heads, beam_width=4, map_allophones=allophones)
        log_probs = estimator.predict(batch, features, time_major=False).outputs
        results[index] = {
            "grid": grid.to(torch.int32).cpu().numpy(),
            "beam_tokens": collected.cpu().numpy(),
            "beam_scores": scores.cpu().numpy(),
            **{f"log_probs/{name}": value.cpu().numpy() for name, value in log_probs.items()},
        }
    return results


def multi_gpu_joined(shares: list, sizes: dict) -> dict:
    """The whole batches' arrays from each data rank's ``multi_gpu_requests``
    (its share), joined along the batch axis and cut to the real rows."""
    return {
        index: {
            key: np.take(
                np.concatenate([share[index][key] for share in shares], axis=MULTI_BATCH_AXES.get(key, 0)),
                np.arange(sizes[index]), axis=MULTI_BATCH_AXES.get(key, 0),
            )
            for key in shares[0][index]
        }
        for index in shares[0]
    }


def multi_gpu_distance(got: dict, expected: dict) -> tuple:
    """(largest log-prob or beam-score distance, integer cells that differ);
    the distances in float64, where a float32 difference is exact."""
    worst, differing = 0.0, 0
    for index, arrays in expected.items():
        for key, value in arrays.items():
            check(got[index][key].shape == value.shape, f"multi-GPU serve request {index} {key}: shape {got[index][key].shape} vs {value.shape}")
            if key.startswith("log_probs/") or key == "beam_scores":
                worst = max(worst, float(np.abs(got[index][key].astype(np.float64) - value).max()))
            else:
                differing += int((got[index][key] != value).sum())
    return worst, differing


def multi_gpu_mixed_steps(mesh, device) -> dict:
    """MULTI_STEPS steps of the full-width training flagship ("mixed", the
    flagship's dropout, A = 2) on this rank's 4 rows of B = 8 x 10 s, twins
    forbidden, launches counted; step ms, the gradient all-reduce's ms (the
    same buckets, timed alone after the steps) and this rank's peak GiB."""
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.parallel.mesh import process_local_slice
    from allophant_tpu_torch.training import train_step

    torch.cuda.reset_peak_memory_stats(device)
    config, model = build_flagship_for_training(seed=0, precision="mixed", device=device, mesh=mesh)
    optimizer = train_step.create_optimizer(config, model.architecture.hidden_size, model.parameters())
    step = train_step.make_train_step(
        model, optimizer, train_step.build_loss_plan(config, True), train_step.build_freeze_plan(config.acoustic_model), mesh
    )
    microbatches = training_microbatches(model, TRAIN_ACCUMULATION, TRAIN_BATCH, TRAIN_SECONDS * SAMPLE_RATE, "cpu")
    rows = process_local_slice(TRAIN_BATCH, mesh)
    local = {key: value[:, rows].contiguous().to(device) for key, value in microbatches.items()}
    readings = []
    with TwinsForbidden():
        for index in range(MULTI_STEPS):
            rng = DropoutRng.for_mesh((config.seed or 0) + index, device, mesh)
            started = time.perf_counter()
            metrics, launches = counted(lambda: step(local, rng, index))
            readings.append({"ms": (time.perf_counter() - started) * 1e3, "launches": launches, "mean_loss": metrics["mean_loss"], "grad_norm": metrics["grad_norm"]})
    grads = [parameter.grad for parameter in model.parameters()]
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize(device)
        started = time.perf_counter()
        train_step.all_reduce_gradients(grads, mesh.data_group)
        torch.cuda.synchronize(device)
        reduce_ms.append((time.perf_counter() - started) * 1e3)
    gradient_bytes = sum(grad.numel() * grad.element_size() for grad in grads)
    return {
        "steps": readings,
        "all_reduce_ms": float(np.median(reduce_ms)),
        "gradient_bytes": gradient_bytes,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
    }


def multi_gpu_rank(rank: int, world_size: int, device, inputs_path: str, output_path: str) -> None:
    """One rank of the multi-GPU phase (spawned by ``parallel.launch.spawn``):
    the full-width mixed dp = 2 steps, the float32 4-layer dp = 2 and
    tp = 2 steps (and a tp = 2 step with every dropout on, K5 at 8 heads of
    the 16), the float32 tp = 2 transformer step with every dropout on, and
    ``use_data_parallel``'s float32 predictions of the serving requests, each with twins forbidden and launches counted. Writes its
    readings to ``output_path`` with its rank in the name; rank 0 also the
    whole gradients and moments of the float32 steps and the predictions."""
    import warnings as warning_filters

    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.parallel import dryrun
    from allophant_tpu_torch.parallel.mesh import create_mesh
    from allophant_tpu_torch.phonetics.features import SingletonFeatureWarning

    warning_filters.simplefilter("ignore", SingletonFeatureWarning)
    inputs = torch.load(inputs_path, weights_only=False)
    data_mesh = create_mesh(MULTI_RANKS, 1)
    model_mesh = create_mesh(1, MULTI_RANKS)
    results = {"device": str(device), "mixed": multi_gpu_mixed_steps(data_mesh, device)}
    torch.cuda.empty_cache()
    shallow = Wav2Vec2Architecture(num_hidden_layers=MULTI_F32_LAYERS)
    for label, mesh, architecture, seed in (
        ("f32_dp", data_mesh, shallow, None),
        ("f32_tp", model_mesh, shallow, None),
        ("tp_dropout", model_mesh, shallow, MULTI_DROPOUT_SEED),
    ):
        with TwinsForbidden():
            (metrics, tensors), launches = counted(
                lambda: dryrun.sharded_step(mesh, device, inputs["f32_microbatches"], None, seed, architecture)
            )
        results[label] = {"metrics": metrics, "launches": launches, "tensors": tensors if rank == 0 else None}
        torch.cuda.empty_cache()
    results["transformer_tp"] = transformer_tp_rank_step(model_mesh, device, inputs, rank == 0)
    torch.cuda.empty_cache()
    from allophant_tpu_torch.ops.beam_kernel import backtrace_cuda, beam_search_cuda

    estimator = dryrun.serving_flagship(device, architecture=Wav2Vec2Architecture()).use_data_parallel(data_mesh)
    beam_search_cuda.launches = backtrace_cuda.launches = 0
    with TwinsForbidden():
        predictions, launches = counted(lambda: multi_gpu_requests(estimator))
    launches.update(beam_search=beam_search_cuda.launches, beam_backtrace=backtrace_cuda.launches)
    results["serve"] = {"launches": launches, "predictions": predictions if rank == 0 else None}
    torch.save(results, output_path.format(rank=rank))


def leaf_shares(got: dict, expected: dict, share: float) -> dict:
    """Per leaf name: its largest distance over its scale, the larger of the
    leaf's largest magnitude and MULTI_FLOOR / ``share`` of the largest of all
    leaves."""
    floor = MULTI_FLOOR * max(np.abs(value).max() for value in expected.values())
    return {
        name: float(np.abs(got[name] - value).max()) / max(float(np.abs(value).max()), floor / share)
        for name, value in expected.items()
    }


def check_leaves(got: dict, expected: dict, share: float, label: str) -> float:
    """Per leaf: within ``share`` of the leaf's largest magnitude, or
    MULTI_FLOOR of the largest of all leaves; returns the worst share."""
    check(set(got) == set(expected), f"{label}: other leaves")
    shares = leaf_shares(got, expected, share)
    for name, value in shares.items():
        check(value <= share, f"{label} {name}: {value:.3e} of its scale off, limit {share}")
    return max(shares.values())


def phase_ctc_long(card: str) -> None:
    """Part of the CTC repair, on the card: at 500 and 1,000 frames the port's
    CTC gradient (f32 log-probs, F.ctc_loss's recursion in f64) lies no
    farther from the float64 gradient than JAX's float32 CTC does."""
    from allophant_tpu_torch.ops import ctc

    for time_steps, limit in CTC_JAX_DISTANCE.items():
        rng = np.random.default_rng(time_steps)
        logits = (3 * rng.standard_normal((2, time_steps, 40))).astype(np.float32)
        labels = torch.from_numpy(rng.integers(1, 40, (2, 30))).cuda()
        label_lengths, lengths = torch.full((2,), 30).cuda(), torch.full((2,), time_steps).cuda()
        tensor = torch.from_numpy(logits).cuda().requires_grad_()
        ctc.ctc_loss_sum_heads([("head", tensor, labels, label_lengths)], lengths)["head"].backward()
        exact = torch.from_numpy(logits.astype(np.float64)).cuda().requires_grad_()
        F.ctc_loss(torch.log_softmax(exact, -1).transpose(0, 1), labels, lengths, label_lengths, reduction="sum").backward()
        distance = float((tensor.grad.double() - exact.grad).abs().max())
        print(f"ctc: T = {time_steps}: the port's gradient {distance:.3e} from float64 (JAX float32: {limit:.3e}); {card}", flush=True)
        check(distance <= limit, f"ctc: T = {time_steps}: {distance:.3e} from float64, JAX's float32 lies {limit:.3e}")


def run_train_cli_ranks(arguments: list, root: Path, label: str, interrupt: bool, timeout: float):
    """The train CLI in MULTI_RANKS child processes under torchrun's
    environment variables (``chip_smoke.py CHILD_FLAG --layers N ...``); with
    ``interrupt``, SIGTERM to the last rank alone once rank 0's first
    statistics line is out. Returns (exit codes, rank 0's stdout lines, the
    ranks' reports, the last rank's stdout lines)."""
    import signal
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    processes, logs = [], []
    for rank in range(MULTI_RANKS):
        environment = {
            **os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(MULTI_RANKS),
            "LOCAL_WORLD_SIZE": str(MULTI_RANKS), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        }
        logs.append(open(root / f"{label}_rank{rank}.log", "w", encoding="utf-8"))
        processes.append(
            subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), CHILD_FLAG, "--layers", str(MULTI_CLI_LAYERS), *arguments],
                stdout=subprocess.PIPE, stderr=logs[-1], text=True, cwd=str(HERE), env=environment,
            )
        )
    deadline = time.perf_counter() + timeout
    lines, signalled = [], False
    try:
        for line in processes[0].stdout:
            lines.append(line.rstrip("\n"))
            if interrupt and not signalled and re.match(r"epoch \d+ step \d+:", line):
                processes[-1].send_signal(signal.SIGTERM)
                signalled = True
            check(time.perf_counter() < deadline, f"{label}: ran past {timeout} s")
        others = processes[-1].stdout.read().splitlines()
        codes = [process.wait(timeout=max(deadline - time.perf_counter(), 1)) for process in processes]
    finally:
        for process, log in zip(processes, logs):
            if process.poll() is None:
                process.kill()
                process.wait()
            log.close()
    reports = [json.loads(line.split(" ", 1)[1]) for line in (lines, others) for line in line if line.startswith("train-cli-child ")]
    return codes, lines, reports, others


def phase_multi_gpu_cli(results: dict, root: Path, card: str) -> None:
    """``allophant train`` over two ranks (torchrun's variables) on the train
    CLI phase's Common Voice corpus, the flagship cut to MULTI_CLI_LAYERS
    layers: SIGTERM to the last rank after rank 0's first statistics line
    stops both after the same step, rank 0 alone writes ``interrupted.ckpt``
    and reports it, and ``--restore`` on both resumes to the last epoch;
    launches counted on every rank, twins forbidden."""
    from allophant_tpu_torch.training.checkpoint import load_checkpoint

    config = json.loads((root / "train_cli_config.json").read_text(encoding="utf-8"))
    save_path = root / "multi_checkpoints"
    arguments = [
        "train", str(root / "cv"), "-t", "common-voice", "-j", json.dumps(config), "-a", str(root / "table.csv"),
        "-d", "-s", str(save_path),
    ]
    runs = []
    for interrupt in (True, False):
        label = f"multi_cli_{len(runs)}"
        started = time.perf_counter()
        codes, lines, reports, others = run_train_cli_ranks(
            arguments if interrupt else [*arguments, "--restore"], root, label, interrupt, timeout=600
        )
        if any(codes) or len(reports) != MULTI_RANKS:
            for rank in range(MULTI_RANKS):
                print((root / f"{label}_rank{rank}.log").read_text(encoding="utf-8", errors="replace")[-3000:], flush=True)
        check(not any(codes) and len(reports) == MULTI_RANKS, f"{label}: exit codes {codes}, {len(reports)} reports")
        check(not any("Training interrupted" in line or re.match(r"epoch \d+ step", line) for line in others), f"{label}: the last rank printed")
        for report in reports:
            for name, count in report["launches"].items():
                results[name] += count
        runs.append((lines, reports))
        statistics = [line for line in lines if re.match(r"epoch \d+ step \d+:", line)]
        print(
            f"multi-GPU train CLI run {len(runs)} ({'SIGTERM to rank 1 after the first statistics line' if interrupt else '--restore'}):"
            f" exit {codes} in {time.perf_counter() - started:.1f} s; statistics {statistics};"
            f" launches by rank {[report['launches'] for report in reports]}; saves by rank {[report['saves'] for report in reports]}; {card}",
            flush=True,
        )
    first_lines = runs[0][0]
    check(sum("Training interrupted; state saved to" in line for line in first_lines) == 1, "multi-GPU train CLI: interrupted.ckpt not reported once")
    interrupted = load_checkpoint(str(save_path / "interrupted.ckpt"))
    final = load_checkpoint(str(save_path / f"epoch-{CLI_EPOCHS}.ckpt"))
    check(bool(interrupted.optimizer_state) and int(interrupted.epoch.step) > 0, f"multi-GPU train CLI: interrupted at {interrupted.epoch}")
    check(int(final.epoch.epoch) == CLI_EPOCHS, f"multi-GPU train CLI: resumed run ended at {final.epoch}")
    for lines, reports in runs:
        launches = [report["launches"] for report in reports]
        check(launches[0] == launches[1], f"multi-GPU train CLI: the ranks launched differently: {launches}")
        check(launches[0]["attention_dropout"] > 0 and launches[0]["attention_backward"] == launches[0]["attention_dropout"],
              f"multi-GPU train CLI: launches {launches[0]}")
    print(
        f"multi-GPU train CLI: both ranks stopped at {interrupted.epoch}; resumed to {final.epoch}; checkpoints"
        f" {sorted(path.name for path in save_path.iterdir())}",
        flush=True,
    )


def phase_multi_gpu_launch(root: Path, card: str) -> None:
    """A plain ``allophant train`` (no torchrun) on MULTI_RANKS visible cards
    (``CUDA_VISIBLE_DEVICES``), the full-width flagship on the train CLI
    phase's corpus: the CLI spawns one rank a card over NCCL. SIGTERM to the
    launching process after the first statistics line reaches every rank
    (each logs it), they stop after the same step, and the launcher exits 0
    with ``interrupted.ckpt`` written once. Needs MULTI_RANKS cards."""
    import signal

    from allophant_tpu_torch.training.checkpoint import load_checkpoint

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(index) for index in range(torch.cuda.device_count())]
    save_path = root / "launch_checkpoints"
    config = (root / "train_cli_config.json").read_text(encoding="utf-8")
    arguments = [
        "train", str(root / "cv"), "-t", "common-voice", "-j", config, "-a", str(root / "table.csv"), "-d", "-s", str(save_path),
    ]
    log_path = root / "multi_launch.log"
    started = time.perf_counter()
    with open(log_path, "w", encoding="utf-8") as log:
        launcher = subprocess.Popen(
            [sys.executable, "-m", "allophant_tpu_torch.cli.run", *arguments],
            stdout=subprocess.PIPE, stderr=log, text=True, cwd=str(HERE),
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ",".join(cards[:MULTI_RANKS]), "PYTHONPATH": str(HERE)},
        )
        lines, signalled = [], None
        try:
            for line in launcher.stdout:
                lines.append(line.rstrip("\n"))
                if signalled is None and re.match(r"epoch \d+ step \d+:", line):
                    launcher.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter()
            code = launcher.wait(timeout=300)
        finally:
            if launcher.poll() is None:
                launcher.send_signal(signal.SIGTERM)
                launcher.send_signal(signal.SIGTERM)
                time.sleep(5)
                launcher.kill()
                launcher.wait()
    errors = log_path.read_text(encoding="utf-8", errors="replace")
    if code != 0:
        print(errors[-4000:], flush=True)
    check(code == 0 and signalled is not None, f"multi-GPU plain launch: exit code {code}, signalled {signalled is not None}")
    received = errors.count("Received SIGTERM")
    check(received == MULTI_RANKS, f"multi-GPU plain launch: {received} ranks logged the SIGTERM, expected {MULTI_RANKS}")
    check(sum("Training interrupted; state saved to" in line for line in lines) == 1, "multi-GPU plain launch: interrupted.ckpt not reported once")
    interrupted = load_checkpoint(str(save_path / "interrupted.ckpt"))
    check(bool(interrupted.optimizer_state) and int(interrupted.epoch.step) > 0, f"multi-GPU plain launch: interrupted at {interrupted.epoch}")
    print(
        f"multi-GPU plain launch on cards {cards[:MULTI_RANKS]} (CUDA_VISIBLE_DEVICES), full width: SIGTERM to the launcher"
        f" reached {received} ranks; exit {code} in {time.perf_counter() - started:.1f} s"
        f" ({time.perf_counter() - signalled:.1f} s from the signal); stopped at {interrupted.epoch};"
        f" statistics {[line for line in lines if re.match(r'epoch \d+ step \d+:', line)]}; {card}",
        flush=True,
    )


# The whole plain run over two cards: the transformer at 2 layers, dropout 0,
# float32, WHOLE_RUN_EPOCHS epochs, then --restore for one more.
WHOLE_RUN_LAYERS, WHOLE_RUN_EPOCHS = 2, 2


def whole_run_config(root: Path, epochs: int) -> dict:
    """The train CLI phase's config with the transformer phase's acoustic
    model cut to WHOLE_RUN_LAYERS layers, every dropout 0, float32, on 80
    filterbanks computed on the fly, ``epochs`` epochs."""
    config = json.loads((root / "train_cli_config.json").read_text(encoding="utf-8"))
    transformer = transformer_config_dict(0.0)
    transformer["nn"]["acoustic_model"]["transformer"]["num_layers"] = WHOLE_RUN_LAYERS
    config["nn"]["acoustic_model"] = transformer["nn"]["acoustic_model"]
    config["preprocessing"] = transformer["preprocessing"]
    config["nn"]["projection"]["acoustic_model_dropout"] = 0.0
    config["nn"].update(mixed_precision=False, maximum_iterations=epochs)
    return config


def phase_multi_gpu_whole_run(root: Path, card: str) -> None:
    """A plain ``allophant train`` (no torchrun) over two visible cards, which
    spawns a rank a card over NCCL, to its end, then ``--restore`` for one
    more epoch; the same two runs in one process on one card. The last
    epoch's checkpoints hold the same parameters within the data-parallel
    limits: each leaf within MULTI_SHARE of its largest magnitude. Needs
    MULTI_RANKS cards."""
    from allophant_tpu_torch.training.checkpoint import load_checkpoint

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(index) for index in range(torch.cuda.device_count())]
    finals, seconds = {}, {}
    for label, devices in (("two cards", cards[:MULTI_RANKS]), ("one process", cards[:1])):
        save_path = root / f"whole_run_{len(devices)}"
        started = time.perf_counter()
        for epochs, extra in ((WHOLE_RUN_EPOCHS, []), (WHOLE_RUN_EPOCHS + 1, ["--restore"])):
            arguments = [
                "train", str(root / "cv"), "-t", "common-voice", "-j", json.dumps(whole_run_config(root, epochs)),
                "-a", str(root / "table.csv"), "-d", "-s", str(save_path), *extra,
            ]
            log_path = root / f"whole_run_{len(devices)}_{epochs}.log"
            with open(log_path, "w", encoding="utf-8") as log:
                run = subprocess.run(
                    [sys.executable, "-m", "allophant_tpu_torch.cli.run", *arguments], stdin=subprocess.DEVNULL,
                    stdout=subprocess.PIPE, stderr=log, text=True, cwd=str(HERE), timeout=900,
                    env={**os.environ, "CUDA_VISIBLE_DEVICES": ",".join(devices), "PYTHONPATH": str(HERE)},
                )
            if run.returncode != 0:
                print(log_path.read_text(encoding="utf-8", errors="replace")[-4000:], flush=True)
            check(run.returncode == 0, f"multi-GPU whole run on {label}, {epochs} epochs: exit code {run.returncode}")
        seconds[label] = time.perf_counter() - started
        final = load_checkpoint(str(save_path / f"epoch-{WHOLE_RUN_EPOCHS + 1}.ckpt"))
        check(int(final.epoch.epoch) == WHOLE_RUN_EPOCHS + 1, f"multi-GPU whole run on {label}: ended at {final.epoch}")
        finals[label] = {"/".join(path): np.asarray(value) for path, value in tree_leaves(final.variables["params"])}
    worst = check_leaves(finals["two cards"], finals["one process"], MULTI_SHARE, "multi-GPU whole run parameters")
    print(
        f"multi-GPU whole run: plain train over cards {cards[:MULTI_RANKS]} to epoch {WHOLE_RUN_EPOCHS}, then --restore to epoch"
        f" {WHOLE_RUN_EPOCHS + 1} (transformer, {WHOLE_RUN_LAYERS} layers, dropout 0, float32): {seconds['two cards']:.1f} s;"
        f" the same in one process {seconds['one process']:.1f} s; the last checkpoints' parameters worst share of a leaf's"
        f" largest {worst:.3e} (limit {MULTI_SHARE}); {card}",
        flush=True,
    )


def phase_multi_gpu(results: dict, root: Path) -> None:
    """Two ranks on the card(s), one process each (``parallel/``): NCCL over
    two cards, or gloo with both on card 0 (correctness, not scaling). The
    kernels are built (phase 2) before the ranks start. Then:
    1. the full-width flagship, "mixed", A = 2, global B = 8 x 10 s (4 rows a
       rank), MULTI_STEPS steps at dp = 2: K5 and K4 48 times a step and K2
       twice on each rank, twins forbidden; step ms, all-reduce ms, peak GiB;
    2. a full-width 4-layer flagship in float32, dropout off: one dp = 2 and
       one tp = 2 step (8 heads of 64 a rank), each equal to this process's
       one-device step; a tp = 2 step with every dropout on, equal to the
       one-device step of the same seed (K5 and K4 at 8 of 16 heads); the
       same of the transformer (6 layers, d_model 512) with an attention
       classifier on its head, against one device given the ranks' ReLU
       masks (``check_transformer_tp``);
    3. ``use_data_parallel`` greedy and beam-4 over the serving requests in
       float32: log-probs within 1e-4 of one device, grid cells that differ
       counted (0 expected);
    4. ``allophant train`` over two ranks (``phase_multi_gpu_cli``); on two
       or more cards also the plain launch stopped by SIGTERM
       (``phase_multi_gpu_launch``) and a whole plain run and its resumption
       against one process (``phase_multi_gpu_whole_run``);
    5. the CTC gradient at 500 and 1,000 frames (``phase_ctc_long``)."""
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.parallel import dryrun, launch

    card = phase_card()
    devices, backend = multi_gpu_route()
    print(f"multi-GPU: {MULTI_RANKS} ranks on {devices} over {backend}"
          f"{'' if backend == 'nccl' else ' (one card: two ranks share it, which proves correctness, not scaling)'}", flush=True)
    started = time.perf_counter()
    phase_ctc_long(card)

    # This process's one-device references.
    shallow = Wav2Vec2Architecture(num_hidden_layers=MULTI_F32_LAYERS)
    _config, template = dryrun.tiny_flagship("cpu", architecture=dataclasses.replace(shallow, num_hidden_layers=1))
    microbatches = {
        key: value.numpy()
        for key, value in training_microbatches(template, TRAIN_ACCUMULATION, TRAIN_BATCH, MULTI_F32_SAMPLES, "cpu", seed=3).items()
    }
    del template
    reference_metrics, reference = dryrun.sharded_step(None, "cuda", microbatches, None, None, shallow)
    dropout_metrics, dropout_reference = dryrun.sharded_step(None, "cuda", microbatches, None, MULTI_DROPOUT_SEED, shallow)
    torch.cuda.empty_cache()
    estimator = dryrun.serving_flagship("cuda", architecture=Wav2Vec2Architecture())
    whole_batches = multi_gpu_requests(estimator)
    sizes = {index: len(request["batch"].lengths) for index, (_name, request) in enumerate(serving_requests())}
    same_rows = multi_gpu_joined([multi_gpu_requests(estimator, (rank, MULTI_RANKS)) for rank in range(MULTI_RANKS)], sizes)
    del estimator
    torch.cuda.empty_cache()
    transformer_inputs, transformer_batches = multi_gpu_transformer_inputs()
    transformer_metrics, transformer_reference = dryrun.config_step(
        None, "cuda", transformer_inputs, transformer_batches, None, MULTI_DROPOUT_SEED
    )
    # The one-device step again: the card's own run-to-run distance (ATen's
    # CUDA CTC backward accumulates with atomics), printed beside the ranks'
    # on the same scales.
    _metrics, transformer_again = dryrun.config_step(None, "cuda", transformer_inputs, transformer_batches, None, MULTI_DROPOUT_SEED)
    transformer_floor = max(leaf_shares(transformer_again["grads"], transformer_reference["grads"], MULTI_SHARE).values())
    del transformer_again
    torch.cuda.empty_cache()

    workdir = root / "multi_gpu"
    workdir.mkdir()
    inputs, outputs = str(workdir / "inputs.pt"), str(workdir / "rank{rank}.pt")
    torch.save(
        {"f32_microbatches": microbatches, "transformer": transformer_inputs, "transformer_microbatches": transformer_batches}, inputs
    )
    spawned = time.perf_counter()
    launch.spawn(multi_gpu_rank, str(workdir), devices, (inputs, outputs))
    ranks = [torch.load(outputs.format(rank=rank), weights_only=False) for rank in range(MULTI_RANKS)]
    print(f"multi-GPU: ranks ran in {time.perf_counter() - spawned:.1f} s", flush=True)

    layers = Wav2Vec2Architecture().num_hidden_layers
    for rank, result in enumerate(ranks):
        mixed = result["mixed"]
        step_ms = ", ".join(f"{reading['ms']:.1f}" for reading in mixed["steps"])
        for index, reading in enumerate(mixed["steps"]):
            expected = {
                "oneshot_attention": 0, "attention_dropout": TRAIN_ACCUMULATION * layers,
                "attention_backward": TRAIN_ACCUMULATION * layers, "dropout_mask": 0, "frame_encoder": TRAIN_ACCUMULATION,
            }
            check(reading["launches"] == expected, f"multi-GPU rank {rank} step {index}: launches {reading['launches']}, expected {expected}")
            check(np.isfinite(reading["mean_loss"]) and np.isfinite(reading["grad_norm"]), f"multi-GPU rank {rank}: non-finite step")
            for name, count in reading["launches"].items():
                results[name] += count
        print(
            f"multi-GPU rank {rank} ({result['device']}): mixed full-width dp = 2 steps of 4 rows x 10 s at A = 2:"
            f" {step_ms} ms"
            f" (loss {mixed['steps'][-1]['mean_loss']:.4f}, grad_norm {mixed['steps'][-1]['grad_norm']:.4f});"
            f" gradient all-reduce {mixed['all_reduce_ms']:.2f} ms for {mixed['gradient_bytes'] / 2**20:.1f} MiB over {backend};"
            f" peak {mixed['peak_gib']:.2f} GiB; launches a step {mixed['steps'][0]['launches']}; {card}",
            flush=True,
        )
        check(mixed["steps"][-1]["mean_loss"] == ranks[0]["mixed"]["steps"][-1]["mean_loss"], "multi-GPU: the ranks' losses differ")
        for label in ("f32_dp", "f32_tp", "tp_dropout", "transformer_tp", "serve"):
            for name, count in result[label]["launches"].items():
                results[name] += count

    f32_layers = MULTI_F32_LAYERS
    for label in ("f32_dp", "f32_tp"):
        got = ranks[0][label]
        for key, value in reference_metrics.items():
            rtol = MULTI_NORM_RTOL if key == "grad_norm" else MULTI_METRIC_RTOL
            check(abs(got["metrics"][key] - value) <= rtol * abs(value), f"multi-GPU {label}: {key} {got['metrics'][key]} vs one device {value}")
        worst = {
            kind: check_leaves(
                got["tensors"][kind], reference[kind], MULTI_SECOND_SHARE if kind == "exp_avg_sq" else MULTI_SHARE, f"multi-GPU {label} {kind}"
            )
            for kind in ("grads", "exp_avg", "exp_avg_sq")
        }
        # Float32 attention without dropout: K1 forward, K4 backward.
        expected = {"oneshot_attention": f32_layers * (TRAIN_ACCUMULATION + 1), "attention_dropout": 0,
                    "attention_backward": f32_layers * TRAIN_ACCUMULATION, "dropout_mask": 0, "frame_encoder": TRAIN_ACCUMULATION + 1}
        check(got["launches"] == expected, f"multi-GPU {label}: launches {got['launches']}, expected {expected}")
        print(
            f"multi-GPU {label}: float32 {f32_layers}-layer step equals one device: loss {got['metrics']['mean_loss']:.6f}"
            f" vs {reference_metrics['mean_loss']:.6f}, grad_norm {got['metrics']['grad_norm']:.6f} vs {reference_metrics['grad_norm']:.6f};"
            f" worst share of a leaf's largest {worst}; launches {got['launches']}",
            flush=True,
        )
    got = ranks[0]["tp_dropout"]
    for key, value in dropout_metrics.items():
        rtol = MULTI_NORM_RTOL if key == "grad_norm" else MULTI_METRIC_RTOL
        check(abs(got["metrics"][key] - value) <= rtol * abs(value), f"multi-GPU tp dropout: {key} {got['metrics'][key]} vs one device {value}")
    worst = {
        kind: check_leaves(
            got["tensors"][kind], dropout_reference[kind],
            MULTI_DROPOUT_SECOND_SHARE if kind == "exp_avg_sq" else MULTI_DROPOUT_SHARE, f"multi-GPU tp dropout {kind}",
        )
        for kind in ("grads", "exp_avg", "exp_avg_sq")
    }
    # The check_fused_ctc forward runs K1; the step K5 and K4 a layer and microbatch.
    expected = {"oneshot_attention": f32_layers, "attention_dropout": f32_layers * TRAIN_ACCUMULATION,
                "attention_backward": f32_layers * TRAIN_ACCUMULATION, "dropout_mask": 0, "frame_encoder": TRAIN_ACCUMULATION + 1}
    check(got["launches"] == expected, f"multi-GPU tp dropout: launches {got['launches']}, expected {expected}")
    print(
        f"multi-GPU tp = 2 float32 {f32_layers}-layer step with every dropout on (attention, activation, hidden, the heads' tap;"
        f" K5 and K4 at heads 8..15 of 16 on rank 1) equals the one-device step of seed {MULTI_DROPOUT_SEED}: loss"
        f" {got['metrics']['mean_loss']:.6f} vs {dropout_metrics['mean_loss']:.6f}, grad_norm {got['metrics']['grad_norm']:.6f}"
        f" vs {dropout_metrics['grad_norm']:.6f}; worst share of a leaf's largest {worst}; launches {got['launches']}",
        flush=True,
    )

    transformer_launches = check_transformer_tp(
        ranks, transformer_inputs, transformer_batches, (transformer_metrics, transformer_reference), transformer_floor
    )
    transformer_layers = transformer_inputs["config"]["nn"]["acoustic_model"]["transformer"]["num_layers"]
    # The check_fused_ctc forward runs K1; the step K5 and K4 a layer and microbatch.
    expected = {"oneshot_attention": transformer_layers, "attention_dropout": transformer_layers * TRAIN_ACCUMULATION,
                "attention_backward": transformer_layers * TRAIN_ACCUMULATION, "dropout_mask": 0, "frame_encoder": 0}
    check(transformer_launches == expected, f"multi-GPU transformer tp: launches {transformer_launches}, expected {expected}")

    # The ranks against one device on the same rows (each rank's share run
    # alone), which they must equal; and against one device on the whole
    # batches, which differs by the float32 GEMMs' and convolutions' rounding
    # at another batch size (cuBLAS and cuDNN pick kernels by shape), printed.
    served = ranks[0]["serve"]["predictions"]
    worst, differing = multi_gpu_distance(served, same_rows)
    whole_worst, whole_differing = multi_gpu_distance(served, whole_batches)
    floor_worst, floor_differing = multi_gpu_distance(same_rows, whole_batches)
    print(
        f"multi-GPU use_data_parallel over {len(sizes)} serving requests (float32, greedy and beam 4): against one device on the"
        f" same rows: log-probs and beam scores {worst:.3e} off (limit {MULTI_LOG_PROB_ATOL}), {differing} grid and beam cells differ;"
        f" against one device on the whole batches: {whole_worst:.3e} off, {whole_differing} cells differ (one device, whole"
        f" batches against the same rows in {MULTI_RANKS} shares: {floor_worst:.3e}, {floor_differing} cells);"
        f" launches a rank {[result['serve']['launches'] for result in ranks]}",
        flush=True,
    )
    check(worst <= MULTI_LOG_PROB_ATOL, f"multi-GPU serve: log-probs {worst:.3e} from one device on the same rows")
    # The ranks stand as far from the whole batches as one device on the same
    # rows does, up to their own distance from it: nothing rank-specific adds.
    check(abs(whole_worst - floor_worst) <= worst and (differing or whole_differing == floor_differing),
          f"multi-GPU serve: against the whole batches {whole_worst:.3e} and {whole_differing} cells, one device on the same"
          f" rows {floor_worst:.3e} and {floor_differing} cells")
    # One search and one backtrace a class count of each beam request, on each rank.
    beam_launches = [(result["serve"]["launches"]["beam_search"], result["serve"]["launches"]["beam_backtrace"]) for result in ranks]
    check(beam_launches[0][0] >= len(sizes) and all(pair == beam_launches[0] for pair in beam_launches) and beam_launches[0][0] == beam_launches[0][1],
          f"multi-GPU serve: beam launches {beam_launches}")
    check(differing == 0, f"multi-GPU serve: {differing} grid cells differ from one device on the same rows")
    phase_multi_gpu_cli(results, root, card)
    if torch.cuda.device_count() >= MULTI_RANKS:
        phase_multi_gpu_launch(root, card)
        phase_multi_gpu_whole_run(root, card)
    else:
        print("multi-GPU plain launch and whole run: not run (one card; they spawn a rank a card over NCCL)", flush=True)
    print(f"multi-GPU: {time.perf_counter() - started:.1f} s", flush=True)


# XLS-R 300M's hub config.json (facebook/wav2vec2-xls-r-300m), the fields the
# encoder's shape reads.
XLSR_300M_CONFIG = {
    "architectures": ["Wav2Vec2ForPreTraining"], "model_type": "wav2vec2",
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
    "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5,
    "num_codevector_groups": 2, "num_codevectors_per_group": 320, "codevector_dim": 768, "proj_codevector_dim": 768,
}


def xlsr_pretraining_state(seed: int) -> dict:
    """A seeded ``Wav2Vec2ForPreTraining`` state dict of XLS-R 300M's shapes,
    as the hub's ``pytorch_model.bin`` holds it: the encoder under
    ``wav2vec2.`` (the positional conv weight-normed as weight_g and
    weight_v), beside the quantizer and the projections of pre-training."""
    config = XLSR_300M_CONFIG
    generator = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=None):
        value = torch.randn(shape, generator=generator)
        return value * (scale if scale is not None else (shape[-1] if len(shape) > 1 else 1) ** -0.5)

    hidden, inner, channels = config["hidden_size"], config["intermediate_size"], config["conv_dim"]
    state = {}
    for index, (width, kernel) in enumerate(zip(channels, config["conv_kernel"])):
        prefix = f"wav2vec2.feature_extractor.conv_layers.{index}"
        state[f"{prefix}.conv.weight"] = draw(width, 1 if index == 0 else channels[index - 1], kernel)
        state[f"{prefix}.conv.bias"] = draw(width, scale=0.02)
        state[f"{prefix}.layer_norm.weight"] = 1 + draw(width, scale=0.1)
        state[f"{prefix}.layer_norm.bias"] = draw(width, scale=0.02)
    state["wav2vec2.feature_projection.layer_norm.weight"] = 1 + draw(channels[-1], scale=0.1)
    state["wav2vec2.feature_projection.layer_norm.bias"] = draw(channels[-1], scale=0.02)
    state["wav2vec2.feature_projection.projection.weight"] = draw(hidden, channels[-1])
    state["wav2vec2.feature_projection.projection.bias"] = draw(hidden, scale=0.02)
    groups, width = config["num_conv_pos_embedding_groups"], config["num_conv_pos_embeddings"]
    state["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = 1 + draw(1, 1, width, scale=0.1)
    state["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = draw(hidden, hidden // groups, width)
    state["wav2vec2.encoder.pos_conv_embed.conv.bias"] = draw(hidden, scale=0.02)
    state["wav2vec2.encoder.layer_norm.weight"] = 1 + draw(hidden, scale=0.1)
    state["wav2vec2.encoder.layer_norm.bias"] = draw(hidden, scale=0.02)
    for layer in range(config["num_hidden_layers"]):
        prefix = f"wav2vec2.encoder.layers.{layer}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[f"{prefix}.attention.{name}.weight"] = draw(hidden, hidden)
            state[f"{prefix}.attention.{name}.bias"] = draw(hidden, scale=0.02)
        for name in ("layer_norm", "final_layer_norm"):
            state[f"{prefix}.{name}.weight"] = 1 + draw(hidden, scale=0.1)
            state[f"{prefix}.{name}.bias"] = draw(hidden, scale=0.02)
        state[f"{prefix}.feed_forward.intermediate_dense.weight"] = draw(inner, hidden)
        state[f"{prefix}.feed_forward.intermediate_dense.bias"] = draw(inner, scale=0.02)
        state[f"{prefix}.feed_forward.output_dense.weight"] = draw(hidden, inner)
        state[f"{prefix}.feed_forward.output_dense.bias"] = draw(hidden, scale=0.02)
    state["wav2vec2.masked_spec_embed"] = draw(hidden, scale=1.0)
    codevectors = config["num_codevector_groups"] * config["num_codevectors_per_group"]
    state["quantizer.codevectors"] = draw(1, codevectors, config["codevector_dim"] // config["num_codevector_groups"])
    state["quantizer.weight_proj.weight"] = draw(codevectors, channels[-1])
    state["quantizer.weight_proj.bias"] = draw(codevectors, scale=0.02)
    state["project_hid.weight"] = draw(config["proj_codevector_dim"], hidden)
    state["project_hid.bias"] = draw(config["proj_codevector_dim"], scale=0.02)
    state["project_q.weight"] = draw(config["proj_codevector_dim"], config["codevector_dim"])
    state["project_q.bias"] = draw(config["proj_codevector_dim"], scale=0.02)
    return state


def write_hub_cache(cache: Path, model_id: str, config: dict, state: dict) -> Path:
    """``model_id`` in the HuggingFace hub cache layout under ``cache``:
    ``refs/main`` naming a snapshot of ``config.json`` and
    ``pytorch_model.bin``. Returns the weights file."""
    revision = "0" * 40
    repository = cache / f"models--{model_id.replace('/', '--')}"
    snapshot = repository / "snapshots" / revision
    snapshot.mkdir(parents=True)
    (repository / "refs").mkdir()
    (repository / "refs" / "main").write_text(revision, encoding="utf-8")
    (snapshot / "config.json").write_text(json.dumps(config), encoding="utf-8")
    torch.save(state, snapshot / "pytorch_model.bin")
    return snapshot / "pytorch_model.bin"


@contextlib.contextmanager
def hub_cache(cache: Path):
    """``$HF_HUB_CACHE`` set to ``cache`` for the block."""
    saved = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(cache)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["HF_HUB_CACHE"]
        else:
            os.environ["HF_HUB_CACHE"] = saved


def phase_pretrained(results: dict, root: Path) -> None:
    """Pretrained encoder weights from the local hub cache only: the
    full-width XLS-R 300M written as the hub keeps it (``config.json`` and a
    ``Wav2Vec2ForPreTraining`` ``pytorch_model.bin`` of seeded values, the
    encoder under ``wav2vec2.`` beside the quantizer; about 1.27 GB) into a
    temporary ``HF_HUB_CACHE``; ``Estimator.from_config`` of the demo config
    on the card loads it, every encoder leaf bit-equal to the file's values
    converted on the host (``hf_conversion``); one "mixed" training step at
    A = 2, B = 8, 10 s with the twins forbidden (K2 twice, K5 and K4 48
    times each). Then the same with the cache emptied: the seeded weights
    and the log line that says why."""
    import logging

    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.demo import demo_config_dict, demo_indexer
    from allophant_tpu_torch.models import pretrained
    from allophant_tpu_torch.models.allophant import attribute_graph_from_config
    from allophant_tpu_torch.models.hf_conversion import convert_wav2vec2_state
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.models.wav2vec2 import Wav2Vec2Architecture
    from allophant_tpu_torch.training.estimator import Estimator
    from allophant_tpu_torch.training.train_step import build_freeze_plan, build_loss_plan, create_optimizer, make_train_step
    from allophant_tpu_torch.weights import wav2vec2_state_from_jax

    config = Config.load(demo_config_dict())
    indexer = demo_indexer(config)
    graph = attribute_graph_from_config(config, indexer)
    model_id = config.nn.acoustic_model.model_id
    started = time.perf_counter()
    state = xlsr_pretraining_state(seed=19)
    cache = root / "hub"
    weights = write_hub_cache(cache, model_id, XLSR_300M_CONFIG, state)
    written = time.perf_counter() - started
    architecture = Wav2Vec2Architecture()
    encoder = {name.removeprefix("wav2vec2."): value.numpy() for name, value in state.items() if name.startswith("wav2vec2.")}
    expected = wav2vec2_state_from_jax(convert_wav2vec2_state(encoder, architecture), architecture.num_hidden_layers)
    del state, encoder
    print(
        f"pretrained: {model_id} written to a hub cache in {written:.1f} s ({weights.stat().st_size / 1e9:.3f} GB,"
        f" Wav2Vec2ForPreTraining layout with quantizer keys)",
        flush=True,
    )

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger(pretrained.__name__).addHandler(handler)
    try:
        with hub_cache(cache):
            torch.cuda.synchronize()
            started = time.perf_counter()
            estimator = Estimator.from_config(config, 1, SAMPLE_RATE, graph, indexer, precision="mixed", device="cuda")
            torch.cuda.synchronize()
            loaded = time.perf_counter() - started
        started = time.perf_counter()
        seeded = Estimator.from_config(config, 1, SAMPLE_RATE, graph, indexer, load_pretrained_weights=False, precision="mixed", device="cuda")
        torch.cuda.synchronize()
        seeded_seconds = time.perf_counter() - started
        state = estimator.model.acoustic_model.state_dict()
        check(set(state) == set(expected), "pretrained: the encoder's leaves differ from the file's")
        differing = [name for name, value in expected.items() if not torch.equal(state[name].cpu(), torch.from_numpy(np.ascontiguousarray(value)))]
        check(not differing, f"pretrained: {len(differing)} encoder leaves differ from the file's converted values, e.g. {differing[:3]}")
        seeded_state = seeded.model.acoustic_model.state_dict()
        check(not torch.equal(seeded_state["feature_projection.projection.weight"], state["feature_projection.projection.weight"]),
              "pretrained: the loaded encoder equals the seeded one")
        del seeded, seeded_state
        print(
            f"pretrained: Estimator.from_config loaded the cached encoder in {loaded:.2f} s (seeded weights alone:"
            f" {seeded_seconds:.2f} s); all {len(expected)} encoder leaves bit-equal to the file's converted values",
            flush=True,
        )

        model = estimator.model
        nn = config.nn
        optimizer = create_optimizer(nn, architecture.hidden_size, model.parameters())
        step = make_train_step(model, optimizer, build_loss_plan(nn, model.plan.allophone_shape is not None), build_freeze_plan(nn.acoustic_model))
        microbatches = training_microbatches(model, TRAIN_ACCUMULATION, TRAIN_BATCH, TRAIN_SECONDS * SAMPLE_RATE, "cuda")
        layers = architecture.num_hidden_layers
        with TwinsForbidden():
            started = time.perf_counter()
            metrics, launches = counted(lambda: step(microbatches, DropoutRng.from_seed(nn.seed, "cuda")))
            step_ms = (time.perf_counter() - started) * 1e3
        for name, count in launches.items():
            results[name] += count
        expected_launches = {"oneshot_attention": 0, "attention_dropout": TRAIN_ACCUMULATION * layers,
                             "attention_backward": TRAIN_ACCUMULATION * layers, "dropout_mask": 0, "frame_encoder": TRAIN_ACCUMULATION}
        check(launches == expected_launches, f"pretrained step: launches {launches}, expected {expected_launches}")
        check(np.isfinite(metrics["mean_loss"]) and np.isfinite(metrics["grad_norm"]), f"pretrained step: non-finite {metrics}")
        print(
            f"pretrained: one mixed step at A={TRAIN_ACCUMULATION} B={TRAIN_BATCH} {TRAIN_SECONDS} s from the loaded encoder:"
            f" mean_loss {metrics['mean_loss']:.6f}, grad_norm {metrics['grad_norm']:.6f}, {step_ms:.1f} ms (first step),"
            f" launches {launches}",
            flush=True,
        )
        del estimator, model, optimizer, step, microbatches
        torch.cuda.empty_cache()

        for path in cache.rglob("*"):
            if path.is_file():
                path.unlink()
        records.clear()
        with hub_cache(cache):
            fallback = Estimator.from_config(config, 1, SAMPLE_RATE, graph, indexer, precision="mixed", device="cuda")
        reference = Estimator.from_config(config, 1, SAMPLE_RATE, graph, indexer, load_pretrained_weights=False, precision="mixed", device="cuda")
        same = all(torch.equal(a, b) for a, b in zip(fallback.model.state_dict().values(), reference.model.state_dict().values()))
        messages = [record.getMessage() for record in records]
        check(same, "pretrained: with the cache emptied, the weights are not the seeded ones")
        check(len(messages) == 1 and model_id in messages[0], f"pretrained: fallback log lines {messages}")
        print(f"pretrained: cache emptied: the seeded weights, and one log line: {messages[0]!r}", flush=True)
        del fallback, reference
    finally:
        logging.getLogger(pretrained.__name__).removeHandler(handler)
        torch.cuda.empty_cache()


def data_cli(arguments: list) -> tuple:
    """(seconds, standard output) of ``allophant_tpu_torch.cli.data`` run in
    this process with ``arguments``."""
    from allophant_tpu_torch.cli import data as cli_data

    output = io.StringIO()
    started = time.perf_counter()
    with contextlib.redirect_stdout(output):
        cli_data.main(arguments)
    return time.perf_counter() - started, output.getvalue()


def train_from_store(label: str, root: Path, arguments: list) -> tuple:
    """A train CLI child run (twins forbidden, launches counted): (report,
    statistics lines, seconds); fails on a non-zero exit."""
    started = time.perf_counter()
    code, lines, report, _stopped = run_train_cli(arguments, root / f"{label}.log", interrupt=False, timeout=600)
    seconds = time.perf_counter() - started
    if code != 0 or report is None:
        print((root / f"{label}.log").read_text(encoding="utf-8", errors="replace")[-4000:], flush=True)
    check(code == 0 and report is not None, f"data CLI {label}: exit code {code}")
    return report, [line for line in lines if re.match(r"epoch \d+ step \d+:", line)], seconds


def store_features_mismatched(corpus: Path, config: dict, stored: dict) -> list:
    """The (split, language, utterance) whose stored features (``stored``:
    split -> the store's features, in the corpus's order of languages and
    utterances) are not bit-equal to the feature function of ``config``
    applied to the clip as the corpus reader gives it to the training loader."""
    from allophant_tpu_torch.config import Config
    from allophant_tpu_torch.data import corpus_loading
    from allophant_tpu_torch.data.preprocessing import FeatureFunction

    parsed = Config.load(config)
    splits = corpus_loading.load_corpus(
        str(corpus), "common-voice", parsed.preprocessing.resample, only_primary_script=parsed.data.only_primary_script
    )
    feature_function = FeatureFunction.from_config(parsed, splits.audio_info().sample_rate or parsed.preprocessing.resample)
    mismatched = []
    for split_name, split in zip(("train", "dev", "test"), splits):
        features = iter(stored[split_name].features)
        for language in split.languages:
            for index in split.monolingual_index_range(language):
                audio, _rate = split.audio(index)
                computed = feature_function(audio if audio.ndim > 1 else audio[None, :])
                if not np.array_equal(computed.reshape(computed.shape[0], -1), next(features)):
                    mismatched.append((split_name, language, int(index)))
    return mismatched


def phase_data_cli(results: dict, root: Path) -> None:
    """The port's ``allophant-data`` on the train CLI phase's Common Voice
    corpus, then ``train -f`` from its stores on the card:
    1. ``save-lengths``, ``preprocess`` (80 log-mel filterbanks, the ragged
       store and ``--zarr``; the two stores' features equal) and ``stats``;
    2. ``train -f STORE`` of the transformer at the transformer phase's
       width (d_model 512, 8 heads of 64, FFN 2048, 6 layers; "mixed",
       dropout 0.1) for one epoch: K5 and K4 once a layer and microbatch, K1
       in validation, twins forbidden;
    3. a float32 2-layer transformer ``train -f`` against the same run on
       features computed on the fly, twice: the store's features bit-equal to
       the feature function of every clip as the loader reads it; the first
       step's loss bit-equal across the three runs, every step's loss and
       gradient norm within the float32 metric limits; the runs' parameter
       distances printed;
    4. the full-width flagship ``train -f`` from a raw-sample (16 kHz)
       ``preprocess`` store for one epoch of 2 steps: K2 once and K5 and K4
       24 times a microbatch.
    Each CLI's seconds are printed."""
    from allophant_tpu_torch.data import store
    from allophant_tpu_torch.training.checkpoint import load_checkpoint

    corpus = root / "cv"
    flagship_config = json.loads((root / "train_cli_config.json").read_text(encoding="utf-8"))
    flagship_config["nn"]["maximum_iterations"] = 1
    transformer = transformer_config_dict(0.1)
    config = json.loads(json.dumps(flagship_config))
    config["nn"]["acoustic_model"] = transformer["nn"]["acoustic_model"]
    config["nn"]["projection"]["acoustic_model_dropout"] = 0.1
    config["preprocessing"] = transformer["preprocessing"]
    workdir = root / "data_cli"
    workdir.mkdir()
    stores = {name: workdir / name for name in ("lengths", "features", "features_zarr", "raw")}
    seconds = {}
    seconds["save-lengths"], _ = data_cli(["save-lengths", str(corpus), str(stores["lengths"]), "-j", json.dumps(config)])
    seconds["preprocess"], _ = data_cli(["preprocess", str(corpus), str(stores["features"]), "-j", json.dumps(config)])
    seconds["preprocess --zarr"], _ = data_cli(["preprocess", str(corpus), str(stores["features_zarr"]), "-j", json.dumps(config), "--zarr"])
    seconds["stats"], printed = data_cli(["stats", str(corpus), "-l", str(stores["lengths"]), "-j", "-r", str(TRANSFORMER_FRAMES_PER_SECOND)])
    seconds["preprocess raw"], _ = data_cli(["preprocess", str(corpus), str(stores["raw"]), "-j", json.dumps(flagship_config)])
    statistics = json.loads(printed)
    counts = {split: sum(statistics[split]["utterance_counts"].values()) for split in ("train", "dev", "test")}
    check(counts == {split: CLI_CLIPS[split] * len(CLI_LANGUAGES) for split in CLI_CLIPS}, f"data CLI stats: counts {counts}")
    languages = {split: list(CLI_LANGUAGES) for split in CLI_CLIPS}
    ragged = store.preprocessed_features_or_lengths(str(stores["features"]), languages, lengths_only=False)
    zarr = store.preprocessed_features_or_lengths(str(stores["features_zarr"]), languages, lengths_only=False)
    lengths = store.preprocessed_features_or_lengths(str(stores["lengths"]), languages)
    for split in CLI_CLIPS:
        check(all(np.array_equal(a, b) for a, b in zip(ragged[split].features, zarr[split].features)), f"data CLI: {split} stores differ")
        check(ragged[split].lengths.tolist() == [len(a) for a in ragged[split].features], f"data CLI: {split} lengths differ from the features")
        # save-lengths counts frames from the audio header, as the JAX CLI
        # does: at most one frame off the computed features.
        check(np.abs(lengths[split].lengths - ragged[split].lengths).max() <= 1, f"data CLI: {split} saved lengths are off the features")
        check(ragged[split].features[0].shape[1] == TRANSFORMER_FEATURES, "data CLI: not 80 filterbanks a frame")
    frames = sum(int(value.sum()) for value in (ragged[split].lengths for split in CLI_CLIPS))
    print(
        f"data CLI: {sum(counts.values())} clips, {frames} frames of {TRANSFORMER_FEATURES} filterbanks;"
        f" seconds {', '.join(f'{name} {value:.2f}' for name, value in seconds.items())}; stats {counts}",
        flush=True,
    )

    def arguments(run_config, save, *extra):
        common = ["train", str(corpus), "-t", "common-voice", "-j", json.dumps(run_config), "-a", str(root / "table.csv")]
        return [*common, *(["-d", "-s", str(workdir / save)] if save else []), *extra]

    layers = transformer["nn"]["acoustic_model"]["transformer"]["num_layers"]
    report, lines, wall = train_from_store("transformer", workdir, arguments(config, "transformer", "-f", str(stores["features"])))
    steps = int(load_checkpoint(str(workdir / "transformer" / "epoch-1.ckpt")).epoch.global_step)
    launches = report["launches"]
    validation_batches = launches["oneshot_attention"] // layers
    expected = {"oneshot_attention": layers * validation_batches, "attention_dropout": TRAIN_ACCUMULATION * layers * steps,
                "attention_backward": TRAIN_ACCUMULATION * layers * steps, "dropout_mask": 0, "frame_encoder": 0}
    check(steps > 0 and validation_batches > 0 and launches == expected, f"data CLI transformer train -f: launches {launches}, expected {expected}")
    for name, count in launches.items():
        results[name] += count
    print(f"data CLI: train -f (transformer, 6 layers, mixed) {wall:.1f} s, {steps} steps; statistics {lines}; launches {launches}", flush=True)

    small = json.loads(json.dumps(config))
    small["nn"]["mixed_precision"] = False
    small["nn"]["acoustic_model"]["transformer"]["num_layers"] = 2
    walls, parameters, steps = {}, {}, {}
    runs = (("store", ["-f", str(stores["features"])]), ("on the fly", []), ("on the fly again", []))
    for label, extra in runs:
        save = f"float32_{label.replace(' ', '_')}"
        report, _lines, walls[label] = train_from_store(save, workdir, arguments(small, save, *extra))
        steps[label] = report["steps"]
        for name, count in report["launches"].items():
            results[name] += count
        flat = tree_leaves(load_checkpoint(str(workdir / save / "epoch-1.ckpt")).variables["params"])
        parameters[label] = {key: np.asarray(value) for key, value in flat}

    def apart(first, second):
        """(leaves not bit-equal, the largest difference as a share of its leaf's largest value)."""
        differing = [key for key, value in parameters[first].items() if not np.array_equal(value, parameters[second][key])]
        share = max((np.abs(parameters[first][key] - parameters[second][key]).max() / max(np.abs(parameters[second][key]).max(), 1e-30)
                     for key in differing), default=0.0)
        return differing, float(share)

    def step_distances(first, second):
        """(steps, the largest relative distance of a step's loss, of its gradient norm)."""
        pairs = list(zip(steps[first], steps[second]))
        check(len(steps[first]) == len(steps[second]) > 0 and all(a["step"] == b["step"] for a, b in pairs),
              f"data CLI: float32 {first} ran steps {[a['step'] for a in steps[first]]}, {second} {[b['step'] for b in steps[second]]}")
        return len(pairs), *(max(abs(a[key] - b[key]) / abs(b[key]) for a, b in pairs) for key in ("loss", "gradient_norm"))

    check(parameters["store"].keys() == parameters["on the fly"].keys(), "data CLI: the float32 runs saved other leaves")
    differing, share = apart("store", "on the fly")
    floor_differing, floor_share = apart("on the fly again", "on the fly")
    # The batches of the runs hold the same float32 features: the store's are
    # the feature function of each clip as the on-the-fly loader reads it, bit
    # for bit. So the first step, before any update, sees the same weights and
    # the same batches in the same order, padding and labels, and the card's
    # float32 forward is deterministic: its loss is bit-equal. From the first
    # update on, ATen's CUDA CTC backward (it accumulates with atomics) parts
    # the runs' weights by a few 1e-7 of a leaf, so later steps' losses and
    # every step's gradient norm are held to the float32 metric limits, which a
    # batch read in another order, padded or labelled otherwise, breaks by
    # orders of magnitude. The parameters after the epoch are printed.
    mismatched = store_features_mismatched(corpus, config, ragged)
    check(not mismatched, f"data CLI: the store's features differ from those computed on the fly for {mismatched}")
    first_losses = {label: steps[label][0]["loss"] if steps[label] else None for label, _extra in runs}
    count, loss_distance, norm_distance = step_distances("store", "on the fly")
    _count, floor_loss, floor_norm = step_distances("on the fly again", "on the fly")
    check(len(set(first_losses.values())) == 1, f"data CLI: float32 first-step losses differ: {first_losses}")
    for label, loss, norm in (("train -f", loss_distance, norm_distance), ("the same on-the-fly run twice", floor_loss, floor_norm)):
        check(loss <= MULTI_METRIC_RTOL and norm <= MULTI_NORM_RTOL,
              f"data CLI: float32 {label}: step losses {loss:.3e} and gradient norms {norm:.3e} apart (limits {MULTI_METRIC_RTOL},"
              f" {MULTI_NORM_RTOL})")
    print(
        f"data CLI: float32 2-layer transformer, train -f {walls['store']:.1f} s, on the fly {walls['on the fly']:.1f} s and"
        f" {walls['on the fly again']:.1f} s; the store's features bit-equal to the feature function of every clip; first-step"
        f" loss {first_losses['store']!r} in all three runs; train -f against on the fly over {count} steps: losses"
        f" {loss_distance:.3e} and gradient norms {norm_distance:.3e} apart at most (limits {MULTI_METRIC_RTOL}, {MULTI_NORM_RTOL}),"
        f" the same on-the-fly run twice {floor_loss:.3e} and {floor_norm:.3e}; parameters after the epoch: {len(differing)} of"
        f" {len(parameters['store'])} saved leaves not bit-equal (largest share {share:.3e}), the same run twice"
        f" {len(floor_differing)} (largest share {floor_share:.3e})",
        flush=True,
    )

    report, lines, wall = train_from_store("flagship_raw", workdir, arguments(flagship_config, None, "-f", str(stores["raw"])))
    launches = report["launches"]
    steps = int(re.match(r"epoch \d+ step (\d+):", lines[-1]).group(1)) if lines else 0
    flagship_layers = 24
    validation_batches = launches["frame_encoder"] - TRAIN_ACCUMULATION * steps
    expected = {"oneshot_attention": flagship_layers * validation_batches, "attention_dropout": TRAIN_ACCUMULATION * flagship_layers * steps,
                "attention_backward": TRAIN_ACCUMULATION * flagship_layers * steps, "dropout_mask": 0,
                "frame_encoder": TRAIN_ACCUMULATION * steps + validation_batches}
    check(steps == 2 and validation_batches > 0 and launches == expected, f"data CLI flagship train -f: {steps} steps, launches {launches}, expected {expected}")
    for name, count in launches.items():
        results[name] += count
    print(f"data CLI: train -f (full-width flagship, raw-sample store) {wall:.1f} s, {steps} steps; statistics {lines}; launches {launches}", flush=True)


# Phase 21: the decode modes exported, and the serving requests' first batch
# padded to the live path's length bucket of its 10 s rows (163,840 samples),
# so that the artifact and the live call run the same shapes.
EXPORT_DECODES = ("greedy", "beam4")
EXPORT_BEAM_WIDTH, EXPORT_N_BEST, EXPORT_REPEATS = 4, 2, 5
ARTIFACT_CHILD_FLAG = "--serve-artifact-child"
ARTIFACT_HEAD = "phoneme"


def export_batch():
    """The first serving request's batch, its audio zero-padded to the
    bucket that ``predict_decoded`` pads it to."""
    from allophant_tpu_torch.data.batch import Batch
    from allophant_tpu_torch.training.estimator import _bucket_length

    batch = serving_requests()[0][1]["batch"]
    audio = np.asarray(batch.audio_features, dtype=np.float32)
    padded = np.zeros((audio.shape[0], _bucket_length(audio.shape[1])), dtype=np.float32)
    padded[:, : audio.shape[1]] = audio
    return Batch(padded, np.asarray(batch.lengths, dtype=np.int32), np.asarray(batch.language_ids, dtype=np.int32))


def wall_ms(call, repeats: int = EXPORT_REPEATS) -> float:
    """Host milliseconds of one ``call`` ended by a device sync, the mean of
    ``repeats`` after a warm-up call."""
    call()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(repeats):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - started) * 1e3 / repeats


def serve_artifact_child(arguments: list) -> int:
    """The child of the export phase: ``load_transcriber`` of a saved artifact
    in a fresh process that imports the serving loader and the kernels' ops
    (no model, training or data module), then the batch of an ``.npz`` file
    through it with the twins forbidden: one warm-up call, one call with the
    launch counters read around it (its outputs saved as numpy to the output
    path), and EXPORT_REPEATS timed calls. Prints one JSON line."""
    sys.path.insert(0, str(HERE))
    path, inputs_path, output_path = arguments
    started = time.perf_counter()
    from allophant_tpu_torch.serving import load_transcriber

    call = load_transcriber(path)
    load_seconds = time.perf_counter() - started
    from allophant_tpu_torch.ops.beam_kernel import beam_search_cuda
    from allophant_tpu_torch.ops.frame_encoder import fused_frame_conv
    from allophant_tpu_torch.ops.oneshot_attention import oneshot_attention

    counters = {"oneshot_attention": oneshot_attention, "frame_encoder": fused_frame_conv, "beam_search": beam_search_cuda}
    with np.load(inputs_path) as arrays:
        inputs = (arrays["audio"], arrays["lengths"], arrays["language_ids"])
    with TwinsForbidden():
        started = time.perf_counter()
        call(*inputs)
        torch.cuda.synchronize()
        first_seconds = time.perf_counter() - started
        for counter in counters.values():
            counter.launches = 0
        outputs = call(*inputs)
        torch.cuda.synchronize()
        launches = {name: counter.launches for name, counter in counters.items()}
        request_ms = wall_ms(lambda: call(*inputs))
    torch.save(torch.utils._pytree.tree_map(lambda tensor: tensor.cpu().numpy(), outputs), output_path)
    prefixes = tuple(f"allophant_tpu_torch.{package}" for package in ("models", "training", "data"))
    report = {
        "load_s": load_seconds, "first_call_s": first_seconds, "request_ms": request_ms, "launches": launches,
        "loaded": sorted(name for name in sys.modules if name.startswith(prefixes)),
    }
    print("serve-artifact-child " + json.dumps(report), flush=True)
    return 0


def n_best(collected: np.ndarray, scores: np.ndarray):
    """Per row, the EXPORT_N_BEST best (tokens, score) of [T, B, K] tokens
    (-1 = none) and [B, K] scores."""
    rows = []
    for row in range(collected.shape[1]):
        order = np.argsort(-scores[row], kind="stable")[:EXPORT_N_BEST]
        rows.append([(collected[:, row, beam][collected[:, row, beam] >= 0], float(scores[row, beam])) for beam in order])
    return rows


def greedy_cells_differing(decoded: dict, grid: np.ndarray, heads: tuple) -> int:
    """Cells of the artifact's per-head (tokens, counts) that differ from the
    live uint16 grid [H, B, T'+1] (column 0 the count, then the tokens)."""
    differing = 0
    for index, name in enumerate(heads):
        if name not in decoded:
            continue
        tokens, counts = decoded[name]
        live_counts = grid[index, :, 0]
        differing += int((counts != live_counts).sum())
        for row, count in enumerate(np.minimum(counts, live_counts)):
            differing += int((tokens[row, :count] != grid[index, row, 1 : 1 + count]).sum())
    return differing


def phase_export(results: dict, root: Path) -> None:
    """``allophant export`` of the full-width "mixed" flagship: for greedy and
    beam4, ``serving.export_transcriber`` at 8 x 163,840 samples (the first
    serving request's batch in its live bucket), ``save_transcriber``, then
    the artifact loaded in a fresh process (``ARTIFACT_CHILD_FLAG``) that
    imports no model code and runs the batch with the twins forbidden: K1
    once a layer, K2 once and K3 once a beam call. The greedy tokens and
    counts must equal the live ``predict_decoded`` grid of the batch cell for
    cell; the beam triple, backtraced on the host, the live
    ``predict_beam_decoded`` n-best of the phoneme head. Export, save and
    load seconds, the artifact's size and its request wall time beside the
    live call's; and the custom op's cost: K1 through its op against the
    kernel's launch called directly."""
    from allophant_tpu_torch import serving
    from allophant_tpu_torch.ops.decode import backtrace_beams
    from allophant_tpu_torch.ops.oneshot_attention import launch_oneshot_attention, oneshot_attention

    card = phase_card()
    estimator = build_serving_flagship()
    layers = estimator.model.architecture.num_hidden_layers
    batch = export_batch()
    rows, samples = batch.audio_features.shape
    heads = tuple(sorted(estimator.predict(batch, time_major=False).outputs))
    inputs_path = root / "export_inputs.npz"
    np.savez(inputs_path, audio=batch.audio_features, lengths=batch.lengths, language_ids=batch.language_ids)

    grid, live_lengths = estimator.predict_decoded(batch, heads=heads)
    grid, live_lengths = grid.to(torch.int32).cpu().numpy(), live_lengths.cpu().numpy()
    live_collected, live_scores, _ = estimator.predict_beam_decoded(batch, heads=(ARTIFACT_HEAD,), beam_width=EXPORT_BEAM_WIDTH)
    live_collected, live_scores = live_collected[0].to(torch.int64).cpu().numpy(), live_scores[0].cpu().numpy()
    live_ms = {
        "greedy": wall_ms(lambda: estimator.predict_decoded(batch, heads=heads)),
        "beam4": wall_ms(lambda: estimator.predict_beam_decoded(batch, heads=(ARTIFACT_HEAD,), beam_width=EXPORT_BEAM_WIDTH)),
    }
    live_calls = {"greedy": "predict_decoded, 38 heads", "beam4": f"predict_beam_decoded, the {ARTIFACT_HEAD} head"}

    for decode in EXPORT_DECODES:
        started = time.perf_counter()
        exported = serving.export_transcriber(estimator, rows, samples, decode, device="cuda")
        export_seconds = time.perf_counter() - started
        ops = sorted({str(node.target) for node in exported.program.graph.nodes if str(node.target).startswith("allophant_torch.")})
        path = root / f"transcriber_{decode}.pt2"
        started = time.perf_counter()
        serving.save_transcriber(exported, str(path))
        save_seconds = time.perf_counter() - started
        del exported
        torch.cuda.empty_cache()
        output_path = root / f"artifact_{decode}.pt"
        child = subprocess.run(
            [sys.executable, str(HERE / "chip_smoke.py"), ARTIFACT_CHILD_FLAG, str(path), str(inputs_path), str(output_path)],
            stdin=subprocess.DEVNULL, capture_output=True, text=True, cwd=str(HERE), timeout=600,
        )
        if child.returncode != 0:
            print(child.stdout[-3000:], child.stderr[-6000:], flush=True)
        check(child.returncode == 0, f"export {decode}: the artifact's child exited {child.returncode}")
        (report,) = [json.loads(line.split(" ", 1)[1]) for line in child.stdout.splitlines() if line.startswith("serve-artifact-child ")]
        check(report["loaded"] == [], f"export {decode}: the loader imported {report['loaded']}")
        beam = decode.startswith("beam")
        expected = {"oneshot_attention": layers, "frame_encoder": 1, "beam_search": int(beam)}
        check(report["launches"] == expected, f"export {decode}: launches {report['launches']}, expected {expected}")
        for name, count in report["launches"].items():
            results[name] += count
        outputs = torch.load(output_path, weights_only=False)
        decoded, lengths = outputs[0], outputs[-1]
        check(np.array_equal(lengths, live_lengths), f"export {decode}: frame lengths {lengths} vs live {live_lengths}")
        differing = greedy_cells_differing(decoded, grid, heads)
        beam_text = ""
        if beam:
            check(ARTIFACT_HEAD not in decoded and len(decoded) == len(heads) - 1, f"export {decode}: heads {sorted(decoded)}")
            collected, scores = backtrace_beams(*outputs[1], lengths)
            beam_cells = int((collected != live_collected).sum())
            score_error = float(np.abs(scores.astype(np.float64) - live_scores).max())
            same_n_best = all(
                len(got) == len(want) and all(np.array_equal(a[0], b[0]) and abs(a[1] - b[1]) <= 1e-4 for a, b in zip(got, want))
                for got, want in zip(n_best(collected, scores), n_best(live_collected, live_scores))
            )
            beam_text = (
                f"; beam {EXPORT_BEAM_WIDTH} on the {ARTIFACT_HEAD} head backtraced on the host: {beam_cells} token cells differ from"
                f" the live search, scores {score_error:.3e} off, {EXPORT_N_BEST}-best {'equal' if same_n_best else 'DIFFERENT'}"
            )
        else:
            check(set(decoded) == set(heads), f"export {decode}: heads {sorted(decoded)}")
        print(
            f"export {decode}: {rows} x {samples} samples, ops {ops}; export {export_seconds:.2f} s, save {save_seconds:.2f} s,"
            f" {path.stat().st_size / 2**20:.1f} MiB; fresh process: load {report['load_s']:.2f} s, first call"
            f" {report['first_call_s']:.2f} s, request {report['request_ms']:.1f} ms (live {live_calls[decode]}:"
            f" {live_ms[decode]:.1f} ms); launches {report['launches']}, twins forbidden, no model module loaded;"
            f" greedy cells differing from the live grid {differing}{beam_text}; {card}",
            flush=True,
        )
        check(differing == 0, f"export {decode}: {differing} greedy cells differ from the live predict_decoded grid")
        if beam:
            check(beam_cells == 0 and same_n_best, f"export {decode}: the beam n-best differs from the live search")
        path.unlink()

    # The custom op's cost: K1 at the serving shape through its op (the
    # dispatcher, the CUDA implementation) in inference mode, as serving and
    # the artifact call it, and under no_grad (autograd's dispatch on top),
    # against the launch function called directly.
    q, k, v, bias = attention_inputs([511] * 8, 511, 16, 64, torch.bfloat16, fused_qkv=True)[:4]
    with torch.inference_mode():
        inference = median_ms(lambda: oneshot_attention(q, k, v, bias, 0.125, 16), 50)
    with torch.no_grad():
        no_grad = median_ms(lambda: oneshot_attention(q, k, v, bias, 0.125, 16), 50)
    direct = median_ms(lambda: launch_oneshot_attention(q, k, v, bias, 0.125, 16), 50)
    print(
        f"export: K1 [8, 511, 1024] bf16 a call through its custom op {inference:.4f} ms in inference mode, {no_grad:.4f} ms"
        f" under no_grad; its launch called directly {direct:.4f} ms (CUDA events, back-to-back calls); {card}",
        flush=True,
    )
    del estimator
    torch.cuda.empty_cache()


MULTI_GPU_FLAG = "--multi-gpu"
W2V_BERT_FLAG = "--w2v-bert"


def multi_gpu_only() -> int:
    """``chip_smoke.py --multi-gpu``: the kernels' build and the multi-GPU
    phase alone, on the train CLI phase's inputs (on a machine of two or more
    cards it also runs the plain launch). Prints no kernels line."""
    from allophant_tpu_torch.device import set_float32_precision
    from allophant_tpu_torch.phonetics.features import SingletonFeatureWarning

    phase_card()
    phase_build()
    set_float32_precision("highest")
    warnings.simplefilter("ignore", SingletonFeatureWarning)
    launches = dict.fromkeys(
        ("oneshot_attention", "frame_encoder", "beam_search", "beam_backtrace", "attention_backward", "attention_dropout", "dropout_mask"),
        0,
    )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as directory:
        root = Path(directory)
        write_train_cli_inputs(root)
        phase_multi_gpu(launches, root)
    print(f"multi-GPU launches: {launches}", flush=True)
    return 0


def w2v_bert_only() -> int:
    """``chip_smoke.py --w2v-bert``: the kernels' build, K7's registers from
    ``nvcc -Xptxas -v``, K7's kernel phase and the w2v-BERT serving phase."""
    from allophant_tpu_torch.device import set_float32_precision
    from allophant_tpu_torch.kernels.build import NVCC_FLAGS, SOURCE_DIR, cuda_tool

    phase_card()
    phase_build()
    set_float32_precision("highest")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as directory:
        result = subprocess.run(
            [cuda_tool(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(directory) / "k7.so"), str(SOURCE_DIR / "relkey_attention.cu")],
            capture_output=True, text=True, timeout=600,
        )
    print("\n".join(line for line in result.stderr.splitlines() if "registers" in line or "spill" in line), flush=True)
    entry = timed("relative-key attention kernel", phase_relkey_attention, *w2v_bert_serving_shape())
    launches = {"relkey_attention": 0}
    timed("w2v-BERT serve", phase_w2v_bert_serve, launches)
    entry["launches"] = launches["relkey_attention"]
    print(json.dumps({"kernels": [entry]}), flush=True)
    return 0


def timed(label: str, function, *arguments):
    """``function(*arguments)``, with a line of the seconds it took."""
    started = time.perf_counter()
    value = function(*arguments)
    print(f"phase {label}: {time.perf_counter() - started:.1f} s", flush=True)
    return value


def main() -> int:
    if sys.argv[1:2] == [CHILD_FLAG]:
        return train_cli_child(sys.argv[2:])
    if sys.argv[1:2] == [ARTIFACT_CHILD_FLAG]:
        return serve_artifact_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "allophant_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: allophant_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from allophant_tpu_torch.device import set_float32_precision

    if sys.argv[1:] == [MULTI_GPU_FLAG]:
        return multi_gpu_only()
    if sys.argv[1:] == [W2V_BERT_FLAG]:
        return w2v_bert_only()
    overall = time.perf_counter()
    card = timed("card", phase_card)
    timed("build", phase_build)
    timed("tensor cores", phase_tensor_cores)
    timed("frame encoder SASS", phase_frame_encoder_sass)
    set_float32_precision("highest")
    launches = dict.fromkeys(
        (
            "oneshot_attention", "frame_encoder", "beam_search", "beam_backtrace", "attention_backward", "attention_dropout",
            "dropout_mask", "relkey_attention",
        ),
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
        timed("attention kernels", phase_attention, serve_lengths, serve_time),
        timed("relative-key attention kernel", phase_relkey_attention, *w2v_bert_serving_shape()),
        timed("frame encoder kernel", phase_frame_encoder, len(first_batch), samples),
        *timed("beam kernels", phase_beam_kernels, serve_lengths, serve_time),
    ]
    dropout_forward, backward = timed("dropout kernels", phase_dropout_attention)
    entries += [backward, dropout_forward, timed("dropout mask kernel", phase_dropout_mask)]
    timed("head offset", phase_head_offset)
    timed("head widths", phase_head_widths)
    estimator = build_serving_flagship()
    timed("serve", phase_serve, estimator, launches)
    timed("serve beam", phase_serve_beam, estimator, launches)
    del estimator
    torch.cuda.empty_cache()
    timed("w2v-BERT serve", phase_w2v_bert_serve, launches)
    timed("wide heads", phase_wide_encoder, launches)
    torch.cuda.empty_cache()
    timed("float32", phase_float32)
    step_seconds = timed("train", phase_train, launches)
    torch.cuda.empty_cache()
    timed("train float32", phase_train_float32)
    torch.cuda.empty_cache()
    timed("remat", phase_remat, launches, step_seconds)
    torch.cuda.empty_cache()
    timed("remat float32", phase_remat_float32)
    torch.cuda.empty_cache()
    timed("transformer", phase_transformer, launches)
    torch.cuda.empty_cache()
    from allophant_tpu_torch.phonetics.features import SingletonFeatureWarning

    # The demo table's one-valued "tone" column is structural: each indexer
    # the CLI rebuilds from a checkpoint would warn of it.
    warnings.simplefilter("ignore", SingletonFeatureWarning)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as directory:
        root = Path(directory)
        master_params = timed("train loop", phase_train_loop, launches, step_seconds, root)
        torch.cuda.empty_cache()
        timed("train loop float32", phase_train_loop_float32)
        torch.cuda.empty_cache()
        timed("predict", phase_predict, launches, root, master_params)
        del master_params
        torch.cuda.empty_cache()
        timed("orbax", phase_orbax, launches, root, card)
        torch.cuda.empty_cache()
        timed("predict float32", phase_predict_float32, root)
        torch.cuda.empty_cache()
        timed("train CLI", phase_train_cli, launches, root)
        torch.cuda.empty_cache()
        timed("multi-GPU", phase_multi_gpu, launches, root)
        torch.cuda.empty_cache()
        timed("pretrained", phase_pretrained, launches, root)
        timed("data CLI", phase_data_cli, launches, root)
        torch.cuda.empty_cache()
        timed("export", phase_export, launches, root)
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
