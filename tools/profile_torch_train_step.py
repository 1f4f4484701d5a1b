"""Where the device time of one flagship training step goes on the GPU: the
PyTorch port's counterpart of ``tools/bench_train_step.py``.

    python3 tools/profile_torch_train_step.py [--steps N] [--trace-dir DIR]

Builds the full-width training flagship (XLS-R 300M + the 37-head
hierarchical head, "mixed": bf16 encoder, f32 head, f32 master weights; the
flagship's dropout, Adam, warmup schedule, clipping and frozen feature
extractor), takes two warm-up steps through ``make_train_step`` at A = 2,
B = 8, 10 s (chip_smoke.py's training microbatches), then profiles ``--steps``
steps under torch.profiler and prints: the card's name and power limit, the
wall time per step and audio-s/s, the device time per step by group (K4, K5,
GEMMs, elementwise, CTC, optimizer, ...) and the top kernels, the device's
idle share (1 - summed kernel time / wall time; one stream, so kernels do not
overlap) and the peak memory. Needs a CUDA device."""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("attention_backward", "attention backward (K4)"),
    ("attention_dropout", "attention dropout (K5)"),
    ("oneshot_attention", "attention (K1)"),
    ("frame_encoder_kernel", "frame encoder (K2)"),
    ("ctc", "CTC loss"),
    ("multi_tensor_apply", "optimizer and clipping (foreach)"),
    ("adam", "optimizer and clipping (foreach)"),
    ("bernoulli", "dropout masks"),
    ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("copy", "dtype casts and copies"),
    ("layer_norm", "layer norm"),
    ("softmax", "softmax"),
    ("reduce", "reductions"),
    ("index", "gathers and scatters"),
    ("elementwise", "elementwise arithmetic"),
)


def group_of(name: str) -> str:
    lowered = name.lower()
    for fragment, group in GROUPS:
        if fragment in lowered:
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=2, help="profiled steps, after two warm-up steps")
    parser.add_argument("--trace-dir", default=str(ROOT / "profiles"), help="where the Chrome trace is written")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from allophant_tpu_torch.demo import build_flagship_for_training
    from allophant_tpu_torch.models.layers import DropoutRng
    from allophant_tpu_torch.training.train_step import build_freeze_plan, build_loss_plan, create_optimizer, make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    config, model = build_flagship_for_training(seed=0, precision="mixed", device="cuda")
    optimizer = create_optimizer(config, model.architecture.hidden_size, model.parameters())
    step = make_train_step(
        model, optimizer, build_loss_plan(config, True), build_freeze_plan(config.acoustic_model)
    )
    accumulation, batch, seconds = chip_smoke.TRAIN_ACCUMULATION, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SECONDS
    microbatches = chip_smoke.training_microbatches(model, accumulation, batch, seconds * chip_smoke.SAMPLE_RATE, "cuda")
    rng = DropoutRng.from_seed(config.seed, "cuda")
    print(f"training step: A={accumulation} B={batch} {seconds} s, {model.architecture.num_hidden_layers} layers, mixed")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(microbatches, rng)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as profiler:
        start = time.perf_counter()
        for _ in range(args.steps):
            step(microbatches, rng)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / args.steps
    peak = torch.cuda.max_memory_allocated()
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / "torch_train_step_trace.json"
    profiler.export_chrome_trace(str(trace))

    by_kernel = defaultdict(float)
    counts = defaultdict(int)
    for event in profiler.events():
        # Device spans of record_function annotations (Optimizer.step#...)
        # cover kernels counted on their own.
        if event.device_type == torch.autograd.DeviceType.CUDA and not event.is_user_annotation:
            by_kernel[event.name] += event.device_time_total / 1e3 / args.steps
            counts[event.name] += 1
    device_ms = sum(by_kernel.values())
    by_group = defaultdict(float)
    for name, milliseconds in by_kernel.items():
        by_group[group_of(name)] += milliseconds
    audio_seconds = accumulation * batch * seconds
    print(
        f"step: {wall * 1e3:.3f} ms wall, {audio_seconds / wall:.1f} audio-s/s, device busy {device_ms:.3f} ms,"
        f" idle share {1 - device_ms / (wall * 1e3):.3f}, peak memory {peak / 2**30:.2f} GiB"
    )
    print("device time per step by group:")
    for group, milliseconds in sorted(by_group.items(), key=lambda item: -item[1]):
        print(f"  {group:34s} {milliseconds:9.3f} ms  {milliseconds / device_ms:6.1%}")
    print("top kernels per step:")
    for name, milliseconds in sorted(by_kernel.items(), key=lambda item: -item[1])[:20]:
        print(f"  {milliseconds:9.3f} ms  x{counts[name] // args.steps:<5d} {name[:100]}")
    print(f"trace: {trace.relative_to(ROOT) if trace.is_relative_to(ROOT) else trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
