"""Where the time of one serving request goes on the GPU, for the PyTorch
port's full-width flagship under the "mixed" preset.

    python3 tools/profile_torch_serving.py [--beam] [--trace-dir DIR]

Runs the 8-utterance request of chip_smoke.py (2-10 s each, one zero-length
filler row) through Estimator.predict_decoded (greedy), or with ``--beam``
through Estimator.predict_beam_decoded over all 38 heads at beam width 4 (as
chip_smoke.py's serve-beam phase), under torch.profiler and prints:
the card's name and power limit, the wall time per request, the device time
summed by kernel group and the top kernels, and the device's idle share (1 -
summed kernel time / wall time; kernels on one stream do not overlap).
Needs a CUDA device."""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Profiled requests, after two warm-up requests.
REPEATS = 3
# Beam width of --beam.
BEAM_WIDTH = 4
# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("beam_search", "beam search (K3)"),
    ("beam_backtrace_kernel", "beam backtrace"),
    ("oneshot_attention", "attention (K1)"),
    ("frame_encoder_kernel", "frame encoder (K2)"),
    ("cudnn", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("copy", "dtype casts and copies"),
    ("layer_norm", "layer norm"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise arithmetic"),
)


def group_of(name: str) -> str:
    for fragment, group in GROUPS:
        if fragment in name:
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--beam", action="store_true", help=f"profile beam serving at width {BEAM_WIDTH}, not greedy")
    parser.add_argument("--trace-dir", default=str(ROOT / "chiprun_out"))
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from allophant_tpu_torch.demo import build_flagship

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    estimator = build_flagship(seed=0, precision="mixed", device="cuda")
    batch = chip_smoke.serving_requests()[0][1]["batch"]
    heads = tuple(sorted(estimator.predict(batch, time_major=False).outputs))
    if args.beam:
        print(f"beam serving, beam width {BEAM_WIDTH}, {len(heads)} heads")
        request = lambda: estimator.predict_beam_decoded(batch, heads=heads, beam_width=BEAM_WIDTH)  # noqa: E731
    else:
        print(f"greedy serving, {len(heads)} heads")
        request = lambda: estimator.predict_decoded(batch, heads=heads)  # noqa: E731
    for _ in range(2):
        request()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as profiler:
        start = time.perf_counter()
        for _ in range(REPEATS):
            request()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / REPEATS
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    trace = trace_dir / f"torch_serving_trace{'_beam' if args.beam else ''}.json"
    profiler.export_chrome_trace(str(trace))

    by_kernel = defaultdict(float)
    counts = defaultdict(int)
    for event in profiler.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[event.name] += event.device_time_total / 1e3 / REPEATS
            counts[event.name] += 1
    device_ms = sum(by_kernel.values())
    by_group = defaultdict(float)
    for name, milliseconds in by_kernel.items():
        by_group[group_of(name)] += milliseconds
    audio_seconds = float(batch.lengths.sum()) / chip_smoke.SAMPLE_RATE
    print(f"request: {wall * 1e3:.3f} ms wall, {audio_seconds / wall:.1f} audio-s/s, device busy {device_ms:.3f} ms,"
          f" idle share {1 - device_ms / (wall * 1e3):.3f}")
    print("device time per request by group:")
    for group, milliseconds in sorted(by_group.items(), key=lambda item: -item[1]):
        print(f"  {group:24s} {milliseconds:9.3f} ms  {milliseconds / device_ms:6.1%}")
    print("top kernels per request:")
    for name, milliseconds in sorted(by_kernel.items(), key=lambda item: -item[1])[:15]:
        print(f"  {milliseconds:9.3f} ms  x{counts[name] // REPEATS:<4d} {name[:110]}")
    print(f"trace: {trace.relative_to(ROOT) if trace.is_relative_to(ROOT) else trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
