#!/usr/bin/env python3
"""Times this checkout's hand-written kernels against another checkout's
build of the same kernels on one GPU, in turns (other, this, this, other), at
the main path's shapes, and compares their outputs:

- K1, one-shot attention, q/k/v [8, 511, 1024] bf16 (strided views of a fused
  projection, the serving request's frame lengths);
- K5 and K4, attention with dropout and its backward, [8, 499, 1024] bf16,
  rate 0.1 (the training shape);
- K2, the frame encoder, [8, 163840] -> [8, 32767, 512] bf16;
- the beam backtrace of one serving request ([288, 511, 4] + [16, 511, 40]).

    python3 tools/compare_torch_kernels.py OTHER_CHECKOUT

The other checkout's csrc/*.cu are built with this checkout's nvcc flags
into allophant_tpu_torch/_build/compare/ and bound with that checkout's
signatures (an entry point from before K5's and K4's head map runs at head
offset 0). Each time is the mean of two medians of three
CUDA-event rounds."""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as smoke  # noqa: E402
import allophant_tpu_torch.ops.beam_kernel as beam_module  # noqa: E402
import allophant_tpu_torch.ops.frame_encoder as frame_module  # noqa: E402
import allophant_tpu_torch.ops.oneshot_attention as attention_module  # noqa: E402
from allophant_tpu_torch.kernels import build  # noqa: E402

LIBRARIES = ("oneshot_attention", "attention_dropout", "attention_backward", "frame_encoder", "beam_search")
ENTRY_POINTS = ("oneshot_attention", "attention_dropout", "attention_backward", "frame_encoder", "beam_backtrace")
MODULES = (attention_module, frame_module, beam_module)


def other_signatures(checkout: Path) -> dict:
    """The other checkout's ``kernels/build.py:_SIGNATURES``."""
    spec = importlib.util.spec_from_file_location("other_build", checkout / "allophant_tpu_torch" / "kernels" / "build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._SIGNATURES


def without_head_map(function):
    """An entry point from before K5's and K4's ``total_heads`` and
    ``head_offset`` (the two arguments before the dtype and the stream),
    called with this checkout's arguments at offset 0."""
    return lambda *arguments: function(*arguments[:-4], *arguments[-2:])


def build_other(checkout: Path) -> dict:
    """The other checkout's entry points, built into _build/compare/."""
    directory = build.BUILD_ROOT / "compare"
    directory.mkdir(parents=True, exist_ok=True)
    jobs = [
        subprocess.Popen([build.cuda_tool(), *build.NVCC_FLAGS, "-o", str(directory / f"lib{name}.so"),
                          str(checkout / "allophant_tpu_torch" / "csrc" / f"{name}.cu")])
        for name in LIBRARIES
    ]
    if any(job.wait() != 0 for job in jobs):
        raise SystemExit("nvcc failed on the other checkout")
    functions = {}
    signatures = other_signatures(checkout)
    for name in ENTRY_POINTS:
        library, symbol, argtypes, *_ = signatures[name]
        function = getattr(ctypes.CDLL(str(directory / f"lib{library}.so")), symbol)
        function.argtypes = argtypes
        function.restype = ctypes.c_int
        if len(build._SIGNATURES[name][2]) - len(argtypes) == 2:
            function = without_head_map(function)
        functions[name] = function
    return functions


def flatten(value):
    return [value] if isinstance(value, torch.Tensor) else [tensor for item in value for tensor in flatten(item)]


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    build.build_all()
    other = build_other(Path(sys.argv[1]).resolve())
    current = {module: module.load_kernel for module in MODULES}

    def use(variant):
        for module in MODULES:
            module.load_kernel = (lambda name: other[name]) if variant == "other" else current[module]

    serve_lengths = [499, 99, 296, 0, 399, 174, 449, 240]
    q, k, v, bias, _ = smoke.attention_inputs(serve_lengths, 511, 16, 64, torch.bfloat16, fused_qkv=True)
    tq, tk, tv, tbias, _ = smoke.attention_inputs([499] * 8, 499, 16, 64, torch.bfloat16, fused_qkv=True)
    grad = torch.randn(tq.shape, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda").to(torch.bfloat16)
    audio = smoke.frame_encoder_inputs(8, 163840)
    seeds = smoke.DROPOUT_SEEDS
    searches = []
    for batch, classes, scale in ((36 * 8, 4, 1.0), (2 * 8, 40, 2.0)):
        emissions, lengths = smoke.beam_inputs(batch, 511, classes, serve_lengths * (batch // 8), 7, scale)
        parents, emitted, _ = beam_module.beam_search_cuda(emissions, lengths, 4)
        searches.append((parents, emitted, lengths))
    cases = {
        "oneshot_attention [8, 511, 1024] bf16": (lambda: attention_module.oneshot_attention(q, k, v, bias, 0.125, 16), 20),
        "attention_dropout [8, 499, 1024] bf16 rate 0.1": (
            lambda: attention_module.oneshot_dropout_attention(tq, tk, tv, tbias, seeds, 0.125, 16, 0.1), 20),
        "attention_backward [8, 499, 1024] bf16 rate 0.1": (
            lambda: attention_module.oneshot_attention_backward(tq, tk, tv, grad, tbias, seeds, 0.125, 16, 0.1), 10),
        "frame_encoder [8, 163840] -> [8, 32767, 512] bf16": (
            lambda: frame_module.fused_frame_conv(*audio, eps=1e-5, out_dtype=torch.bfloat16), 20),
        "beam_backtrace per request ([288, 511, 4] + [16, 511, 40])": (
            lambda: [beam_module.backtrace_cuda(*search) for search in searches], 20),
    }
    smoke.phase_card()
    for label, (call, iterations) in cases.items():
        outputs = {}
        for variant in ("other", "this"):
            use(variant)
            outputs[variant] = flatten(call())
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(outputs["other"], outputs["this"]))
        difference = max((a.float() - b.float()).abs().max().item() for a, b in zip(outputs["other"], outputs["this"]))
        readings = {"other": [], "this": []}
        for variant in ("other", "this", "this", "other"):
            use(variant)
            readings[variant].append(smoke.median_ms(call, iterations))
        use("this")
        print(
            f"compare {label}: other {', '.join(f'{x:.4f}' for x in readings['other'])} ms, this"
            f" {', '.join(f'{x:.4f}' for x in readings['this'])} ms; mean other {np.mean(readings['other']):.4f},"
            f" this {np.mean(readings['this']):.4f}; outputs bit-equal {equal} (max difference {difference:.3e})",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
