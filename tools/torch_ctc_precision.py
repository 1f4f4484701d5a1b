"""How far the CTC gradient of the port (``ops/ctc.py``: float32 log-probs,
``F.ctc_loss``'s recursion in float64) lies from the same gradient computed
wholly in float64, at growing sequence lengths; with the JAX package
importable, also JAX's float32 gradient (``allophant_tpu/ops/ctc.py``).

    python3 tools/torch_ctc_precision.py [--device cpu|cuda]

Inputs: seeded logits N(0, 3^2) of [2, T, 40] and 30 labels a row, all
frames valid. Prints, per T, the largest absolute difference of each f32
gradient from the f64 one (the gradient's largest magnitude is about 1)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    from allophant_tpu_torch.ops import ctc

    try:
        import jax.numpy as jnp
        from jax import grad

        from allophant_tpu.ops import ctc as jax_ctc
    except ImportError:
        jax_ctc = None
    rng = np.random.default_rng(0)
    batch, classes, labels_per_row = 2, 40, 30
    for time_steps in (100, 500, 1000, 1920):
        logits = (3 * rng.standard_normal((batch, time_steps, classes))).astype(np.float32)
        labels = rng.integers(1, classes, (batch, labels_per_row)).astype(np.int64)
        label_lengths = np.full(batch, labels_per_row)
        lengths = np.full(batch, time_steps)
        tensor = torch.from_numpy(logits).to(args.device).requires_grad_()
        loss = ctc.ctc_loss_sum_heads(
            [("head", tensor, torch.from_numpy(labels).to(args.device), torch.from_numpy(label_lengths).to(args.device))],
            torch.from_numpy(lengths).to(args.device),
        )["head"]
        loss.backward()
        exact = torch.from_numpy(logits.astype(np.float64)).to(args.device).requires_grad_()
        torch.nn.functional.ctc_loss(
            torch.log_softmax(exact, -1).transpose(0, 1), torch.from_numpy(labels).to(args.device),
            torch.from_numpy(lengths).to(args.device), torch.from_numpy(label_lengths).to(args.device), reduction="sum",
        ).backward()
        reference = exact.grad.cpu().numpy()
        line = f"T={time_steps}: port {np.abs(tensor.grad.cpu().numpy() - reference).max():.3e}"
        if jax_ctc is not None:
            jax_gradient = grad(
                lambda values: jax_ctc.ctc_loss_sum_heads(
                    [("head", values, jnp.asarray(labels, jnp.int32), jnp.asarray(label_lengths, jnp.int32))], jnp.asarray(lengths, jnp.int32)
                )["head"]
            )(jnp.asarray(logits))
            line += f", JAX f32 {np.abs(np.asarray(jax_gradient) - reference).max():.3e}"
        print(f"{line}, largest gradient {np.abs(reference).max():.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
