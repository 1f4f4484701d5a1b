#!/usr/bin/env python3
"""End to end, this checkout against another on one GPU, in turns (other,
this, this, other): each turn is a fresh process in that checkout that runs
its own chip_smoke.py phases for the full-width flagship, greedy serving and
beam serving (three requests, then five repeats of the 8 x 2-10 s request)
and three training steps (A = 2, B = 8, 10 s), and prints their throughput
lines.

    python3 tools/compare_torch_end_to_end.py OTHER_CHECKOUT

Each checkout builds its kernels into its own allophant_tpu_torch/_build/."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
RUN = """
import sys
sys.path.insert(0, '.')
import chip_smoke as smoke
from allophant_tpu_torch.device import set_float32_precision
from allophant_tpu_torch.kernels.build import build_all
build_all()
set_float32_precision('highest')
results = dict.fromkeys(('oneshot_attention', 'frame_encoder', 'beam_search', 'beam_backtrace',
                         'attention_backward', 'attention_dropout', 'dropout_mask'), 0)
estimator = smoke.build_serving_flagship()
smoke.phase_serve(estimator, results)
smoke.phase_serve_beam(estimator, results)
del estimator
smoke.phase_train(results)
"""


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    checkouts = {"other": Path(sys.argv[1]).resolve(), "this": HERE}
    for label in ("other", "this", "this", "other"):
        result = subprocess.run([sys.executable, "-c", RUN], cwd=checkouts[label], capture_output=True, text=True, timeout=900)
        if result.returncode != 0:
            print(result.stdout[-2000:], result.stderr[-2000:], file=sys.stderr)
            return 1
        for line in result.stdout.splitlines():
            if "throughput" in line:
                print(f"{label}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
