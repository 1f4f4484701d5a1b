"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below what the configuration
states (the encoder's bfloat16 products as per-tensor fp8 e4m3, the head's
float32 products in TF32), judged by the numbers a run compares.
``--control head`` lowers the head alone (bfloat16 encoder, TF32 head).

    python3 cardbench/calibrate.py --workload CELL --seeds N [N ...] [--control lower|head]

Prints one JSON line a seed with the control's readings, and for a
training cell also the reference's with half of each microbatch left out
(the fault "half of the batch left out, the mean taken over the rest"). A
cell's limits
(``cardbench/limits/<cell>.json``) lie between the largest reading of the
program's own runs and the smallest of these; benchmark runs never run the
control. Needs a CUDA card, as the cells do."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: One precision below the "mixed" preset's parts.
CONTROL = {"encoder": "fp8", "head": "tf32"}
#: The head alone one precision below: the program's encoder, a TF32 head.
CONTROLS = {"lower": CONTROL, "head": {"encoder": "bfloat16", "head": "tf32"}}


def context_for(spec: dict, workload: str, seed: int, device: str = "cuda", **overrides):
    from cardbench.core.context import make_context

    return make_context(spec, workload, seed, 0.0, False, device, 0.0, **overrides)


def serving_control(context, numerics, offered: int = 64) -> dict:
    """The control's gap over a sample drawn as a run draws it, from the
    first ``offered`` requests of the seed's stream."""
    from cardbench.core import registry
    from cardbench.tasks import serve

    kind = registry.traffic_kind(context.traffic["kind"])
    stream = kind.replayed(context.traffic, context.seed)
    sample = serve.Sample(int(context.traffic["check"]["requests"]), context.seed)
    for _ in range(offered):
        sample.offer(next(stream), None)
    requests = [request for request, _host in sample.items()]
    return serve.control_numbers(context, requests, numerics)


def half_batch(groups):
    """The fault "half of the batch left out, the mean taken over the rest":
    each microbatch keeps its first half of the rows."""
    from dataclasses import replace

    out = []
    for group in groups:
        cut = []
        for request in group:
            rows = max(1, (len(request.lengths) + 1) // 2)
            cut.append(replace(
                request, audio=request.audio[:rows], lengths=request.lengths[:rows], language_ids=request.language_ids[:rows],
                labels={name: value[:rows] for name, value in request.labels.items()},
                label_lengths={name: value[:rows] for name, value in request.label_lengths.items()},
            ))
        out.append(cut)
    return out


def training_control(context, numerics) -> dict:
    """The training numbers of the reference at the control's precision
    against the float32 reference, over the seed's first checked updates,
    and of the float32 reference with half of each microbatch left out."""
    import torch

    from cardbench.core import port, registry, weights
    from cardbench.tasks import train

    config, head, traffic = context.config, context.head, context.traffic
    kind = registry.traffic_kind(traffic["kind"])
    stream = kind.requests(traffic, context.seed, head)
    groups = [[next(stream) for _ in range(int(traffic["microbatches"]))] for _ in range(train.check_steps_of(context))]
    device = torch.device(context.device)
    drawn = weights.draw(port.reference_shapes(config, head), context.seed, device, head["static"])
    initial = {name: value.detach().cpu() for name, value in drawn.items()}
    del drawn
    exact = train.reference_steps(context, groups, initial, device)
    readings = {}
    for label, run in (("control", train.reference_steps(context, groups, initial, device, numerics)),
                       ("half_batch", train.reference_steps(context, half_batch(groups), initial, device))):
        checks = train.compare(context, run["losses"], run["grads"], run["changes"], exact)
        readings[label] = {name: check.value for name, check in checks.items()}
    return readings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", choices=sorted(CONTROLS), default="lower")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cardbench.core import card, registry
    from cardbench.reference.model import Numerics

    card.require_cards(1)
    print(f"cardbench card: {card.describe()}", flush=True)
    spec = registry.benchmark(ROOT)
    numerics = Numerics(CONTROLS[args.control]["encoder"], CONTROLS[args.control]["head"])
    for seed in args.seeds:
        started = time.perf_counter()
        context = context_for(spec, args.workload, seed)
        if context.traffic["task"] == "train":
            readings = training_control(context, numerics)
        else:
            readings = serving_control(context, numerics)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": f"{numerics.encoder}/{numerics.head}",
                          "readings": readings, "seconds": time.perf_counter() - started}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
