"""The system under test: the port's model of a configuration, built through
its normal path (``demo._flagship_build`` -> ``build_model``) and given the
benchmark's weights."""

from __future__ import annotations

import numpy as np
import torch

from cardbench.core import registry, weights
from cardbench.reference.model import ReferenceAllophant


def architecture(config: dict):
    """The port's architecture object of the configuration's encoder."""
    return registry.encoder(config["encoder"]).port_architecture(config["architecture"])


def check_head(model, head: dict) -> None:
    """Raises unless the port's head is the frozen one: the same classifiers,
    sizes and tables."""
    plan = head["plan"]
    ours = [(node["name"], node["output_size"], node["projection_size"]) for node in plan["nodes"]]
    theirs = [(node.name, node.output_size, node.projection_size) for node in model.plan.nodes]
    if ours != theirs:
        raise ValueError(f"the port's head {theirs[:3]}... is not the frozen head {ours[:3]}...")
    static = head["static"]
    buffers = dict(model.named_buffers())
    checks = {
        "projection.composition_feature_table": static["composition_feature_table"],
        "projection.allophone.gather_indices": static["allophone_gather"],
        "projection.allophone.initialization": static["allophone_matrices"],
    }
    for name, expected in checks.items():
        if not np.array_equal(buffers[name].cpu().numpy(), expected):
            raise ValueError(f"the port's {name} is not the frozen head's")


_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def precision_departures(config: dict) -> list:
    """Where the port does not run the precision the configuration states:
    each part of ``precision_parts`` (which the reference, the control and
    ``mfu`` read) against the port's preset as ``resolve_precision`` gives it,
    and the process's TF32 switches, as the port left them, against the
    stated float32 matmul precision. Empty when all agree."""
    from allophant_tpu_torch.training.estimator import resolve_precision

    dtype, head_dtype, matmul = resolve_precision(config["precision"])
    stated = config["precision_parts"]
    tf32 = stated["float32_matmul"] == "high"
    runs = {
        "encoder": _DTYPE_NAMES.get(dtype, str(dtype)),
        "head": _DTYPE_NAMES.get(head_dtype or dtype, str(head_dtype or dtype)),
        "float32_matmul": matmul,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    wanted = {**{key: stated[key] for key in ("encoder", "head", "float32_matmul")},
              "cuda.matmul.allow_tf32": tf32, "cudnn.allow_tf32": tf32}
    return [f"{key}: runs {runs[key]}, stated {wanted[key]}" for key in runs if runs[key] != wanted[key]]


def reference_shapes(config: dict, head: dict):
    return ReferenceAllophant(config, head, device="meta").shapes()


def build(config: dict, head: dict, seed: int, device, training: bool):
    """The port's model on ``device`` with the seed's weights: serving keeps
    the preset's compute types in the weights, training float32 master
    weights (remat as the configuration says). Returns the model and the
    host copy of the drawn weights (float32, by name)."""
    from allophant_tpu_torch.demo import _flagship_build
    from allophant_tpu_torch.training.estimator import resolve_precision

    dtype, head_dtype, _ = resolve_precision(config["precision"])
    remat = bool(config["training"]["remat"]) if training else False
    model = _flagship_build(
        architecture(config), dtype, head_dtype, device, param_dtype=torch.float32 if training else None, remat=remat
    ).model
    check_head(model, head)
    drawn = weights.draw(reference_shapes(config, head), seed, device, head["static"])
    weights.load_into(model, drawn)
    host = {name: value.detach().cpu() for name, value in drawn.items()} if training else None
    del drawn
    return model, host


def frame_lengths(config: dict, lengths) -> np.ndarray:
    """Frames of utterances of ``lengths`` samples, by the configuration's encoder."""
    return registry.encoder(config["encoder"]).frame_lengths(config["architecture"], lengths)
