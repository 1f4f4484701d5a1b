"""On the card: the control of each cell's comparison (the reference one
precision below the configuration's, in the program's place) reads above
the cell's limit, on three seeds. Skips without a CUDA card."""

import pytest
import torch

from cardbench import calibrate
from cardbench.core import registry
from cardbench.reference.model import Numerics

SPEC = registry.benchmark()
CONTROL = Numerics(calibrate.CONTROL["encoder"], calibrate.CONTROL["head"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("workload", [cell["name"] for cell in SPEC["workloads"]])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_the_control_is_not_correct(card, workload, seed):
    context = calibrate.context_for(SPEC, workload, seed)
    if context.traffic["task"] == "train":
        readings = calibrate.training_control(context, CONTROL)["control"]
    else:
        readings = calibrate.serving_control(context, CONTROL)
    assert any(value > context.limits[name] for name, value in readings.items()), readings
