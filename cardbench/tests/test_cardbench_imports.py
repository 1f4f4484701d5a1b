"""What the harness loads: no module whose top-level name, taken whole, is
``jax``, ``jaxlib``, ``flax`` or ``allophant_tpu`` (the port's name,
``allophant_tpu_torch``, begins with it and is not it); the reference loads
nothing of the port either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "allophant_tpu"}


def loaded_top_level(code: str) -> set:
    script = code + "\nimport json, sys\nprint(json.dumps(sorted({name.split('.')[0] for name in sys.modules})))"
    output = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, check=True, stdin=subprocess.DEVNULL,
    ).stdout
    return set(json.loads(output.strip().splitlines()[-1]))


def test_the_harness_metrics_and_tasks_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import runpy; run = runpy.run_path('cardbench/run.py', run_name='cardbench_run')\n"
        "from cardbench.core import registry\n"
        "spec = registry.benchmark()\n"
        "[registry.per_layer(spec, cell['name']) for cell in spec['workloads']]\n"
        "[registry.task(task) for task in ('serve', 'train')]\n"
        "[registry.encoder(registry.config(spec, entry['name'])['encoder']) for entry in spec['configs']]\n"
        "from cardbench.core import card; card.counters()\n"
        "import cardbench.calibrate\n"
        "import allophant_tpu_torch.training.estimator, allophant_tpu_torch.training.train_step, allophant_tpu_torch.demo\n"
    )
    names = loaded_top_level(code)
    assert "allophant_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import cardbench.reference.model, cardbench.reference.train, cardbench.reference.judge, cardbench.reference.beam\n"
        "import cardbench.reference.dropout, cardbench.reference.numerics, cardbench.reference.layers\n"
        "import importlib, pathlib\n"
        "[importlib.import_module('cardbench.reference.encoders.' + path.stem) for path in pathlib.Path('cardbench/reference/encoders').glob('*.py')]\n"
    )
    names = loaded_top_level(code)
    assert not names & (FORBIDDEN | {"allophant_tpu_torch"})


def test_no_source_of_the_reference_imports_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"allophant_tpu_torch"}, (path.name, name)


def test_the_run_refuses_forbidden_modules_by_whole_name():
    sys.path.insert(0, str(ROOT))
    import runpy

    run = runpy.run_path(str(BENCH / "run.py"), run_name="cardbench_run_names")
    assert run["forbidden_modules"](["allophant_tpu_torch", "allophant_tpu_torch.ops", "numpy"]) == []
    assert run["forbidden_modules"](["jax.numpy", "allophant_tpu.ops", "flax"]) == ["allophant_tpu", "flax", "jax"]
