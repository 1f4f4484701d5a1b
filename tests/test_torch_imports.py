"""Import guard of the PyTorch port: no module of allophant_tpu_torch (the
C++ build helper ``native/build.py`` included), and not chip_smoke.py,
imports JAX, flax, orbax, pandas, msgpack, regex, transformers, safetensors,
tensorstore, zstandard or the JAX package — the machine with the GPU may have none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = (
    "jax", "jaxlib", "flax", "optax", "orbax", "pandas", "msgpack", "regex", "allophant_tpu", "transformers",
    "safetensors", "tensorstore", "zstandard",
)
SOURCES = sorted((ROOT / "allophant_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda path: str(path.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    for module in _imported_modules(path):
        root = module.split(".")[0]
        assert root not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {module}"


def test_the_parallel_package_is_guarded():
    """``allophant_tpu_torch/parallel/`` is among the guarded sources, and
    importing it joins no process group."""
    parallel = {path.name for path in SOURCES if path.parent.name == "parallel"}
    assert {"__init__.py", "mesh.py", "sharding.py", "tensor_parallel.py", "launch.py", "dryrun.py"} <= parallel
    script = (
        "import torch.distributed as dist\n"
        "import allophant_tpu_torch.parallel.dryrun, allophant_tpu_torch.parallel.launch\n"
        "assert not dist.is_initialized()\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr


def test_the_serving_modules_are_guarded():
    """The serving export, the kernels' custom ops and the strided conv are
    among the guarded sources."""
    guarded = {str(path.relative_to(ROOT)) for path in SOURCES}
    for name in ("serving.py", "kernels/library.py", "ops/strided_conv.py"):
        assert f"allophant_tpu_torch/{name}" in guarded, name


def test_importing_every_module_loads_no_forbidden_package():
    modules = [
        ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for path in SOURCES
        if path.name != "chip_smoke.py"
    ]
    # Only modules loaded by the port's imports count (an interpreter start-up
    # hook may have loaded others before).
    script = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        f"loaded = sorted(n for n in set(sys.modules) - before if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not loaded, loaded\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
