"""Writes the Orbax checkpoint fixture ``tests/data/orbax_mini/`` with the JAX
package, on 4 virtual CPU devices, so that tensorstore writes it: zstd
compressed chunks inside an OCDBT store, with arrays split into several
chunks by a sharded save.

- ``checkpoint/``: ``save_orbax`` of the mini model of ``tests/fixtures.py``
  (``mini_config_dict()``, the transformer on raw samples) with its
  parameters sharded over a 2 x 2 (data, model) mesh by JAX's
  ``param_spec``, so most arrays are written as several chunks (Orbax
  splits each array among the devices that hold a part or a replica of it).
- ``extras/``: a ``StandardCheckpointer`` save of the dtypes the model does
  not hold: a sharded bfloat16 array, float16, int32, int64, uint16, uint8
  and bool arrays and a numpy float32 scalar.
- ``leaves.npz``: every leaf, keyed ``checkpoint/<path>`` and
  ``extras/<path>`` (bfloat16 as float32, which is exact).

Run from the repository root:

    JAX_PLATFORMS=cpu python tools/write_orbax_fixture.py [OUT_DIR]

``OUT_DIR`` defaults to ``tests/data/orbax_mini``; an existing one is
replaced."""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
_FLAGS = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _FLAGS:
    os.environ["XLA_FLAGS"] = (_FLAGS + " --xla_force_host_platform_device_count=4").strip()

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from allophant_tpu.config import Config  # noqa: E402
from allophant_tpu.models.allophant import attribute_graph_from_config  # noqa: E402
from allophant_tpu.parallel.mesh import create_mesh  # noqa: E402
from allophant_tpu.parallel.sharding import apply_param_shardings  # noqa: E402
from allophant_tpu.phonetics.features import PhoneticAttributeIndexer  # noqa: E402
from allophant_tpu.training import checkpoint as checkpoint_module  # noqa: E402
from allophant_tpu.training.estimator import Estimator  # noqa: E402
from fixtures import mini_allophoible_csv, mini_config_dict  # noqa: E402


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, (*prefix, key))
        else:
            yield "/".join((*prefix, key)), value


def main(out_dir: Path) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit(f"needs 4 devices, found {len(jax.devices())}")
    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    mesh = create_mesh(jax.devices()[:4], data_parallel=2, model_parallel=2)

    config = Config.load(mini_config_dict())
    indexer = PhoneticAttributeIndexer.from_config(config, mini_allophoible_csv())
    estimator = Estimator.from_config(
        config, 1, 16_000, attribute_graph_from_config(config, indexer), indexer,
        load_pretrained_weights=False, seed=13, precision="float32",
    )
    variables = dict(estimator.variables)
    variables["params"] = apply_param_shardings(variables["params"], mesh)
    checkpoint_module.save_orbax(
        checkpoint_module.Checkpoint(
            config=config,
            feature_size=1,
            sample_rate=16_000,
            attribute_graph=estimator.attribute_graph,
            epoch=checkpoint_module.EpochPosition(2, 40, 5),
            phonetic_indexer_state=indexer.state(),
            variables=variables,
            optimizer_state=b"fixture-optimizer",
        ),
        str(out_dir / "checkpoint"),
    )

    rng = np.random.default_rng(13)
    model_split = NamedSharding(mesh, PartitionSpec(None, "model"))
    extras = {
        "bfloat16": jax.device_put(jnp.asarray(rng.standard_normal((8, 6)), jnp.bfloat16), model_split),
        "float16": rng.standard_normal((4, 3)).astype(np.float16),
        "int32": rng.integers(-1000, 1000, (3, 5)).astype(np.int32),
        "int64": np.arange(-3, 9, dtype=np.int64).reshape(3, 4) * (1 << 40),
        "uint16": rng.integers(0, 65535, (7,)).astype(np.uint16),
        "uint8": rng.integers(0, 255, (2, 2, 3)).astype(np.uint8),
        "bool": rng.random((5,)) > 0.5,
        "scalar": np.float32(3.25),
    }
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(out_dir / "extras"), extras)
    checkpointer.wait_until_finished()

    leaves = {}
    for name, value in _flatten(jax.tree_util.tree_map(np.asarray, variables)):
        leaves[f"checkpoint/{name}"] = value
    for name, value in extras.items():
        value = np.asarray(value)
        leaves[f"extras/{name}"] = value.astype(np.float32) if value.dtype == jnp.bfloat16 else value
    np.savez_compressed(out_dir / "leaves.npz", **leaves)
    total = sum(path.stat().st_size for path in out_dir.rglob("*") if path.is_file())
    print(f"wrote {out_dir} ({total} bytes)")


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "tests" / "data" / "orbax_mini")
