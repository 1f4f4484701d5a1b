"""Parameter sharding rules: tensor parallelism over the model axis
(counterpart of ``allophant_tpu/parallel/sharding.py``).

JAX's rules on the port's names, by a parameter's module name wherever it
occurs, as JAX matches its suffixes: the column-parallel projections
(``q_proj``, ``k_proj``, ``v_proj``, ``intermediate_dense``, ``linear1``,
``input_projection``) shard their output features, weight and bias; the
row-parallel ones (``out_proj``, ``output_dense``, ``linear2``) their input
features, weight only (the bias is added after the reduce). Everything else
is replicated. They occur in the wav2vec2 encoder layers, the transformer
acoustic model's layers and the projection head's attention classifiers.
The wav2vec2 encoder and the transformer fuse q, k and v into one
``qkv_proj`` [3D, D]: its shard takes, of each of the three, the rows of the
rank's heads, so the local tile is again a fused [3D/tp, D] projection of
H/tp heads.

Torch keeps a Dense weight as [out, in], where JAX keeps [in, out]: a JAX
spec ``(None, "model")`` is the port's dimension 0, ``("model", None)`` its
dimension 1."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from allophant_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, broadcast, gather_rows

# Module name -> fused parts of its column-parallel output.
_COLUMN_PARALLEL = {
    "qkv_proj": 3, "q_proj": 1, "k_proj": 1, "v_proj": 1, "intermediate_dense": 1, "linear1": 1, "input_projection": 1,
}
_ROW_PARALLEL = ("out_proj", "output_dense", "linear2")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """How a parameter is laid out over the model axis: ``dim`` is the torch
    dimension split over it (None: replicated), ``parts`` the number of fused
    blocks along ``dim`` that are each split (3 for the fused QKV)."""

    dim: Optional[int] = None
    parts: int = 1

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def partition(self, ndim: int) -> Tuple[Optional[str], ...]:
        """The spec as a tuple of axis names per dimension (a PartitionSpec's
        entries, in torch's layout)."""
        return tuple(MODEL_AXIS if axis == self.dim else None for axis in range(ndim))


def param_spec(name: str) -> ParamSpec:
    """The layout of the port's parameter ``name`` (a ``named_parameters``
    key) over the model axis."""
    *path, leaf = name.split(".")
    if not path:
        return ParamSpec()
    parent = path[-1]
    if parent in _COLUMN_PARALLEL and leaf in ("weight", "bias"):
        return ParamSpec(0, _COLUMN_PARALLEL[parent])
    if parent in _ROW_PARALLEL and leaf == "weight":
        return ParamSpec(1)
    return ParamSpec()


def _shard_view(full: torch.Tensor, spec: ParamSpec, model_rank: int, model_parallel: int) -> torch.Tensor:
    """The view of ``full`` that rank ``model_rank`` holds, shaped
    [..., parts, size, ...] at ``spec.dim``."""
    dim = spec.dim
    shape = full.shape
    if shape[dim] % (spec.parts * model_parallel):
        raise ValueError(f"Dimension {dim} of {tuple(shape)} does not split into {spec.parts} x {model_parallel}")
    blocks = full.reshape(*shape[:dim], spec.parts, shape[dim] // spec.parts, *shape[dim + 1 :])
    size = blocks.shape[dim + 1] // model_parallel
    return blocks.narrow(dim + 1, model_rank * size, size)


def _local_shape(shape, spec: ParamSpec, model_parallel: int):
    shape = list(shape)
    shape[spec.dim] //= model_parallel
    return tuple(shape)


def shard_tensor(full, spec: ParamSpec, model_rank: int, model_parallel: int) -> torch.Tensor:
    """Rank ``model_rank``'s shard of the full tensor (or numpy array)
    ``full``, a new contiguous tensor."""
    full = torch.as_tensor(np.asarray(full) if not isinstance(full, torch.Tensor) else full)
    if not spec.sharded or model_parallel == 1:
        return full.clone()
    view = _shard_view(full, spec, model_rank, model_parallel)
    return view.reshape(_local_shape(full.shape, spec, model_parallel)).clone()


def shard_state(state: Mapping[str, object], model_rank: int, model_parallel: int) -> Dict[str, torch.Tensor]:
    """Rank ``model_rank``'s entries of a full state dict (tensors or numpy
    arrays keyed by parameter name)."""
    return {name: shard_tensor(value, param_spec(name), model_rank, model_parallel) for name, value in state.items()}


def gather_tensor(local: torch.Tensor, spec: ParamSpec, mesh: Mesh) -> torch.Tensor:
    """The full tensor of which ``local`` is this rank's shard, on every rank of
    the model group: the ranks' [parts, size, ...] blocks stacked by
    ``gather_rows`` and laid out as ``_shard_view`` cuts them."""
    if not spec.sharded or mesh.model_group is None:
        return local
    dim, parts = spec.dim, spec.parts
    blocks = local.movedim(dim, 0)
    rest = blocks.shape[1:]
    blocks = blocks.reshape(1, parts, blocks.shape[0] // parts, *rest)
    stacked = gather_rows(blocks, mesh.model_rank, mesh.model_parallel, mesh.model_group)
    return stacked.transpose(0, 1).reshape(-1, *rest).movedim(0, dim)


def gather_state(named: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a rank's named shards (parameters, gradients or
    optimizer moments), on every rank of its model group."""
    return {name: gather_tensor(value.detach(), param_spec(name), mesh) for name, value in named.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Makes every rank hold rank 0's parameters and buffers (``replicate_pytree``
    of the JAX package): a replicated tensor is broadcast over the whole mesh
    from its first rank, a sharded one over each data group from the group's
    first rank, which holds the same shard as the mesh's first data row."""
    if mesh.size == 1:
        return module
    for name, tensor in (*module.named_parameters(), *module.named_buffers()):
        if param_spec(name).sharded and mesh.model_parallel > 1:
            broadcast(tensor.data, mesh.data_ranks[0], mesh.data_group)
        else:
            broadcast(tensor.data, mesh.ranks[0], mesh.group)
    return module
