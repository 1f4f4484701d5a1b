"""The process group and a (data, model) grid of ranks (counterpart of
``allophant_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices; the port runs one process per
device, joined by ``torch.distributed`` (NCCL between GPUs, gloo on the CPU).
A ``Mesh`` lays the world's ranks out as JAX lays out its devices, row-major
over (data, model): rank ``r`` is data rank ``r // model_parallel`` and model
rank ``r % model_parallel``. Its data group holds the ranks of its model
column (gradients are summed there), its model group the ranks of its data
row (the tensor-parallel layers reduce there). A group of one rank is
``None``, and every collective on it is skipped, so a one-process mesh needs
no process group at all."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from allophant_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def torchrun_environment() -> bool:
    """Whether this process was started by ``torchrun`` (or anything that sets
    its environment variables)."""
    return all(name in os.environ for name in _TORCHRUN_VARIABLES)


# How long a collective may wait for the other ranks before it fails.
TIMEOUT = datetime.timedelta(minutes=10)


def backend(devices: Sequence) -> str:
    """The backend of a group whose ranks run on ``devices`` (one a rank):
    NCCL when each rank has a card of its own, gloo when a rank runs on the
    CPU or two ranks share a card (NCCL refuses two ranks on one card)."""
    devices = [torch.device(device) for device in devices]
    cards = {(device.index or 0) for device in devices if device.type == "cuda"}
    return "nccl" if len(cards) == len(devices) else "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this process: ``device`` (CUDA unless the caller asks for
    another; raises without one), and for CUDA without an index the card of
    ``LOCAL_RANK`` (0 when unset; taken round the visible cards when ranks
    share them)."""
    resolved = resolve_device(device)
    if resolved.type == "cuda" and resolved.index is None:
        resolved = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return resolved


def _node_devices(device: torch.device) -> list:
    """The devices of this node's ``torchrun`` ranks (``LOCAL_WORLD_SIZE`` of
    them, ``device``'s kind, the cards taken round as ``rank_device`` takes
    them)."""
    count = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if device.type != "cuda":
        return [device] * count
    return [torch.device("cuda", rank % torch.cuda.device_count()) for rank in range(count)]


def initialize(
    device: torch.device,
    store_path: Optional[str] = None,
    rank: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> None:
    """Joins the process group on ``device``: with ``store_path``, from a
    ``FileStore`` at that path (no port to collide with), as rank ``rank`` of
    the ranks on ``devices``; else from ``torchrun``'s environment. The
    backend follows ``backend`` over every rank's device. A CUDA device
    becomes the current one."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if store_path is not None:
        if rank is None or devices is None:
            raise ValueError("A FileStore group needs this rank and every rank's device")
        world_size = len(devices)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend(devices), store=store, rank=rank, world_size=world_size, timeout=TIMEOUT)
    elif torchrun_environment():
        dist.init_process_group(backend(_node_devices(device)), init_method="env://", timeout=TIMEOUT)
    else:
        raise ValueError("No torchrun environment and no FileStore path: nothing to join")


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of ranks and its groups.
    ``ranks`` are the world ranks of the grid, row-major; ``rank`` is this
    process's world rank; ``group`` holds the whole grid."""

    data_parallel: int
    model_parallel: int
    ranks: Tuple[int, ...]
    rank: int
    group: Optional[object]
    data_group: Optional[object]
    model_group: Optional[object]

    @property
    def shape(self):
        return {DATA_AXIS: self.data_parallel, MODEL_AXIS: self.model_parallel}

    @property
    def size(self) -> int:
        return self.data_parallel * self.model_parallel

    @property
    def index(self) -> int:
        """This rank's place in the grid, row-major."""
        return self.ranks.index(self.rank)

    @property
    def data_rank(self) -> int:
        return self.index // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.index % self.model_parallel

    @property
    def data_ranks(self) -> Tuple[int, ...]:
        """The world ranks of this rank's data group (its model column)."""
        return self.ranks[self.model_rank :: self.model_parallel]

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        """The world ranks of this rank's model group (its data row)."""
        start = self.data_rank * self.model_parallel
        return self.ranks[start : start + self.model_parallel]


def _group(members: Sequence[int], world_size: int):
    if len(members) == 1:
        return None
    if len(members) == world_size:
        return dist.group.WORLD
    return dist.new_group(list(members))


def create_mesh(
    data_parallel: Optional[int] = None, model_parallel: int = 1, ranks: Optional[Sequence[int]] = None
) -> Optional[Mesh]:
    """A (data, model) mesh over ``ranks`` (default: every rank of the world).
    Every rank of the world calls it, members or not, since the groups are
    created collectively; a rank outside ``ranks`` gets None. Raises when the
    shape does not match the rank count, as the JAX mesh does."""
    rank, world_size = world()
    ranks = tuple(range(world_size)) if ranks is None else tuple(ranks)
    count = len(ranks)
    if data_parallel is None:
        data_parallel = count // model_parallel
    if data_parallel * model_parallel != count:
        raise ValueError(f"Mesh shape {data_parallel}x{model_parallel} does not match {count} devices")
    if any(not 0 <= member < world_size for member in ranks):
        raise ValueError(f"Ranks {ranks} do not exist in a world of {world_size}")
    groups = {"mesh": _group(ranks, world_size)}
    for row in range(data_parallel):
        members = ranks[row * model_parallel : (row + 1) * model_parallel]
        groups[("model", row)] = _group(members, world_size)
    for column in range(model_parallel):
        members = ranks[column::model_parallel]
        groups[("data", column)] = _group(members, world_size)
    if rank not in ranks:
        return None
    index = ranks.index(rank)
    return Mesh(
        data_parallel, model_parallel, ranks, rank, groups["mesh"],
        groups[("data", index % model_parallel)], groups[("model", index // model_parallel)],
    )


def all_reduce(tensor: torch.Tensor, group, op=None) -> torch.Tensor:
    """Reduces ``tensor`` in place over ``group`` (a sum unless ``op`` says
    otherwise); nothing to do on a group of one."""
    if group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, source: int, group) -> torch.Tensor:
    """Broadcasts ``tensor`` in place from world rank ``source`` over ``group``."""
    if group is not None:
        dist.broadcast(tensor, source, group=group)
    return tensor


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def process_local_slice(global_batch_size: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of a global batch over the data ranks (the
    ranks of one model group share it). Raises when the batch does not divide."""
    count = mesh.data_parallel
    if global_batch_size % count:
        raise ValueError(f"Global batch size {global_batch_size} is not divisible by {count} processes")
    local = global_batch_size // count
    start = mesh.data_rank * local
    return slice(start, start + local)


def gather_rows(local: torch.Tensor, start: int, total: int, group) -> torch.Tensor:
    """The [total, ...] tensor whose rows ``start:start + len(local)`` are this
    rank's ``local`` rows and the rest the other ranks' of ``group``: an
    all-reduce of zero-padded buffers, since gloo has no all-gather of CUDA
    tensors. Integer and bool tensors travel as int32 or int64 (gloo sums
    neither uint16 nor bool)."""
    if group is None:
        return local
    dtype = local.dtype
    carrier = dtype
    if dtype in (torch.uint8, torch.uint16, torch.int8, torch.int16, torch.bool):
        carrier = torch.int32
    buffer = torch.zeros((total, *local.shape[1:]), dtype=carrier, device=local.device)
    buffer[start : start + local.shape[0]] = local.to(carrier)
    all_reduce(buffer, group)
    return buffer.to(dtype)
