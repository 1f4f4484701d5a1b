"""Starting one process a rank: ``spawn`` runs a function in every rank of a
new process group (``torch.multiprocessing``'s spawn start method, a
``FileStore`` under a directory for the rendezvous, so no port is taken)."""

from __future__ import annotations

import os
import signal
from typing import Callable, Optional, Sequence

import torch

from allophant_tpu_torch.parallel import mesh as mesh_module

_FORWARDED = (signal.SIGTERM, signal.SIGINT)


def _rank_main(
    index: int,
    function: Callable,
    store_path: str,
    devices: Sequence[str],
    cpu_threads: Optional[int],
    own_process_group: bool,
    arguments: tuple,
) -> None:
    if own_process_group:
        # The parent forwards the terminal's SIGINT: none arrives twice.
        os.setpgrp()
    os.environ["LOCAL_RANK"] = str(index)
    if cpu_threads is not None:
        torch.set_num_threads(cpu_threads)
    device = mesh_module.rank_device(devices[index])
    mesh_module.initialize(device, store_path=store_path, rank=index, devices=devices)
    try:
        function(index, len(devices), device, *arguments)
    finally:
        torch.distributed.destroy_process_group()


def spawn(
    function: Callable,
    workdir: str,
    devices: Sequence[str],
    arguments: tuple = (),
    cpu_threads: Optional[int] = None,
    forward_signals: bool = False,
) -> None:
    """Runs ``function(rank, world_size, device, *arguments)`` in one new
    process for each of ``devices``, joined in one process group (its backend
    by ``mesh.backend``); rank ``r`` runs on ``devices[r]``. ``function`` must
    be importable (it is pickled by name). With ``forward_signals`` the ranks
    run in process groups of their own and SIGTERM and SIGINT sent to this
    process are passed on to every rank. Waits for every rank; raises if any
    raised or died. ``workdir`` holds the group's store file (it must not hold
    one from an earlier group)."""
    import torch.multiprocessing as multiprocessing

    store_path = os.path.join(workdir, "process_group_store")
    context = multiprocessing.start_processes(
        _rank_main,
        args=(function, store_path, tuple(str(device) for device in devices), cpu_threads, forward_signals, tuple(arguments)),
        nprocs=len(devices),
        join=False,
        start_method="spawn",
    )
    handlers = {}
    if forward_signals:

        def forward(signum, _frame):
            for process in context.processes:
                if process.is_alive():
                    os.kill(process.pid, signum)

        handlers = {signum: signal.signal(signum, forward) for signum in _FORWARDED}
    try:
        while not context.join():
            pass
    finally:
        for signum, handler in handlers.items():
            signal.signal(signum, handler)
