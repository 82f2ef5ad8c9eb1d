"""Process setup and the film gather (counterpart of
``tpurt/dist/runtime.py``).

tpurt is single-controller: one process sees every device.  The port is
SPMD: one process per rank (``torchrun``, or ``dist/dryrun.py``'s spawned
ranks), each holding its shard and talking over a ``torch.distributed``
process group: NCCL between cards, gloo between CPU processes (the tests).
There is no fallback: a group that fails to come up on the card raises.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("tpurt_torch.dist")


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device: str = "cuda") -> None:
    """Join (or, with nothing given, make) the default process group.

    Arguments absent fall back to torchrun's environment: MASTER_ADDR and
    MASTER_PORT (the coordinator), WORLD_SIZE and RANK.  The coordinator is
    ``host:port`` (a TCP rendezvous) or a URL such as ``file:///path``.
    With neither a coordinator nor more than one process this makes a
    world-1 group over an in-process store, which a DeviceMesh needs.
    backend: ``"nccl"`` for ``device="cuda"``, ``"gloo"`` otherwise; on the
    card each rank takes the card LOCAL_RANK (torchrun) or its rank names.
    A group already made by the caller is kept."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    rank = process_id or 0
    if device == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    if coordinator is None and num_processes in (None, 1):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=rank)
    log.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
             backend)


def is_coordinator() -> bool:
    """True on rank 0, and in a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_film(image: torch.Tensor) -> np.ndarray | None:
    """The film from this rank's shard of it (rank r holds the r-th of equal
    contiguous row blocks): the whole film, as numpy, on rank 0; None on
    every other rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return image.detach().cpu().numpy()
    shard = image.detach().contiguous()
    parts = ([torch.empty_like(shard) for _ in range(dist.get_world_size())]
             if is_coordinator() else None)
    dist.gather(shard, parts, dst=0)
    return torch.cat(parts).cpu().numpy() if is_coordinator() else None
