"""Processes and process groups for the mesh: one process per rank.

JAX sees every device of a host from one process; torch.distributed runs
one process per card. `spawn` starts n ranks of a fresh process group on
this host (torch.multiprocessing's spawn start method: never a fork after
CUDA has been initialised); `init_from_env` joins the group that torchrun
describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

Backends: NCCL for CUDA with one rank per card (NCCL refuses two ranks on
one card); gloo for the CPU, and for CUDA tensors where ranks share a card
(gloo's CUDA all_reduce and broadcast are all that the mesh uses).
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# seconds a collective may wait before the group gives up
TIMEOUT_S = 600


def default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_rank(rank: int, world: int, backend: str, device: str, init_method: str,
              local_rank: Optional[int] = None) -> torch.device:
    """Join a process group as `rank` of `world` and return this rank's
    device: cuda:(local_rank mod the cards present), made current before the
    group is created (NCCL and cuDNN follow the current device), or the
    CPU."""
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..pipeline.orchestrator import resolve_device

        resolve_device(dev)
        n = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n:
            raise ValueError(f"NCCL takes one rank per card: local rank {local_rank} "
                             f"of a host with {n} card(s)")
        dev = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def init_from_env(device: str) -> torch.device:
    """Join the process group torchrun describes in the environment."""
    return init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     default_backend(device), device, "env://",
                     local_rank=int(os.environ["LOCAL_RANK"]))


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def _rank_main(rank, world, fn, args, backend, device, tmp, threads):
    torch.set_num_threads(threads)
    dev = init_rank(rank, world, backend, device, f"file://{tmp}/rendezvous")
    try:
        out = fn(dev, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device: str = "cpu",
          backend: Optional[str] = None, threads: int = 1) -> List:
    """Run fn(device, *args) in `nprocs` new processes, the ranks of a fresh
    process group (rendezvous through a file in a temporary directory),
    each with `threads` intra-op threads; returns each rank's return value
    (saved with torch.save, on the CPU), in rank order. `fn` must be a
    module-level function of a module that imports without side effects:
    the spawn start method pickles it by name. A rank that raises ends the
    others, and spawn raises with its traceback."""
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        from ..pipeline.orchestrator import resolve_device

        resolve_device(device)
        if backend == "nccl" and nprocs > torch.cuda.device_count():
            raise ValueError(f"{nprocs} NCCL ranks need {nprocs} cards, "
                             f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(nprocs, fn, args, backend, device, tmp, threads),
            nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(nprocs)]
