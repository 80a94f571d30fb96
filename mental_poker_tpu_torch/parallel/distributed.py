"""Multi-process start-up (counterpart of `mental_poker_tpu/parallel/distributed.py`).

The JAX package reaches its collectives through `jax.distributed.initialize`
and a global device mesh; the port through a `torch.distributed` process
group, one process per card, and a `DeviceMesh` over the group
(`parallel/sharding.py`).

Launcher contract (`torchrun`'s environment):

    python -m torch.distributed.run --nproc_per_node=N your_program.py

sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT` in
each process; `init_distributed` reads them, or takes the same values as
arguments. The backend follows the device: NCCL for "cuda" (each process on
card `LOCAL_RANK`), gloo for "cpu". Nothing falls back from one to the
other.
"""

from __future__ import annotations

import os

import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process-group backend of `device` ("cuda" -> NCCL, "cpu" -> gloo).
    Raises for a CUDA device when no card is present."""
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: device 'cuda' asked for, but no CUDA card is present")
    return BACKENDS[device.type]


def init_distributed(
    device="cuda",
    address: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> bool:
    """Join the process group of a multi-process run; a no-op on one process.

    `address` ("host:port" of rank 0's store), `world_size` and `rank`
    default to `MASTER_ADDR`:`MASTER_PORT`, `WORLD_SIZE` and `RANK`. Returns
    True when more than one process runs. A second call is a no-op. With
    CUDA the process takes card `LOCAL_RANK` (default: `rank`) before the
    NCCL group starts.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ["RANK"])
    if address is None:
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size, rank=rank)
    return True


def global_mesh(n_sp: int = 1, device="cuda"):
    """The (dp, sp) mesh over every rank of the run (after
    `init_distributed`): sp groups of `n_sp` consecutive ranks, so with
    `n_sp` at most the cards of one host the sp collectives stay inside a
    host and only dp crosses hosts."""
    from .sharding import make_mesh

    return make_mesh(None, n_sp, device)
