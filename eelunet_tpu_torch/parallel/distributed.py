"""The multi-process runtime on ``torch.distributed`` (counterpart of
``eelunet_tpu/parallel/distributed.py``).

One process per card, as ``torchrun --nproc_per_node=<cards>`` starts
them: ``init_distributed`` joins the processes into one group, and the
``data`` axis of the mesh (``mesh.py``) spans its ranks. Where JAX sees one
global batch and inserts the collectives itself, each rank here holds its
own rows of every global batch (``data/pipeline.DataLoader(process_shard=)``)
and the Trainer reduces what must be global: the gradients (DDP), the batch
norms' statistics (``nn/layers.BatchNorm2d``), the losses and the metric
counts. Without a group every function here is the single-process no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join this process to the group of a multi-process run; returns False
    (and does nothing) for a single-process run.

    Resolution order: the explicit arguments (``coordinator_address`` as
    ``host:port``, or an init-method URL such as ``file:///path``), then
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); with neither it returns False.

    ``device`` is where this rank runs: "cuda" (None) puts each rank on its
    own card, the ``LOCAL_RANK``-th (the rank itself without torchrun), and
    makes it the current device before anything allocates; a rank without
    its card raises. A device with an index ("cuda:0") puts the rank there
    as asked. ``backend``: NCCL for a CUDA device, gloo for the CPU, unless
    the caller names one (gloo also reduces CUDA tensors, which lets two
    ranks share one card)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
        rank = process_id if process_id is not None else env.get("RANK")
        if world is None or rank is None:
            raise ValueError("init_distributed: a coordinator_address needs num_processes "
                             "and process_id (or WORLD_SIZE and RANK)")
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT") and "RANK" in env \
            and "WORLD_SIZE" in env:
        init_method, world, rank = "env://", env["WORLD_SIZE"], env["RANK"]
    else:
        return False
    world, rank = int(world), int(rank)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        from eelunet_tpu_torch.registry import resolve_device

        resolve_device(dev)  # raises without a card
        index = dev.index if dev.index is not None else int(env.get("LOCAL_RANK", rank))
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} runs on card {index} (LOCAL_RANK), but this host has "
                f"{torch.cuda.device_count()} card(s): start one process per card")
        torch.cuda.set_device(index)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return True


def shutdown_distributed() -> None:
    """Leave the group (the end of a multi-process entry point)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the only process that logs, prints and writes files."""
    return process_index() == 0


def process_shard_spec() -> Optional[tuple]:
    """(process_index, process_count) for ``DataLoader(process_shard=)``, or
    None when single-process."""
    return (process_index(), process_count()) if process_count() > 1 else None


def data_group():
    """The process group of the ``data`` axis (every rank), or None when
    single-process."""
    return dist.group.WORLD if process_count() > 1 else None


def _comm_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")


def sync_seed(seed: Optional[int]) -> int:
    """A training seed that is the same on every rank: the per-rank slices
    of each global batch partition it only if every rank shuffles alike. A
    None seed is drawn on rank 0 and broadcast."""
    if seed is None:
        seed = int(np.random.randint(0, 10000))
    if process_count() == 1:
        return seed
    t = torch.tensor([seed], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def assemble_global_batch(array, device) -> torch.Tensor:
    """This rank's rows of a global batch, on this rank's ``device``. JAX
    assembles one global array from the processes' slices
    (``make_array_from_process_local_data``); under DDP the rows stay on
    their rank, and the reductions that make the step global are the
    Trainer's."""
    from eelunet_tpu_torch.data.pipeline import to_device

    return to_device(array, torch.device(device))


def barrier() -> None:
    """Wait for every rank (a no-op when single-process)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place (a no-op when single-process)."""
    if process_count() > 1:
        dist.all_reduce(tensor)
    return tensor
