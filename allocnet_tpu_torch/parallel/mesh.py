"""Data parallelism over processes: one process per device, the scenario
batch split over them, parameters replicated, gradients averaged.

Port of `allocnet_tpu/parallel/mesh.py`.  The JAX module shards a batch
over the local devices of one process (a Mesh with a 'dp' axis); here each
device has its own process in a `torch.distributed` process group (NCCL on
cards, gloo on the CPU), the batch is cut by rank (`shard_batch`) and the
training step is wrapped in DistributedDataParallel (train/trainer.py).
`initialize_distributed` reads the usual launch environment (`torchrun`:
WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from allocnet_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    """The 'dp' axis: `size` processes of one device each; this process is
    `rank` on `device`."""
    size: int
    rank: int
    device: torch.device


def world() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the first `n_devices` processes (all by default).  This
    process's device: its local rank's card (LOCAL_RANK) unless `device`
    says otherwise.  A rank outside the mesh gets rank >= size."""
    size, rank = world()
    n = n_devices or size
    if n > size:
        raise ValueError(f"make_mesh: {n} devices asked for, {size} "
                         f"processes in the group (one device each)")
    if device is None and torch.cuda.is_available():
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    return Mesh(size=n, rank=rank, device=resolve_device(device))


def batch_sharding(mesh: Mesh):
    """Placement of a batch: dim 0 split over the mesh."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated(mesh: Mesh):
    """Placement of parameters: a full copy on every device."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree: Any) -> Any:
    """This rank's contiguous slice of dim 0 of every array in `tree`
    (tensors or numpy arrays, in tuples, lists or dicts), as tensors on
    the mesh's device.  Dim 0 must split evenly."""
    def cut(a):
        n = a.shape[0]
        if n % mesh.size:
            raise ValueError(f"shard_batch: a batch of {n} does not split "
                             f"over {mesh.size} devices")
        k = n // mesh.size
        part = a[mesh.rank * k:(mesh.rank + 1) * k]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(mesh.device)
    return _map(cut, tree)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Every tensor of `tree` on the mesh's device, with rank 0's values
    on every rank (a broadcast from rank 0)."""
    def bcast(a):
        t = torch.as_tensor(a).to(mesh.device).clone()
        if world()[0] > 1:
            dist.broadcast(t, src=0)
        return t
    return _map(bcast, tree)


def _looks_multiprocess() -> bool:
    """True when the environment carries a multi-process launch (a
    master address, or more than one process): the user intends
    distributed execution, and training alone would be wrong."""
    if os.environ.get("MASTER_ADDR"):
        return True
    n = os.environ.get("WORLD_SIZE")
    try:
        return int(n) > 1 if n is not None else False
    except ValueError:
        return True


def initialize_distributed(backend: str | None = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the process group of a multi-process launch (env://: WORLD_SIZE,
    RANK, MASTER_ADDR, MASTER_PORT); call once per process.  Without a
    launch in the environment it does nothing and returns False; a
    configured launch that cannot initialize raises (each process training
    on its own shard with no gradient exchange would be wrong).  Backend:
    NCCL with a card, else gloo."""
    if dist.is_initialized():
        return True
    if not _looks_multiprocess():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True
