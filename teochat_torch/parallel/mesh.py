"""Device mesh over torch.distributed processes (port of teochat_tpu/parallel/mesh.py).

One `DeviceMesh` with the JAX package's (data, fsdp, model) axes, a process
(a rank) a device: `data` splits batch rows, `fsdp` splits batch rows and
stores every leaf sharded on its rule's fsdp dim (ZeRO-3), `model` runs
Megatron-style tensor parallelism over the heads and the MLP columns
(parallel/sharding.py holds the rules, parallel/tensor_parallel.py the
collectives). The axis arithmetic is the JAX function's: any one axis may be
-1 and takes what the others leave; `sequence` (context parallelism:
parallel/ring_attention.py) and `pipe` (GPipe: parallel/pipeline.py) are
appended only above 1, so 3-axis layouts are untouched.

The mesh's device type is explicit: "cuda" (the default, one card a rank,
NCCL) or "cpu" (gloo, which the tests ask for). `init_distributed` starts
the process group from torchrun's environment, as the JAX driver's
`--distributed` calls `jax.distributed.initialize()`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from teochat_torch.config import MeshConfig

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape(cfg: Optional[MeshConfig], n: int) -> Tuple[List[int], List[str]]:
    """(axis sizes, axis names) of a mesh over `n` devices: the JAX
    create_mesh's arithmetic and errors."""
    cfg = cfg or MeshConfig(fsdp=-1)
    sizes = [cfg.data, cfg.fsdp, cfg.model]
    names = list(cfg.axis_names)
    if cfg.sequence < 1:
        raise ValueError(f"sequence axis size must be >= 1, got {cfg.sequence}")
    if cfg.sequence != 1:
        sizes.append(cfg.sequence)
        names.append("sequence")
    if cfg.pipe < 1:
        raise ValueError(f"pipe axis size must be >= 1, got {cfg.pipe}")
    if cfg.pipe != 1:
        sizes.append(cfg.pipe)
        names.append("pipe")
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return sizes, names


def create_mesh(cfg: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """A (data, fsdp, model[, sequence][, pipe]) DeviceMesh over the
    initialized process group's ranks, in rank order. `device_type` "cuda"
    (NCCL) or "cpu" (gloo) must be the group's own."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = cfg or MeshConfig(fsdp=-1)
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group (init_distributed first)")
    sizes, names = mesh_shape(cfg, dist.get_world_size())
    if device_type not in BACKENDS:
        raise ValueError(f"create_mesh: device_type {device_type!r}, not one of {list(BACKENDS)}")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))


def local_mesh(device_type: str = "cuda"):
    """Every rank on `fsdp` (the JAX local_mesh's layout)."""
    return create_mesh(MeshConfig(data=1, fsdp=-1, model=1), device_type)


def init_distributed(device_type: str = "cuda", *, backend: Optional[str] = None,
                     device: Optional[torch.device] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Start the process group and return this rank's device. Without
    arguments it reads torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT through `env://`, LOCAL_RANK for the card).
    "cuda" takes NCCL and the card LOCAL_RANK (one process a card), "cpu"
    gloo. `backend` and `device` name others explicitly (two ranks on one
    card: gloo over CUDA tensors, both ranks on cuda:0)."""
    if device_type not in BACKENDS:
        raise ValueError(f"init_distributed: device_type {device_type!r}, not one of "
                         f"{list(BACKENDS)}")
    missing = [k for k, v in (("RANK", rank), ("WORLD_SIZE", world_size))
               if v is None and k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {', '.join(missing)} not set: run under torchrun "
                           "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) or pass them")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
                  if device_type == "cuda" else torch.device("cpu"))
    if device.type != device_type:
        raise ValueError(f"init_distributed: device {device} is not a {device_type} device")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or BACKENDS[device_type], init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return device
