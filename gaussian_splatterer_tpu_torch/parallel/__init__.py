"""Multi-device training on ``torch.distributed`` (counterpart of
gaussian_splatterer_tpu.parallel).

The JAX package drives N devices from one controller through a ``Mesh``
and ``shard_map``; here each device has a process of its own (a rank), the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis
names, and each JAX collective is an explicit call (parallel/collectives.py).
Rank r trains on ``cuda:r`` unless the caller asks for the CPU; the backend
is ``nccl`` for CUDA and ``gloo`` for the CPU (``backend_for``).

Ported: the camera-data-parallel step (dp.py), the splat-sharded step
(fsdp.py), the band-parallel step (tp.py), the 3-axis camera x band x
splat step (mesh3.py), the routed 3-axis step that never gathers the
parameters (routed3.py, on route.py's exact uneven exchange of records),
densify under sharded parameters (densify.py), the sharded truth capture
over ranks or over one process's cards (capture.py) and, in
io/checkpoint.py, the sharded checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gaussian_splatterer_tpu_torch.parallel.capture import (
    capture_images_local,
    capture_images_sharded,
    frame_seed,
    local_devices,
)
from gaussian_splatterer_tpu_torch.parallel.densify import densify_sharded
from gaussian_splatterer_tpu_torch.parallel.dp import (
    CAMERA_AXIS,
    make_camera_mesh,
    make_dp_train_step,
    make_local_accumulate,
    shard_truths,
)
from gaussian_splatterer_tpu_torch.parallel.fsdp import (
    SPLAT_AXIS,
    SplatShard,
    gather_model,
    make_2d_mesh,
    make_fsdp_train_step,
    shard_model,
    shard_truths_2d,
)
from gaussian_splatterer_tpu_torch.parallel.mesh3 import (
    make_3d_mesh,
    make_3d_train_step,
    shard_model_3d,
    shard_truths_3d,
)
from gaussian_splatterer_tpu_torch.parallel.route import (
    bucket_local,
    bucket_route,
    route_back,
    unbucket_local,
)
from gaussian_splatterer_tpu_torch.parallel.routed3 import RouteStats, make_routed3_train_step
from gaussian_splatterer_tpu_torch.parallel.tp import (
    TILE_AXIS,
    make_band_accumulate,
    make_tile_mesh,
    make_tp_train_step,
    shard_truths_tp,
)

__all__ = [
    "CAMERA_AXIS",
    "TILE_AXIS",
    "capture_images_local",
    "capture_images_sharded",
    "local_devices",
    "densify_sharded",
    "frame_seed",
    "SPLAT_AXIS",
    "RouteStats",
    "SplatShard",
    "bucket_local",
    "bucket_route",
    "backend_for",
    "gather_model",
    "make_camera_mesh",
    "make_dp_train_step",
    "make_local_accumulate",
    "make_2d_mesh",
    "make_3d_mesh",
    "make_3d_train_step",
    "make_band_accumulate",
    "make_fsdp_train_step",
    "make_tile_mesh",
    "make_routed3_train_step",
    "make_tp_train_step",
    "route_back",
    "shard_model",
    "shard_model_3d",
    "shard_truths",
    "shard_truths_2d",
    "shard_truths_3d",
    "shard_truths_tp",
    "unbucket_local",
    "init_distributed",
    "spawn_ranks",
    "world_size",
    "rank",
]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                     init_method: Optional[str] = None, backend: Optional[str] = None) -> int:
    """Join the default process group and return its world size.

    With ``rank``, ``world_size`` and ``init_method`` (e.g.
    ``tcp://127.0.0.1:PORT``) given, the group is made from them; otherwise
    from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) where it is set.  Neither: one process, world size 1, no
    group.  A group made earlier is kept.  ``backend`` defaults to
    ``backend_for`` the current CUDA device when CUDA is available, else
    gloo."""
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = rank is not None or world_size is not None or init_method is not None
    if not explicit and not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return 1
    if explicit and (rank is None or world_size is None or init_method is None):
        raise ValueError("init_distributed needs rank, world_size and init_method together")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend)
    if explicit:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(**kw)
    return dist.get_world_size()


def spawn_ranks(fn, nprocs: int, *args) -> None:
    """Run ``fn(rank, init_method, *args)`` in ``nprocs`` spawned processes,
    ``init_method`` a TCP address on 127.0.0.1 at a free port for
    init_distributed, and wait for them all; a rank's error raises here."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(fn, args=(f"tcp://127.0.0.1:{port}", *args), nprocs=nprocs, join=True,
                       start_method="spawn")


def world_size() -> int:
    """The default group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0
