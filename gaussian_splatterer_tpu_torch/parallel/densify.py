"""Densify under sharded parameters: gather -> densify -> re-shard
(counterpart of gaussian_splatterer_tpu.parallel.densify).

The reference densifies on the host every ``intervalDensify`` iterations
(src/Trainer.cu:433-542), a gather to one place at a slow cadence.  For a
splat-sharded model (fsdp.py) this keeps that shape: every rank gathers
the rows and both densify signals, runs the single-device
``train/densify.densify`` unchanged on the same arrays (so every rank gets
the same model) and keeps its own rows again with the caller's sharder.
A camera-data-parallel model is replicated and densifies directly.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from gaussian_splatterer_tpu_torch.parallel.collectives import all_gather_rows
from gaussian_splatterer_tpu_torch.parallel.fsdp import SPLAT_AXIS, SplatShard, gather_model
from gaussian_splatterer_tpu_torch.train.densify import DensifyParams, densify


def densify_sharded(mesh: DeviceMesh, shard: SplatShard, var_loc: torch.Tensor,
                    avg_grad_loc: torch.Tensor, params: DensifyParams, reshard_model):
    """Densify a splat-sharded model exactly as one device would.

    ``var_loc`` (rows,) and ``avg_grad_loc`` (rows, 3) are the rank's rows,
    as the FSDP step returns them; ``reshard_model(mesh, model)`` re-applies
    the rest-state sharding (fsdp.shard_model).  A collective: every rank
    calls it."""
    group = mesh.get_group(SPLAT_AXIS)
    model = gather_model(mesh, shard)
    var = all_gather_rows(var_loc, group)
    grad = all_gather_rows(avg_grad_loc, group)
    return reshard_model(mesh, densify(model, var, grad, params))
