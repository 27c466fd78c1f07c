"""Two-axis sharding: camera data parallelism x splat-sharded parameters
(counterpart of gaussian_splatterer_tpu.parallel.fsdp).

The model's capacity axis is split over the ``splat`` axis of a
(``camera``, ``splat``) mesh: each rank keeps capacity / n_splat rows (a
``SplatShard``), and every rank trains on its own block of the truth
frames (both axes act as data parallelism).  A step

  1. all-gathers the rows over ``splat`` (one all_gather_into_tensor of a
     flat (rows, 3 + 3K + 3 + 1 + 4) buffer),
  2. runs the rank's frames through the shared frame loop,
  3. reduce-scatters the gradient sums and ``var_sum`` over ``splat`` (one
     reduce_scatter_tensor), then sums them over ``camera``,
  4. sums the loss over both axes and takes the largest duplicate count,
  5. updates the rank's own rows only.

``var_loc`` and ``avg_grad_loc`` come back as the rank's rows, as in JAX.
Densify gathers the model (parallel/densify.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.parallel.collectives import (
    CommStats, all_gather_rows, all_reduce_max, all_reduce_sum, reduce_scatter_rows,
)
from gaussian_splatterer_tpu_torch.parallel.dp import (
    CAMERA_AXIS, make_local_accumulate, shard_truths, step_inputs,
)
from gaussian_splatterer_tpu_torch.train.trainer import (
    CameraBatch, LearningRates, RenderFn, TrainMetrics, _apply_sgd,
)

SPLAT_AXIS = "splat"
_FIELDS = ("means", "shs", "scales", "opacities", "rotations")


class SplatShard:
    """One rank's rows of a splat-sharded model: the five parameter
    tensors, capacity // n_splat rows each (rows ``offset`` on), beside the
    whole model's ``count``, ``capacity`` and ``sh_degree``, and the
    ``mesh`` whose ``splat`` axis splits the rows (the sharded checkpoints
    read it).  The step updates the rows in place."""

    def __init__(self, means, shs, scales, opacities, rotations, count: int, capacity: int,
                 sh_degree: int, offset: int, mesh: Optional[DeviceMesh] = None):
        self.means, self.shs, self.scales = means, shs, scales
        self.opacities, self.rotations = opacities, rotations
        self.count, self.capacity, self.sh_degree = int(count), int(capacity), int(sh_degree)
        self.offset = int(offset)
        self.mesh = mesh

    @property
    def rows(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device


def make_2d_mesh(device_type: str, n_camera: int, n_splat: int) -> DeviceMesh:
    """A (``camera``, ``splat``) mesh over the first n_camera x n_splat
    ranks of the default group, rank = camera index x n_splat + splat
    index."""
    return init_device_mesh(device_type, (n_camera, n_splat),
                            mesh_dim_names=(CAMERA_AXIS, SPLAT_AXIS))


def shard_truths_2d(mesh: DeviceMesh, truths: torch.Tensor) -> torch.Tensor:
    """Frames split over BOTH axes: the rank's block in mesh order."""
    return shard_truths(mesh, truths)


def shard_model(mesh: DeviceMesh, model: SplatModel) -> SplatShard:
    """This rank's capacity / n_splat rows of ``model`` (copies), on any
    mesh with a ``splat`` axis: replicated over its other axes."""
    n = mesh.size(mesh.mesh_dim_names.index(SPLAT_AXIS))
    cap = model.capacity
    if cap % n:
        raise ValueError(f"capacity {cap} does not split over {n} splat shards")
    rows = cap // n
    lo = mesh.get_local_rank(SPLAT_AXIS) * rows
    return SplatShard(*(getattr(model, f).detach()[lo:lo + rows].clone() for f in _FIELDS),
                      count=model.count, capacity=cap, sh_degree=model.sh_degree, offset=lo,
                      mesh=mesh)


def _pack(tensors) -> torch.Tensor:
    """(R, ...) tensors -> one (R, sum of widths) buffer."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in tensors], 1)


def _unpack(buf: torch.Tensor, like) -> list[torch.Tensor]:
    widths = [t[0].numel() for t in like]
    return [x.reshape(buf.shape[0], *t.shape[1:])
            for x, t in zip(torch.split(buf, widths, 1), like)]


def gather_params(mesh: DeviceMesh, shard: SplatShard, stats: Optional[CommStats] = None):
    """The whole model's five parameter tensors from every rank's rows: one
    all-gather over ``splat``."""
    local = [getattr(shard, f) for f in _FIELDS]
    full = all_gather_rows(_pack(local), mesh.get_group(SPLAT_AXIS), stats)
    return _unpack(full, local)


def gather_model(mesh: DeviceMesh, shard: SplatShard) -> SplatModel:
    """The whole model, on every rank (a collective: every rank calls it)."""
    return SplatModel(*gather_params(mesh, shard), count=shard.count,
                      sh_degree=shard.sh_degree)


def make_fsdp_train_step(
    mesh: DeviceMesh,
    width: int,
    height: int,
    sh_degree: int,
    renderer: str = "tiled",
    render_fn: Optional[RenderFn] = None,
    row_chunk: int = 32,
    runtime: Optional[RuntimeConfig] = None,
    fused: Optional[bool] = None,
    frame_group: int = 8,
    reduction: str = "index_add",
):
    """Build the sharded-parameter (shard, truths, cams, lrs) -> (shard,
    metrics) step over a (``camera``, ``splat``) mesh.

    ``truths`` is this rank's block of the 2F frames (shard_truths_2d); 2F
    must split over all the mesh's ranks.  The collectives count into
    ``step.comm``."""
    local_accumulate, fused = make_local_accumulate(
        width, height, sh_degree, renderer, render_fn, row_chunk, runtime, fused,
        frame_group, reduction)
    splat_g, camera_g = mesh.get_group(SPLAT_AXIS), mesh.get_group(CAMERA_AXIS)
    n_dev = mesh.size()
    comm = CommStats()

    def step(shard: SplatShard, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        if shard.sh_degree != sh_degree:
            raise ValueError(f"the model's SH degree {shard.sh_degree} is not the step's "
                             f"{sh_degree}")
        dev = shard.device
        cams_l, bgs = step_inputs(mesh, truths, cams, dev)
        # 1. the whole parameters: one all-gather over splat
        params = gather_params(mesh, shard, comm)
        active = torch.arange(shard.capacity, device=dev) < shard.count
        g_sum, var_sum, loss_sum, num_dup = local_accumulate(params, active, truths, cams_l,
                                                             bgs)
        # 2. the rank's rows of the gradient and var sums: reduce-scatter
        #    over splat, then sum over camera
        rows = reduce_scatter_rows(_pack([*g_sum, var_sum]), splat_g, comm)
        (rows,) = all_reduce_sum([rows], camera_g, comm)
        *g_loc, var_loc = _unpack(rows, [*g_sum, var_sum])
        # 3. the loss over both axes, the duplicate count's largest
        (loss_sum,) = all_reduce_sum([loss_sum], None, comm)
        num_dup = all_reduce_max(num_dup, None, dev, comm)
        samples = float(truths.shape[0] * n_dev)
        avg = [g / samples for g in g_loc]
        _apply_sgd(shard, avg, lrs)
        return shard, TrainMetrics(loss=loss_sum / samples, var_loc=var_loc / samples,
                                   avg_grad_loc=avg[0], num_dup=num_dup)

    step.comm = comm
    step.fused = fused
    return step
