"""Three-axis sharding: camera DP x image bands x splat-sharded parameters
(counterpart of gaussian_splatterer_tpu.parallel.mesh3).

One (``camera``, ``tile``, ``splat``) mesh composes the three axes:

  * ``camera``: truth frames are data-parallel (parallel/dp.py);
  * ``tile``: each rank rasterizes one horizontal band of its frames
    (parallel/tp.py);
  * ``splat``: the parameters are sharded at rest (parallel/fsdp.py's
    SplatShard: one all-gather in, reduce-scattered gradients out).  The
    splat axis is data-parallel too: frames split over (``camera``,
    ``splat``) together.

A step, in JAX's order: all-gather the rows over ``splat``; run the band
loop (each group's per-frame location gradients summed over ``tile``
before the norm); reduce-scatter the gradient and signal sums over
``splat``; then sum the location gradients and the signal over ``camera``
and the other gradients over (``camera``, ``tile``).  Fused tiled step
only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.parallel.collectives import (
    CommStats, all_reduce_max, all_reduce_sum, reduce_scatter_rows,
)
from gaussian_splatterer_tpu_torch.parallel.dp import CAMERA_AXIS, step_inputs
from gaussian_splatterer_tpu_torch.parallel.fsdp import (
    SPLAT_AXIS, SplatShard, _pack, _unpack, gather_params, shard_model,
)
from gaussian_splatterer_tpu_torch.parallel.tp import (
    TILE_AXIS, make_band_accumulate, shard_truths_tp,
)
from gaussian_splatterer_tpu_torch.train.trainer import (
    CameraBatch, LearningRates, TrainMetrics, _apply_sgd, fused_kw_from_runtime,
)

# frames split over these axes together, camera-major (JAX's
# P((CAMERA_AXIS, SPLAT_AXIS)))
FRAME_AXES = (CAMERA_AXIS, SPLAT_AXIS)


def make_3d_mesh(device_type: str, n_camera: int, n_tile: int, n_splat: int) -> DeviceMesh:
    """A (``camera``, ``tile``, ``splat``) mesh over the n_camera x n_tile x
    n_splat ranks of the default group, rank = (camera index x n_tile +
    tile index) x n_splat + splat index."""
    return init_device_mesh(device_type, (n_camera, n_tile, n_splat),
                            mesh_dim_names=(CAMERA_AXIS, TILE_AXIS, SPLAT_AXIS))


def shard_model_3d(mesh: DeviceMesh, model: SplatModel) -> SplatShard:
    """The rank's capacity / n_splat rows, replicated over ``camera`` and
    ``tile`` (fsdp.shard_model on the 3-D mesh)."""
    return shard_model(mesh, model)


def shard_truths_3d(mesh: DeviceMesh, truth_tiles: torch.Tensor) -> torch.Tensor:
    """(2F, T, P, 3) pre-tiled truths -> the rank's frames, split over
    (``camera``, ``splat``) together, and its band's tiles over ``tile``."""
    return shard_truths_tp(mesh, truth_tiles, FRAME_AXES)


def make_3d_train_step(
    mesh: DeviceMesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    frame_group: int = 8,
    reduction: str = "index_add",
):
    """Build the (shard, truths, cams, lrs) -> (shard, metrics) step over a
    (``camera``, ``tile``, ``splat``) mesh.

    ``shard`` is the rank's rows (shard_model_3d), updated in place;
    ``truths`` its frames and band (shard_truths_3d).  2F must split over
    camera x splat, the tile rows over ``tile``.  ``var_loc`` and
    ``avg_grad_loc`` come back as the rank's rows.  The collectives count
    into ``step.comm``."""
    fkw = dict(fused_kw_from_runtime(runtime), reduction=reduction)

    def size(axis):
        return mesh.size(mesh.mesh_dim_names.index(axis))

    n_cam, n_band, n_splat = size(CAMERA_AXIS), size(TILE_AXIS), size(SPLAT_AXIS)
    camera_g, tile_g = mesh.get_group(CAMERA_AXIS), mesh.get_group(TILE_AXIS)
    splat_g = mesh.get_group(SPLAT_AXIS)
    comm = CommStats()
    accumulate = make_band_accumulate(mesh, width, height, sh_degree, fkw, frame_group, comm)

    def step(shard: SplatShard, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        if shard.sh_degree != sh_degree:
            raise ValueError(f"the model's SH degree {shard.sh_degree} is not the step's "
                             f"{sh_degree}")
        dev = shard.device
        cams_l, bgs = step_inputs(mesh, truths, cams, dev, FRAME_AXES)
        # 1. the whole parameters: one all-gather over splat
        params = gather_params(mesh, shard, comm)
        active = torch.arange(shard.capacity, device=dev) < shard.count
        g_sum, var_sum, loss_sum, num_dup = accumulate(params, active, truths, cams_l, bgs)
        num_dup = all_reduce_max(num_dup, None, dev, comm)
        # 2. the rank's rows of the sums: reduce-scatter over splat (its
        #    ranks hold different frames, a data-parallel sum)
        rows = reduce_scatter_rows(_pack([*g_sum, var_sum]), splat_g, comm)
        *g_loc, var_loc = _unpack(rows, [*g_sum, var_sum])
        # 3. the location gradients and the signal were summed over tile in
        #    the frame loop: over camera now, with the others; those still
        #    hold band partials, so over tile too
        g_means, var_loc, *g_rest = all_reduce_sum([g_loc[0], var_loc, *g_loc[1:]], camera_g,
                                                   comm)
        g_rest = all_reduce_sum(g_rest, tile_g, comm)
        (loss_sum,) = all_reduce_sum([loss_sum], None, comm)
        loss_sum = loss_sum / n_band
        samples = float(truths.shape[0] * n_cam * n_splat)
        avg = [g / samples for g in (g_means, *g_rest)]
        _apply_sgd(shard, avg, lrs)
        return shard, TrainMetrics(loss=loss_sum / samples, var_loc=var_loc / samples,
                                   avg_grad_loc=avg[0], num_dup=num_dup)

    step.comm = comm
    return step
