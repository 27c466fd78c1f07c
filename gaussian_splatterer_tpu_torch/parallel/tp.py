"""Band parallelism: each frame's tile grid split into horizontal bands
(counterpart of gaussian_splatterer_tpu.parallel.tp).

Camera DP (parallel/dp.py) runs out of parallelism when the rig has fewer
frames than there are devices.  A (``camera``, ``tile``) mesh splits the
frames over ``camera`` and every frame's tile rows into ``n_tile`` bands:
rank (c, t) rasterizes band t of the frames of camera block c.

  * The projection stays full-image; the rank shifts the projected centres
    by -t x band_h and bins on its band's tile grid
    (ops.raster_tiled.render_train_grads_batch ``band=``); splats outside
    the band clamp to empty tile boxes and cost nothing.  The fused kernel
    K3 runs unchanged on the band's grid.
  * Pre-tiled truths are in row-major tile order, so a band's tiles are a
    contiguous slice of the T axis (shard_truths_tp).
  * A band's gradients are partial sums over its pixels, so sums over
    ``camera`` and ``tile`` give the full-frame gradients.
  * The densify signal is the sum over frames of each frame's |location
    gradient|, a norm, so each group's raw per-frame location gradients are
    summed over ``tile`` first (one all-reduce a frame group, in the frame
    loop), then normed.

The model is replicated: every band needs every splat.  Fused tiled step
only, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.parallel.collectives import (
    CommStats, all_reduce_max, all_reduce_sum,
)
from gaussian_splatterer_tpu_torch.parallel.dp import (
    CAMERA_AXIS, block, frame_slice, step_inputs,
)
from gaussian_splatterer_tpu_torch.train.trainer import (
    CameraBatch, LearningRates, TrainMetrics, _apply_sgd, _params, fused_kw_from_runtime,
    make_frame_accumulator,
)

TILE_AXIS = "tile"


def make_tile_mesh(device_type: str, n_camera: int, n_tile: int) -> DeviceMesh:
    """A (``camera``, ``tile``) mesh over the n_camera x n_tile ranks of the
    default group, rank = camera index x n_tile + tile index."""
    return init_device_mesh(device_type, (n_camera, n_tile),
                            mesh_dim_names=(CAMERA_AXIS, TILE_AXIS))


def shard_truths_tp(mesh: DeviceMesh, truth_tiles: torch.Tensor,
                    frame_axes=(CAMERA_AXIS,)) -> torch.Tensor:
    """(2F, T, P, 3) pre-tiled truths -> the rank's block of frames over
    ``frame_axes`` and its band: the contiguous T / n_tile slice of tiles
    (row-major tile order)."""
    n_tile = mesh.size(mesh.mesh_dim_names.index(TILE_AXIS))
    tiles = block(truth_tiles.shape[1], n_tile, mesh.get_local_rank(TILE_AXIS), "tiles")
    return truth_tiles[frame_slice(mesh, truth_tiles.shape[0], frame_axes), tiles]


def band_height(height: int, tile: int, n_band: int) -> int:
    """The pixel height of each of ``n_band`` equal bands of whole tile
    rows; unequal bands raise (the loss's division by n_band assumes them
    equal)."""
    ty_tiles = -(-height // tile)
    if ty_tiles % n_band:
        raise ValueError(f"tile rows ({ty_tiles}) must divide evenly into {n_band} bands")
    return ty_tiles // n_band * tile


def make_band_accumulate(mesh: DeviceMesh, width: int, height: int, sh_degree: int,
                         fused_opts: dict, frame_group: int, comm: CommStats):
    """The rank's frame loop for its band: returns accumulate(params,
    active, truths, cams, bgs) -> SUMS over the rank's frames of (grads,
    densify signal, loss, num_dup), the loop of
    train/trainer.make_frame_accumulator with each group's per-frame
    location gradients summed over ``tile`` (one all-reduce, counted in
    ``comm``) before their sum and norm.  ``num_dup`` is the band's count.
    Shared by the tp and the 3-D steps."""
    tile = fused_opts.get("tile", 32)
    n_band = mesh.size(mesh.mesh_dim_names.index(TILE_AXIS))
    band_h = band_height(height, tile, n_band)
    y_off = mesh.get_local_rank(TILE_AXIS) * band_h
    tile_g = mesh.get_group(TILE_AXIS)

    def over_bands(d_means_b):
        return all_reduce_sum([d_means_b], tile_g, comm)[0]

    accumulate = make_frame_accumulator(
        width, height, sh_degree, "tiled", fused=True,
        fused_opts=dict(fused_opts, band=(y_off, band_h)), frame_group=frame_group,
        loc_reduce=over_bands)

    def band_accumulate(params, active, truths, cams: CameraBatch, bgs):
        return accumulate(params, active, truths, cams, bgs, 1.0)

    return band_accumulate


def make_tp_train_step(
    mesh: DeviceMesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    frame_group: int = 8,
    reduction: str = "index_add",
):
    """Build the band-parallel (model, truths, cams, lrs) -> (model,
    metrics) step over a (``camera``, ``tile``) mesh.

    ``truths`` is the rank's (frames, T / n_tile, P, 3) slice of the
    pre-tiled truths (shard_truths_tp); 2F must split over ``camera`` and
    the tile rows over ``tile``.  The model is replicated and updated in
    place.  ``reduction`` is the fused step's route for the duplicate
    gradients.  The collectives count into ``step.comm``."""
    fkw = dict(fused_kw_from_runtime(runtime), reduction=reduction)
    n_band = mesh.size(mesh.mesh_dim_names.index(TILE_AXIS))
    camera_g = mesh.get_group(CAMERA_AXIS)
    n_cam = mesh.size(mesh.mesh_dim_names.index(CAMERA_AXIS))
    comm = CommStats()
    accumulate = make_band_accumulate(mesh, width, height, sh_degree, fkw, frame_group, comm)

    def step(model: SplatModel, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        dev = model.device
        cams_l, bgs = step_inputs(mesh, truths, cams, dev, (CAMERA_AXIS,))
        g_sum, var_sum, loss_sum, num_dup = accumulate(
            _params(model), model.active_mask(), truths, cams_l, bgs)
        # the location gradients and the signal were summed over tile in the
        # frame loop: over camera now; the other gradients and the loss over
        # both axes (the whole group)
        g_means, var_sum = all_reduce_sum([g_sum[0], var_sum], camera_g, comm)
        *g_rest, loss_sum = all_reduce_sum([*g_sum[1:], loss_sum], None, comm)
        num_dup = all_reduce_max(num_dup, None, dev, comm)
        # each band's loss is a mean over its own tiles: n_band x the frame's
        loss_sum = loss_sum / n_band
        samples = float(truths.shape[0] * n_cam)
        avg = [g / samples for g in (g_means, *g_rest)]
        _apply_sgd(model, avg, lrs)
        return model, TrainMetrics(loss=loss_sum / samples, var_loc=var_sum / samples,
                                   avg_grad_loc=avg[0], num_dup=num_dup)

    step.comm = comm
    return step
