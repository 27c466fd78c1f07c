"""Data parallelism over truth cameras (counterpart of
gaussian_splatterer_tpu.parallel.dp).

Truth frames are independent (the reference averages the gradients over
all frames, src/Trainer.cu:416-419), so the 2F frames of a step are split
over the ranks of a 1-D ``camera`` mesh.  Each rank runs its frames
through the same frame loop as the single-device step (fused: K3 a group
of frames), the gradient sums, ``var_sum`` and ``loss_sum`` are summed
over the ranks in one all-reduce of a flat buffer (JAX's ``psum``), the
duplicate count takes the largest (``pmax``), and every rank applies the
same clamped SGD update to its replicated copy of the model.  All-reduce
gives every rank the same sums, so the copies stay equal.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.parallel.collectives import (
    CommStats, all_reduce_max, all_reduce_sum,
)
from gaussian_splatterer_tpu_torch.train.trainer import (
    CameraBatch,
    LearningRates,
    RenderFn,
    TrainMetrics,
    _apply_sgd,
    _default_render,
    _params,
    backgrounds,
    fused_kw_from_runtime,
    make_frame_accumulator,
)

CAMERA_AXIS = "camera"


def make_camera_mesh(device_type: str) -> DeviceMesh:
    """A 1-D ``camera`` mesh over every rank of the default group."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(CAMERA_AXIS,))


def axes_size(mesh: DeviceMesh, axes: Optional[Sequence[str]] = None) -> int:
    """The number of ranks along ``axes`` (every axis when None)."""
    axes = mesh.mesh_dim_names if axes is None else axes
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def mesh_rank(mesh: DeviceMesh, axes: Optional[Sequence[str]] = None) -> int:
    """This rank's place along ``axes`` (every axis when None), flattened
    in their order: the index of its block of frames."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    names = mesh.mesh_dim_names
    flat = 0
    for a in (names if axes is None else axes):
        i = names.index(a)
        flat = flat * mesh.size(i) + coord[i]
    return flat


def block(n_items: int, parts: int, index: int, what: str = "frames") -> slice:
    """The ``index``-th of ``parts`` equal contiguous blocks of ``n_items``."""
    if n_items % parts:
        raise ValueError(f"{n_items} {what} do not split over {parts} ranks")
    k = n_items // parts
    return slice(index * k, (index + 1) * k)


def frame_slice(mesh: DeviceMesh, n_frames: int,
                axes: Optional[Sequence[str]] = None) -> slice:
    """This rank's contiguous block of the ``n_frames`` frames, split over
    ``axes`` (every axis when None)."""
    return block(n_frames, axes_size(mesh, axes), mesh_rank(mesh, axes))


def shard_truths(mesh: DeviceMesh, truths: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of the 2F truth frames: with 2 ranks,
    rank 0 holds the white-background frames and rank 1 the black ones."""
    return truths[frame_slice(mesh, truths.shape[0])]


def make_local_accumulate(
    width: int,
    height: int,
    sh_degree: int,
    renderer: str,
    render_fn: Optional[RenderFn],
    row_chunk: int,
    runtime: Optional[RuntimeConfig],
    fused: Optional[bool],
    frame_group: int,
    reduction: str = "index_add",
):
    """The rank's frame loop, shared by the DP and FSDP steps: returns
    (local_accumulate, fused), where local_accumulate(params, active,
    truths, cams, bgs) -> (g_sum, var_sum, loss_sum, num_dup) gives SUMS
    over the rank's frames (train/trainer.make_frame_accumulator with
    divisor 1).

    ``fused=None`` takes the fused step whenever the tiled renderer with
    its default render is asked for and the resolution is a multiple of
    the tile, as the single-device Trainer does; it reads pre-tiled truths
    (ops.raster_tiled.image_to_tiles) and groups the rank's frames in
    ``_largest_divisor_leq(n_local, frame_group)``.  ``reduction`` is the
    fused step's route for the duplicate gradients."""
    tile = runtime.tile_px if runtime is not None else 32
    if fused is None:
        fused = (renderer == "tiled" and render_fn is None
                 and width % tile == 0 and height % tile == 0)
    if fused:
        accumulate = make_frame_accumulator(
            width, height, sh_degree, renderer, row_chunk, None, True,
            dict(fused_kw_from_runtime(runtime), reduction=reduction), frame_group)
    else:
        render = render_fn if render_fn is not None else _default_render(
            renderer, row_chunk, runtime)
        accumulate = make_frame_accumulator(width, height, sh_degree, renderer, row_chunk,
                                            render, False)

    def local_accumulate(params, active, truths, cams: CameraBatch, bgs):
        return accumulate(params, active, truths, cams, bgs, 1.0)

    return local_accumulate, fused


def step_inputs(mesh: DeviceMesh, truths: torch.Tensor, cams: CameraBatch, device,
                axes: Optional[Sequence[str]] = None):
    """The rank's cameras and backgrounds for its ``truths`` (its block of
    the 2F frames, split over ``axes``, every axis when None), after the
    same checks as JAX's step."""
    f = cams.num_frames
    n_dev = axes_size(mesh, axes)
    if truths.shape[0] * n_dev != 2 * f:
        raise ValueError(f"{truths.shape[0]} truth frames on each of {n_dev} ranks; "
                         f"a step needs 2 x {f} cameras")
    sl = frame_slice(mesh, 2 * f, axes)
    return CameraBatch(*(x[sl] for x in cams.twice())), backgrounds(f, device)[sl]


def make_dp_train_step(
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
    """Build the camera-data-parallel (model, truths, cams, lrs) ->
    (model, metrics) step.

    ``truths`` is this rank's block of the 2F frames (shard_truths); 2F
    must split evenly over the mesh.  ``cams`` holds all F cameras; the
    model is replicated and updated in place.  The step's collectives
    count into ``step.comm`` (a CommStats)."""
    local_accumulate, fused = make_local_accumulate(
        width, height, sh_degree, renderer, render_fn, row_chunk, runtime, fused,
        frame_group, reduction)
    group = mesh.get_group(CAMERA_AXIS)
    n_dev = mesh.size()
    comm = CommStats()

    def step(model: SplatModel, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        cams_l, bgs = step_inputs(mesh, truths, cams, model.device)
        g_sum, var_sum, loss_sum, num_dup = local_accumulate(
            _params(model), model.active_mask(), truths, cams_l, bgs)
        # one all-reduce for every gradient tensor, var_sum and loss_sum
        *g_sum, var_sum, loss_sum = all_reduce_sum([*g_sum, var_sum, loss_sum], group, comm)
        num_dup = all_reduce_max(num_dup, group, model.device, comm)
        samples = float(truths.shape[0] * n_dev)
        avg = [g / samples for g in g_sum]
        _apply_sgd(model, avg, lrs)
        return model, TrainMetrics(loss=loss_sum / samples, var_loc=var_sum / samples,
                                   avg_grad_loc=avg[0], num_dup=num_dup)

    step.comm = comm
    step.fused = fused
    return step

