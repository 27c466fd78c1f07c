"""The routed 3-axis step: projected records routed to their compositors,
no parameter gather (counterpart of gaussian_splatterer_tpu.parallel.routed3).

The 3-axis step (parallel/mesh3.py) keeps the parameters sharded at rest
but all-gathers the whole model every step.  Here a rank only ever holds
its own parameter rows (N / S splats) and the projected records of the
splats that land on its band, so its memory grows with N / S plus its
band's work, not with N.

A step on a (``camera``, ``tile``, ``splat``) mesh (C x B x S), rank
(c, b, s):

  1. projects its rows for its projection frames: the 2F frames split
     over (camera, tile), global frame ids camera-major; under autograd,
     with the means expanded per frame, so that each frame's location
     gradients come out apart;
  2. finds, per (frame, splat), the bands that its tile box on the full
     grid overlaps (up to B records a splat, one band slot each), each
     record 13 values: the 9 feature rows, depth, rx, ry and the frame id,
     held once a (frame, splat) and read once a record sent;
  3. routes the records over ``tile`` to their band, then over ``splat``
     to the rank that holds the frame's truths ((f // fpb) % S);
  4. groups the received records by local frame into (fpb, M) virtual
     splats (route.bucket_local), M the largest frame's count, padding
     slots invalid;
  5. composites its band from these rows (ops.raster_tiled.
     render_train_grads_rows, ``my`` shifted by the band's offset in
     float32), a frame group at a time;
  6. routes the row gradients back along both hops (route.route_back,
     which sums each (frame, splat)'s band records in band-slot order);
  7. pulls them through its projection (one torch.autograd.grad): the
     per-frame location gradients are whole, so ``var_loc`` is exact with
     no collective before the norm;
  8. sums the gradients over ``camera`` and ``tile`` (they are born
     sharded over ``splat``), the loss over every axis (divided by B), and
     takes the largest duplicate count and route counts; then the clamped
     SGD update of its rows.

The one deliberate difference from JAX: the exchanges are exact
(collectives.all_to_all_rows takes uneven splits), so the step drops no
record.  It therefore takes none of JAX's capacities (``route_cap1``,
``route_cap2``, ``virt_cap``); RouteStats reports the true maxima, the
numbers that JAX's capacities must reach for its step to drop nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.ops.binning import tile_aabb
from gaussian_splatterer_tpu_torch.ops.raster_tiled import (
    REDUCTIONS, loc_norm_sum, project_frames, render_train_grads_rows,
)
from gaussian_splatterer_tpu_torch.ops.transforms import SplatComponents
from gaussian_splatterer_tpu_torch.parallel.collectives import (
    CommStats, all_reduce_max_ints, all_reduce_sum,
)
from gaussian_splatterer_tpu_torch.parallel.dp import (
    CAMERA_AXIS, frame_slice, step_inputs,
)
from gaussian_splatterer_tpu_torch.parallel.fsdp import SPLAT_AXIS, SplatShard
from gaussian_splatterer_tpu_torch.parallel.mesh3 import FRAME_AXES
from gaussian_splatterer_tpu_torch.parallel.route import (
    bucket_local, bucket_route, route_back, unbucket_local,
)
from gaussian_splatterer_tpu_torch.parallel.tp import TILE_AXIS, band_height
from gaussian_splatterer_tpu_torch.train.trainer import (
    CameraBatch, LearningRates, TrainMetrics, _apply_sgd, _largest_divisor_leq,
    fused_kw_from_runtime,
)

# the projection frames split over these axes together, camera-major (JAX's
# P((CAMERA_AXIS, TILE_AXIS)) of the cameras)
PROJECTION_AXES = (CAMERA_AXIS, TILE_AXIS)
# a record's rows: the 9 feature rows (render_train_grads_rows' order),
# then the binning's depth, rx, ry and the frame id
_R_MY, _R_DEPTH, _R_RX, _R_RY, _R_FRAME = 1, 9, 10, 11, 12
_FEATURES = 9


class RouteStats(NamedTuple):
    """The step's true maxima over the mesh: the records one rank sent one
    band (JAX's ``route_cap1``), the records one band rank sent one frame
    owner (``route_cap2``) and a frame's virtual splats (``virt_cap``).
    Past its capacity, JAX's step drops records; this one has none."""

    route1_max: int
    route2_max: int
    frame_max: int


def make_routed3_train_step(
    mesh: DeviceMesh,
    width: int,
    height: int,
    sh_degree: int,
    runtime: Optional[RuntimeConfig] = None,
    *,
    frame_group: int = 8,
    reduction: str = "index_add",
):
    """Build the (shard, truths, cams, lrs) -> (shard, metrics, RouteStats)
    step over a (``camera``, ``tile``, ``splat``) mesh that never holds the
    whole parameters on a rank (module docstring).

    The inputs are placed as mesh3's: ``shard`` by mesh3.shard_model_3d (a
    SplatShard, updated in place), ``truths`` by mesh3.shard_truths_3d
    (frames over camera x splat, tile rows over tile).  2F must split over
    camera x splat and over camera x tile.  ``frame_group`` frames are composited a launch; ``reduction`` is the
    fused core's route for the duplicate gradients.  The collectives count
    into ``step.comm``."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction {reduction!r} is not one of {REDUCTIONS}")
    fkw = fused_kw_from_runtime(runtime)
    tile, max_dup, aa = fkw.get("tile", 32), fkw.get("max_dup", 2**18), fkw.get("aa", False)

    def size(axis):
        return mesh.size(mesh.mesh_dim_names.index(axis))

    n_cam, n_band, n_splat = size(CAMERA_AXIS), size(TILE_AXIS), size(SPLAT_AXIS)
    band_h = band_height(height, tile, n_band)
    rows_per_band = band_h // tile
    tx_tiles, ty_tiles = -(-width // tile), -(-height // tile)
    camera_g, tile_g = mesh.get_group(CAMERA_AXIS), mesh.get_group(TILE_AXIS)
    splat_g = mesh.get_group(SPLAT_AXIS)
    y_off = float(mesh.get_local_rank(TILE_AXIS) * band_h)
    comm = CommStats()

    def project(shard: SplatShard, cams: CameraBatch):
        """1. (the leaves, the detached components (F, n), the rows (9, F n)
        in the leaves' graph) of the rank's rows for its projection frames."""
        f, n = cams.num_frames, shard.rows
        active = torch.arange(n, device=shard.device) + shard.offset < shard.count
        leaves = [shard.means.detach().expand(f, -1, -1).clone()] + [
            x.detach() for x in (shard.shs, shard.scales, shard.opacities, shard.rotations)]
        for x in leaves:
            x.requires_grad_(True)
        with torch.enable_grad():
            comps, rows9 = project_frames(*leaves, active, *cams, width, height, sh_degree, aa)
        return leaves, comps, rows9

    def records(comps: SplatComponents, rows9: torch.Tensor, first_frame: int):
        """2. (the band of each (band slot, frame, splat) record, (B, F
        n), -1 for none; the (frame, splat) rows (F n, 13) that the records
        carry)."""
        f, n = comps.mx.shape
        x0, y0, x1, y1 = tile_aabb(comps.mx.reshape(-1), comps.my.reshape(-1),
                                   comps.rx.reshape(-1), comps.ry.reshape(-1), tile, tx_tiles,
                                   ty_tiles)
        nonempty = (x1 > x0) & (y1 > y0) & comps.valid.reshape(-1)
        b_lo, b_hi = y0 // rows_per_band, (y1 - 1) // rows_per_band
        band = b_lo[None, :] + torch.arange(n_band, device=b_lo.device)[:, None]
        dst = torch.where(nonempty[None, :] & (band <= b_hi[None, :]), band, -1)
        frame = torch.arange(first_frame, first_frame + f, dtype=torch.float32,
                             device=rows9.device).repeat_interleave(n)
        payload = torch.cat([rows9.detach(), comps.depth.reshape(1, -1), comps.rx.reshape(1, -1),
                             comps.ry.reshape(1, -1), frame[None, :]]).T
        return dst, payload

    def composite(b3: torch.Tensor, valid3: torch.Tensor, truths, bgs):
        """5. (loss_sum, d_rows (fpb, 9, M), num_dup) of the band's frames
        from their virtual splats b3 (fpb, 13, M), frame_group a launch."""
        comps = SplatComponents(
            mx=b3[:, 0], my=b3[:, _R_MY] - y_off, ca=b3[:, 2], cb=b3[:, 3], cc=b3[:, 4],
            cr=b3[:, 5], cg=b3[:, 6], cb2=b3[:, 7], opacity=b3[:, 8], depth=b3[:, _R_DEPTH],
            radius=b3[:, _R_RX], rx=b3[:, _R_RX], ry=b3[:, _R_RY], valid=valid3)
        fpb = b3.shape[0]
        group = _largest_divisor_leq(fpb, frame_group)
        loss_sum = torch.zeros((), dtype=torch.float32, device=b3.device)
        d_rows = torch.empty((fpb, _FEATURES, b3.shape[2]), dtype=torch.float32,
                             device=b3.device)
        num_dup = 0
        for g0 in range(0, fpb, group):
            sl = slice(g0, g0 + group)
            l_sum, d, _res, nd, _nw = render_train_grads_rows(
                SplatComponents(*(x[sl] for x in comps)), width, band_h, truths[sl], bgs[sl],
                tile=tile, max_dup=max_dup, reduction=reduction)
            loss_sum += l_sum
            d_rows[sl] = d
            num_dup = max(num_dup, nd)
        return loss_sum, d_rows, num_dup

    def step(shard: SplatShard, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        if shard.sh_degree != sh_degree:
            raise ValueError(f"the model's SH degree {shard.sh_degree} is not the step's "
                             f"{sh_degree}")
        dev, f = shard.device, cams.num_frames
        for axes, what in ((FRAME_AXES, "camera x splat"), (PROJECTION_AXES, "camera x tile")):
            if (2 * f) % (size(axes[0]) * size(axes[1])):
                raise ValueError(f"2 x {f} cameras do not split over {what}")
        _cams_c, bgs = step_inputs(mesh, truths, cams, dev, FRAME_AXES)
        fpb = truths.shape[0]
        proj = frame_slice(mesh, 2 * f, PROJECTION_AXES)
        leaves, comps, rows9 = project(shard, CameraBatch(*(x[proj] for x in cams.twice())))
        dst1, payload = records(comps, rows9, proj.start)
        # 3. over tile to the band, then over splat to the frame's owner
        recv1, counts1, mc1 = bucket_route(dst1, payload, tile_g, comm)
        dst2 = torch.div(recv1[:, _R_FRAME].long(), fpb, rounding_mode="floor") % n_splat
        recv2, counts2, mc2 = bucket_route(dst2, recv1, splat_g, comm)
        # 4. by local frame, as many slots as the largest frame's records
        dst3 = recv2[:, _R_FRAME].long() % fpb
        mc3 = int(torch.bincount(dst3, minlength=fpb).max())
        slots = max(mc3, 1)
        b3, valid3, _ = bucket_local(dst3, recv2.T, fpb, slots)
        loss_sum, d_rows, num_dup = composite(b3, valid3, truths, bgs)
        # 6. back along both hops; a (frame, splat)'s band records summed
        g_recv2 = unbucket_local(dst3, d_rows, slots).T
        g_recv1 = route_back(dst2, g_recv2, counts2, splat_g, comm)
        d_rows9 = route_back(dst1, g_recv1, counts1, tile_g, comm).T.contiguous()
        # 7. through the projection
        d_means_b, *g_rest = torch.autograd.grad(rows9, leaves, d_rows9)
        sums = [d_means_b.sum(0), loc_norm_sum(d_means_b), *g_rest]
        # 8. over the frame-split axes; the loss over all, the maxima over all
        for group, n in ((camera_g, n_cam), (tile_g, n_band)):
            if n > 1:
                sums = all_reduce_sum(sums, group, comm)
        g_means, var_loc, *g_rest = sums
        (loss_sum,) = all_reduce_sum([loss_sum], None, comm)
        num_dup, *maxima = all_reduce_max_ints([num_dup, mc1, mc2, mc3], None, dev, comm)
        samples = float(2 * f)
        avg = [g / samples for g in (g_means, *g_rest)]
        _apply_sgd(shard, avg, lrs)
        metrics = TrainMetrics(loss=loss_sum / n_band / samples, var_loc=var_loc / samples,
                               avg_grad_loc=avg[0], num_dup=num_dup)
        return shard, metrics, RouteStats(*maxima)

    step.comm = comm
    return step
