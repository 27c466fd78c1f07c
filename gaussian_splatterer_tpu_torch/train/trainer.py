"""Training engine: capture, train step, SGD apply, render (counterpart of
gaussian_splatterer_tpu.train.trainer).

One training iteration renders the model from every truth camera twice
(white background set, then black; dual-background supervision is what
teaches opacity, src/Trainer.cu:311-314), feeds the signed residual
``truth - rendered`` back through the rasterizer (src/Trainer.cu:33-44,
378-412), averages the per-splat gradients over all 2F frames, accumulates
the mean |location gradient| as the densify "variance" signal
(src/Trainer.cu:47-77), and applies one per-feature-LR SGD step with scale
and opacity clamps (src/Trainer.cu:81-101).  The residual is the negative
L2 gradient, so ``param += grad * lr`` is gradient descent on
0.5 * |render - truth|^2.

Two step kinds, as in the JAX package:
  * fused (renderer "tiled", resolution a multiple of the tile): the
    frame-batched training core ops.raster_tiled.render_train_grads_batch,
    ``frame_group`` frames per launch of the CUDA kernel composite_train,
    against pre-tiled truths; ``reduction`` (a fused option, and a
    Trainer argument) picks how the duplicate gradients reach their
    splats: "index_add" (the default) or "cumsum" (the JAX package's
    per-frame scan route, kernel cumsum_frames, deterministic);
  * frame by frame, ``torch.autograd.grad`` of a differentiable renderer:
    renderer "tiled" at a resolution that is not a multiple of the tile
    (render_tiled, whose compositor's backward is the CUDA kernel
    composite_bwd), renderer "oracle", or a caller's ``render_fn``.  The
    Trainer passes its runtime-configured renderer, so this step bins with
    the runtime's tile_px, max_dup and mip_antialias.
With ``train_devices`` N > 1 (``gsplat-torch train --devices N``) each of N
ranks of a ``torch.distributed`` group runs a Trainer: ``train_mesh`` "dp"
(camera-data-parallel, parallel/dp.py) or "fsdp" (splat-sharded,
parallel/fsdp.py), with sharded recaptures (parallel/capture.py).

The step updates the model's parameters in place (the JAX step returns a
new model); densify returns a new model.
"""

from __future__ import annotations

import random
import warnings
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops.raster_tiled import (
    REDUCTIONS, image_to_tiles, loc_norm_sum, render_train_grads_batch,
)
from gaussian_splatterer_tpu_torch.train.densify import DensifyParams, densify


class CameraBatch(NamedTuple):
    """Stacked per-frame camera data, all on the model's device: the fused
    step's frame-batched projection reads a group's tangents as an (F,)
    tensor there, so no group uploads them."""

    view: torch.Tensor  # (F, 4, 4)
    proj_view: torch.Tensor  # (F, 4, 4)
    cam_pos: torch.Tensor  # (F, 3)
    tan_fovx: torch.Tensor  # (F,)
    tan_fovy: torch.Tensor  # (F,)

    @classmethod
    def from_cameras(cls, cameras: Sequence[Camera], width: int, height: int, *,
                     device, train: bool = True) -> "CameraBatch":
        tans = np.array([c.tan_fov(width, height, train=train) for c in cameras], np.float32)

        def stack(xs):
            return torch.from_numpy(np.stack(xs).astype(np.float32)).to(device)

        return cls(
            view=stack([c.get_view() for c in cameras]),
            proj_view=stack([c.get_proj_view(width / height) for c in cameras]),
            cam_pos=stack([c.location for c in cameras]),
            tan_fovx=torch.from_numpy(tans[:, 0].copy()).to(device),
            tan_fovy=torch.from_numpy(tans[:, 1].copy()).to(device),
        )

    @property
    def num_frames(self) -> int:
        return self.view.shape[0]

    def twice(self) -> "CameraBatch":
        """The 2F cameras of a step: the white-background pass, then the
        black one."""
        return CameraBatch(*(torch.cat([x, x]) for x in self))


class LearningRates(NamedTuple):
    location: float
    sh: float
    scale: float
    opacity: float
    rotation: float
    scale_max: float

    @classmethod
    def from_project(cls, p: Project) -> "LearningRates":
        return cls(location=p.lrLocation, sh=p.lrSh, scale=p.lrScale,
                   opacity=p.lrOpacity, rotation=p.lrRotation, scale_max=p.paramScaleMax)


class TrainMetrics(NamedTuple):
    loss: torch.Tensor  # () mean MSE over all 2F frames
    var_loc: torch.Tensor  # (C,) densify variance signal
    avg_grad_loc: torch.Tensor  # (C, 3) mean location gradient
    num_dup: int  # most binning duplicates of any frame this step (fused
    # path; -1 when the renderer doesn't report it).  > max_dup means the
    # deepest duplicates were dropped; Trainer.maybe_grow_dup_buffer grows it.
    num_work: int = -1  # the JAX package's work-list count; no work list here


RenderFn = Callable[..., torch.Tensor]


def _default_render(kind: str, row_chunk: int,
                    runtime: Optional[RuntimeConfig] = None) -> RenderFn:
    if kind == "oracle":
        from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle

        return partial(render_oracle, row_chunk=row_chunk)
    if kind == "tiled":
        from gaussian_splatterer_tpu_torch.ops.raster_tiled import render_tiled

        if runtime is not None:
            return partial(render_tiled, tile=runtime.tile_px, max_dup=runtime.max_dup,
                           aa=runtime.mip_antialias)
        return render_tiled
    raise ValueError(f"unknown renderer {kind!r}")


def fused_kw_from_runtime(runtime: Optional[RuntimeConfig]) -> dict:
    """Fused-step options from the RuntimeConfig.  ``train_mm_bf16``,
    ``train_chunk``, ``train_work_cap``, ``train_fast_exp`` and
    ``train_mm_power`` tune the TPU kernel and have no counterpart here:
    the CUDA kernel computes in float32 and has no work list."""
    if runtime is None:
        return {}
    return dict(tile=runtime.tile_px, max_dup=runtime.max_dup, aa=runtime.mip_antialias)


def _largest_divisor_leq(n: int, k: int) -> int:
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


def _params(model: SplatModel):
    return (model.means, model.shs, model.scales, model.opacities, model.rotations)


@torch.no_grad()
def _apply_sgd(model: SplatModel, avg, lrs: LearningRates) -> None:
    g_means, g_shs, g_scales, g_opac, g_rot = avg
    model.means.add_(g_means * lrs.location)
    model.shs.add_(g_shs * lrs.sh)
    model.scales.copy_(torch.clamp(model.scales + g_scales * lrs.scale, 0.0, lrs.scale_max))
    model.opacities.copy_(torch.clamp(model.opacities + g_opac * lrs.opacity, 0.0, 1.0))
    model.rotations.add_(g_rot * lrs.rotation)


def backgrounds(f: int, device) -> torch.Tensor:
    """The (2F, 3) backgrounds of a step's frames: F white, then F black."""
    return torch.cat([torch.ones((f, 3)), torch.zeros((f, 3))]).to(device)


def make_frame_accumulator(
    width: int,
    height: int,
    sh_degree: int,
    renderer: str = "oracle",
    row_chunk: int = 32,
    render_fn: Optional[RenderFn] = None,
    fused: bool = False,
    fused_opts: Optional[dict] = None,
    frame_group: int = 8,
    loc_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The frame loop of a train step, shared by the single-device step and
    the sharded ones (parallel/dp.py, parallel/tp.py): a function

        accumulate(params, active, truths, cams, bgs, divisor) ->
            (g, var, loss_sum, num_dup)

    over the frames given (``cams`` one camera a frame, ``bgs`` (n, 3)).
    ``g`` are the five parameter gradients and ``var`` the (C,) sum of each
    frame's |location gradient|, summed over the frames and divided by
    ``divisor``: the fused step divides the sums (``frame_group`` frames a
    launch of render_train_grads_batch, snapped down to a divisor of the
    frame count), the frame-by-frame step each frame's terms, as the JAX
    package's single-device step does.  ``loss_sum`` is the sum of the
    frames' mean squared residuals; ``num_dup`` the most duplicates of any
    frame on the fused step, -1 off it.

    ``loc_reduce`` (fused step only) asks each group for its per-frame
    location gradients (F, N, 3) and passes them through it before they are
    summed and normed: the band step sums a frame's bands there, since the
    norm is not linear."""
    fkw = dict(fused_opts or {})
    if loc_reduce is not None:
        if not fused:
            raise ValueError("loc_reduce needs the fused step")
        fkw["frame_loc_grads"] = True
    if not fused:
        render = render_fn if render_fn is not None else _default_render(renderer, row_chunk)

    def accumulate(params, active, truths, cams: CameraBatch, bgs, divisor: float):
        n = truths.shape[0]
        dev = params[0].device
        gsum = [torch.zeros_like(p) for p in params]
        var = torch.zeros((params[0].shape[0],), dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        if fused:
            group = _largest_divisor_leq(n, frame_group)
            num_dup = 0
            for g0 in range(0, n, group):
                sl = slice(g0, g0 + group)
                l_sum, g, v, _, nd, _ = render_train_grads_batch(
                    *params, active, *(x[sl] for x in cams),
                    width, height, truths[sl], bgs[sl], sh_degree, **fkw)
                if loc_reduce is not None:
                    d_means_b = loc_reduce(v)
                    g, v = (d_means_b.sum(0), *g[1:]), loc_norm_sum(d_means_b)
                for acc, gi in zip(gsum, g):
                    acc += gi
                var += v
                loss_sum += l_sum
                num_dup = max(num_dup, nd)
            return [x / divisor for x in gsum], var / divisor, loss_sum, num_dup
        tans = torch.stack([cams.tan_fovx, cams.tan_fovy], 1).tolist()
        for i in range(n):
            leaves = [p.detach().clone().requires_grad_(True) for p in params]
            with torch.enable_grad():
                img = render(*leaves, active, cams.view[i], cams.proj_view[i],
                             cams.cam_pos[i], *tans[i], width, height, bgs[i],
                             sh_degree, 1.0)
            residual = (truths[i] - img).detach()  # signed diff = -dL/dpixel of L2/2
            g = torch.autograd.grad(img, leaves, residual)
            for acc, gi in zip(gsum, g):
                acc += gi / divisor
            var += torch.linalg.vector_norm(g[0], dim=-1) / divisor
            loss_sum += torch.mean(torch.square(residual))
        return gsum, var, loss_sum, -1  # num_dup is not reported off the fused path

    return accumulate


def make_train_step(
    width: int,
    height: int,
    sh_degree: int,
    renderer: str = "oracle",
    row_chunk: int = 32,
    render_fn: Optional[RenderFn] = None,
    fused: bool = False,
    fused_opts: Optional[dict] = None,
    frame_group: int = 8,
):
    """Build a (model, truths, cams, lrs) -> (model, metrics) step.

    truths: (2F, H, W, 3) float32, F white-background frames then F
    black-background frames in the same camera order (src/Trainer.cu:
    311-314); with ``fused=True`` pre-tiled to (2F, T, P, 3) with
    ops.raster_tiled.image_to_tiles.  The fused step composites
    ``frame_group`` frames per kernel launch, snapped down to a divisor of
    2F; ``fused_opts`` are render_train_grads_batch's keywords (tile,
    max_dup, aa, reduction).  The model's parameters are updated in
    place."""
    accumulate = make_frame_accumulator(width, height, sh_degree, renderer, row_chunk,
                                        render_fn, fused, fused_opts, frame_group)

    def step(model: SplatModel, truths: torch.Tensor, cams: CameraBatch, lrs: LearningRates):
        f = cams.num_frames
        if truths.shape[0] != 2 * f:
            raise ValueError("need a white and a black frame per camera")
        samples = float(2 * f)
        avg, var, loss_sum, num_dup = accumulate(
            _params(model), model.active_mask(), truths, cams.twice(),
            backgrounds(f, model.device), samples)
        _apply_sgd(model, avg, lrs)
        return model, TrainMetrics(loss=loss_sum / samples, var_loc=var,
                                   avg_grad_loc=avg[0], num_dup=num_dup)

    return step


def _resolve_devices(n: int, frames: int, device_type: str = "cpu",
                     device_count: Optional[int] = None) -> int:
    """The number of ranks to train on when ``n`` are asked for: 1 for 0 or
    1; otherwise the largest divisor of the step's ``frames`` (2F, split
    evenly by the sharded steps) up to ``n``, with a warning when that is
    fewer.  On ``cuda`` with ``device_count`` given (the launcher's cards,
    one a rank), ``n`` above it raises."""
    if n <= 1:
        return 1
    if device_type == "cuda" and device_count is not None and n > device_count:
        raise RuntimeError(f"train_devices={n} but only {device_count} devices are attached")
    k = n
    while frames % k:
        k -= 1
    if k != n:
        warnings.warn(f"2*num_cameras={frames} not divisible by {n} devices; training on {k}")
    return k


def randomize_rig_rotations(project: Project, rng: Optional[random.Random] = None) -> None:
    """All four rig rotations -> uniform [0, 360) (reference
    src/ui/tools/UiPanelToolsTruth.cpp:192-197; auto-train triggers this
    before every re-capture, src/ui/UiFrame.cpp:286-290)."""
    r = rng or random
    for sph in (project.sphere1, project.sphere2):
        sph.rotX = r.uniform(0.0, 360.0)
        sph.rotY = r.uniform(0.0, 360.0)


class Trainer:
    """Host-side orchestration: owns the model, truth buffers and schedules.

    ``rtx`` is any object with ``render(camera, background, samples, width,
    height) -> (H, W, 3)`` image (numpy or tensor): the path tracer
    (rt.RtxHost, whose images already lie on its device) or a surrogate
    such as renders of a teacher model.  The model's device is the training
    device.  ``reduction`` is the fused step's route for the duplicate
    gradients, "index_add" or "cumsum" (ops.raster_tiled.REDUCTIONS).

    Several devices: ``devices`` (a count, or a sequence whose length is
    taken) or else ``runtime.train_devices`` asks for N; ``devices`` is the
    number resolved from it (None for one).  Each rank of a process group of
    that size (parallel.init_distributed) makes its own Trainer with the
    same arguments, its model on its own device, and calls it in step with
    the others.  Made without such a group (a project saved for N devices,
    opened to print its info or render), the Trainer raises at its first
    step or capture.  On "fsdp" ``model`` is the rank's rows (a
    parallel.SplatShard); assigning a whole SplatModel shards it, and
    ``_gathered_model()`` (a collective) returns the whole model.
    """

    def __init__(
        self,
        project: Project,
        runtime: RuntimeConfig,
        model: SplatModel,
        renderer: str = "oracle",
        row_chunk: int = 32,
        render_fn: Optional[RenderFn] = None,
        devices: Optional[Sequence] = None,
        reduction: str = "index_add",
    ):
        if reduction not in REDUCTIONS:
            raise ValueError(f"reduction {reduction!r} is not one of {REDUCTIONS}")
        if devices is not None and not isinstance(devices, int):
            devices = len(devices)
        self._devices_asked = devices
        self.project = project
        self.runtime = runtime
        self._mesh = None
        self._model_sharded = False
        self.model = model
        self.renderer = renderer
        self.row_chunk = row_chunk
        self.reduction = reduction
        self._user_render = render_fn is not None
        self._render_fn = render_fn
        self.truths: Optional[torch.Tensor] = None  # (2F, H, W, 3) or (2F, T, P, 3)
        self.truth_cams: Optional[CameraBatch] = None
        self.last_metrics: Optional[TrainMetrics] = None
        self._last_buffer_check_it: Optional[int] = None
        self._capture_seed = 0  # the sharded capture's seed counter
        self.devices = self._resolve()
        self._build_step()

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, m) -> None:
        if self._model_sharded and isinstance(m, SplatModel):
            from gaussian_splatterer_tpu_torch.parallel import shard_model

            m = shard_model(self._mesh, m)
        self._model = m

    def _resolve(self) -> Optional[int]:
        """The number of ranks asked for, resolved by _resolve_devices
        (None for one).  The
        card count is the launcher's to check: ranks of a gloo group may
        share one card."""
        n = self._devices_asked
        if n is None:
            n = int(self.runtime.train_devices or 0)
        k = _resolve_devices(n, 2 * self.project.num_cameras, self.model.device.type)
        return k if k > 1 else None

    def refresh_devices(self) -> None:
        """Resolve the ranks again after the Project changed under the
        Trainer (Session.load_settings swaps the rig in place): the
        frame-divisor shrink depends on 2 x num_cameras."""
        new = self._resolve()
        if new != self.devices:
            if self._model_sharded:
                self._model = self._gathered_model()
            self.devices = new
            self._mesh = None
            self._model_sharded = False
            self._build_step()

    def _build_step(self) -> None:
        """(Re)build the step from the current RuntimeConfig: at
        construction and when maybe_grow_dup_buffer grows max_dup."""
        runtime = self.runtime
        if not self._user_render:
            self._render_fn = _default_render(self.renderer, self.row_chunk, runtime)
        self._fused = (
            self.renderer == "tiled" and not self._user_render
            and runtime.render_resolution_x % runtime.tile_px == 0
            and runtime.render_resolution_y % runtime.tile_px == 0
        )
        if self.devices is not None:
            self._build_mesh_step()
            return
        self._step = make_train_step(
            runtime.render_resolution_x, runtime.render_resolution_y, runtime.sh_degree,
            renderer=self.renderer, row_chunk=self.row_chunk,
            # the runtime-configured renderer even when it is the default:
            # the bare fallback would bin with render_tiled's own defaults
            # (tile 16, max_dup 2^19, no AA) on the non-fused tiled step
            render_fn=self._render_fn,
            fused=self._fused,
            fused_opts=dict(fused_kw_from_runtime(runtime), reduction=self.reduction),
            frame_group=runtime.frame_group,
        )

    def _build_mesh_step(self) -> None:
        """The sharded step of ``runtime.train_mesh``: "dp", the replicated
        model over a 1-D camera mesh; "fsdp", the model's rows split over a
        1 x N (camera x splat) mesh, densify gathering them.  Without a
        process group of the resolved size there is no step (train raises).
        Both steps take the single-device step's arguments."""
        from gaussian_splatterer_tpu_torch import parallel

        runtime, n = self.runtime, self.devices
        kind = runtime.train_mesh
        if kind not in ("dp", "fsdp"):
            raise ValueError(f"unknown train_mesh {kind!r} (expected 'dp' or 'fsdp')")
        self._step = None
        if parallel.world_size() != n:
            return
        dev_type = self.model.device.type
        if self._mesh is None:
            self._mesh = (parallel.make_camera_mesh(dev_type) if kind == "dp"
                          else parallel.make_2d_mesh(dev_type, 1, n))
        common = dict(renderer=self.renderer,
                      render_fn=self._render_fn if self._user_render else None,
                      row_chunk=self.row_chunk, runtime=runtime, fused=self._fused,
                      frame_group=runtime.frame_group, reduction=self.reduction)
        size = (runtime.render_resolution_x, runtime.render_resolution_y, runtime.sh_degree)
        if kind == "dp":
            self._step = parallel.make_dp_train_step(self._mesh, *size, **common)
        else:
            self._step = parallel.make_fsdp_train_step(self._mesh, *size, **common)
            self._reshard_model = parallel.shard_model
            self._model_sharded = True
            self.model = self._model  # the rest state: this rank's rows

    def _require_group(self) -> None:
        if self.devices is not None and self._step is None:
            n = self.devices
            raise RuntimeError(
                f"training on {n} devices needs a torch.distributed process group of {n} "
                f"ranks: run `gsplat-torch train PROJECT --devices {n}` (one process a "
                "device), or set train_devices to 1")

    def _gathered_model(self) -> SplatModel:
        """The whole model: itself on one device and under "dp"; under
        "fsdp" gathered from every rank's rows (a collective: every rank
        calls it)."""
        if not self._model_sharded:
            return self.model
        from gaussian_splatterer_tpu_torch.parallel import gather_model

        return gather_model(self._mesh, self.model)

    def share_rig(self) -> None:
        """Rank 0's rig rotations on every rank (after a randomized
        recapture: each rank's rng draws its own)."""
        if self.devices is None:
            return
        from gaussian_splatterer_tpu_torch.parallel.collectives import broadcast_object

        p = self.project
        rot = broadcast_object([(s.rotX, s.rotY) for s in (p.sphere1, p.sphere2)])
        for sph, (rx, ry) in zip((p.sphere1, p.sphere2), rot):
            sph.rotX, sph.rotY = rx, ry

    # ------------------------------------------------------------------
    def maybe_grow_dup_buffer(self, metrics: Optional[TrainMetrics] = None) -> bool:
        """Grow max_dup after a binning overflow.

        The fused step reports the most duplicates any frame generated
        (TrainMetrics.num_dup).  The reference radix-sorts the exact count
        and cannot truncate (src/Trainer.cu:334-360), so when num_dup >
        max_dup this grows max_dup, with 25% headroom rounded up to a
        multiple of train_chunk, and returns True.  The step that overflowed
        dropped its deepest duplicates.  One check per iteration.  (The JAX
        package also shrinks its static buffers; here buffers are sized from
        the true count every step, so there is nothing to shrink.)"""
        metrics = metrics if metrics is not None else self.last_metrics
        if metrics is None:
            return False
        it = self.project.iterations
        if self._last_buffer_check_it == it:
            return False
        self._last_buffer_check_it = it
        nd = int(metrics.num_dup)
        if nd <= self.runtime.max_dup:
            return False
        chunk = self.runtime.train_chunk
        new_max = -(-int(nd * 1.25) // chunk) * chunk
        warnings.warn(
            f"binning duplicate buffer overflow: {nd} > max_dup={self.runtime.max_dup}; "
            f"growing to {new_max} (the overflowing step dropped its deepest duplicates)")
        self.runtime.max_dup = new_max
        self._build_step()
        return True

    def calibrate_work_cap(self, metrics: Optional[TrainMetrics] = None,
                           slack: float = 4.0) -> bool:
        """The JAX package sizes its TPU work-list budget here.  The CUDA
        kernel has no work list: nothing to calibrate."""
        return False

    # ------------------------------------------------------------------
    def capture_truths(self, rtx, devices=None) -> None:
        """Photograph the scene from every rig camera against white AND
        black backgrounds (src/Trainer.cu:218-250): whites then blacks,
        tiled for the fused step.

        ``devices`` (default: the Trainer's) splits the path tracer's
        frames, with a new seed each capture: a count > 1 over the ranks of
        the default group (parallel.capture_images_sharded; a sharded
        Trainer keeps its own block of the frames), a list of more than one
        device, without a process group, over those devices in this process
        (parallel.capture_images_local).  A truth source without a traced
        scene (no ``_tris``) is called for every frame on every rank."""
        from gaussian_splatterer_tpu_torch import parallel

        self._require_group()
        w = self.runtime.render_resolution_x
        h = self.runtime.render_resolution_y
        dev = self.model.device
        cameras = Camera.get_cameras(self.project)
        n = devices if devices is not None else self.devices
        traced = getattr(rtx, "_tris", None) is not None
        local = isinstance(n, (list, tuple))
        if traced and local and len(n) > 1 and parallel.world_size() == 1:
            self._capture_seed += 1
            truths = parallel.capture_images_local(
                rtx, cameras, self.project.rtSamples, w, h, n, seed=self._capture_seed).to(dev)
        elif traced and not local and n and n > 1 and parallel.world_size() > 1:
            self._capture_seed += 1
            truths = parallel.capture_images_sharded(
                rtx, cameras, self.project.rtSamples, w, h, seed=self._capture_seed,
                gather=self._mesh is None).to(dev)
        else:
            def shoot(c, bg):
                img = rtx.render(c, bg, self.project.rtSamples, w, h)
                return torch.as_tensor(img, dtype=torch.float32).to(dev)

            whites = [shoot(c, (1.0, 1.0, 1.0)) for c in cameras]
            blacks = [shoot(c, (0.0, 0.0, 0.0)) for c in cameras]
            truths = torch.stack(whites + blacks)
            if self._mesh is not None:
                truths = parallel.shard_truths(self._mesh, truths)
        if self._fused:
            truths = image_to_tiles(truths, self.runtime.tile_px).contiguous()
        self.truths = truths
        self.truth_cams = CameraBatch.from_cameras(cameras, w, h, train=True, device=dev)

    # ------------------------------------------------------------------
    def train(self, densify_now: bool = False) -> TrainMetrics:
        self._require_group()
        if self.truths is None:
            raise RuntimeError("Can't run training iteration, no truth data available!")
        p, runtime = self.project, self.runtime
        p.iterations += 1
        lrs = LearningRates.from_project(p)
        px_scale = 1.0
        if runtime.lr_resolution_ref:
            # gradients are pixel sums (src/Trainer.cu:33-44): scale the LRs by
            # ref_pixels / actual_pixels so a recipe tuned at
            # lr_resolution_ref^2 behaves the same at this resolution
            ref = runtime.lr_resolution_ref
            px_scale = (ref * ref) / float(runtime.render_resolution_x
                                           * runtime.render_resolution_y)
            lrs = lrs._replace(location=p.lrLocation * px_scale, sh=p.lrSh * px_scale,
                               scale=p.lrScale * px_scale, opacity=p.lrOpacity * px_scale,
                               rotation=p.lrRotation * px_scale)
        if runtime.lr_location_decay != 1.0:
            # 3DGS-style exponential location-LR schedule (off by default)
            lrs = lrs._replace(location=p.lrLocation * px_scale
                               * runtime.lr_location_decay ** p.iterations)
        self.model, metrics = self._step(self.model, self.truths, self.truth_cams, lrs)
        if densify_now:
            dp = DensifyParams.from_project(p)
            threshold = p.paramDensifyVariance / px_scale
            if runtime.densify_variance_decay != 1.0:
                # anneal the split/clone trigger over training (off by default)
                threshold *= runtime.densify_variance_decay ** p.iterations
            dp = dp._replace(densify_variance=threshold)
            if self._model_sharded:
                # the rows gathered -> the single-device densify -> re-sharded
                from gaussian_splatterer_tpu_torch.parallel import densify_sharded

                self.model = densify_sharded(self._mesh, self.model, metrics.var_loc,
                                             metrics.avg_grad_loc, dp, self._reshard_model)
            else:
                self.model = densify(self.model, metrics.var_loc, metrics.avg_grad_loc, dp)
            self.maybe_grow_dup_buffer(metrics)
        reset_iv = runtime.opacity_reset_interval
        if reset_iv and p.iterations % reset_iv == 0:
            # 3DGS-style opacity reset (off by default; no reference equivalent)
            with torch.no_grad():
                self.model.opacities.clamp_(max=0.01)
        self.last_metrics = metrics
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def binning_stats(self, camera_index: int = 0) -> dict:
        """Duplicate-buffer utilization for one truth camera: num_dup over
        max_dup; > 1.0 means the deepest duplicates are dropped."""
        from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
        from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

        if self.truth_cams is None:
            raise RuntimeError("no truth cameras captured")
        i, m, rt = camera_index, self._gathered_model(), self.runtime
        cams = self.truth_cams
        c = project_splat_components(
            m.means, m.shs, m.scales, m.opacities, m.rotations, m.active_mask(),
            cams.view[i], cams.proj_view[i], cams.cam_pos[i], float(cams.tan_fovx[i]),
            float(cams.tan_fovy[i]), rt.render_resolution_x, rt.render_resolution_y,
            rt.sh_degree, 1.0, aa=rt.mip_antialias,
        )
        num = bin_splats(c, rt.render_resolution_x, rt.render_resolution_y, rt.tile_px,
                         rt.max_dup).num_dup
        return {"num_dup": num, "max_dup": rt.max_dup, "utilization": num / rt.max_dup,
                "overflow": num > rt.max_dup}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render(self, camera: Camera, width: Optional[int] = None,
               height: Optional[int] = None, splat_scale: float = 1.0) -> torch.Tensor:
        """Forward-only serve path: black background, aspect-scaled x-FOV
        quirk preserved (src/Trainer.cu:148-216)."""
        w = width or self.runtime.render_resolution_x
        h = height or self.runtime.render_resolution_y
        tan_x, tan_y = camera.tan_fov(w, h, train=False)
        m = self._gathered_model()
        return self._render_fn(
            m.means, m.shs, m.scales, m.opacities, m.rotations, m.active_mask(),
            camera.get_view(), camera.get_proj_view(w / h), camera.location, tan_x, tan_y,
            w, h, torch.zeros(3, device=m.device), m.sh_degree, splat_scale,
        )
