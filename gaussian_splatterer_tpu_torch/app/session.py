"""Headless application session (counterpart of
gaussian_splatterer_tpu.app.session).

Owns the project settings, the path-traced truth scene (``RtxHost``) and
the ``Trainer``, whose model is the session's model; provides the field
initializers, truth capture, training with the capture/densify cadence
(``auto_train``, with npz checkpoints, a PNG snapshot series and the live
watch page), resume from a checkpoint, project save/load in the directory
layout the JAX package writes (``settings.json``, ``runtime.json``,
``splats.gobj``; reference src/ui/UiFrame.cpp:452-532), still-image
export of the splats and of the traced scene
(src/ui/tools/UiPanelToolsView.cpp:112-141, 227-259), and the model's
export to and import from standard 3DGS ``.ply`` and its export to a
self-contained HTML viewer.

Trained on N devices (``runtime.train_devices``), every rank of the
process group runs its own Session with the same arguments and calls it in
step with the others: reading ``model`` gathers a splat-sharded model (a
collective), and rank 0 alone (``writer``) writes files: settings.json,
runtime.json, .gobj, checkpoints, snapshots, the watch page and exports.
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional

import numpy as np
import torch

from gaussian_splatterer_tpu_torch import parallel, resolve_device
from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from gaussian_splatterer_tpu_torch.io.gobj import load_gobj, save_gobj
from gaussian_splatterer_tpu_torch.io.image import save_png
from gaussian_splatterer_tpu_torch.io.ply import load_ply, save_ply
from gaussian_splatterer_tpu_torch.io.viewer import export_viewer_html
from gaussian_splatterer_tpu_torch.io.watch import write_watch_page
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import (
    SplatModel,
    SplatModelHost,
    init_field_grid,
    init_field_model,
    init_field_mono,
)
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu_torch.ops.raster_tiled import render_tiled
from gaussian_splatterer_tpu_torch.rt import RtxHost
from gaussian_splatterer_tpu_torch.train.schedule import auto_train
from gaussian_splatterer_tpu_torch.train.trainer import Trainer
from gaussian_splatterer_tpu_torch.utils.metrics import MetricsLogger

SETTINGS_FILE = "settings.json"
SPLATS_FILE = "splats.gobj"
RUNTIME_FILE = "runtime.json"
RENDERERS = ("tiled", "oracle")
ORACLE_ROW_CHUNK = 32  # pixel rows per oracle step (the JAX Trainer's default)


class Session:
    """Project + scene + trainer on one device, or on one rank's device of
    several (reference UiFrame, headless)."""

    def __init__(self, project: Optional[Project] = None,
                 runtime: Optional[RuntimeConfig] = None,
                 device="cuda", renderer: str = "tiled",
                 rng: Optional[random.Random] = None):
        if renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {renderer!r}")
        self.device = resolve_device(device)
        self.project = project or Project.app_default()
        self.runtime = runtime or RuntimeConfig()
        self.renderer = renderer
        self.rng = rng or random.Random()
        self.rtx = RtxHost(roulette_from=self.runtime.rt_roulette_from, device=self.device)
        self.logger = MetricsLogger()
        # boot field: the reference starts on the 17^3 grid
        # (src/ui/UiFrame.cpp:67); the mono splat under smaller capacities
        rt = self.runtime
        init = init_field_grid if rt.splats_capacity >= 17**3 else init_field_mono
        model = init(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs).to_device(self.device)
        self.trainer = Trainer(self.project, self.runtime, model, renderer=renderer)

    @property
    def devices(self) -> Optional[int]:
        """The number of ranks the trainer shards over (None for one)."""
        return self.trainer.devices

    @property
    def writer(self) -> bool:
        """Whether this process writes files: rank 0, or the only process."""
        return parallel.rank() == 0

    # -- scene ------------------------------------------------------------
    @property
    def model(self) -> SplatModel:
        """The whole model (gathered from the ranks' rows when sharded)."""
        return self.trainer._gathered_model()

    @model.setter
    def model(self, m: SplatModel) -> None:
        self.trainer.model = m

    def load_model_obj(self, path: str, progress=None) -> None:
        self.rtx.load_model(path, progress)
        self.project.pathModel = path

    def load_texture(self, path: str) -> None:
        self.rtx.load_texture_diffuse(path)
        self.project.pathTextureDiffuse = path

    # -- field initializers (reference src/ui/UiFrame.cpp:137-264) --------
    def init_field(self, kind: str) -> None:
        rt = self.runtime
        if kind == "grid":
            host = init_field_grid(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs)
        elif kind == "mono":
            host = init_field_mono(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs)
        elif kind == "model":
            if self.rtx.mesh is None:
                raise RuntimeError("init_field('model') requires a loaded OBJ")
            host = init_field_model(self.rtx.mesh.vertices, self.rtx.mesh.triangles,
                                    rt.splats_capacity, rt.sh_degree, rt.sh_coeffs)
        else:
            raise ValueError(f"unknown field initializer {kind!r}")
        self.model = host.to_device(self.device)
        self.project.iterations = 0

    # -- training -----------------------------------------------------------
    def _capture_devices(self):
        """With ``capture_data_parallel``, what a capture splits over: the
        ranks of the process group, or without one this process's cards
        (JAX splits over ``jax.devices()`` in one process)."""
        if not self.runtime.capture_data_parallel:
            return None
        if parallel.world_size() > 1:
            return parallel.world_size()
        return parallel.local_devices(self.device)

    def capture(self) -> None:
        self.trainer.capture_truths(self.rtx, devices=self._capture_devices())

    def train(self, steps: int = 1, densify: bool = False):
        for _ in range(steps):
            metrics = self.trainer.train(densify_now=densify)
        return metrics

    def auto_train(self, steps: int, on_step=None,
                   checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
                   snapshot_dir: Optional[str] = None, snapshot_every: int = 0,
                   watch_dir: Optional[str] = None, watch_every: int = 0) -> dict:
        """The reference's auto-train loop: a randomized re-capture every
        intervalCapture iterations, densify every intervalDensify.  Each
        step is logged; at the capture cadence (or the densify cadence, or
        every 100 iterations when both are off) a binning overflow grows
        the duplicate buffer.  Returns auto_train's wall-clock split.

        Every ``checkpoint_every`` iterations ``checkpoint_dir/latest.npz``
        is rewritten (io/checkpoint.py); every ``snapshot_every`` a splat
        render goes to ``snapshot_dir/iter_NNNNNN.png``; every
        ``watch_every`` ``watch_dir`` gets ``latest.png``, ``status.json``
        and a self-refreshing ``index.html`` (io/watch.py).  Snapshots and
        the watch page advance the free-orbit preview clock by the wall
        time since the last one (reference src/ui/UiFrame.cpp:272), so the
        series orbits the model."""
        t_start = time.monotonic()
        it_start = self.project.iterations
        watch_history: list = []

        def count() -> int:
            return int(self.trainer.model.count)

        def _advance_preview_clock():
            now = time.monotonic()
            last = getattr(self, "_last_snapshot_time", None)
            if last is not None:
                self.project.previewTimer += now - last
            self._last_snapshot_time = now

        def log_step(it, metrics):
            if snapshot_dir and snapshot_every and it % snapshot_every == 0:
                os.makedirs(snapshot_dir, exist_ok=True)
                _advance_preview_clock()
                self.export_splats_png(os.path.join(snapshot_dir, f"iter_{it:06d}.png"))
            if watch_dir and watch_every and it % watch_every == 0:
                os.makedirs(watch_dir, exist_ok=True)
                _advance_preview_clock()
                self.export_splats_png(os.path.join(watch_dir, "latest.png"))
                elapsed = time.monotonic() - t_start
                status = {
                    "iteration": it,
                    "loss": f"{float(metrics.loss):.6f}",
                    "splats": f"{count()} / {self.runtime.splats_capacity}",
                    "steps/s": f"{(it - it_start) / max(elapsed, 1e-9):.2f}",
                    "elapsed": f"{elapsed:.0f}s",
                    "devices": self.devices or 1,
                }
                watch_history.append({"it": it, "loss": round(float(metrics.loss), 6),
                                      "splats": count()})
                if self.writer:
                    write_watch_page(watch_dir, status, watch_history)
            self.logger.log_step(it, metrics.loss, count())
            if checkpoint_dir and checkpoint_every and it % checkpoint_every == 0:
                model = self.model  # every rank: a sharded model gathers
                if self.writer:
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    save_checkpoint(os.path.join(checkpoint_dir, "latest.npz"), model,
                                    self.project)
            p = self.project
            if it % max(p.intervalCapture or p.intervalDensify or 100, 1) == 0:
                self.trainer.maybe_grow_dup_buffer(metrics)
            if on_step is not None:
                on_step(it, metrics)

        return auto_train(self.trainer, self.rtx, steps, rng=self.rng, on_step=log_step,
                          capture_devices=self._capture_devices())

    def resume_from_checkpoint(self, checkpoint_dir: str) -> None:
        """Load ``checkpoint_dir/latest.npz`` onto the session's device and
        swap in its project (its iteration count with it); every rank loads
        it, and a splat-sharded trainer keeps its rows."""
        model, project = load_checkpoint(os.path.join(checkpoint_dir, "latest.npz"),
                                         device=self.device)
        self.model = model
        if project is not None:
            self.project = project
            self.trainer.project = project

    # -- project persistence (reference src/ui/UiFrame.cpp:323-450) ---------
    def save_project(self, directory: str) -> None:
        if self.writer:
            os.makedirs(directory, exist_ok=True)
            self.runtime.save(os.path.join(directory, RUNTIME_FILE))
        self.save_settings(os.path.join(directory, SETTINGS_FILE))
        self.save_splats(os.path.join(directory, SPLATS_FILE))

    def load_project(self, directory: str, runtime: Optional[RuntimeConfig] = None) -> None:
        """Load settings (with their OBJ and texture) and splats, and
        runtime.json when present; a given ``runtime`` overrides the
        persisted one."""
        if runtime is None:
            rt_path = os.path.join(directory, RUNTIME_FILE)
            if os.path.exists(rt_path):
                runtime = RuntimeConfig.load(rt_path)
        if runtime is not None:
            self.apply_runtime(runtime)
        self.load_settings(os.path.join(directory, SETTINGS_FILE))
        self.load_splats(os.path.join(directory, SPLATS_FILE))

    def apply_runtime(self, runtime: RuntimeConfig) -> None:
        """Swap in a RuntimeConfig and rebuild the trainer around it; the
        model is re-padded when the capacity changed (a project load
        replaces it right after)."""
        if runtime == self.runtime:
            return
        model = self.model
        if runtime.splats_capacity != model.capacity:
            n = model.count
            if n == 0:
                model = SplatModel.empty(runtime.splats_capacity, model.sh_degree,
                                         model.sh_coeffs, device=self.device)
            else:
                host = model.to_host()
                model = SplatModelHost.from_arrays(
                    host.means[:n], host.shs[:n], host.scales[:n], host.opacities[:n],
                    host.rotations[:n], capacity=runtime.splats_capacity,
                ).to_device(self.device)
        self.runtime = runtime
        self.rtx.roulette_from = runtime.rt_roulette_from
        self.trainer = Trainer(self.project, runtime, model, renderer=self.renderer)

    def save_settings(self, path: str) -> None:
        if self.writer:
            self.project.save(path)

    def load_settings(self, path: str) -> None:
        self.project = Project.load(path)
        self.trainer.project = self.project
        # the loaded rig may change 2 x num_cameras, which the ranks divide
        self.trainer.refresh_devices()
        if self.project.pathModel and os.path.exists(self.project.pathModel):
            self.load_model_obj(self.project.pathModel)
        if self.project.pathTextureDiffuse and os.path.exists(self.project.pathTextureDiffuse):
            self.load_texture(self.project.pathTextureDiffuse)

    def save_splats(self, path: str) -> None:
        host = self.model.to_host()
        if self.writer:
            save_gobj(host, path)

    def load_splats(self, path: str) -> None:
        host = load_gobj(path, capacity=self.runtime.splats_capacity)
        self.model = host.to_device(self.device)

    def save_splats_ply(self, path: str) -> None:
        """Standard 3DGS binary PLY export (io/ply.py), which ecosystem
        viewers and tools read."""
        host = self.model.to_host()
        if self.writer:
            save_ply(host, path)

    def load_splats_ply(self, path: str) -> None:
        """Standard 3DGS binary PLY import onto the session's device, at
        ``runtime.splats_capacity`` slots or more."""
        host = load_ply(path, capacity=self.runtime.splats_capacity)
        self.model = host.to_device(self.device)

    # -- rendering / export ---------------------------------------------------
    def preview_camera(self) -> Camera:
        return Camera.get_preview_camera(self.project)

    def render_splats(self, width=None, height=None, camera=None,
                      splat_scale=None) -> torch.Tensor:
        """(H, W, 3) float32 on the session's device (JAX Trainer.render).
        Differentiable with respect to the model's parameters where they
        require a gradient (they do not by default)."""
        cam = camera or self.preview_camera()
        scale = splat_scale if splat_scale is not None else self.project.previewSplatScale
        w = width or self.runtime.render_resolution_x
        h = height or self.runtime.render_resolution_y
        tan_x, tan_y = cam.tan_fov(w, h, train=False)
        m = self.model
        args = (
            m.means, m.shs, m.scales, m.opacities, m.rotations, m.active_mask(),
            cam.get_view(), cam.get_proj_view(w / h), cam.location, tan_x, tan_y, w, h,
            torch.zeros(3, dtype=torch.float32, device=self.device), m.sh_degree, scale,
        )
        if self.renderer == "oracle":
            return render_oracle(*args, row_chunk=ORACLE_ROW_CHUNK)
        rt = self.runtime
        return render_tiled(*args, tile=rt.tile_px, max_dup=rt.max_dup, aa=rt.mip_antialias)

    def render_rtx(self, width=None, height=None, camera=None, samples=None,
                   show_cameras: bool = False) -> torch.Tensor:
        """The traced scene, (H, W, 3) float32 on the session's device, black
        background.  The preview panel's samples and orbs with
        ``show_cameras``, the export's rtSamples without (reference
        src/ui/UiPanelViewInput.cpp:46, src/ui/tools/UiPanelToolsView.cpp:235)."""
        cam = camera or self.preview_camera()
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        s = samples or (self.project.previewRtSamples if show_cameras
                        else self.project.rtSamples)
        orbs = [c.location for c in Camera.get_cameras(self.project)] if show_cameras else None
        return self.rtx.render(cam, (0.0, 0.0, 0.0), s, w, h, splat_cameras=orbs)

    def export_splats_png(self, path: str, width=None, height=None) -> None:
        """Reference 'Render Splats' export (vertically flipped PNG)."""
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        img = self.render_splats(w, h)
        if self.writer:
            self._save(img, path)

    def export_rtx_png(self, path: str, width=None, height=None, samples=None) -> None:
        """Reference 'Render RTX' export (vertically flipped PNG)."""
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        img = self.render_rtx(w, h, samples=samples)
        if self.writer:
            self._save(img, path)

    def export_viewer_html(self, path: str) -> None:
        """Self-contained interactive WebGL viewer (io/viewer.py), the
        shareable stand-in for the reference's live preview panels."""
        model = self.model
        if self.writer:
            export_viewer_html(model, path)

    @staticmethod
    def _save(img: torch.Tensor, path: str) -> None:
        save_png(np.ascontiguousarray(torch.clamp(img.detach(), 0, 1).cpu().numpy()), path)
