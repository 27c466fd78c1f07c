"""Headless application session, serving half (counterpart of
gaussian_splatterer_tpu.app.session).

Reads and writes the project directory the JAX package writes
(``settings.json``, ``runtime.json``, ``splats.gobj``; reference
src/ui/UiFrame.cpp:452-532) and renders the splat model from the preview
camera ('Render Splats' export, src/ui/tools/UiPanelToolsView.cpp:112-141).
The render is the JAX package's ``Trainer.render``: black background, the
serve path's aspect-scaled x-FOV, and the runtime's tile, duplicate budget
and anti-aliasing switch.  Truth capture, training and the OBJ/texture
scene belong to later parts of the port.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.io.gobj import load_gobj, save_gobj
from gaussian_splatterer_tpu_torch.io.image import save_png
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu_torch.ops.raster_tiled import render_tiled

SETTINGS_FILE = "settings.json"
SPLATS_FILE = "splats.gobj"
RUNTIME_FILE = "runtime.json"
RENDERERS = ("tiled", "oracle")
ORACLE_ROW_CHUNK = 32  # pixel rows per oracle step (the JAX Trainer's default)


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device without CUDA raises (there is
    no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    return dev


class Session:
    """Project + splat model on one device (reference UiFrame, headless)."""

    def __init__(self, project: Optional[Project] = None,
                 runtime: Optional[RuntimeConfig] = None,
                 device="cuda", renderer: str = "tiled"):
        if renderer not in RENDERERS:
            raise ValueError(f"unknown renderer {renderer!r}")
        self.device = resolve_device(device)
        self.project = project or Project.app_default()
        self.runtime = runtime or RuntimeConfig()
        self.renderer = renderer
        rt = self.runtime
        self.model = SplatModel.empty(rt.splats_capacity, rt.sh_degree, rt.sh_coeffs,
                                      device=self.device)

    # -- project persistence (reference src/ui/UiFrame.cpp:323-450) -----
    def save_project(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.save_settings(os.path.join(directory, SETTINGS_FILE))
        self.runtime.save(os.path.join(directory, RUNTIME_FILE))
        self.save_splats(os.path.join(directory, SPLATS_FILE))

    def load_project(self, directory: str, runtime: Optional[RuntimeConfig] = None) -> None:
        """Load settings + splats (+ runtime.json when present); a given
        ``runtime`` overrides the persisted one."""
        if runtime is None:
            rt_path = os.path.join(directory, RUNTIME_FILE)
            if os.path.exists(rt_path):
                runtime = RuntimeConfig.load(rt_path)
        if runtime is not None:
            self.runtime = runtime
        self.load_settings(os.path.join(directory, SETTINGS_FILE))
        self.load_splats(os.path.join(directory, SPLATS_FILE))

    def save_settings(self, path: str) -> None:
        self.project.save(path)

    def load_settings(self, path: str) -> None:
        self.project = Project.load(path)

    def save_splats(self, path: str) -> None:
        save_gobj(self.model.to_host(), path)

    def load_splats(self, path: str) -> None:
        host = load_gobj(path, capacity=self.runtime.splats_capacity)
        self.model = host.to_device(self.device)

    # -- rendering / export ----------------------------------------------
    def preview_camera(self) -> Camera:
        return Camera.get_preview_camera(self.project)

    @torch.no_grad()
    def render_splats(self, width=None, height=None, camera=None,
                      splat_scale=None) -> torch.Tensor:
        """(H, W, 3) float32 on the session's device (JAX Trainer.render)."""
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

    def export_splats_png(self, path: str, width=None, height=None) -> None:
        """Reference 'Render Splats' export (vertically flipped PNG)."""
        w = width or self.project.renderResX
        h = height or self.project.renderResY
        img = self.render_splats(w, h)
        save_png(np.ascontiguousarray(torch.clamp(img, 0, 1).cpu().numpy()), path)
