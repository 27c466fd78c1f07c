"""Project / runtime configuration (counterpart of gaussian_splatterer_tpu.config).

``Project`` mirrors the reference's settings struct (reference
src/Project.h:6-75) field for field, so ``settings.json`` round-trips
between the reference, the JAX package and this port.  ``RuntimeConfig``
holds the framework knobs that persist beside it in ``runtime.json``.  The
two files use exactly the JAX package's keys; unknown keys are ignored on
load, and every field the JAX package writes is accepted here, including
the TPU-tuning knobs that no code of the port reads yet.

Standard library only.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _fill(cls, d: dict[str, Any]):
    out = cls()
    for f in dataclasses.fields(cls):
        if f.name in d:
            setattr(out, f.name, d[f.name])
    return out


@dataclass
class CameraSphere:
    """One Fibonacci-sphere camera rig (reference src/Project.h:14-22)."""

    count: int = 16
    distance: float = 10.0
    fovDeg: float = 60.0
    rotX: float = 0.0  # degrees; rotates about the +Y axis (reference quirk, src/Camera.cpp:40)
    rotY: float = 0.0  # degrees; rotates about the +X axis (reference quirk, src/Camera.cpp:41)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CameraSphere":
        return _fill(cls, d)


@dataclass
class Project:
    """Whole-run settings; JSON-compatible with the reference (src/Project.h:64-73)."""

    perspective: str = ""  # opaque UI layout string in the reference; carried for parity

    pathModel: str = ""
    pathTextureDiffuse: str = ""

    sphere1: CameraSphere = field(default_factory=CameraSphere)
    sphere2: CameraSphere = field(default_factory=CameraSphere)

    rtSamples: int = 100

    # Per-feature SGD learning rates (reference src/Project.h:26-30)
    lrLocation: float = 0.00005
    lrSh: float = 0.0001
    lrScale: float = 0.00002
    lrOpacity: float = 0.0001
    lrRotation: float = 0.000025

    paramScaleMax: float = 0.3

    # Densify heuristics (reference src/Project.h:34-41)
    paramCullOpacity: float = 0.005
    paramCullSize: float = 0.004
    paramDensifyVariance: float = 2.0
    paramSplitSize: float = 0.04
    paramSplitDistance: float = 1.5
    paramSplitScale: float = 0.8
    paramCloneDistance: float = 1.6

    iterations: int = 0
    intervalCapture: int = 50
    intervalDensify: int = 200

    # Preview / export state (the headless renders use previewSplatScale
    # and the free-orbit fields)
    previewTimer: float = 0.0
    previewRtSamples: int = 50
    previewSplatScale: float = 1.0
    previewTruth: bool = False
    previewTruthIndex: int = 0
    previewFreeOrbit: bool = True
    previewFreeOrbitSpeed: float = 0.5
    previewFreeDistance: float = 10.0
    previewFreeFovDeg: float = 60.0
    previewFreeRotX: float = 25.0
    previewFreeRotY: float = 0.0

    renderResX: int = 2048
    renderResY: int = 2048

    @classmethod
    def app_default(cls) -> "Project":
        """The state the reference app boots with (src/ui/UiFrame.cpp:130-135):
        defaults plus an empty second sphere at 30 degrees FOV."""
        p = cls()
        p.sphere2.count = 0
        p.sphere2.fovDeg = 30.0
        return p

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Project":
        p = _fill(cls, {k: v for k, v in d.items() if k not in ("sphere1", "sphere2")})
        for name in ("sphere1", "sphere2"):
            if name in d:
                setattr(p, name, CameraSphere.from_json(d[name]))
        return p

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    @classmethod
    def load(cls, path: str) -> "Project":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    @property
    def num_cameras(self) -> int:
        """Total truth cameras across both rigs (reference src/Camera.cpp:29-31)."""
        return self.sphere1.count + self.sphere2.count


@dataclass
class RuntimeConfig:
    """Framework-level knobs; compile-time constants in the reference (src/Config.h).

    The render path of this port reads ``render_resolution_x/y``,
    ``splats_capacity``, ``sh_degree``/``sh_coeffs``, ``tile_px`` (8, 16 or
    32), ``max_dup`` and ``mip_antialias``; training also ``frame_group``,
    ``train_chunk`` (the rounding of a grown ``max_dup``),
    ``opacity_reset_interval``, ``densify_variance_decay``,
    ``lr_location_decay``, ``lr_resolution_ref`` and ``train_devices``
    (more than one is not ported yet).  ``train_mm_bf16``,
    ``train_work_cap``, ``train_fast_exp`` and ``train_mm_power`` tune the
    TPU kernel and are accepted without effect: the CUDA kernel computes
    in float32 and has no work list.  The other fields belong to parts of
    the JAX package not ported yet; they are kept so that ``runtime.json``
    files round-trip unchanged.
    """

    render_resolution_x: int = 1024  # truth/training resolution (src/Config.h:13-14)
    render_resolution_y: int = 1024
    splats_capacity: int = 1_000_000  # SPLATS_LIMIT (src/Config.h:17)
    sh_degree: int = 1  # SPLATS_SH_DEGREE (src/Config.h:19)
    sh_coeffs: int = 4  # SPLATS_SH_COEF (src/Config.h:20)
    auto_train_budget: float = 100.0  # max steps/s in auto-train (src/Config.h:10)

    tile_px: int = 32  # rasterizer tile edge in pixels
    # Duplicate (splat, tile) pairs kept per frame; the deepest pairs past
    # it are dropped and counted (the reference's overflow contract).
    max_dup: int = 2**21
    rt_bounces: int = 50  # path-tracer bounce cap (reference src/rtx/RtxDevice.cu:23)
    rt_roulette_from: int = 0
    frame_group: int = 8
    train_mm_bf16: bool = True
    train_chunk: int = 256
    train_work_cap: int | None = None
    auto_shrink_buffers: bool = True
    # Mip-splatting anti-aliasing (Yu et al. 2023): scale opacity by
    # sqrt(det(cov2d) / det(cov2d + dilation)); off by default.
    mip_antialias: bool = False
    train_fast_exp: bool = False
    train_mm_power: bool = False
    opacity_reset_interval: int = 0
    densify_variance_decay: float = 1.0
    lr_location_decay: float = 1.0
    capture_data_parallel: bool = False
    train_devices: int = 0
    train_mesh: str = "dp"
    lr_resolution_ref: int = 0

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh)

    @classmethod
    def load(cls, path: str) -> "RuntimeConfig":
        with open(path) as fh:
            return _fill(cls, json.load(fh))
