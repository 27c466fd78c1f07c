"""Pinhole cameras and Fibonacci-sphere rig generation (numpy only;
counterpart of gaussian_splatterer_tpu.models.camera).

Re-implements the reference camera model (src/Camera.{h,cpp}) with the same
conventions, since the rasterizer math depends on them:

* ``view = -lookAt(eye, target, +Y)`` — the reference negates the whole view
  matrix (src/Camera.cpp:79-82).  With glm's right-handed lookAt this flips
  the camera-space z sign so that points in front of the camera get
  *positive* view-space depth, which is what the INRIA-style rasterizer
  expects for its near-plane cull (depth > 0.2).
* ``projection = perspective(fovY, aspect, near=0.1, far=100)`` in glm
  RH_NO convention (src/Camera.cpp:84-86).
* Rig rotation quirk: ``rotX`` rotates about the **Y** axis and ``rotY``
  about the **X** axis (src/Camera.cpp:40-41,49-50).

All matrices are returned as (4, 4) float32 numpy arrays in standard
mathematical row convention (``p' = M @ p``).  The reference stores glm
column-major buffers and the CUDA rasterizer multiplies them as
``out.x = m[0]*x + m[4]*y + m[8]*z + m[12]`` (column-major apply), which is
the same mathematical product — only the in-memory layout differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, List

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from gaussian_splatterer_tpu_torch.config import Project

_GOLDEN_RATIO = (1.0 + math.sqrt(5.0)) / 2.0
_ANGLE_STEP = 2.0 * math.pi * _GOLDEN_RATIO


def fibonacci_sphere(count: int, distance: float) -> np.ndarray:
    """Golden-ratio point placement on a sphere (reference src/Camera.cpp:9-27).

    Returns (count, 3) float32.
    """
    i = np.arange(count, dtype=np.float32)
    t = i / np.float32(count if count else 1)
    angle1 = np.arccos(1.0 - 2.0 * t)
    angle2 = np.float32(_ANGLE_STEP) * i
    out = np.stack(
        [
            np.sin(angle1) * np.cos(angle2),
            np.sin(angle1) * np.sin(angle2),
            np.cos(angle1),
        ],
        axis=-1,
    ) * np.float32(distance)
    return out.astype(np.float32)


def _rot_axis_angle(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """3x3 rotation about a unit axis (equivalent to glm::angleAxis as mat)."""
    x, y, z = axis
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    C = 1.0 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        dtype=np.float32,
    )


def _sphere_rotation(rot_x_deg: float, rot_y_deg: float) -> np.ndarray:
    """Rig rotation offset: rotX about +Y THEN rotY about +X, composed as
    R = R_Y(rotX) @ R_X(rotY) (reference src/Camera.cpp:40-41)."""
    ry = _rot_axis_angle(np.array([0.0, 1.0, 0.0]), math.radians(rot_x_deg))
    rx = _rot_axis_angle(np.array([1.0, 0.0, 0.0]), math.radians(rot_y_deg))
    return ry @ rx


@dataclass
class Camera:
    """Pinhole camera: origin, look-at target, vertical FOV in degrees."""

    location: np.ndarray  # (3,) float32
    target: np.ndarray  # (3,) float32
    fov_deg_y: float

    # -- rig generation -------------------------------------------------
    @staticmethod
    def get_cameras_count(project: "Project") -> int:
        return project.sphere1.count + project.sphere2.count

    @staticmethod
    def get_cameras(project: "Project") -> List["Camera"]:
        """Both Fibonacci rigs with per-sphere rotation offsets
        (reference src/Camera.cpp:33-58)."""
        target = np.zeros(3, dtype=np.float32)
        out: List[Camera] = []
        for sph in (project.sphere1, project.sphere2):
            rot = _sphere_rotation(sph.rotX, sph.rotY)
            for loc in fibonacci_sphere(sph.count, sph.distance):
                out.append(Camera((rot @ loc).astype(np.float32), target, sph.fovDeg))
        return out

    @staticmethod
    def get_preview_camera(project: "Project") -> "Camera":
        """Truth-view index or free-orbit camera (reference src/Camera.cpp:60-74)."""
        target = np.zeros(3, dtype=np.float32)
        if project.previewTruth:
            return Camera.get_cameras(project)[project.previewTruthIndex]
        deg_orbit = (
            project.previewTimer * project.previewFreeOrbitSpeed
            if project.previewFreeOrbit
            else 0.0
        )
        # NOTE reference adds the orbit angle in *radians* to a degrees->radians
        # conversion of rotY (src/Camera.cpp:69); replicated as-is.
        rot = _rot_axis_angle(
            np.array([0.0, 1.0, 0.0]), math.radians(project.previewFreeRotY) + deg_orbit
        ) @ _rot_axis_angle(np.array([1.0, 0.0, 0.0]), math.radians(project.previewFreeRotX))
        loc = rot @ np.array([0.0, 0.0, -project.previewFreeDistance], dtype=np.float32)
        return Camera(loc.astype(np.float32), target, project.previewFreeFovDeg)

    # -- matrices ---------------------------------------------------------
    def look_at(self) -> np.ndarray:
        """glm::lookAt (RH): camera looks down -z in camera space."""
        eye = np.asarray(self.location, dtype=np.float64)
        center = np.asarray(self.target, dtype=np.float64)
        up = np.array([0.0, 1.0, 0.0])
        f = center - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4)
        m[0, :3], m[1, :3], m[2, :3] = s, u, -f
        m[0, 3] = -np.dot(s, eye)
        m[1, 3] = -np.dot(u, eye)
        m[2, 3] = np.dot(f, eye)
        return m.astype(np.float32)

    def get_view(self) -> np.ndarray:
        """The reference's negated lookAt (src/Camera.cpp:79-82)."""
        return (-self.look_at()).astype(np.float32)

    def get_projection(self, aspect: float, near: float = 0.1, far: float = 100.0) -> np.ndarray:
        """glm::perspective RH_NO (src/Camera.cpp:84-86)."""
        tan_half = math.tan(math.radians(self.fov_deg_y) * 0.5)
        m = np.zeros((4, 4), dtype=np.float32)
        m[0, 0] = 1.0 / (aspect * tan_half)
        m[1, 1] = 1.0 / tan_half
        m[2, 2] = -(far + near) / (far - near)
        m[2, 3] = -(2.0 * far * near) / (far - near)
        m[3, 2] = -1.0
        return m

    def get_proj_view(self, aspect: float) -> np.ndarray:
        return (self.get_projection(aspect) @ self.get_view()).astype(np.float32)

    def tan_fov(self, width: int, height: int, train: bool = True) -> tuple[float, float]:
        """(tan_fovx, tan_fovy) as the reference passes them to the rasterizer.

        Training path uses the *vertical* FOV for both axes
        (src/Trainer.cu:355-356); the interactive render path scales the
        x-FOV angle by the aspect ratio before taking the tangent — a quirk
        at src/Trainer.cu:196 — replicated for the serve path.
        """
        tan_y = math.tan(math.radians(self.fov_deg_y) * 0.5)
        if train:
            return tan_y, tan_y
        tan_x = math.tan(math.radians(width * self.fov_deg_y / height) * 0.5)
        return tan_x, tan_y
