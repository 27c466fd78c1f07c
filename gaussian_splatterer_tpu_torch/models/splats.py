"""Gaussian-splat model state (counterpart of gaussian_splatterer_tpu.models.splats).

The reference keeps splats as SoA float arrays with an explicit
``capacity``/``count`` pair (src/ModelSplatsHost.h:11-21).  The port keeps
the same capacity-padded layout: ``SplatModel`` is an ``nn.Module`` whose
parameters are the padded (capacity, ...) tensors, and ``count`` says how
many leading rows are live.  Rows past ``count`` are masked by every
renderer.

Quaternions are scalar-first ``[w, x, y, z]``, as in the JAX package.
The field initializers (reference src/ui/UiFrame.cpp:137-264) build a
``SplatModelHost`` in numpy, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

_FIELDS = ("means", "shs", "scales", "opacities", "rotations")


class SplatModel(nn.Module):
    """Fixed-capacity padded splat set on one device.

    Shapes (C = capacity, K = SH coefficient count):
      means      (C, 3)    world-space centers
      shs        (C, K, 3) spherical-harmonics color coefficients
      scales     (C, 3)    per-axis standard deviations
      opacities  (C,)      in [0, 1]
      rotations  (C, 4)    quaternions, scalar-first [w, x, y, z]
      count      int       number of live splats (<= C)

    The parameters do not require gradients: the render path is forward
    only.
    """

    def __init__(self, means, shs, scales, opacities, rotations, count: int,
                 sh_degree: int = 1):
        super().__init__()
        for name, value in zip(_FIELDS, (means, shs, scales, opacities, rotations)):
            setattr(self, name, nn.Parameter(value.to(torch.float32), requires_grad=False))
        self.count = int(count)
        self.sh_degree = int(sh_degree)
        if not 0 <= self.count <= self.capacity:
            raise ValueError(f"count {self.count} outside [0, {self.capacity}]")

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_coeffs(self) -> int:
        return self.shs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def active_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.count

    @classmethod
    def empty(cls, capacity: int, sh_degree: int = 1, sh_coeffs: int = 4, *,
              device) -> "SplatModel":
        rot = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
        rot[:, 0] = 1.0
        z = dict(dtype=torch.float32, device=device)
        return cls(
            torch.zeros((capacity, 3), **z), torch.zeros((capacity, sh_coeffs, 3), **z),
            torch.zeros((capacity, 3), **z), torch.zeros((capacity,), **z), rot,
            0, sh_degree,
        )

    @classmethod
    def from_numpy(cls, means, shs, scales, opacities, rotations, count: int,
                   device, sh_degree: Optional[int] = None) -> "SplatModel":
        """Carry a JAX model over: its capacity-padded arrays, as numpy,
        become this model's parameters on ``device``, copied, so that
        training in place leaves them as they were.  The SH degree is
        inferred from the coefficient count when not given."""
        arrays = [np.ascontiguousarray(a, np.float32) for a in
                  (means, shs, scales, opacities, rotations)]
        if sh_degree is None:
            sh_degree = _sh_degree_of(arrays[1].shape[1])
        tensors = [torch.tensor(a, device=device) for a in arrays]
        return cls(*tensors, count=count, sh_degree=sh_degree)

    def to_host(self) -> "SplatModelHost":
        return SplatModelHost.from_device(self)


def _sh_degree_of(k: int) -> int:
    r = math.isqrt(k)
    return r - 1 if r * r == k else (k - 1) // 3


class SplatModelHost:
    """Host-side (numpy) mutable splat set, mirror of the device model
    (reference ModelSplatsHost, src/ModelSplatsHost.{h,cpp})."""

    def __init__(self, capacity: int, sh_degree: int = 1, sh_coeffs: int = 4):
        self.capacity = int(capacity)
        self.sh_degree = int(sh_degree)
        self.sh_coeffs = int(sh_coeffs)
        self.count = 0
        self.means = np.zeros((capacity, 3), np.float32)
        self.shs = np.zeros((capacity, sh_coeffs, 3), np.float32)
        self.scales = np.zeros((capacity, 3), np.float32)
        self.opacities = np.zeros((capacity,), np.float32)
        self.rotations = np.zeros((capacity, 4), np.float32)
        self.rotations[:, 0] = 1.0

    @classmethod
    def from_arrays(cls, means, shs, scales, opacities, rotations,
                    capacity: Optional[int] = None) -> "SplatModelHost":
        """Build from flat arrays.  Capacity grows x10 from 1e6 like the
        reference (src/ModelSplatsHost.cpp:31-37) when not given, and a
        too-small explicit capacity grows to fit; the SH degree is inferred
        from the coefficient count."""
        means = np.asarray(means, np.float32).reshape(-1, 3)
        n = means.shape[0]
        if n == 0:
            return cls(capacity or 1, sh_degree=1, sh_coeffs=4)
        shs = np.asarray(shs, np.float32).reshape(n, -1, 3)
        k = shs.shape[1]
        if capacity is None:
            capacity = 1_000_000
            while capacity < n:
                capacity *= 10
        m = cls(max(capacity, n), sh_degree=_sh_degree_of(k), sh_coeffs=k)
        m.count = n
        m.means[:n] = means
        m.shs[:n] = shs
        m.scales[:n] = np.asarray(scales, np.float32).reshape(n, 3)
        m.opacities[:n] = np.asarray(opacities, np.float32).reshape(n)
        m.rotations[:n] = np.asarray(rotations, np.float32).reshape(n, 4)
        return m

    @classmethod
    def from_device(cls, model: SplatModel) -> "SplatModelHost":
        """Copy ``model``, on any device, to the host."""
        m = cls(model.capacity, model.sh_degree, model.sh_coeffs)
        m.count = int(model.count)
        for name in _FIELDS:
            getattr(m, name)[:] = getattr(model, name).detach().cpu().numpy()
        return m

    def to_device(self, device) -> SplatModel:
        return SplatModel.from_numpy(
            self.means, self.shs, self.scales, self.opacities, self.rotations,
            self.count, device, self.sh_degree,
        )

    def push_back(self, mean, shs, scale, opacity, rotation) -> None:
        if self.count >= self.capacity:
            raise RuntimeError("Model ran out of capacity!")
        i = self.count
        self.means[i] = np.asarray(mean, np.float32)
        self.shs[i] = np.asarray(shs, np.float32).reshape(self.sh_coeffs, 3)
        self.scales[i] = np.asarray(scale, np.float32)
        self.opacities[i] = np.float32(opacity)
        self.rotations[i] = np.asarray(rotation, np.float32)
        self.count += 1

    def copy(self, index_to: int, index_from: int) -> None:
        if not (0 <= index_to < self.count and 0 <= index_from < self.count):
            raise RuntimeError("Can't copy splat in model, incorrect bounds!")
        for name in _FIELDS:
            arr = getattr(self, name)
            arr[index_to] = arr[index_from]


def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def quat_from_axis_angle(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Unit quaternion [w, x, y, z] from a (possibly unnormalized) axis.  The
    reference passes glm::angleAxis an unnormalized cross product
    (src/ui/UiFrame.cpp:254-257); like the JAX package, this normalizes."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return quat_identity()
    axis = axis / n
    h = angle_rad * 0.5
    return np.array([math.cos(h), *(math.sin(h) * axis)], dtype=np.float32)


def init_field_grid(capacity: int = 1_000_000, sh_degree: int = 1,
                    sh_coeffs: int = 4) -> SplatModelHost:
    """17^3 grid of splats over [-4, 4]^3, spacing 0.5, scale 0.05
    (reference src/ui/UiFrame.cpp:137-160); a smaller capacity keeps the
    grid's first points."""
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    coords = (np.arange(17, dtype=np.float32) * 0.5 - 4.0).astype(np.float32)
    xs, ys, zs = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1)
    n = min(pts.shape[0], capacity)
    m.means[:n] = pts[:n]
    m.scales[:n] = 0.05
    m.opacities[:n] = 1.0
    m.rotations[:n] = quat_identity()
    m.count = n
    return m


def init_field_mono(capacity: int = 1_000_000, sh_degree: int = 1,
                    sh_coeffs: int = 4) -> SplatModelHost:
    """One 0.3-scale splat at the origin (reference src/ui/UiFrame.cpp:162-176)."""
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    m.scales[0] = 0.3
    m.opacities[0] = 1.0
    m.rotations[0] = quat_identity()
    m.count = 1
    return m


def init_field_model(vertices: np.ndarray, triangles: np.ndarray, capacity: int = 1_000_000,
                     sh_degree: int = 1, sh_coeffs: int = 4) -> SplatModelHost:
    """One thin splat per mesh triangle, oriented to the face normal
    (reference src/ui/UiFrame.cpp:178-264).  vertices (V, 3), triangles
    (T, 3) int indices."""
    m = SplatModelHost(capacity, sh_degree, sh_coeffs)
    v0, v1, v2 = (vertices[triangles[:, k]] for k in range(3))
    n = triangles.shape[0]
    m.means[:n] = (v0 + v1 + v2) / 3.0
    e1, e2 = v1 - v0, v2 - v0
    scales = np.stack([np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1),
                       np.full(n, 0.005, np.float32)], axis=-1)
    m.scales[:n] = scales * 0.2
    m.opacities[:n] = 1.0
    up = np.array([0.0, 0.0, 1.0])
    normals = np.cross(e1, e2)
    normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    for i in range(n):
        angle = math.acos(float(np.clip(np.dot(up, normals[i]), -1.0, 1.0)))
        m.rotations[i] = quat_from_axis_angle(np.cross(up, normals[i]), angle)
    m.count = n
    return m
