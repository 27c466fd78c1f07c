"""The scenes the measuring scripts and chip_smoke.py share, in numpy.

``build_scene`` and ``bench_cameras`` are the headline bench's scene and
frame cameras (the JAX package's bench.py ``build_scene``), bit for bit.
``CROSS_*``, ``checker_texture``, ``mushroom_mesh`` and ``mushroom_texture``
are the built-in scenes of the quality run (its scripts/quality_run.py):
a two-plane cross with a checker texture, and the north star's procedural
mushroom.  Nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
from gaussian_splatterer_tpu_torch.models.camera import Camera


def bench_cameras(n_frames: int) -> list[Camera]:
    """The bench's frame cameras: a row receding from the scene."""
    return [Camera(np.array([0.3 + 0.2 * i, -0.2, -10.0 - 0.5 * i], np.float32),
                   np.zeros(3, np.float32), 60.0) for i in range(n_frames)]


def splat_arrays(n_splats: int, capacity: int, seed: int = 0):
    """The bench scene's splats: ``n_splats`` random splats (SH degree 1)
    padded to ``capacity``, (means, shs, scales, opacities, rotations) as
    numpy float32."""
    rng = np.random.default_rng(seed)
    means = np.zeros((capacity, 3), np.float32)
    means[:n_splats] = rng.uniform(-3, 3, (n_splats, 3))
    shs = np.zeros((capacity, 4, 3), np.float32)
    shs[:n_splats] = rng.normal(0, 0.5, (n_splats, 4, 3))
    scales = np.zeros((capacity, 3), np.float32)
    scales[:n_splats] = rng.uniform(0.01, 0.08, (n_splats, 3))
    opac = np.zeros((capacity,), np.float32)
    opac[:n_splats] = rng.uniform(0.2, 1.0, n_splats)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_splats] = rng.normal(0, 1, (n_splats, 4))
    return means, shs, scales, opac, rot


def build_scene(n_splats: int, capacity: int, width: int, height: int, n_frames: int,
                seed: int = 0):
    """The bench scene: splat_arrays seen by ``n_frames`` bench cameras.
    Returns ((means, shs, scales, opacities, rotations), active, views
    (F, 4, 4), proj_views (F, 4, 4), positions (F, 3), tan_fovx (F,),
    tan_fovy (F,), cameras), every array numpy float32 (active bool)."""
    params = splat_arrays(n_splats, capacity, seed)
    active = np.arange(capacity) < n_splats
    cams = bench_cameras(n_frames)
    views = np.stack([np.asarray(c.get_view(), np.float32) for c in cams])
    pvs = np.stack([np.asarray(c.get_proj_view(1.0), np.float32) for c in cams])
    poss = np.stack([np.asarray(c.location, np.float32) for c in cams])
    tans = np.array([c.tan_fov(width, height, train=True) for c in cams], np.float32)
    return params, active, views, pvs, poss, tans[:, 0].copy(), tans[:, 1].copy(), cams


CROSS_OBJ_VERTS = np.array(
    [
        [-1.2, -1.2, 0], [1.2, -1.2, 0], [1.2, 1.2, 0], [-1.2, 1.2, 0],
        [0, -1.2, -1.2], [0, 1.2, -1.2], [0, 1.2, 1.2], [0, -1.2, 1.2],
    ],
    np.float32,
)
CROSS_TRIS = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
CROSS_UV = np.array(
    [
        [[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]],
        [[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]],
    ],
    np.float32,
)


def checker_texture(n=64, a=(0.9, 0.3, 0.2), b=(0.2, 0.4, 0.9)):
    t = np.zeros((n, n, 4), np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    mask = ((xx // 8) + (yy // 8)) % 2 == 0
    t[mask] = (*a, 1.0)
    t[~mask] = (*b, 1.0)
    return t


def mushroom_mesh(n_theta=48, n_prof=24) -> TriangleMesh:
    """Procedural mushroom (surface of revolution: stem + cap), the
    'mushroom-class OBJ' of the north star.  UV: (theta, profile arclength)."""
    prof = []
    for t in np.linspace(0.0, 1.0, n_prof):
        if t < 0.45:  # stem
            r = 0.35 + 0.05 * np.cos(t * 9)
            y = -1.2 + t / 0.45 * 1.2
        else:  # cap: hemisphere-ish with a lip
            u = (t - 0.45) / 0.55 * np.pi / 2
            r = 1.25 * np.cos(u) + 0.02
            y = 0.85 * np.sin(u)
        prof.append((r, y))
    prof = np.array(prof, np.float32)

    verts, uvs = [], []
    for i, (r, y) in enumerate(prof):
        for j in range(n_theta):
            th = 2 * np.pi * j / n_theta
            verts.append((r * np.cos(th), y, r * np.sin(th)))
            uvs.append((j / n_theta, i / (n_prof - 1)))
    verts = np.array(verts, np.float32)
    uvs = np.array(uvs, np.float32)

    tris, tri_uv = [], []
    for i in range(n_prof - 1):
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a = i * n_theta + j
            b = i * n_theta + j2
            c = (i + 1) * n_theta + j
            d = (i + 1) * n_theta + j2
            for t3 in ((a, b, d), (a, d, c)):
                tris.append(t3)
                tri_uv.append([uvs[k] for k in t3])
    return TriangleMesh(verts, np.array(tris, np.int32), np.array(tri_uv, np.float32))


def mushroom_texture(n=128, spot_alpha=1.0):
    """Red-capped, spotted mushroom texture over the (theta, profile) UV.
    ``spot_alpha < 1`` makes the cap spots semi-transparent (the tracer's
    stochastic alpha, reference RtxDevice.cu:128-143)."""
    t = np.zeros((n, n, 4), np.float32)
    v = np.linspace(0, 1, n)[:, None]  # profile coordinate (rows)
    t[..., 0] = np.where(v > 0.45, 0.85, 0.93)
    t[..., 1] = np.where(v > 0.45, 0.12, 0.87)
    t[..., 2] = np.where(v > 0.45, 0.10, 0.72)
    rng = np.random.default_rng(5)
    spots = np.zeros((n, n), bool)
    for _ in range(25):  # white spots on the cap
        cy = rng.uniform(0.55, 0.95) * n
        cx = rng.uniform(0, 1) * n
        yy, xx = np.mgrid[0:n, 0:n]
        d2 = (yy - cy) ** 2 + (np.minimum(np.abs(xx - cx), n - np.abs(xx - cx))) ** 2
        spot = d2 < (n * 0.035) ** 2
        t[spot, 0:3] = 0.95
        spots |= spot
    t[..., 3] = np.where(spots, spot_alpha, 1.0)
    return t

