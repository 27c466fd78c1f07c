"""Shared inputs for the parity tests of the PyTorch port
(tests/test_torch_*.py): one numpy draw from a seed, handed to both the JAX
package and the port.

Imports no JAX at module level, so that the CUDA tests of a file that uses
it can run on a machine without JAX (see README, "PyTorch/CUDA port")."""

import numpy as np
import pytest
import torch

from gaussian_splatterer_tpu_torch.models.camera import Camera

W = H = 64


def random_splats(n, seed=0, cap=None, sh_coeffs=4):
    """The scene of tests/test_raster_tiled.py's random_splats, as numpy
    arrays (means, shs, scales, opacities, rotations, active)."""
    rng = np.random.default_rng(seed)
    cap = cap or n
    means = np.zeros((cap, 3), np.float32)
    means[:n] = rng.uniform(-2.5, 2.5, (n, 3))
    shs = np.zeros((cap, sh_coeffs, 3), np.float32)
    shs[:n] = rng.normal(0, 0.5, (n, sh_coeffs, 3))
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = rng.uniform(0.05, 0.45, (n, 3))
    opac = np.zeros((cap,), np.float32)
    opac[:n] = rng.uniform(0.2, 1.0, n)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n] = rng.normal(0, 1, (n, 4))
    active = np.arange(cap) < n
    return means, shs, scales, opac, rot, active


def camera_args(width=W, height=H, fov=60.0, dist=8.0, train=True):
    """(view, proj_view, cam_pos, tan_fovx, tan_fovy) as numpy / floats."""
    cam = Camera(np.array([0.3, -0.2, -dist], np.float32), np.zeros(3, np.float32), fov)
    tx, ty = cam.tan_fov(width, height, train=train)
    return cam.get_view(), cam.get_proj_view(width / height), cam.location, tx, ty


def camera_stack(frames, width=W, height=H, fov=60.0):
    """(views, proj_views, cam_posns, tan_fovxs, tan_fovys) of ``frames``
    training cameras around the scene, as stacked numpy arrays."""
    cams = [Camera(np.array([0.3 * (i + 1), -0.2, -(8.0 - 0.5 * i)], np.float32),
                   np.zeros(3, np.float32), fov) for i in range(frames)]
    tans = np.array([c.tan_fov(width, height, train=True) for c in cams], np.float32)
    return (np.stack([c.get_view() for c in cams]),
            np.stack([c.get_proj_view(width / height) for c in cams]),
            np.stack([c.location for c in cams]), tans[:, 0], tans[:, 1])


def random_truths(frames, seed, width=W, height=H):
    """(F, H, W, 3) uniform truth images and (F, 3) uniform backgrounds."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (frames, height, width, 3)).astype(np.float32),
            rng.uniform(0, 1, (frames, 3)).astype(np.float32))


# the edge scenes of synthetic_launch: the footprint skip's edges
SYNTHETIC_SCENES = ("tiny", "whole_tile", "op_edge", "degenerate")
AMIN = np.float32(1.0 / 255.0)  # the kernels' alpha threshold


def conic(sx, sy, theta):
    """Conic (a, b, c) of a Gaussian with axis scales sx, sy rotated by theta."""
    cs, sn = np.cos(theta), np.sin(theta)
    ia, ib = 1.0 / sx**2, 1.0 / sy**2
    return cs * cs * ia + sn * sn * ib, cs * sn * (ia - ib), sn * sn * ia + cs * cs * ib


def synthetic_launch(scene, tile, device="cpu", n=48, seed=5):
    """composite_train's arguments for two frames of 2 x 2 tiles of
    ``tile`` px, ``n`` depth-ordered duplicates a tile, made with numpy from
    ``seed``: ``tiny`` splats under 2 px across; ``whole_tile`` a first
    splat far wider than the tile; ``op_edge`` opacities at and one float
    either side of 1/255, centred on pixels; ``degenerate`` conics with a c
    - b^2 at 0 or one float either side (in float32), beside ordinary ones."""
    rng = np.random.default_rng(seed)
    blocks, tx, tiles_frame = 8, 2, 4
    feat = np.zeros((9, blocks * n), np.float32)
    for blk in range(blocks):
        t = blk % tiles_frame
        ox, oy = (t % tx) * tile, (t // tx) * tile
        sx, sy = rng.uniform(0.8, tile / 2, n), rng.uniform(0.8, tile / 2, n)
        if scene == "tiny":
            sx, sy = rng.uniform(0.15, 0.6, n), rng.uniform(0.15, 0.6, n)
        a, b, c = conic(sx, sy, rng.uniform(0, np.pi, n))
        mx, my = ox + rng.uniform(-3, tile + 3, n), oy + rng.uniform(-3, tile + 3, n)
        op = rng.uniform(0.1, 1.0, n)
        if scene == "whole_tile":
            mx[0], my[0], a[0], b[0], c[0], op[0] = ox + tile / 2, oy + tile / 2, 1e-4, 0, 1e-4, 0.5
        elif scene == "op_edge":
            k = n // 2
            mx[:k], my[:k] = ox + rng.integers(0, tile, k), oy + rng.integers(0, tile, k)
            op[:k] = rng.choice([np.nextafter(AMIN, 0), AMIN, np.nextafter(AMIN, 1)], k)
        elif scene == "degenerate":
            k = n // 2
            b32 = np.sqrt(a[:k].astype(np.float32) * c[:k].astype(np.float32))
            b[:k] = np.nextafter(b32, rng.choice([-1.0, 1.0], k) * np.inf)
            b[:k:3] = b32[::3]
        cols = slice(blk * n, (blk + 1) * n)
        feat[:, cols] = np.stack([mx, my, a, b, c, *rng.uniform(0, 1, (3, n)), op])
    ts = torch.arange(blocks, dtype=torch.int32) * n
    truth = torch.from_numpy(rng.uniform(0, 1, (blocks, tile * tile, 3)).astype(np.float32))
    bg = torch.from_numpy(rng.uniform(0, 1, (2, 3)).astype(np.float32))
    return tuple(x.to(device) for x in (torch.from_numpy(feat), ts, ts + n, truth, bg)) + (
        tile, tx, tiles_frame)


def synthetic_frame(scene, tile, device="cpu"):
    """composite_fwd's arguments (feat, tile_start, tile_end, tile, tx_tiles)
    of synthetic_launch's two frames laid out as one frame of 2 x 4 tiles:
    the second frame's four tiles sit two tile rows lower, their duplicates
    moved down with them."""
    feat, ts, te, _, _, tile, tx, tiles_frame = synthetic_launch(scene, tile)
    feat[1, int(ts[tiles_frame]):] += 2 * tile
    return feat.to(device), ts.to(device), te.to(device), tile, tx


def to_jax(arrays):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrays)


def jax_model(arrays, count, sh_degree=1):
    """A JAX SplatModel of numpy (means, shs, scales, opacities, rotations)."""
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.models.splats import SplatModel

    means, shs, scales, opac, rot = to_jax(arrays[:5])
    return SplatModel(means=means, shs=shs, scales=scales, opacities=opac, rotations=rot,
                      count=jnp.int32(count), sh_degree=sh_degree)


def model_arrays(model):
    """((means, shs, scales, opacities, rotations) as numpy, count) of a JAX
    or a port SplatModel, e.g. after a train step, for comparison."""
    fields = (model.means, model.shs, model.scales, model.opacities, model.rotations)
    return tuple(np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
                 for x in fields), int(model.count)


def to_torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


@pytest.fixture()
def cuda_device():
    """Tests of the CUDA kernels: skipped where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)
