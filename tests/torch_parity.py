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


def to_jax(arrays):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrays)


def to_torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


@pytest.fixture()
def cuda_device():
    """Tests of the CUDA kernels: skipped where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)
