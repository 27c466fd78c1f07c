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
