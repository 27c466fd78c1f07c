"""PyTorch port vs JAX package: projection and binning (CPU, small shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import H, W, camera_args, random_splats, to_jax, to_torch

from gaussian_splatterer_tpu.ops import binning as jbin
from gaussian_splatterer_tpu.ops import transforms as jtr
from gaussian_splatterer_tpu_torch.ops import binning as tbin
from gaussian_splatterer_tpu_torch.ops import transforms as ttr

_FIELDS = ("mx", "my", "ca", "cb", "cc", "cr", "cg", "cb2", "opacity", "depth",
           "radius", "rx", "ry")


def _project_both(n, seed, sh_degree, aa, width=W, height=H, scale_mod=1.0, dist=8.0):
    arrays = random_splats(n, seed, cap=n + 8, sh_coeffs=(sh_degree + 1) ** 2)
    cam = camera_args(width, height, dist=dist)
    j = jtr.project_splat_components(
        *to_jax(arrays), *to_jax(cam[:3]), cam[3], cam[4], width, height,
        sh_degree, scale_mod, aa=aa,
    )
    t = ttr.project_splat_components(
        *to_torch(arrays), *cam, width, height, sh_degree, scale_mod, aa=aa,
    )
    return j, t


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("aa", [False, True])
def test_projection_matches_jax(sh_degree, aa):
    j, t = _project_both(200, 10 + sh_degree, sh_degree, aa, scale_mod=0.8)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert valid.sum() > 50
    for name in _FIELDS:
        np.testing.assert_allclose(
            getattr(t, name).numpy()[valid], np.asarray(getattr(j, name))[valid],
            rtol=1e-5, atol=1e-6, err_msg=name,
        )


def test_projection_culls_like_jax():
    # a close camera puts splats behind the near plane and off screen
    j, t = _project_both(200, 3, 1, False, dist=2.0)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert 0 < valid.sum() < 200
    np.testing.assert_array_equal(t.rx.numpy(), np.asarray(j.rx))


def test_quat_to_rotmat_and_cov3d_match_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (32, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(ttr.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jtr.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(
        ttr.build_cov3d(torch.from_numpy(s), torch.from_numpy(q), 1.5).numpy(),
        np.asarray(jtr.build_cov3d(jnp.asarray(s), jnp.asarray(q), 1.5)),
        rtol=1e-5, atol=1e-7,
    )


def _tile_lists(gather_idx, start, end):
    return [list(np.asarray(gather_idx)[s:e]) for s, e in zip(np.asarray(start), np.asarray(end))]


@pytest.mark.parametrize("tile,max_dup", [(8, 2**12), (16, 2**12), (32, 2**12), (8, 300)])
def test_binning_matches_jax(tile, max_dup):
    """Each tile's depth-ordered splat ids and num_dup, exactly; the last
    case overflows max_dup and drops the deepest duplicates as JAX does."""
    j, t = _project_both(200, 21, 1, False)
    jb = jbin.bin_splats(j, W, H, tile, max_dup, chunk=min(128, max_dup))
    tb = tbin.bin_splats(t, W, H, tile, max_dup)
    assert tb.num_dup == int(jb.num_dup)
    if max_dup == 300:
        assert tb.num_dup > max_dup
        assert tb.gather_idx.shape[0] == max_dup
    assert _tile_lists(tb.gather_idx, tb.tile_start, tb.tile_end) == _tile_lists(
        jb.gather_idx, jb.tile_start, jb.tile_end)
    np.testing.assert_array_equal(tb.depth_order.numpy(), np.asarray(jb.depth_order))


def test_binning_empty_and_tile_aabb():
    j, t = _project_both(0, 0, 1, False)
    tb = tbin.bin_splats(t, W, H, 16, 2**10)
    assert tb.num_dup == 0 and tb.gather_idx.numel() == 0
    assert (tb.tile_start == tb.tile_end).all()
    rng = np.random.default_rng(2)
    mx, my = (rng.uniform(-40, 100, 64).astype(np.float32) for _ in range(2))
    rx, ry = (rng.integers(0, 30, 64).astype(np.float32) for _ in range(2))
    jr = jbin.tile_aabb(*to_jax((mx, my, rx, ry)), 16, 4, 4)
    tr = tbin.tile_aabb(*to_torch((mx, my, rx, ry)), 16, 4, 4)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
