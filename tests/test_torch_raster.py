"""PyTorch port vs JAX package: the tiled render path and the oracle.

On the CPU the port's compositor is its plain PyTorch version
(composite_fwd_reference); JAX's render_tiled runs its Pallas kernel in
interpret mode, as tests/test_raster_tiled.py does.  The tolerance is that
file's atol of 1e-5.

The CUDA kernel's tests (marker ``cuda``) need a card and skip here.  The
JAX package is imported inside the tests that use it, so that the file also
imports on a machine with a card and no JAX."""

import shutil

import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    SYNTHETIC_SCENES, H, W, camera_args, cuda_device, random_splats, synthetic_frame, to_jax,
    to_torch,
)

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle as t_oracle
from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

ATOL = 1e-5


def _args(n, seed, bg, width=W, height=H):
    """(JAX arguments, port arguments) of one render call."""
    arrays = random_splats(n, seed)
    cam = camera_args(width, height)
    targs = (*to_torch(arrays), *cam, width, height,
             torch.tensor(bg, dtype=torch.float32), 1, 1.0)
    jargs = (*to_jax(arrays), *to_jax(cam[:3]), cam[3], cam[4], width, height,
             *to_jax([np.asarray(bg, np.float32)]), 1, 1.0)
    return jargs, targs


@pytest.mark.parametrize("tile,n,seed,bg", [
    (8, 60, 4, (0.0, 0.0, 0.0)),
    (16, 200, 3, (0.2, 0.3, 0.4)),
    (32, 80, 1, (1.0, 1.0, 1.0)),
])
def test_render_tiled_matches_jax(tile, n, seed, bg):
    """Port render_tiled (plain compositor) vs JAX render_tiled (interpret)
    and the JAX oracle with the tile-granular cull; the port's oracle vs
    JAX's oracle."""
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle as j_oracle
    from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled as j_tiled

    jargs, targs = _args(n, seed, bg)
    img_t = rt.render_tiled(*targs, tile=tile, max_dup=2**13).numpy()
    img_j = np.asarray(j_tiled(*jargs, tile=tile, chunk=128, max_dup=2**13, interpret=True))
    img_jo = np.asarray(j_oracle(*jargs, row_chunk=16, tile_cull=tile))
    img_to = t_oracle(*targs, row_chunk=16, tile_cull=tile).numpy()
    assert img_t.shape == (H, W, 3)
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)
    np.testing.assert_allclose(img_t, img_jo, atol=ATOL)
    np.testing.assert_allclose(img_to, img_jo, atol=ATOL)


def test_oracle_matches_jax_without_cull_and_with_aa():
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle as j_oracle

    jargs, targs = _args(60, 8, (0.1, 0.2, 0.3))
    for aa in (False, True):
        np.testing.assert_allclose(
            t_oracle(*targs, row_chunk=32, aa=aa).numpy(),
            np.asarray(j_oracle(*jargs, row_chunk=32, aa=aa)), atol=ATOL,
        )


def _targs(n, seed, bg, width=W, height=H):
    cam = camera_args(width, height)
    return (*to_torch(random_splats(n, seed)), *cam, width, height,
            torch.tensor(bg, dtype=torch.float32), 1, 1.0)


def test_empty_model_is_background():
    targs = _targs(0, 0, (0.25, 0.5, 0.75))
    img = rt.render_tiled(*targs, tile=16, max_dup=2**10)
    np.testing.assert_allclose(img.numpy(), np.broadcast_to([0.25, 0.5, 0.75], (H, W, 3)),
                               atol=1e-6)


def test_non_multiple_size_crops_padding_tiles():
    targs = _targs(60, 2, (0.0, 0.0, 0.0), width=40, height=24)
    img = rt.render_tiled(*targs, tile=16, max_dup=2**12)
    assert img.shape == (24, 40, 3)
    np.testing.assert_allclose(img.numpy(), t_oracle(*targs, row_chunk=8, tile_cull=16).numpy(),
                               atol=ATOL)


def _sequential_composite(feat, start, end, tile, tx_tiles):
    """Per-pixel scalar loop of the INRIA rules: the plain version's own
    reference."""
    f = feat.numpy().astype(np.float64)
    out = np.zeros((len(start), tile * tile, 4))
    for t, (s, e) in enumerate(zip(start.tolist(), end.tolist())):
        for p in range(tile * tile):
            px, py = (t % tx_tiles) * tile + p % tile, (t // tx_tiles) * tile + p // tile
            T, c = 1.0, np.zeros(3)
            for j in range(s, e):
                dx, dy = px - f[0, j], py - f[1, j]
                power = -0.5 * (f[2, j] * dx * dx + f[4, j] * dy * dy) - f[3, j] * dx * dy
                alpha = min(0.99, f[8, j] * np.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                c += alpha * T * f[5:8, j]
                T *= 1 - alpha
            out[t, p, :3], out[t, p, 3] = c, T
    return out


def test_plain_composite_early_termination():
    """Stacked opaque duplicates drive T under 1e-4: the pixel stops without
    the duplicate that would cross it, as the scalar loop does."""
    rng = np.random.default_rng(0)
    d = 40
    feat = np.zeros((9, d), np.float32)
    feat[0:2] = rng.uniform(2, 6, (2, d))  # centers inside the first 8x8 tile
    feat[2] = feat[4] = rng.uniform(0.02, 0.3, d)  # conic a, c
    feat[3] = rng.uniform(-0.01, 0.01, d)
    feat[5:8] = rng.uniform(0, 1, (3, d))
    feat[8] = rng.uniform(0.6, 1.0, d)
    start = torch.tensor([0, 25, 40], dtype=torch.int32)
    end = torch.tensor([25, 40, 40], dtype=torch.int32)
    out = rt.composite_fwd(torch.from_numpy(feat), start, end, 8, 3)
    ref = _sequential_composite(torch.from_numpy(feat), start, end, 8, 3)
    assert (ref[0, :, 3] < 1e-3).any()  # some pixels did terminate
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.tile([0, 0, 0, 1], (64, 1)))


def test_composite_rejects_bad_arguments():
    feat = torch.zeros((9, 4))
    ranges = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        rt.composite_fwd(feat, ranges, ranges, 12, 2)
    with pytest.raises(ValueError, match="float32"):
        rt.composite_fwd(feat.double(), ranges, ranges, 16, 2)
    with pytest.raises(ValueError, match="int32"):
        rt.composite_fwd(feat, ranges.long(), ranges, 16, 2)


def test_render_tiled_model_wrapper():
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel

    arrays = random_splats(50, 6, cap=64)
    model = SplatModel.from_numpy(*arrays[:5], count=50, device="cpu")
    cam = Camera(np.array([0.3, -0.2, -8.0], np.float32), np.zeros(3, np.float32), 60.0)
    img = rt.render_tiled_model(model, cam, W, H, torch.zeros(3), train_fov=False, tile=32)
    targs = (*to_torch(arrays), *camera_args(train=False), W, H, torch.zeros(3), 1, 1.0)
    assert torch.equal(img, rt.render_tiled(*targs, tile=32))


def test_tile_image_roundtrip():
    img = torch.arange(32 * 48 * 3, dtype=torch.float32).reshape(32, 48, 3)
    tiles = rt.image_to_tiles(img, 16)
    assert tiles.shape == (6, 256, 3)
    assert torch.equal(rt.tiles_to_image(tiles, 48, 32, 16), img)


def test_lib_path_hashes_the_included_header(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of what nvcc compiles, its local
    headers included: an edit of composite_common.cuh renames the three
    compositors' libraries (so a stale one is never reused) and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    shipped = {name: cuda_build._lib_path(name) for name in cuda_build.KERNELS}
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    assert {name: cuda_build._lib_path(name) for name in cuda_build.KERNELS} == shipped
    header = csrc / "composite_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    moved = {name for name in cuda_build.KERNELS if cuda_build._lib_path(name) != shipped[name]}
    assert moved == {"composite_fwd", "composite_bwd", "composite_train"}
    text = cuda_build.source_text(csrc / "composite_fwd.cu")
    assert text.count("// edited") == 1 and '#include "composite_common.cuh"' not in text
    assert "#pragma once" not in text


# -- CUDA kernel (needs a card) ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_kernel_matches_plain_version(cuda_device, tile):
    arrays = random_splats(200, 3)
    cam = camera_args()
    with torch.no_grad():
        comps = project_splat_components(*to_torch(arrays, cuda_device), *cam, W, H, 1)
        bins = bin_splats(comps, W, H, tile, 2**13)
        feat = rt.gather_features(comps, bins)
        args = (feat, bins.tile_start, bins.tile_end, tile, -(-W // tile))
        before = rt.composite_fwd_launches
        out = rt.composite_fwd(*args)
        torch.cuda.synchronize()
        assert rt.composite_fwd_launches == before + 1
        ref = rt.composite_fwd_reference(*args)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_empty_tiles_and_overflow(cuda_device):
    arrays = random_splats(200, 3)
    cam = camera_args()
    tiled = to_torch(arrays, cuda_device)
    with torch.no_grad():
        img = rt.render_tiled(*tiled, *cam, W, H, torch.zeros(3, device=cuda_device), 1,
                              tile=16, max_dup=64)
        ref = rt.render_tiled(*to_torch(arrays), *cam, W, H, torch.zeros(3), 1,
                              tile=16, max_dup=64)
    assert float((img.cpu() - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("scene", SYNTHETIC_SCENES)
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_kernel_edge_scenes_equal_plain(cuda_device, scene, tile):
    """The footprint skip's edges on the card (splats under 2 px, one wider
    than the tile, opacities at 1/255, conics at a c = b^2): the image
    equals the plain version's bit for bit, and two launches are bit-equal."""
    args = synthetic_frame(scene, tile, cuda_device)
    out, out2 = rt.composite_fwd(*args), rt.composite_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    assert torch.equal(out, rt.composite_fwd_reference(*args))
