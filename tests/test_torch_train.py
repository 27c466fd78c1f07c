"""PyTorch port vs JAX package: the training slice (the frame-batched
projection and binning of the fused step's front end, fused train core,
densify, train step, Trainer and auto_train).

On the CPU the port's fused compositor is its plain PyTorch version
(composite_train_reference); the JAX side runs its Pallas kernel in
interpret mode with float32 cumsums (mm_bf16=False; the Trainer's
train_mm_bf16 default rounds them to bf16).  Tolerances: loss rtol 1e-5,
residuals atol 1e-5, gradients atol 5e-5 of the largest magnitude of
their row or parameter (tests/test_raster_tiled.py's tolerance).  The two
sides differ only in summation order: sequential transmittance products
and pixel sums here, triangular-matmul cumsums there.  The frame-batched
projection is held to JAX's vmapped one at the single-camera test's rtol
1e-5, atol 1e-6, with ``valid`` equal; to the port's own per-frame calls
exactly, given the same float32 tangents; the batched binning to the
frame-by-frame one (bin_frames) field for field, exactly.

The CUDA kernel's tests (marker ``cuda``) need a card and skip here."""

import math
import random
import warnings

import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    AMIN, SYNTHETIC_SCENES, W, H, camera_stack, conic, cuda_device, jax_model, model_arrays,
    random_splats, random_truths, synthetic_frame, synthetic_launch, to_jax, to_torch,
)

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.binning import bin_frames, bin_splats, bin_splats_batch
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu_torch.ops.transforms import (
    SH_C0, SplatComponents, project_splat_components,
)
from gaussian_splatterer_tpu_torch.train import (
    CameraBatch, DensifyParams, LearningRates, Trainer, auto_train, densify,
    make_train_step,
)

LOSS_RTOL, RES_ATOL, GRAD_ATOL = 1e-5, 1e-5, 5e-5
GRAD_NAMES = ("means", "shs", "scales", "opacities", "rotations")


def assert_rel_close(a, b, err_msg=""):
    """|a - b| <= GRAD_ATOL * max(1e-3, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1e-3, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_ATOL, err_msg=err_msg)


def jax_res(res8):
    """JAX channel-major (F, T, 8, P) residual tiles -> (F, T, P, 4)."""
    return np.asarray(res8)[..., 0:4, :].swapaxes(-1, -2)


def project_stack(arrays, cams, width=W, height=H, sh_degree=1, scale_mod=1.0, aa=False,
                  tangent=float):
    """Port projection of each frame in its own call, fields stacked to (F,
    N); ``tangent`` makes the call's tangents from the numpy float32 ones
    (``float``: a Python double, as the serve path passes them)."""
    views, pvs, poss, txs, tys = cams
    frames = [project_splat_components(*to_torch(arrays), views[i], pvs[i], poss[i],
                                       tangent(txs[i]), tangent(tys[i]), width, height,
                                       sh_degree, scale_mod, aa=aa)
              for i in range(len(views))]
    return SplatComponents(*(torch.stack(xs) for xs in zip(*frames)))


def project_batch(arrays, cams, width=W, height=H, sh_degree=1, scale_mod=1.0, aa=False):
    """The batched twin of project_stack: the F frames in one frame-batched
    call, every field (F, N)."""
    return project_splat_components(*to_torch(arrays), *to_torch(cams), width, height,
                                    sh_degree, scale_mod, aa=aa)


def jax_project_batch(arrays, cams, sh_degree, scale_mod=1.0, aa=False):
    """``jax.vmap(project_splat_components)`` over the F cameras."""
    import jax
    from gaussian_splatterer_tpu.ops.transforms import project_splat_components as j_project

    args = to_jax(arrays)
    return jax.vmap(lambda v, pv, pos, tx, ty: j_project(
        *args, v, pv, pos, tx, ty, W, H, sh_degree, scale_mod, aa=aa))(*to_jax(cams))


def jax_tiles(imgs, tile):
    import jax
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm

    return jax.vmap(lambda im: image_to_tiles_cm(im, tile))(jnp.asarray(imgs))


# -- the frame-batched front end: projection and binning ---------------------

PROJ_FIELDS = ("mx", "my", "ca", "cb", "cc", "cr", "cg", "cb2", "opacity", "depth", "radius",
               "rx", "ry")


def _projection_case(sh_degree, frames=3, n=200):
    arrays = random_splats(n, 10 + sh_degree, cap=n + 8, sh_coeffs=(sh_degree + 1) ** 2)
    return arrays, camera_stack(frames)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
@pytest.mark.parametrize("aa", [False, True])
def test_batched_projection_matches_jax(sh_degree, aa):
    """F = 3 cameras in one call against JAX's vmapped projection: every
    field (F, N), ``valid`` equal, the rest at test_projection_matches_jax's
    rtol 1e-5, atol 1e-6 on the valid splats."""
    arrays, cams = _projection_case(sh_degree)
    t = project_batch(arrays, cams, sh_degree=sh_degree, scale_mod=0.8, aa=aa)
    j = jax_project_batch(arrays, cams, sh_degree, 0.8, aa)
    valid = np.asarray(j.valid)
    assert valid.shape == (3, 208)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert valid.sum(axis=1).min() > 50
    for name in PROJ_FIELDS:
        assert getattr(t, name).shape == (3, 208), name
        np.testing.assert_allclose(getattr(t, name).numpy()[valid],
                                   np.asarray(getattr(j, name))[valid],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("aa", [False, True])
def test_batched_projection_matches_per_frame(sh_degree, aa):
    """The batched call against F unbatched calls.  Given the frame's
    float32 tangents as tensors, each call does the same float32 operations
    on each element: every field exactly equal.  Given them as Python
    floats (the serve path's form), the focal lengths and clamp limits are
    computed in double and rounded once, so they may sit one float32 ulp
    from the batched call's float32 products; the conic inverts a 2 x 2
    matrix built from them: within 16 eps of each field's largest value,
    ``valid`` equal.  Means given once (N, 3) or once a frame (F, N, 3)
    project alike."""
    arrays, cams = _projection_case(sh_degree)
    batched = project_batch(arrays, cams, sh_degree=sh_degree, aa=aa)
    same = project_stack(arrays, cams, sh_degree=sh_degree, aa=aa, tangent=torch.tensor)
    double = project_stack(arrays, cams, sh_degree=sh_degree, aa=aa)
    means_b = torch.from_numpy(arrays[0]).expand(3, -1, -1)
    per_frame_means = project_splat_components(means_b, *to_torch(arrays[1:]), *to_torch(cams),
                                               W, H, sh_degree, aa=aa)
    eps = float(np.finfo(np.float32).eps)
    assert torch.equal(double.valid, batched.valid)
    for name in SplatComponents._fields:
        b = getattr(batched, name)
        assert torch.equal(getattr(same, name), b), name
        assert torch.equal(getattr(per_frame_means, name), b), name
        if name != "valid":
            scale = float(b[batched.valid].abs().max())
            np.testing.assert_allclose(getattr(double, name).numpy(), b.numpy(), rtol=0,
                                       atol=16 * eps * scale, err_msg=name)


@pytest.mark.parametrize("aa", [False, True])
def test_batched_projection_grads_match_jax(aa):
    """The VJP of project_frames's rows (9, F*N) against jax.vjp of the JAX
    package's build_rows (raster_tiled.py, render_train_grads_batch) for
    one seeded cotangent: per-frame location gradients (F, N, 3) and the
    four other parameters' (summed over the frames), at the gradient
    tolerance (assert_rel_close)."""
    import jax
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.transforms import project_splat_components as j_project

    f, n, sh_degree = 3, 60, 1
    arrays = random_splats(n, 27, cap=n + 4)
    cams = camera_stack(f)
    cot = np.random.default_rng(4).normal(size=(9, f, n + 4)).astype(np.float32)

    params = to_torch(arrays)
    leaves = [params[0].expand(f, -1, -1).clone()] + [x.clone() for x in params[1:5]]
    for x in leaves:
        x.requires_grad_(True)
    comps, rows9 = rt.project_frames(*leaves, params[5], *cams, W, H, sh_degree, aa)
    assert rows9.shape == (9, f * (n + 4)) and comps.mx.shape == (f, n + 4)
    g_t = torch.autograd.grad(rows9, leaves, torch.from_numpy(cot.reshape(9, -1)))

    active = jnp.asarray(arrays[5])
    jcams = to_jax(cams)

    def build_rows(means_b, shs, scales, opac, rot):
        def one(mb, v, pv, pos, tx, ty):
            pr = j_project(mb, shs, scales, opac, rot, active, v, pv, pos, tx, ty, W, H,
                           sh_degree, 1.0, aa=aa)
            return jnp.stack([pr.mx, pr.my, pr.ca, pr.cb, pr.cc, pr.cr, pr.cg, pr.cb2,
                              pr.opacity])

        return jax.vmap(one)(means_b, *jcams)  # (F, 9, N)

    j_args = to_jax(arrays[:5])
    rows_j, pull = jax.vjp(build_rows, jnp.broadcast_to(j_args[0], (f, n + 4, 3)), *j_args[1:])
    g_j = pull(jnp.asarray(np.moveaxis(cot, 0, 1)))
    np.testing.assert_allclose(rows9.detach().numpy(),
                               np.moveaxis(np.asarray(rows_j), 1, 0).reshape(9, -1),
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("means_b",) + GRAD_NAMES[1:], g_t, g_j):
        assert a.shape == b.shape, name
        assert_rel_close(a.numpy(), b, f"gradient {name}")
    assert float(g_t[0].abs().max()) > 0


def _binning_group(frames, empty, n=120, seed=21):
    """(F, N) projected components of ``frames`` cameras; with ``empty`` the
    middle frame has no valid splat."""
    comps = project_batch(random_splats(n, seed), camera_stack(frames))
    if empty:
        valid = comps.valid.clone()
        valid[frames // 2] = False
        comps = comps._replace(valid=valid)
    return comps


def assert_frame_bins_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y.to(x.device)), name
        else:
            assert x == y, name


@pytest.mark.parametrize("frames,empty", [(1, False), (3, False), (3, True)])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("max_dup", [2**12, 100])
def test_bin_splats_batch_equals_bin_frames(frames, empty, tile, max_dup):
    """One batched pass against the frame-by-frame bin_frames: every
    FrameBins field exactly equal; at max_dup 100 every frame overflows
    and drops its deepest duplicates; with ``empty`` the middle frame has
    no duplicate."""
    comps = _binning_group(frames, empty)
    split = [SplatComponents(*(x[i] for x in comps)) for i in range(frames)]
    fb = bin_splats_batch(comps, W, H, tile, max_dup)
    assert_frame_bins_equal(fb, bin_frames(split, W, H, tile, max_dup))
    assert (fb.num_dup > max_dup) == (max_dup == 100)
    assert (fb.frame_dups[frames // 2] == 0) == empty
    assert fb.tile_start.shape == (frames * (-(-W // tile)) * (-(-H // tile)),)


# -- the fused train core ------------------------------------------------------


@pytest.mark.parametrize("tile", [16, 32])
def test_train_grads_rows_match_jax(tile):
    """Same pre-projected rows into both: loss, residual tiles, d_rows."""
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_rows as j_rows
    from gaussian_splatterer_tpu.ops.transforms import SplatComponents as JComps

    comps = project_stack(random_splats(40, 21), camera_stack(2))
    truths, bgs = random_truths(2, 3)
    loss_t, d_t, res_t, nd_t, nw_t = rt.render_train_grads_rows(
        comps, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile), torch.from_numpy(bgs),
        tile=tile, max_dup=2**12)
    loss_j, d_j, res_j, nd_j, _ = j_rows(
        JComps(*to_jax([x.numpy() for x in comps])), W, H, jax_tiles(truths, tile),
        to_jax([bgs])[0], tile=tile, max_dup=2**12, interpret=True, mm_bf16=False)
    assert nd_t == int(nd_j) > 0 and nw_t == -1
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_t.numpy(), jax_res(res_j), atol=RES_ATOL)
    d_j = np.asarray(d_j)
    assert d_t.shape == d_j.shape == (2, 9, 40)
    for r in range(9):
        assert_rel_close(d_t[:, r].numpy(), d_j[:, r], f"d_rows row {r}")


def _batch_inputs(frames, tile, seed=31, n=40, cap=None):
    arrays = random_splats(n, seed, cap=cap)
    cams = camera_stack(frames)
    truths, bgs = random_truths(frames, 5)
    return arrays, cams, truths, bgs


def _jax_batch(arrays, cams, truths, bgs, tile, max_dup):
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_batch as j_batch

    return j_batch(*to_jax(arrays), *to_jax(cams), W, H, jax_tiles(truths, tile),
                   to_jax([bgs])[0], 1, tile=tile, max_dup=max_dup, interpret=True,
                   mm_bf16=False)


@pytest.mark.parametrize("max_dup", [2**12, 96])
def test_train_grads_batch_match_jax(max_dup):
    """F = 3: loss, the five gradients, var_loc, residuals and num_dup; at
    max_dup 96 the frames overflow and drop their deepest duplicates."""
    tile = 16
    arrays, cams, truths, bgs = _batch_inputs(3, tile)
    loss_t, g_t, var_t, res_t, nd_t, nw_t = rt.render_train_grads_batch(
        *to_torch(arrays), *cams, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
        torch.from_numpy(bgs), 1, tile=tile, max_dup=max_dup)
    loss_j, g_j, var_j, res_j, nd_j, _ = _jax_batch(arrays, cams, truths, bgs, tile, max_dup)
    assert nd_t == int(nd_j) and nw_t == -1
    assert (nd_t > max_dup) == (max_dup < 2**12)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_t.numpy(), jax_res(res_j), atol=RES_ATOL)
    for name, a, b in zip(GRAD_NAMES, g_t, g_j):
        assert a.shape == b.shape
        assert_rel_close(a.numpy(), b, f"gradient {name}")
    assert_rel_close(var_t.numpy(), var_j, "var_loc")


def test_train_grads_single_frame_match_jax():
    """F = 1 at tile 16.  (At tile 32 the JAX side's tile-local moment
    products put up to 8e-5 of the largest scale and rotation gradient on
    them against a float64 oracle, and the port 1e-6: the oracle test below
    holds the port at tile 32.)"""
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads as j_one

    tile = 16
    arrays, cams, truths, bgs = _batch_inputs(1, tile, seed=8)
    one = [c[0] for c in cams]
    loss_t, g_t, res_t = rt.render_train_grads(
        *to_torch(arrays), *one, W, H, rt.image_to_tiles(torch.from_numpy(truths[0]), tile),
        torch.from_numpy(bgs[0]), 1, tile=tile, max_dup=2**12)
    loss_j, g_j, res_j = j_one(*to_jax(arrays), *to_jax(one[:3]), one[3], one[4], W, H,
                               jax_tiles(truths, tile)[0], to_jax([bgs[0]])[0], 1,
                               tile=tile, max_dup=2**12, interpret=True, mm_bf16=False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_t.numpy(), jax_res(res_j[None])[0], atol=RES_ATOL)
    for name, a, b in zip(GRAD_NAMES, g_t, g_j):
        assert_rel_close(a.numpy(), b, f"gradient {name}")


@pytest.mark.parametrize("tile", [16, 32])
def test_fused_grads_match_autograd_of_oracle(tile):
    """The fused gradients are J^T residual: autograd of -1/2 |img - truth|^2
    through the port's oracle with the tile-granular cull."""
    arrays, cams, truths, bgs = _batch_inputs(2, tile, seed=12)
    params = to_torch(arrays)
    loss_f, g_f, *_ = rt.render_train_grads_batch(
        *params, *cams, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
        torch.from_numpy(bgs), 1, tile=tile, max_dup=2**12)
    leaves = [p.clone().requires_grad_(True) for p in params[:5]]
    total, loss_o = 0.0, 0.0
    for i in range(2):
        img = render_oracle(*leaves, params[5], *(c[i] for c in cams), W, H,
                            torch.from_numpy(bgs[i]), 1, row_chunk=16, tile_cull=tile)
        diff = img - torch.from_numpy(truths[i])
        total = total - 0.5 * torch.sum(diff * diff)
        loss_o = loss_o + float(torch.mean(diff.detach() ** 2))
    g_o = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(loss_f), loss_o, rtol=1e-5)
    for name, a, b in zip(GRAD_NAMES, g_f, g_o):
        assert_rel_close(a.numpy(), b.numpy(), f"gradient {name}")


@pytest.mark.parametrize("aa", [False, True])
def test_padded_slots_get_finite_zero_gradients(aa):
    """Inactive capacity slots (zero means and scales, identity rotation)
    and a zero quaternion in one: every gradient finite, zero off the
    live splats, with and without the mip anti-aliasing."""
    tile = 16
    arrays, cams, truths, bgs = _batch_inputs(2, tile, n=30, cap=48)
    rot = arrays[4].copy()
    rot[40] = 0.0  # a padded slot with a zero quaternion
    arrays = (*arrays[:4], rot, arrays[5])
    _, grads, var, res, _, _ = rt.render_train_grads_batch(
        *to_torch(arrays), *cams, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
        torch.from_numpy(bgs), 1, tile=tile, max_dup=2**12, aa=aa)
    for name, g in zip(GRAD_NAMES, grads):
        assert torch.isfinite(g).all(), name
        assert not g[30:].any(), name
    assert torch.isfinite(var).all() and not var[30:].any()
    assert torch.isfinite(res).all()
    assert grads[0][:30].abs().max() > 0


def test_bin_frames_concatenates_ranges():
    comps = project_stack(random_splats(40, 21), camera_stack(2))
    frames = [SplatComponents(*(x[i] for x in comps)) for i in range(2)]
    fb = bin_frames(frames, W, H, 16, 2**12)
    b0, b1 = (bin_splats(c, W, H, 16, 2**12) for c in frames)
    d0 = b0.gather_idx.shape[0]
    assert fb.tile_start.shape == (32,) and int(fb.tile_end[15]) == d0
    assert torch.equal(fb.tile_start[16:], b1.tile_start + d0)
    assert torch.equal(fb.gather_idx[d0:], b1.gather_idx + 40)
    assert fb.num_dup == max(b0.num_dup, b1.num_dup) != min(b0.num_dup, b1.num_dup)


def test_train_empty_tiles_write_truth_minus_background():
    feat = torch.zeros((9, 0))
    ranges = torch.zeros(8, dtype=torch.int32)
    truth = torch.rand((8, 64, 3), generator=torch.Generator().manual_seed(0))
    bg = torch.tensor([[0.1, 0.2, 0.3], [0.5, 0.5, 0.5]])
    res, d_feat = rt.composite_train(feat, ranges, ranges, truth, bg, 8, 2, 4)
    assert d_feat.shape == (9, 0)
    assert torch.equal(res[:4, :, :3], truth[:4] - bg[0])
    assert torch.equal(res[4:, :, :3], truth[4:] - bg[1])
    assert torch.equal(res[..., 3], torch.ones((8, 64)))


def test_composite_train_rejects_bad_arguments():
    feat = torch.zeros((9, 4))
    ranges = torch.zeros(4, dtype=torch.int32)
    truth, bg = torch.zeros((4, 256, 3)), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="truth"):
        rt.composite_train(feat, ranges, ranges, truth[:, :64], bg, 16, 2, 2)
    with pytest.raises(ValueError, match="frames"):
        rt.composite_train(feat, ranges, ranges, truth, bg[:1], 16, 2, 2)
    with pytest.raises(ValueError, match="tile"):
        rt.composite_train(feat, ranges, ranges, truth, bg, 12, 2, 2)


# -- the footprint skip --------------------------------------------------------

FOOTPRINT_CASES = ("random", "opacity_edge", "determinant_edge", "box_edge", "huge_and_tiny",
                   "nonfinite")


def _rows(mx, my, a, b, c, op):
    """(9, m) float32 duplicate rows, colour 0.5."""
    cols = [np.asarray(x, np.float64).ravel() for x in (mx, my, a, b, c)]
    m = cols[0].shape[0]
    rgb = [np.full(m, 0.5)] * 3
    return torch.from_numpy(np.stack(cols + rgb + [np.asarray(op, np.float64).ravel()])
                            .astype(np.float32))


def _footprint_case(case):
    """(feat (9, m), px (m, P), py (m, P)) float32 of one predicate case."""
    rng = np.random.default_rng(17)
    if case == "random":  # 10^5 pairs, half within 2% of the ellipse's edge
        m, n = 1000, 100
        a, b, c = conic(np.exp(rng.uniform(np.log(0.3), np.log(30), m)),
                         np.exp(rng.uniform(np.log(0.3), np.log(30), m)),
                         rng.uniform(0, np.pi, m))
        op = np.where(rng.uniform(size=m) < 0.1, rng.uniform(0, 0.01, m), rng.uniform(0, 1, m))
        feat = _rows(rng.uniform(0, 64, m), rng.uniform(0, 64, m), a, b, c, op)
        f = feat.double()
        lsq = 2 * np.log(np.maximum(f[8].numpy(), 1e-30) / AMIN).clip(min=1e-3)
        phi = rng.uniform(0, 2 * np.pi, (m, n))
        u, v = np.cos(phi), np.sin(phi)
        q = f[2].numpy()[:, None] * u * u + 2 * f[3].numpy()[:, None] * u * v \
            + f[4].numpy()[:, None] * v * v
        r = np.sqrt(lsq[:, None] / q) * rng.uniform(0.98, 1.02, (m, n))
        r[:, n // 2:] = rng.uniform(0, 1.3, (m, n - n // 2)) * r[:, n // 2:]
        px, py = f[0].numpy()[:, None] + r * u, f[1].numpy()[:, None] + r * v
        px[::2, :n // 4], py[::2, :n // 4] = np.round(px[::2, :n // 4]), np.round(py[::2, :n // 4])
        return feat, *(torch.from_numpy(x.astype(np.float32)) for x in (px, py))
    if case == "opacity_edge":  # op at, one float above and below 1/255, pixel at the centre
        ops = [np.nextafter(AMIN, 0), AMIN, np.nextafter(AMIN, 1), 2 * AMIN, 0.0, -0.5]
        feat = _rows([10.0] * 6, [20.0] * 6, [0.5] * 6, [0.1] * 6, [0.3] * 6, ops)
        grid = np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4)), -1).reshape(-1, 2)
        px = torch.from_numpy(np.tile(10.0 + grid[:, 0], (6, 1)).astype(np.float32))
        py = torch.from_numpy(np.tile(20.0 + grid[:, 1], (6, 1)).astype(np.float32))
        return feat, px, py
    if case == "determinant_edge":  # a c - b^2 at 0, one float below, and tiny
        bs = [1.0, np.nextafter(np.float32(1), np.float32(2)), np.float32(1 - 2**-23), 2.0]
        feat = _rows([5.0] * 4, [5.0] * 4, [1.0] * 4, bs, [1.0] * 4, [0.9] * 4)
        g = rng.uniform(-40, 40, (4, 2, 200)).astype(np.float32)
        return feat, torch.from_numpy(5 + g[:, 0]), torch.from_numpy(5 + g[:, 1])
    if case == "box_edge":  # pixels on each widened edge, one float outside, at its tangent
        m = 200
        a, b, c = conic(rng.uniform(0.5, 8, m), rng.uniform(0.5, 8, m), rng.uniform(0, np.pi, m))
        feat = _rows(rng.uniform(0, 64, m), rng.uniform(0, 64, m), a, b, c, rng.uniform(0.02, 1, m))
        xlo, xhi, ylo, yhi = rt.footprint_box(feat)
        f = feat.double()
        # the ellipse touches x = mx - ex at dy = (b / c) ex, y = my - ey at dx = (b / a) ey
        bc, ba = (f[3] / f[4]).float(), (f[3] / f[2]).float()
        mx, my = feat[0], feat[1]
        out = lambda e, d: torch.nextafter(e, torch.full_like(e, d))  # noqa: E731
        px = torch.stack([xlo, xhi, out(xlo, -1e9), out(xhi, 1e9), mx + ba * (my - ylo),
                          mx - ba * (yhi - my), mx + ba * (my - out(ylo, -1e9)),
                          mx - ba * (out(yhi, 1e9) - my)], 1)
        py = torch.stack([my + bc * (mx - xlo), my - bc * (xhi - mx),
                          my + bc * (mx - out(xlo, -1e9)), my - bc * (out(xhi, 1e9) - mx), ylo,
                          yhi, out(ylo, -1e9), out(yhi, 1e9)], 1)
        return feat, px, py
    if case == "huge_and_tiny":  # conics of 1e30 (a point) and 1e-30 (the plane)
        feat = _rows([8.0, 8.5, 8.0, 8.0], [8.0, 8.25, 8.0, 8.0], [1e30, 1e30, 1e-30, 1e-30],
                     [0.0, 1e29, 0.0, 1e-31], [1e30, 1e30, 1e-30, 1e-30], [1.0, 0.5, 0.9, 0.5])
        grid = np.stack(np.meshgrid(np.arange(0, 17), np.arange(0, 17)), -1).reshape(-1, 2)
        px = torch.from_numpy(np.tile(grid[:, 0], (4, 1)).astype(np.float32))
        py = torch.from_numpy(np.tile(grid[:, 1], (4, 1)).astype(np.float32))
        return feat, px, py
    vals = [np.nan, np.inf, -np.inf]  # "nonfinite": each of the six rows in turn
    base = [10.0, 10.0, 0.5, 0.1, 0.5, 0.8]
    rows = []
    for i in range(6):
        for v in vals:
            r = list(base)
            r[i] = v
            rows.append(r)
    feat = _rows(*np.array(rows).T)
    g = rng.uniform(-30, 50, (len(rows), 2, 100)).astype(np.float32)
    return feat, torch.from_numpy(g[:, 0]), torch.from_numpy(g[:, 1])


@pytest.mark.parametrize("case", FOOTPRINT_CASES)
def test_footprint_never_skips_a_reachable_pair(case):
    """The footprint predicate, the plain twin of composite_train's skip,
    never skips a (pixel, duplicate) pair that the plain arithmetic
    (power <= 0 and alpha >= 1/255, float32 op by op) would visit."""
    feat, px, py = _footprint_case(case)
    box = rt.footprint_box(feat)
    skips = rt.footprint_skips([e[:, None] for e in box], px, py)
    _, _, power, _, _, alpha = rt._gauss(feat[:, :, None], px, py)
    reachable = (power <= 0.0) & (alpha >= rt.ALPHA_MIN)
    assert not (skips & reachable).any()
    xlo, xhi, ylo, yhi = box
    if case == "random":  # the pixels probe the edge: a box 0.1% narrower would fail
        assert skips.float().mean() > 0.05 and reachable.float().mean() > 0.2
        mx, my = feat[0, :, None], feat[1, :, None]
        narrow = ((px - mx).abs() > 0.999 * (xhi[:, None] - mx)) | (
            (py - my).abs() > 0.999 * (yhi[:, None] - my))
        assert (narrow & reachable).any()
    elif case == "opacity_edge":  # 0 and negative: empty; at and above: the centre kept
        assert reachable[1:4, 24].all() and not reachable[[0, 4, 5]].any()
        assert torch.isinf(xlo[[4, 5]]).all() and (xlo[[4, 5]] > 0).all()
        assert skips[[4, 5]].all() and not skips[:4, 24].any()
        assert float(xhi[0] - xlo[0]) < 0.01  # one float below: within the margin
    elif case == "determinant_edge":  # not positive definite: the plane; tiny: huge
        assert torch.isinf(xlo[:2]).all() and torch.isinf(xlo[3]) and not skips[[0, 1, 3]].any()
        assert reachable[0].any() and float(xhi[2] - xlo[2]) > 1e3
    elif case == "box_edge":  # on the edge kept, one float outside skipped
        assert not skips[:, [0, 1, 4, 5]].any() and skips[:, [2, 3, 6, 7]].all()
    elif case == "huge_and_tiny":  # a point box at the centre; the plane
        assert reachable[0].sum() == 1 and skips[0].sum() == 16 * 17 + 16
        assert not skips[2:].any() and reachable[2].all()
    else:
        assert torch.isinf(xlo).all() and (xlo < 0).all() and not skips.any()


@pytest.mark.parametrize("replay", ["composite_fwd_reference", "composite_bwd_reference",
                                    "composite_train_reference"])
@pytest.mark.parametrize("scene", SYNTHETIC_SCENES)
def test_pairs_box_is_a_per_pixel_count(scene, replay):
    """stats["pairs_box"] of each plain replay (the work count of K1's, K2's
    and K3's bounds) equals a per-pixel count of the visited pairs inside
    the exact footprint box, tile by tile and pixel by pixel, and is at most
    ``pairs``.  K3's on synthetic_launch's two frames, K1's and K2's on the
    same scene as one frame (synthetic_frame)."""
    if replay == "composite_train_reference":
        args = synthetic_launch(scene, 8)
        feat, ts, te, _, _, tile, tx, tiles_frame = args
    else:
        args = synthetic_frame(scene, 8)
        feat, ts, te, tile, tx = args
        tiles_frame = ts.shape[0]
        if replay == "composite_bwd_reference":
            out = rt.composite_fwd_reference(*args)
            gin = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, tuple(out.shape))
                                   .astype(np.float32))
            args = (feat, ts, te, out, gin, tile, tx)
    stats = {}
    getattr(rt, replay)(*args, stats=stats)
    pairs = box = 0
    pix = torch.arange(tile * tile)
    for blk in range(ts.shape[0]):
        t = blk % tiles_frame
        px = ((t % tx) * tile + pix % tile).float()[None]
        py = ((t // tx) * tile + pix // tile).float()[None]
        alive, trans = torch.ones(1, tile * tile, dtype=torch.bool), torch.ones(1, tile * tile)
        for j in range(int(ts[blk]), int(te[blk])):
            mx, my, a, b, c, op = (float(feat[r, j]) for r in (0, 1, 2, 3, 4, 8))
            lsq = 2 * (math.log(op) - math.log(AMIN)) if op > 0 else -1.0
            det = a * c - b * b
            if lsq < 0:
                inside = torch.zeros_like(alive)
            elif not (a > 0 and det > 0):
                inside = torch.ones_like(alive)
            else:
                inside = ((px.double() - mx).abs() <= math.sqrt(lsq * c / det)) & (
                    (py.double() - my).abs() <= math.sqrt(lsq * a / det))
            pairs += int(alive.sum())
            box += int((alive & inside).sum())
            _, _, power, _, _, alpha = rt._gauss(feat[:, j:j + 1, None], px, py)
            contrib = (power <= 0.0) & (alpha >= rt.ALPHA_MIN) & alive
            test_t = trans * (1.0 - alpha)
            stop = contrib & (test_t < 1e-4)
            trans = torch.where(contrib & ~stop, test_t, trans)
            alive &= ~stop
    assert (stats["pairs"], stats["pairs_box"]) == (pairs, box)
    assert 0 < box < pairs


def test_k3_sass_and_ptxas_readers():
    """chip_smoke's readers on made-up listings: K3's two loops over
    duplicates (pass 1: 4 expf of PPT 4 pixels; pass 2 with 12 SHFL) inside
    the outer loop over batches; in one listing with K1's loop (no SHFL), an
    untemplated K1 (one pixel a thread) and K2's loop (12 SHFL), each
    compositor's own loops only; and the ptxas register and spill line of
    each entry function."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def listing(at, ops):
        return "".join(f"        /*{at + 16 * i:04x}*/                   {op} ;\n"
                       for i, op in enumerate(ops))

    p1 = ["LDS.128 R4, [R2]"] + ["MUFU.EX2 R1, R2", "FMUL R1, R2, R3"] * 4 + ["@P0 BRA 0x110"]
    p2 = ["MUFU.EX2 R1, R2"] * 4 + ["SHFL.BFLY PT, R1, R2, 0x1f"] * 12 + ["@P1 BRA 0x200"]
    sass = ("\tFunction : _ZN12_GLOBAL__N_122composite_train_kernelILi4EEvPKfx\n"
            + listing(0x100, ["S2R R0, SR_TID.X"]) + listing(0x110, p1)
            + listing(0x200, p2) + listing(0x200 + 16 * len(p2), ["BRA 0x100"]))
    (c1, c2) = smoke.compositor_sass_counts(sass, "composite_train")
    assert (c1["pass"], c1["pairs"], c1["instructions"], c1["shfl_per_dup"]) == (1, 4, 10, 0)
    assert (c2["pass"], c2["pairs"], c2["instructions"], c2["shfl_per_dup"]) == (2, 4, 17, 12)
    assert c2["kinds"] == {"MUFU": 4, "SHFL": 12, "BRA": 1} and c1["per_pair"] == 10 / 4

    def function(name, loop):
        end = 0x100 + 16 * len(loop)
        return (f"\tFunction : _ZN12_GLOBAL__N_1{name}\n" + listing(0x100, loop)
                + listing(end, ["BRA 0x100"]))

    k2 = ["MUFU.EX2 R1, R2", "FFMA R1, R2, R3, R4"] + ["SHFL.BFLY PT, R1, R2, 0x1f"] * 12 + [
        "@P1 BRA 0x100"]
    k1 = ["MUFU.EX2 R1, R2", "FMUL R1, R2, R3"] * 4 + ["@P0 BRA 0x100"]
    both = (function("20composite_fwd_kernelILi4EEvPKfx", k1)
            + function("20composite_fwd_kernelEPKfx", ["MUFU.EX2 R1, R2", "@P0 BRA 0x100"])
            + sass + function("20composite_bwd_kernelILi1EEvPKfx", k2))
    (f4, f1) = smoke.compositor_sass_counts(both, "composite_fwd")
    assert (f4["ppt"], f4["pass"], f4["pairs"], f4["instructions"]) == (4, 1, 4, 9)
    assert (f1["ppt"], f1["pairs"], f1["per_pair"], f1["shfl_per_dup"]) == (1, 1, 2, 0)
    (b1,) = smoke.compositor_sass_counts(both, "composite_bwd")
    assert (b1["ppt"], b1["pass"], b1["pairs"], b1["shfl_per_dup"]) == (1, 2, 1, 12)
    assert [c["pass"] for c in smoke.compositor_sass_counts(both, "composite_train")] == [1, 2]
    log = ("ptxas info    : Compiling entry function '_Z3fooILi4EEv' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers, 21520 bytes smem\n"
           "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
           "ptxas info    : Used 12 registers\n")
    assert smoke.ptxas_lines(log, "foo") == [
        "_Z3fooILi4EEv: 80 registers; 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads"]


# -- CUDA kernel (needs a card) ------------------------------------------------


def _kernel_inputs(device, tile, frames=2, n=200, seed=3):
    """Binned duplicate rows, truth tiles and backgrounds of ``frames``
    frames, as one composite_train launch takes them."""
    comps = SplatComponents(*(x.to(device) for x in project_stack(random_splats(n, seed),
                                                                    camera_stack(frames))))
    rows9 = rt._rows(comps).reshape(9, -1)
    truths, bgs = random_truths(frames, 4)
    _, args = rt.train_launch_inputs(
        rows9, comps, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
        torch.from_numpy(bgs), tile, 2**13)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_train_kernel_matches_plain_version(cuda_device, tile):
    """Residual atol 1e-5 and d_feat within 1e-4 of each row's largest
    magnitude: the two take the same decisions and differ only in the order
    of the sums over a tile's pixels."""
    args = _kernel_inputs(cuda_device, tile)
    before = rt.composite_train_launches
    res_k, d_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    assert rt.composite_train_launches == before + 1
    res_p, d_p = rt.composite_train_reference(*args)
    assert torch.isfinite(res_k).all() and torch.isfinite(d_k).all()
    assert float((res_k - res_p).abs().max()) <= 1e-5
    scale = d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    assert float(((d_k - d_p).abs() / scale).max()) <= 1e-4
    assert d_p.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("scene", SYNTHETIC_SCENES)
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_train_kernel_edge_scenes_match_plain(cuda_device, scene, tile):
    """The footprint skip's edges on the card (splats under 2 px, one wider
    than the tile, opacities at 1/255, conics at a c = b^2), at the
    tolerances of test_train_kernel_matches_plain_version."""
    args = synthetic_launch(scene, tile, cuda_device)
    res_k, d_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    res_p, d_p = rt.composite_train_reference(*args)
    assert torch.isfinite(res_k).all() and torch.isfinite(d_k).all()
    assert float((res_k - res_p).abs().max()) <= 1e-5
    scale = d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    assert float(((d_k - d_p).abs() / scale).max()) <= 1e-4


@pytest.mark.cuda
def test_train_kernel_launches_are_bit_equal(cuda_device):
    """A fixed sum order: two launches on the same inputs give the same bits."""
    args = _kernel_inputs(cuda_device, 32)
    (res_a, d_a), (res_b, d_b) = rt.composite_train(*args), rt.composite_train(*args)
    torch.cuda.synchronize()
    assert torch.equal(res_a, res_b) and torch.equal(d_a, d_b)


@pytest.mark.cuda
def test_train_kernel_empty_tiles(cuda_device):
    feat = torch.zeros((9, 0), device=cuda_device)
    ranges = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    truth = torch.rand((8, 1024, 3), device=cuda_device)
    bg = torch.tensor([[0.1, 0.2, 0.3], [0.5, 0.5, 0.5]], device=cuda_device)
    res, _ = rt.composite_train(feat, ranges, ranges, truth, bg, 32, 2, 4)
    torch.cuda.synchronize()
    assert torch.equal(res[:4, :, :3], truth[:4] - bg[0])
    assert torch.equal(res[4:, :, :3], truth[4:] - bg[1])
    assert torch.equal(res[..., 3], torch.ones((8, 1024), device=cuda_device))


@pytest.mark.cuda
def test_train_grads_on_card_match_cpu(cuda_device):
    tile = 32
    arrays, cams, truths, bgs = _batch_inputs(3, tile, n=120)
    tiles = rt.image_to_tiles(torch.from_numpy(truths), tile)
    out = {}
    for dev in ("cpu", cuda_device):
        params = to_torch(arrays, dev)
        out[str(dev)] = rt.render_train_grads_batch(
            *params, *cams, W, H, tiles.to(dev), torch.from_numpy(bgs).to(dev), 1,
            tile=tile, max_dup=2**12)
    (loss_c, g_c, var_c, res_c, nd_c, _), (loss_k, g_k, var_k, res_k, nd_k, _) = out.values()
    assert nd_c == nd_k
    np.testing.assert_allclose(float(loss_k), float(loss_c), rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_k.cpu().numpy(), res_c.numpy(), atol=RES_ATOL)
    for name, a, b in zip(GRAD_NAMES, g_k, g_c):
        assert_rel_close(a.cpu().numpy(), b.numpy(), f"gradient {name}")
    assert_rel_close(var_k.cpu().numpy(), var_c.numpy(), "var_loc")


@pytest.mark.cuda
@pytest.mark.parametrize("frames,empty,max_dup", [(3, False, 2**12), (3, True, 100)])
def test_bin_splats_batch_on_card_equals_cpu(cuda_device, frames, empty, max_dup):
    """The batched binning on the card: every field (all integers) equal to
    the CPU's."""
    comps = _binning_group(frames, empty)
    on_card = SplatComponents(*(x.to(cuda_device) for x in comps))
    fb = bin_splats_batch(on_card, W, H, 16, max_dup)
    assert fb.gather_idx.device.type == "cuda"
    assert_frame_bins_equal(bin_splats_batch(comps, W, H, 16, max_dup), fb)


@pytest.mark.cuda
def test_batched_front_end_syncs_once_a_group(cuda_device):
    """render_train_grads_batch on a 3-frame group whose inputs are on the
    card synchronises with the host once: the binning's read of the F
    duplicate counts (torch.cuda.set_sync_debug_mode("warn") counts it)."""
    tile = 32
    arrays, cams, truths, bgs = _batch_inputs(3, tile, n=120)
    args = (*to_torch(arrays, cuda_device), *to_torch(cams, cuda_device), W, H,
            rt.image_to_tiles(torch.from_numpy(truths), tile).to(cuda_device),
            torch.from_numpy(bgs).to(cuda_device), 1)
    rt.render_train_grads_batch(*args, tile=tile, max_dup=2**12)  # builds and loads K3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rt.render_train_grads_batch(*args, tile=tile, max_dup=2**12)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


# -- train step, densify, Trainer and auto_train -------------------------------

RES, TILE = 32, 16


def _rig(cams=4):
    """The app's rig cut to ``cams`` cameras, with the boosted rates of
    tests/test_trainer.py so that a short run moves."""
    p = Project.app_default()
    p.sphere1.count = cams
    p.lrLocation, p.lrSh, p.lrScale, p.lrOpacity, p.lrRotation = 1e-2, 2.5e-2, 5e-3, 2.5e-2, 5e-3
    return p


def _runtime(**kw):
    return RuntimeConfig(render_resolution_x=RES, render_resolution_y=RES, tile_px=TILE,
                         max_dup=2**12, frame_group=4, train_mm_bf16=False, **kw)


def test_fused_step_projects_and_bins_once_a_group(monkeypatch):
    """The fused step's front end is frame-batched: 8 frames in frame
    groups of 4 make two projection calls, each over (4, N), and two
    bin_splats_batch calls; no frame is projected or binned alone."""
    calls = {"project": [], "bin_splats_batch": 0}
    project, bin_batch = rt.project_splat_components, rt.bin_splats_batch

    def counted_project(means, *args, **kw):
        calls["project"].append(tuple(means.shape))
        return project(means, *args, **kw)

    def counted_bin(*args, **kw):
        calls["bin_splats_batch"] += 1
        return bin_batch(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the fused step binned a frame alone")

    monkeypatch.setattr(rt, "project_splat_components", counted_project)
    monkeypatch.setattr(rt, "bin_splats_batch", counted_bin)
    monkeypatch.setattr(rt, "bin_splats", refuse)
    arrays = random_splats(40, 17, cap=48)
    cams = CameraBatch.from_cameras(Camera.get_cameras(_rig()), RES, RES, device="cpu")
    truths, _ = random_truths(8, 9, RES, RES)
    step = make_train_step(RES, RES, 1, renderer="tiled", fused=True,
                           fused_opts=dict(tile=TILE, max_dup=2**12), frame_group=4)
    _, metrics = step(SplatModel.from_numpy(*arrays[:5], count=40, device="cpu"),
                      rt.image_to_tiles(torch.from_numpy(truths), TILE), cams,
                      LearningRates.from_project(_rig()))
    assert calls == {"project": [(4, 48, 3), (4, 48, 3)], "bin_splats_batch": 2}
    assert metrics.num_dup > 0


def test_fused_train_step_matches_jax():
    """4-camera rig, 8 frames a step, frame_group 4 (two launches): the
    metrics and the parameter updates of one SGD step."""
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.train.trainer import CameraBatch as JCams
    from gaussian_splatterer_tpu.train.trainer import LearningRates as JLrs
    from gaussian_splatterer_tpu.train.trainer import make_train_step as j_make_step

    arrays = random_splats(40, 17, cap=48)
    p = _rig()
    cams = CameraBatch.from_cameras(Camera.get_cameras(p), RES, RES, device="cpu")
    truths, _ = random_truths(8, 9, RES, RES)
    lrs = LearningRates.from_project(p)
    model = SplatModel.from_numpy(*arrays[:5], count=40, device="cpu")
    step = make_train_step(RES, RES, 1, renderer="tiled", fused=True,
                           fused_opts=dict(tile=TILE, max_dup=2**12), frame_group=4)
    before = rt.composite_train_launches
    model, m_t = step(model, rt.image_to_tiles(torch.from_numpy(truths), TILE), cams, lrs)
    assert rt.composite_train_launches == before  # the plain version, on the CPU
    j_step = j_make_step(RES, RES, 1, renderer="tiled", fused=True,
                         fused_opts=dict(tile=TILE, max_dup=2**12, mm_bf16=False), frame_group=4)
    j_model, m_j = j_step(jax_model(arrays, 40), jax_tiles(truths, TILE),
                          JCams(*(jnp.asarray(x.numpy()) for x in cams)),
                          JLrs(*(jnp.float32(x) for x in lrs)))
    assert m_t.num_dup == int(m_j.num_dup) > 0
    np.testing.assert_allclose(float(m_t.loss), float(m_j.loss), rtol=LOSS_RTOL)
    assert_rel_close(m_t.var_loc.numpy(), m_j.var_loc, "var_loc")
    assert_rel_close(m_t.avg_grad_loc.numpy(), m_j.avg_grad_loc, "avg_grad_loc")
    (new_t, _), (new_j, _) = model_arrays(model), model_arrays(j_model)
    for name, a, b, old in zip(GRAD_NAMES, new_t, new_j, arrays):
        assert_rel_close(a - old, b - old, f"update of {name}")


@pytest.mark.parametrize("capacity", [96, 52])
def test_densify_matches_jax(capacity):
    """Cull, split and clone of 40 splats; at capacity 52 the appends stop
    at the capacity, splits first."""
    from gaussian_splatterer_tpu.train.densify import DensifyParams as JParams
    from gaussian_splatterer_tpu.train.densify import densify as j_densify

    n = 40
    means, shs, scales, opac, rot, _ = random_splats(n, 23, cap=capacity)
    opac[:3] = 0.001  # culled for opacity
    scales[3:5] = 0.001  # culled for size
    rng = np.random.default_rng(5)
    var = np.zeros(capacity, np.float32)
    var[:n] = rng.uniform(0.0, 2.0, n)
    grad = np.zeros((capacity, 3), np.float32)
    grad[:n] = rng.normal(0.0, 0.3, (n, 3))
    arrays = (means, shs, scales, opac, rot)
    dp = DensifyParams(cull_opacity=0.005, cull_size=0.004, densify_variance=0.5,
                       split_size=0.45, split_distance=1.5, split_scale=0.8, clone_distance=1.6)
    out_t = densify(SplatModel.from_numpy(*arrays, count=n, device="cpu"),
                    torch.from_numpy(var), torch.from_numpy(grad), dp)
    out_j = j_densify(jax_model(arrays, n), *to_jax([var, grad]), JParams(*map(np.float32, dp)))
    (a_t, c_t), (a_j, c_j) = model_arrays(out_t), model_arrays(out_j)
    volatile = (var - np.linalg.norm(grad, axis=-1) > 0.5)[5:n]
    splits = (volatile & (np.linalg.norm(scales, axis=-1)[5:n] > 0.45)).sum()
    assert 0 < splits < volatile.sum()  # both kinds of append
    assert (capacity - n < volatile.sum()) == (capacity == 52)  # capped at 52 only
    assert c_t == c_j == n - 5 + min(volatile.sum(), capacity - n)
    for name, a, b in zip(GRAD_NAMES, a_t, a_j):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)


class StubRtx:
    """Truth source: one fixed image per background, whatever the camera."""

    def __init__(self, seed):
        self.seed = seed

    def render(self, camera, background, samples, width, height):
        return random_truths(2, self.seed, width, height)[0][0 if background[0] > 0.5 else 1]


def test_trainer_auto_train_matches_jax():
    """Three auto_train steps of the port's Trainer and the JAX package's,
    with the same truths: capture at iterations 0 and 2 (with a rig
    rotation), densify at 0 and 2 (every splat splits; the second densify
    reaches the capacity), the same counts and parameters."""
    import dataclasses

    from gaussian_splatterer_tpu.config import Project as JProject
    from gaussian_splatterer_tpu.config import RuntimeConfig as JRuntimeConfig
    from gaussian_splatterer_tpu.train import Trainer as JTrainer
    from gaussian_splatterer_tpu.train import auto_train as j_auto_train

    n, cap = 12, 40
    arrays = random_splats(n, 29, cap=cap)
    p = _rig()
    p.intervalCapture = p.intervalDensify = 2
    p.paramDensifyVariance = -1.0  # every splat volatile
    p.paramSplitSize = 0.0  # and split: the split offsets do not read the gradient
    runtime = _runtime(splats_capacity=cap)
    trainers = {
        "port": (Trainer(p, runtime, SplatModel.from_numpy(*arrays[:5], count=n, device="cpu"),
                         renderer="tiled"), auto_train),
        "jax": (JTrainer(JProject.from_json(p.to_json()),
                         JRuntimeConfig(**dataclasses.asdict(runtime)), jax_model(arrays, n),
                         renderer="tiled"), j_auto_train),
    }
    seen = {}
    for name, (trainer, run) in trainers.items():
        log = seen[name] = {"captures": [], "counts": [], "losses": []}
        capture = trainer.capture_truths

        def counting_capture(rtx, capture=capture, trainer=trainer, log=log):
            log["captures"].append(trainer.project.iterations)
            capture(rtx)

        def on_step(it, m, trainer=trainer, log=log):
            log["counts"].append(int(trainer.model.count))
            log["losses"].append(float(m.loss))

        trainer.capture_truths = counting_capture
        run(trainer, StubRtx(7), 3, rng=random.Random(0), on_step=on_step)
    port, jax_ = seen["port"], seen["jax"]
    assert port["captures"] == jax_["captures"] == [0, 2]
    assert port["counts"] == jax_["counts"] == [24, 24, 40]
    np.testing.assert_allclose(port["losses"], jax_["losses"], rtol=LOSS_RTOL)
    t_port, t_jax = trainers["port"][0], trainers["jax"][0]
    assert t_port.project.sphere1.rotX == t_jax.project.sphere1.rotX != 0.0
    (a_t, _), (a_j, _) = model_arrays(t_port.model), model_arrays(t_jax.model)
    for name, a, b in zip(GRAD_NAMES, a_t, a_j):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def _rgb_sh(rgb):
    sh = np.zeros((4, 3), np.float32)
    sh[0] = (np.asarray(rgb, np.float32) - 0.5) / SH_C0
    return sh


def _two_splats(centres, colours, sizes, opacities):
    """A 16-slot model of two axis-aligned splats (tests/test_trainer.py's)."""
    cap = 16
    means, shs = np.zeros((cap, 3), np.float32), np.zeros((cap, 4, 3), np.float32)
    scales, opac = np.zeros((cap, 3), np.float32), np.zeros(cap, np.float32)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    for i in range(2):
        means[i], shs[i], scales[i], opac[i] = centres[i], _rgb_sh(colours[i]), sizes[i], \
            opacities[i]
    return SplatModel.from_numpy(means, shs, scales, opac, rot, count=2, device="cpu")


class OracleRtx:
    """Truth source: the port's oracle renders of a target model."""

    def __init__(self, target):
        self.target = target

    def render(self, camera, background, samples, width, height):
        m = self.target
        tx, ty = camera.tan_fov(width, height, train=True)
        return render_oracle(m.means, m.shs, m.scales, m.opacities, m.rotations,
                             m.active_mask(), camera.get_view(),
                             camera.get_proj_view(width / height), camera.location, tx, ty,
                             width, height, torch.tensor(background, dtype=torch.float32),
                             m.sh_degree, 1.0, row_chunk=16)


def test_port_trainer_lowers_loss():
    """tests/test_trainer.py's convergence check, on the port's fused step."""
    p = _rig()
    p.sphere1.distance = 5.0
    target = _two_splats([[0.5, 0, 0], [-0.5, 0.3, 0]], [[0.9, 0.2, 0.1], [0.1, 0.8, 0.3]],
                         [[0.4] * 3, [0.35] * 3], [0.9, 0.8])
    student = _two_splats([[0.3, 0.1, 0.1], [-0.3, 0.2, -0.1]], [[0.5] * 3, [0.5] * 3],
                          [[0.35] * 3, [0.4] * 3], [0.7, 0.7])
    trainer = Trainer(p, _runtime(), student, renderer="tiled")
    trainer.capture_truths(OracleRtx(target))
    assert trainer._fused and trainer.truths.shape == (8, 4, 256, 3)
    first = trainer.train()
    for _ in range(29):
        last = trainer.train()
    assert p.iterations == 30
    assert float(last.loss) < 0.5 * float(first.loss)
    assert trainer.binning_stats()["num_dup"] > 0
    img = trainer.render(Camera.get_cameras(p)[0])
    assert img.shape == (RES, RES, 3) and torch.isfinite(img).all()


def test_overflow_grows_dup_buffer():
    """tests/test_trainer.py's overflow recovery: a step past max_dup drops
    its deepest duplicates and reports the true count; the trainer grows
    max_dup (25% headroom, a multiple of train_chunk) and trains on."""
    student = SplatModel.from_numpy(*random_splats(30, 2, cap=32)[:5], count=30, device="cpu")
    runtime = _runtime()
    runtime.max_dup = 8
    trainer = Trainer(_rig(), runtime, student, renderer="tiled")
    trainer.capture_truths(StubRtx(3))
    m1 = trainer.train()
    assert m1.num_dup > 8
    with pytest.warns(UserWarning, match="overflow"):
        assert trainer.maybe_grow_dup_buffer(m1)
    assert runtime.max_dup == -(-int(m1.num_dup * 1.25) // runtime.train_chunk) \
        * runtime.train_chunk
    m2 = trainer.train()
    assert m2.num_dup <= runtime.max_dup and np.isfinite(float(m2.loss))
    assert not trainer.maybe_grow_dup_buffer(m2)


def test_from_numpy_copies_the_arrays():
    """Training updates the model in place: the arrays it was made from
    stay as they were."""
    arrays = random_splats(8, 1, cap=16)[:5]
    means = arrays[0].copy()
    model = SplatModel.from_numpy(*arrays, count=8, device="cpu")
    with torch.no_grad():
        model.means.add_(1.0)
    assert np.array_equal(arrays[0], means)


def test_unported_training_paths_raise():
    """More than one device needs a process group of that many ranks: the
    Trainer is made without one (a project saved so still opens), and its
    first step raises a RuntimeError naming the size and `gsplat-torch
    train --devices` instead of training another way.  A tiled step that
    cannot be fused (40 x 40 at tile 16) trains on the serve path's
    backward."""
    student = SplatModel.from_numpy(*random_splats(8, 1, cap=16)[:5], count=8, device="cpu")
    unfused = Trainer(_rig(), RuntimeConfig(render_resolution_x=40, render_resolution_y=40,
                                            tile_px=16), student, renderer="tiled")
    unfused.capture_truths(StubRtx(3))
    assert not unfused._fused
    assert np.isfinite(float(unfused.train().loss))
    multi = Trainer(_rig(), _runtime(train_devices=2), student, renderer="tiled")
    iterations = multi.project.iterations
    assert multi.devices == 2
    with pytest.raises(RuntimeError, match="process group of 2 ranks.*train PROJECT --devices 2"):
        multi.train()
    assert multi.project.iterations == iterations
    trainer = Trainer(_rig(), _runtime(), student, renderer="tiled")
    assert not trainer.calibrate_work_cap()
