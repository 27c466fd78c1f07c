"""PyTorch port vs JAX package: the serve path's backward (the compositor's
VJP, K2) and the non-fused tiled train step that runs on it.

On the CPU the port's backward compositor is its plain PyTorch version
(composite_bwd_reference), reached through the same autograd Function as
on the card; JAX's render_tiled runs its custom-VJP Pallas kernels in
interpret mode, as tests/test_raster_tiled.py does.  Tolerances: gradients
within 5e-5 of each tensor's largest magnitude and the background gradient
atol 1e-5 (tests/test_raster_tiled.py's), losses rtol 1e-5.  The two sides
differ only in summation order: sequential transmittance products and
pixel sums here, triangular-matmul cumsums and moment products there.

The CUDA kernel's tests (marker ``cuda``) need a card and skip here.  The
JAX package is imported inside the tests that use it, so that the file also
imports on a machine with a card and no JAX."""

from functools import partial

import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    SYNTHETIC_SCENES, camera_args, cuda_device, jax_model, model_arrays, random_splats,
    random_truths, synthetic_frame, to_jax, to_torch,
)

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components
from gaussian_splatterer_tpu_torch.train import CameraBatch, LearningRates, Trainer
from gaussian_splatterer_tpu_torch.train import make_train_step
from gaussian_splatterer_tpu_torch.train.trainer import _default_render

GRAD_ATOL, BG_ATOL, LOSS_RTOL = 5e-5, 1e-5, 1e-5
GRAD_NAMES = ("means", "shs", "scales", "opacities", "rotations")


def assert_rel_close(a, b, err_msg=""):
    """|a - b| <= GRAD_ATOL * max(1e-3, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1e-3, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_ATOL, err_msg=err_msg)


def _port_grads(render, arrays, width, height, bg, residual, device="cpu", **kw):
    """Gradients of sum(img * residual) with respect to the five parameters
    (and the background, last) of one port render."""
    cam = camera_args(width, height)
    params = to_torch(arrays, device)
    leaves = [p.clone().requires_grad_(True) for p in params[:5]]
    bg_t = torch.tensor(bg, dtype=torch.float32, device=device).requires_grad_(True)
    img = render(*leaves, params[5], *cam, width, height, bg_t, 1, 1.0, **kw)
    res = torch.as_tensor(residual, device=device)
    return torch.autograd.grad((img * res).sum(), [*leaves, bg_t])


def _jax_grads(arrays, width, height, bg, residual, render):
    import jax
    import jax.numpy as jnp

    cam = camera_args(width, height)
    jarr = to_jax(arrays)

    def f(p, bg_j):
        img = render(*p, jarr[5], *to_jax(cam[:3]), cam[3], cam[4], width, height, bg_j, 1, 1.0)
        return jnp.sum(img * jnp.asarray(residual))

    g, g_bg = jax.grad(f, argnums=(0, 1))(tuple(jarr[:5]), jnp.asarray(bg, jnp.float32))
    return (*g, g_bg)


def _jax_tiled(tile, max_dup):
    from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled as j_tiled

    return partial(j_tiled, tile=tile, max_dup=max_dup, interpret=True)


def _rel_dev(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1e-3, float(np.max(np.abs(b))))


def assert_matches_jax(port, jax_tiled, jax_oracle, name):
    """The port within the tolerance of the JAX oracle (tile-granular cull),
    and of the JAX render_tiled wherever that is itself within the tolerance
    of its oracle.  Only the scale and rotation gradients may miss it: the
    JAX side's tile-local moment products (_grad_rows_moments) cancel in
    float32 on the conic rows, 9.8e-5 of the largest scale and 5.9e-5 of
    the largest rotation gradient at 40 x 40, tile 16 (the port: 4.2e-7)."""
    assert_rel_close(port, jax_oracle, f"{name} against the JAX oracle")
    if name in ("scales", "rotations") and _rel_dev(jax_tiled, jax_oracle) > GRAD_ATOL:
        return
    assert_rel_close(port, jax_tiled, f"{name} against the JAX render_tiled")


@pytest.mark.parametrize("tile,width,height", [(8, 64, 64), (16, 64, 64), (32, 64, 64),
                                               (16, 40, 40)])
def test_render_tiled_grads_match_jax(tile, width, height):
    """tests/test_raster_tiled.py's gradient scene (40 splats, seed 7,
    residual seed 11, black background): the port's render_tiled gradients
    against jax.grad of the JAX package's render_tiled and oracle; at
    40 x 40 the last tile row and column are cropped."""
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle as j_oracle

    arrays = random_splats(40, 7)
    residual = np.random.default_rng(11).normal(0, 1, (height, width, 3)).astype(np.float32)
    bg = (0.0, 0.0, 0.0)
    g_t = _port_grads(rt.render_tiled, arrays, width, height, bg, residual, tile=tile,
                      max_dup=2**13)
    g_j = _jax_grads(arrays, width, height, bg, residual, _jax_tiled(tile, 2**13))
    g_o = _jax_grads(arrays, width, height, bg, residual,
                     partial(j_oracle, row_chunk=8, tile_cull=tile))
    for name, a, b, o in zip(GRAD_NAMES, g_t, g_j, g_o):
        assert a.shape == b.shape
        assert_matches_jax(a.numpy(), b, o, name)
    assert g_t[0].abs().max() > 0


def test_background_gradient_matches_jax():
    """tests/test_raster_tiled.py's background scene (20 splats, seed 9):
    d mean(img) / d background, atol 1e-5."""
    arrays = random_splats(20, 9)
    residual = np.full((64, 64, 3), 1.0 / (64 * 64 * 3), np.float32)
    bg = (0.3, 0.6, 0.9)
    g_t = _port_grads(rt.render_tiled, arrays, 64, 64, bg, residual, tile=16, max_dup=2**12)
    g_j = _jax_grads(arrays, 64, 64, bg, residual, _jax_tiled(16, 2**12))
    np.testing.assert_allclose(g_t[5].numpy(), np.asarray(g_j[5]), atol=BG_ATOL)
    assert 0.0 < float(g_t[5].min()) < 1.0 / 3.0


@pytest.mark.parametrize("tile,width,height,bg", [(16, 64, 64, (0.2, 0.3, 0.4)),
                                                  (32, 64, 64, (1.0, 1.0, 1.0)),
                                                  (16, 40, 24, (0.0, 0.0, 0.0))])
def test_render_tiled_grads_match_autograd_of_oracle(tile, width, height, bg):
    """The backward through composite_bwd_reference against autograd through
    the port's oracle with the tile-granular cull, background gradient
    included."""
    arrays = random_splats(60, 5)
    residual = np.random.default_rng(2).normal(0, 1, (height, width, 3)).astype(np.float32)
    g_t = _port_grads(rt.render_tiled, arrays, width, height, bg, residual, tile=tile,
                      max_dup=2**13)
    g_o = _port_grads(render_oracle, arrays, width, height, bg, residual, row_chunk=8,
                      tile_cull=tile)
    for name, a, b in zip((*GRAD_NAMES, "background"), g_t, g_o):
        assert_rel_close(a.numpy(), b.numpy(), f"gradient {name}")


def _composite_inputs(tile, n=120, seed=3, width=64, height=64, device="cpu"):
    """Binned duplicate rows of one frame and a seeded gin, as one
    composite_bwd launch takes them, with the forward output."""
    arrays = random_splats(n, seed)
    with torch.no_grad():
        comps = project_splat_components(*to_torch(arrays, device), *camera_args(width, height),
                                         width, height, 1)
        bins = bin_splats(comps, width, height, tile, 2**13)
        feat = rt.gather_features(comps, bins)
    tx = -(-width // tile)
    num_tiles = bins.tile_start.shape[0]
    out = rt.composite_fwd_reference(feat.cpu(), bins.tile_start.cpu(), bins.tile_end.cpu(),
                                     tile, tx).to(device)
    gin = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (num_tiles, tile * tile, 4)).astype(np.float32)).to(device)
    return feat, bins.tile_start, bins.tile_end, out, gin, tile, tx


@pytest.mark.parametrize("tile", [8, 32])
def test_composite_function_backward_is_composite_bwd(tile):
    """The autograd Function's forward is composite_fwd and its backward
    composite_bwd_reference on the saved rows and output, bit for bit; the
    integer ranges get no gradient."""
    feat, start, end, out, gin, tile, tx = _composite_inputs(tile)
    leaf = feat.clone().requires_grad_(True)
    out_f = rt.composite(leaf, start, end, tile, tx)
    assert torch.equal(out_f.detach(), out)
    (d_feat,) = torch.autograd.grad(out_f, leaf, gin)
    stats = {}
    ref = rt.composite_bwd_reference(feat, start, end, out, gin, tile, tx, stats=stats)
    assert torch.equal(d_feat, ref) and ref.abs().max() > 0
    fwd_stats = {}
    rt.composite_fwd_reference(feat, start, end, tile, tx, stats=fwd_stats)
    assert stats == fwd_stats and stats["composited"] > 0


def test_empty_model_gradients_are_exactly_zero():
    arrays = random_splats(0, 0, cap=8)
    residual = np.random.default_rng(1).normal(0, 1, (64, 64, 3)).astype(np.float32)
    g = _port_grads(rt.render_tiled, arrays, 64, 64, (0.25, 0.5, 0.75), residual, tile=16,
                    max_dup=2**10)
    for name, x in zip(GRAD_NAMES, g[:5]):
        assert torch.count_nonzero(x) == 0, name
    np.testing.assert_allclose(g[5].numpy(), residual.sum(axis=(0, 1)), rtol=1e-5)


def test_overflowed_max_dup_gradients_are_finite():
    """Past max_dup the deepest duplicates are dropped: they have no
    column, and the gradients stay finite."""
    arrays = random_splats(200, 3)
    with torch.no_grad():
        comps = project_splat_components(*to_torch(arrays), *camera_args(), 64, 64, 1)
    assert bin_splats(comps, 64, 64, 16, 64).num_dup > 64
    residual = np.random.default_rng(4).normal(0, 1, (64, 64, 3)).astype(np.float32)
    g = _port_grads(rt.render_tiled, arrays, 64, 64, (0.0, 0.0, 0.0), residual, tile=16,
                    max_dup=64)
    for name, x in zip(GRAD_NAMES, g[:5]):
        assert torch.isfinite(x).all(), name
    assert g[0].abs().max() > 0


def test_composite_bwd_rejects_bad_arguments():
    feat = torch.zeros((9, 4))
    ranges = torch.zeros(4, dtype=torch.int32)
    out = torch.zeros((4, 256, 4))
    with pytest.raises(ValueError, match="gin"):
        rt.composite_bwd(feat, ranges, ranges, out, out[:, :64], 16, 2)
    with pytest.raises(ValueError, match="out"):
        rt.composite_bwd(feat, ranges, ranges, out.double(), out, 16, 2)
    with pytest.raises(ValueError, match="tile"):
        rt.composite_bwd(feat, ranges, ranges, out, out, 12, 2)


# -- the non-fused tiled train step --------------------------------------------

RES = 40  # not a multiple of the tile: the Trainer takes the non-fused step


def _rig(cams=2):
    """The app's rig cut to ``cams`` cameras, with the boosted rates of
    tests/test_trainer.py so that a short run moves."""
    p = Project.app_default()
    p.sphere1.count = cams
    p.lrLocation, p.lrSh, p.lrScale, p.lrOpacity, p.lrRotation = 1e-2, 2.5e-2, 5e-3, 2.5e-2, 5e-3
    return p


def test_non_fused_tiled_step_matches_jax():
    """One make_train_step(40, 40, 1, renderer="tiled") step, 2 cameras (4
    frames): the metrics and the parameter updates of one SGD step, from
    the same model and truths, against the JAX package's step on its
    render_tiled and on its oracle (assert_matches_jax).  The JAX
    render_tiled gets a buffer that holds every duplicate (interpret mode
    scales with it)."""
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle as j_oracle
    from gaussian_splatterer_tpu.train.trainer import CameraBatch as JCams
    from gaussian_splatterer_tpu.train.trainer import LearningRates as JLrs
    from gaussian_splatterer_tpu.train.trainer import make_train_step as j_make_step

    arrays = random_splats(40, 17, cap=48)
    p = _rig()
    cams = CameraBatch.from_cameras(Camera.get_cameras(p), RES, RES, device="cpu")
    truths, _ = random_truths(4, 9, RES, RES)
    lrs = LearningRates.from_project(p)
    model = SplatModel.from_numpy(*arrays[:5], count=40, device="cpu")
    step = make_train_step(RES, RES, 1, renderer="tiled")
    launches = (rt.composite_fwd_launches, rt.composite_bwd_launches, rt.composite_train_launches)
    model, m_t = step(model, torch.from_numpy(truths), cams, lrs)
    # the plain versions, on the CPU: no launch is counted
    assert (rt.composite_fwd_launches, rt.composite_bwd_launches,
            rt.composite_train_launches) == launches
    j_args = (jnp.asarray(truths), JCams(*(jnp.asarray(x.numpy()) for x in cams)),
              JLrs(*(jnp.float32(x) for x in lrs)))
    j_out = {}
    for kind, render in (("tiled", _jax_tiled(16, 2**12)),
                         ("oracle", partial(j_oracle, row_chunk=8, tile_cull=16))):
        j_step = j_make_step(RES, RES, 1, renderer=kind, render_fn=render)
        j_out[kind] = j_step(jax_model(arrays, 40), *j_args)
    (j_model, m_j), (o_model, m_o) = j_out["tiled"], j_out["oracle"]
    assert m_t.num_dup == int(m_j.num_dup) == -1
    np.testing.assert_allclose(float(m_t.loss), float(m_j.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m_t.loss), float(m_o.loss), rtol=LOSS_RTOL)
    assert_matches_jax(m_t.var_loc.numpy(), m_j.var_loc, m_o.var_loc, "var_loc")
    assert_matches_jax(m_t.avg_grad_loc.numpy(), m_j.avg_grad_loc, m_o.avg_grad_loc,
                       "avg_grad_loc")
    news = [model_arrays(m)[0] for m in (model, j_model, o_model)]
    for name, a, b, o, old in zip(GRAD_NAMES, *news, arrays):
        assert_matches_jax(a - old, b - old, o - old, name)
    assert np.abs(news[0][0] - arrays[0]).max() > 0


def test_default_tiled_render_without_runtime():
    """As in the JAX package: the bare render_tiled, with its own defaults."""
    assert _default_render("tiled", 32) is rt.render_tiled
    assert _default_render("tiled", 32, RuntimeConfig(tile_px=8)).keywords["tile"] == 8


class _Truths:
    """Truth source: one fixed image per background, whatever the camera."""

    def render(self, camera, background, samples, width, height):
        return random_truths(2, 3, width, height)[0][0 if background[0] > 0.5 else 1]


@pytest.mark.parametrize("tile,max_dup,res", [(16, 2**12, 40), (8, 2**11, 44)])
def test_trainer_takes_the_non_fused_step_with_its_runtime(monkeypatch, tile, max_dup, res):
    """A Trainer at a resolution that is not a multiple of its tile trains
    through the non-fused step, and the step's renders bin with the
    runtime's tile_px, max_dup and mip_antialias, not render_tiled's
    defaults (tile 16, max_dup 2^19, no AA)."""
    seen = []
    bin_splats_ = rt.bin_splats

    def spy(comps, width, height, tile_, max_dup_):
        seen.append((tile_, max_dup_))
        return bin_splats_(comps, width, height, tile_, max_dup_)

    monkeypatch.setattr(rt, "bin_splats", spy)
    student = SplatModel.from_numpy(*random_splats(30, 1, cap=32)[:5], count=30, device="cpu")
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                            max_dup=max_dup, mip_antialias=True)
    trainer = Trainer(_rig(), runtime, student, renderer="tiled")
    assert trainer._fused is False
    assert trainer._render_fn.keywords == dict(tile=tile, max_dup=max_dup, aa=True)
    trainer.capture_truths(_Truths())
    assert trainer.truths.shape == (4, res, res, 3)
    before = [p.detach().clone() for p in (student.means, student.opacities)]
    metrics = trainer.train()
    assert np.isfinite(float(metrics.loss)) and metrics.num_dup == -1
    assert seen == [(tile, max_dup)] * 4  # one render a frame
    assert not torch.equal(trainer.model.means, before[0])
    assert torch.isfinite(trainer.model.opacities).all()


# -- CUDA kernel (needs a card) ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_bwd_kernel_matches_plain_version(cuda_device, tile):
    """d_feat within 1e-4 of each row's largest magnitude: the two take the
    same decisions and differ only in the order of the sums over a tile's
    pixels.  Two launches are bit-equal."""
    args = _composite_inputs(tile, n=200, device=cuda_device)
    before = rt.composite_bwd_launches
    d_k = rt.composite_bwd(*args)
    d_k2 = rt.composite_bwd(*args)
    torch.cuda.synchronize()
    assert rt.composite_bwd_launches == before + 2
    assert torch.equal(d_k, d_k2)
    d_p = rt.composite_bwd_reference(*args)
    assert torch.isfinite(d_k).all() and d_p.abs().max() > 0
    scale = d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    assert float(((d_k - d_p).abs() / scale).max()) <= 1e-4


@pytest.mark.cuda
def test_render_tiled_grads_on_card_match_cpu(cuda_device):
    """At 40 x 40 (cropped tiles): the card's gradients, through K1 and K2,
    against the CPU's through the plain versions."""
    arrays = random_splats(120, 6)
    residual = np.random.default_rng(3).normal(0, 1, (40, 40, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        before = rt.composite_bwd_launches
        out[str(dev)] = _port_grads(rt.render_tiled, arrays, 40, 40, (0.1, 0.2, 0.3), residual,
                                    device=dev, tile=16, max_dup=2**13)
        assert rt.composite_bwd_launches == before + (dev != "cpu")
    g_c, g_k = out.values()
    for name, a, b in zip((*GRAD_NAMES, "background"), g_k, g_c):
        assert torch.isfinite(a).all()
        assert_rel_close(a.cpu().numpy(), b.numpy(), f"gradient {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", SYNTHETIC_SCENES)
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_bwd_kernel_edge_scenes_match_plain(cuda_device, scene, tile):
    """The footprint skip's edges on the card (splats under 2 px, one wider
    than the tile, opacities at 1/255, conics at a c = b^2): d_feat within
    1e-4 of each row's largest magnitude, two launches bit-equal."""
    feat, ts, te, tile, tx = synthetic_frame(scene, tile, cuda_device)
    out = rt.composite_fwd_reference(feat, ts, te, tile, tx)
    gin = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, tuple(out.shape))
                           .astype(np.float32)).to(cuda_device)
    args = (feat, ts, te, out, gin, tile, tx)
    d_k, d_k2 = rt.composite_bwd(*args), rt.composite_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_k2)
    d_p = rt.composite_bwd_reference(*args)
    assert torch.isfinite(d_k).all() and d_p.abs().max() > 0
    scale = d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    assert float(((d_k - d_p).abs() / scale).max()) <= 1e-4
