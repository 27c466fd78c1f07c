"""PyTorch port vs JAX package: band-parallel training (parallel/tp.py),
the 3-axis step (parallel/mesh3.py), the fused core's ``band=`` and
``frame_loc_grads=``, sharded checkpoints, ``sh_to_rgb``,
``render_oracle_model`` and the capture split over one process's devices.

The port's sharded steps run in tests/torch_parallel_runner.py, started
once a world size by a module fixture: ``bands`` at world 2 (the tp step on
a 1 x 2 camera x tile mesh, both reduction routes, and the sharded
checkpoint round trip) and ``bands3d`` at world 4 (the 3-axis step on a
1 x 2 x 2 camera x tile x splat mesh, both routes).  The scene is the
runner's step scene: 24 splats in 64 slots, SH 1, 4 cameras, 64^2, tile 16,
so 4 tile rows and 2 bands of 2.  Each step is held against the port's
single-device fused step on the same route and against JAX's sharded step
on virtual CPU devices, at the JAX package's tolerances for these steps
(tests/test_parallel.py:245-256, 290-299): loss rtol 1e-5, var_loc atol
5e-5 (the band sums reassociate), parameters atol 1e-5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_runner as runner
from torch_parity import camera_stack, jax_model, random_splats, random_truths, to_jax

from gaussian_splatterer_tpu_torch import parallel
from gaussian_splatterer_tpu_torch.app.session import Session
from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.io.checkpoint import load_checkpoint, load_checkpoint_sharded
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle_model
from gaussian_splatterer_tpu_torch.ops.transforms import sh_to_rgb
from gaussian_splatterer_tpu_torch.parallel import capture_images_local, frame_seed
from gaussian_splatterer_tpu_torch.train import fused_kw_from_runtime, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, VAR_ATOL, PARAM_ATOL = 1e-5, 5e-5, 1e-5
FIELDS = ("means", "shs", "scales", "opacities", "rotations")
ROUTES = ("index_add", "cumsum")


def _world(tmp_path_factory, suite):
    out = tmp_path_factory.mktemp(f"torch_parallel_{suite}")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_parallel_runner.py"),
                           suite, str(out)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]

    def load(case):
        ranks = []
        for r in range(runner.WORLDS[suite]):
            with np.load(out / f"{case}_rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        assert not any(bool(x["jax_loaded"]) for x in ranks), "a rank imported JAX"
        return ranks

    load.out = out
    return load


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The runner's ``bands`` suite at world 2."""
    return _world(tmp_path_factory, "bands")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The runner's ``bands3d`` suite at world 4."""
    return _world(tmp_path_factory, "bands3d")


@pytest.fixture(scope="module")
def single():
    """The port's single-device fused step on the runner's scene, one
    (model arrays, metrics) a reduction route."""
    out = {}
    for reduction in ROUTES:
        model, cams, tiles, lrs, runtime = runner._step_scene()
        res = runner.STEP_RES
        step = make_train_step(res, res, 1, renderer="tiled", fused=True,
                               fused_opts=dict(fused_kw_from_runtime(runtime),
                                               reduction=reduction))
        m, met = step(model(), tiles, cams, lrs)
        out[reduction] = ({k: getattr(m, k).detach().numpy() for k in FIELDS},
                          {"loss": float(met.loss), "var_loc": met.var_loc.numpy()})
    return out


def jax_step_inputs():
    """The runner's step scene for the JAX package (channel-major tiles,
    float32 fused cumsums)."""
    from gaussian_splatterer_tpu.config import Project as JProject
    from gaussian_splatterer_tpu.config import RuntimeConfig as JRuntimeConfig
    from gaussian_splatterer_tpu.models.camera import Camera as JCamera
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm
    from gaussian_splatterer_tpu.train.trainer import CameraBatch as JCameraBatch
    from gaussian_splatterer_tpu.train.trainer import LearningRates as JLearningRates

    res, tile = runner.STEP_RES, runner.STEP_TILE
    arrays, n = runner.step_arrays()
    rig = JProject.from_json(runner.port_rig(runner.STEP_CAMS).to_json())
    cams = JCameraBatch.from_cameras(JCamera.get_cameras(rig), res, res)
    tiles = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(jnp.asarray(runner.step_truths(res)))
    runtime = JRuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                             max_dup=2**12, train_mm_bf16=False)
    return jax_model(arrays, n), cams, tiles, JLearningRates.from_project(JProject()), runtime


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's make_tp_train_step on a 1 x 2 mesh of virtual CPU devices."""
    from gaussian_splatterer_tpu.parallel.tp import (
        make_tile_mesh, make_tp_train_step, shard_truths_tp,
    )

    model, cams, tiles, lrs, runtime = jax_step_inputs()
    mesh = make_tile_mesh(1, 2, devices=jax.devices()[:2])
    step = make_tp_train_step(mesh, runner.STEP_RES, runner.STEP_RES, 1, runtime=runtime)
    return step(model, shard_truths_tp(mesh, tiles), cams, lrs)


@pytest.fixture(scope="module")
def jax_3d():
    """JAX's make_3d_train_step on a 1 x 2 x 2 mesh of virtual CPU devices."""
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh, make_3d_train_step, shard_model_3d, shard_truths_3d,
    )

    model, cams, tiles, lrs, runtime = jax_step_inputs()
    mesh = make_3d_mesh(1, 2, 2, devices=jax.devices()[:4])
    step = make_3d_train_step(mesh, runner.STEP_RES, runner.STEP_RES, 1, runtime=runtime)
    return step(shard_model_3d(mesh, model), shard_truths_3d(mesh, tiles), cams, lrs)


def assert_matches(params, met, want_params, want_met):
    np.testing.assert_allclose(met["loss"], float(want_met["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["var_loc"], np.asarray(want_met["var_loc"]), atol=VAR_ATOL)
    for name in FIELDS:
        np.testing.assert_allclose(params[name], np.asarray(want_params[name]),
                                   atol=PARAM_ATOL, err_msg=name)


def jax_fields(j_model, j_met):
    return ({k: np.asarray(getattr(j_model, k)) for k in FIELDS},
            {"loss": float(j_met.loss), "var_loc": np.asarray(j_met.var_loc)})


@pytest.mark.parametrize("reduction", ROUTES)
def test_tp_step_matches_single_device_and_jax(world2, single, jax_tp, reduction):
    """The band step on a 1 x 2 mesh: each rank holds 8 frames and 8 of the
    16 tiles (2 of the 4 tile rows), the replicated copies stay bit-equal,
    and model, loss and var_loc match the single-device step and JAX's
    make_tp_train_step."""
    ranks = world2(f"tp_{reduction}")
    assert [(int(r["frames"]), int(r["tiles"])) for r in ranks] == [(8, 8)] * 2
    for name in (*FIELDS, "var_loc", "loss"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    # one frame group of 8 (one all-reduce of its location gradients), then
    # the camera sums, the other sums over both axes and num_dup's max
    assert [int(r["calls"]) for r in ranks] == [4, 4]
    assert int(ranks[0]["num_dup"]) > 0
    assert_matches(ranks[0], ranks[0], *single[reduction])
    assert_matches(ranks[0], ranks[0], *jax_fields(*jax_tp))


@pytest.mark.parametrize("reduction", ROUTES)
def test_mesh3_step_matches_single_device_and_jax(world4, single, jax_3d, reduction):
    """The 3-axis step on a 1 x 2 x 2 mesh: rank (0, t, s) holds 4 frames,
    band t's 8 tiles and rows [32 s, 32 s + 32); the two bands' copies of a
    shard are bit-equal, and the whole model matches the single-device step
    and JAX's make_3d_train_step."""
    ranks = world4(f"mesh3_{reduction}")
    half = runner.STEP_CAP // 2
    assert [int(r["offset"]) for r in ranks] == [0, half, 0, half]
    assert all(int(r["frames"]) == 4 and int(r["tiles"]) == 8 and int(r["rows"]) == half
               for r in ranks)
    for s in range(2):
        for name in (*FIELDS, "var_loc", "loss"):
            np.testing.assert_array_equal(ranks[s][name], ranks[2 + s][name], err_msg=name)
    whole = {k: np.concatenate([ranks[0][k], ranks[1][k]]) for k in (*FIELDS, "var_loc")}
    met = {"loss": ranks[0]["loss"], "var_loc": whole["var_loc"]}
    assert_matches(whole, met, *single[reduction])
    assert_matches(whole, met, *jax_fields(*jax_3d))


def _band_inputs(frames=2, tile=16, n=40, seed=31):
    arrays = random_splats(n, seed)
    cams = camera_stack(frames)
    truths, bgs = random_truths(frames, 5)
    return arrays, cams, truths, bgs, tile


def _before(means, shs, scales, opacities, rotations, active, views, proj_views, cam_posns,
            tan_fovxs, tan_fovys, width, height, truth_tiles, backgrounds, sh_degree, *,
            tile, max_dup, reduction):
    """render_train_grads_batch as it was before ``band=``: the reference
    for band=None."""
    f = len(views)
    leaves = [means.detach().expand(f, -1, -1).clone()] + [
        x.detach() for x in (shs, scales, opacities, rotations)]
    for x in leaves:
        x.requires_grad_(True)
    with torch.enable_grad():
        comps, rows9 = rt.project_frames(*leaves, active, views, proj_views, cam_posns,
                                         tan_fovxs, tan_fovys, width, height, sh_degree)
    loss_sum, d_rows9, res, num_dup = rt._train_core(
        rows9.detach(), comps, width, height, truth_tiles, backgrounds, tile, max_dup,
        reduction)
    d_means_b, *grads = torch.autograd.grad(rows9, leaves, d_rows9)
    var_loc = torch.sqrt(torch.sum(torch.square(d_means_b), dim=-1)).sum(0)
    return loss_sum, (d_means_b.sum(0), *grads), var_loc, res, num_dup, -1


@pytest.mark.parametrize("reduction", ROUTES)
def test_band_none_is_bit_equal_to_the_step_before_bands(reduction):
    """band=None gives what the core gave before bands, bit for bit, and so
    does the whole image as one band; frame_loc_grads returns the per-frame
    location gradients whose norms sum to var_loc."""
    from torch_parity import to_torch

    arrays, cams, truths, bgs, tile = _band_inputs()
    args = (*to_torch(arrays), *(torch.from_numpy(np.asarray(c)) for c in cams),
            64, 64, rt.image_to_tiles(torch.from_numpy(truths), tile), torch.from_numpy(bgs), 1)
    kw = dict(tile=tile, max_dup=2**12, reduction=reduction)
    want = _before(*args, **kw)
    for got in (rt.render_train_grads_batch(*args, **kw),
                rt.render_train_grads_batch(*args, band=(0, 64), **kw)):
        for a, b in zip(got[:4], want[:4]):
            for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
        assert got[4] == want[4]
    d = rt.render_train_grads_batch(*args, frame_loc_grads=True, **kw)[2]
    assert d.shape == (2, 40, 3)
    assert torch.equal(rt.loc_norm_sum(d), want[2])


@pytest.mark.parametrize("band", [(16, 32), (48, 16)])
def test_band_batch_matches_jax(band):
    """One band of 2 frames, frame_loc_grads on, against JAX's
    render_train_grads_batch with the same band (interpret mode, float32
    cumsums): loss, the five gradients, the per-frame location gradients,
    residuals and num_dup; a band whose height is not a multiple of the
    tile raises."""
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_batch as j_batch
    from torch_parity import to_torch

    arrays, cams, truths, bgs, tile = _band_inputs()
    y0, bh = band
    rows = slice(y0 // tile * 4, (y0 + bh) // tile * 4)  # 4 tiles a row at 64 px
    t_tiles = rt.image_to_tiles(torch.from_numpy(truths), tile)[:, rows].contiguous()
    loss_t, g_t, d_t, res_t, nd_t, _ = rt.render_train_grads_batch(
        *to_torch(arrays), *(torch.from_numpy(np.asarray(c)) for c in cams), 64, 64, t_tiles,
        torch.from_numpy(bgs), 1, tile=tile, max_dup=2**12, band=band, frame_loc_grads=True,
        reduction="cumsum")
    j_tiles = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(jnp.asarray(truths))[:, rows]
    loss_j, g_j, d_j, res_j, nd_j = j_batch(
        *to_jax(arrays), *to_jax(cams), 64, 64, j_tiles, jnp.asarray(bgs), 1, tile=tile,
        max_dup=2**12, interpret=True, mm_bf16=False, band=band, frame_loc_grads=True)[:5]
    assert nd_t == int(nd_j) > 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert d_t.shape == np.asarray(d_j).shape == (2, 40, 3)
    for name, a, b in (*zip(FIELDS, g_t, g_j), ("frame_loc_grads", d_t, d_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4 * max(np.abs(b).max(), 1e-6),
                                   err_msg=name)
    res_j = np.moveaxis(np.asarray(res_j), 2, 3)[..., :4]  # (F, T, P, 8) -> rgb, T_final
    np.testing.assert_allclose(res_t.numpy(), res_j, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of the tile"):
        rt.render_train_grads_batch(
            *to_torch(arrays), *(torch.from_numpy(np.asarray(c)) for c in cams), 64, 64,
            t_tiles, torch.from_numpy(bgs), 1, tile=tile, band=(0, 24))


def test_sharded_checkpoint_round_trip(world2):
    """Each rank's FSDP rows come back bit for bit into a shard of other
    values (with the project); a load with no process group gives the whole
    model, equal to the npz checkpoint of the gathered model."""
    ranks = world2("ckpt")
    half = runner.STEP_CAP // 2
    for r, x in enumerate(ranks):
        assert int(x["offset"]) == int(x["back_offset"]) == r * half
        assert int(x["count"]) == runner.STEP_N and int(x["iterations"]) == 17
        for name in FIELDS:
            np.testing.assert_array_equal(x[f"back_{name}"], x[f"saved_{name}"], err_msg=name)
    model, project = load_checkpoint_sharded(str(world2.out / "ckpt_sharded"), device="cpu")
    want, want_project = load_checkpoint(str(world2.out / "ckpt_gathered.npz"), device="cpu")
    assert model.count == want.count and model.sh_degree == want.sh_degree
    assert project.to_json() == want_project.to_json()
    for name in FIELDS:
        assert torch.equal(getattr(model, name), getattr(want, name)), name


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb_matches_jax(degree):
    """Random coefficients and unit directions, every degree, the clamp at
    zero included."""
    from gaussian_splatterer_tpu.ops.transforms import sh_to_rgb as j_sh_to_rgb

    rng = np.random.default_rng(degree)
    shs = rng.normal(0, 1.0, (64, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = sh_to_rgb(torch.from_numpy(shs), torch.from_numpy(dirs), degree).numpy()
    want = np.asarray(j_sh_to_rgb(jnp.asarray(shs), jnp.asarray(dirs), degree))
    assert (got == 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_render_oracle_model_matches_jax():
    """A 20-splat model with capacity padding, one camera, 32 x 32, against
    JAX's render_oracle_model."""
    from gaussian_splatterer_tpu.models.camera import Camera as JCamera
    from gaussian_splatterer_tpu.ops.raster_reference import render_oracle_model as j_oracle

    arrays = random_splats(20, 3, cap=24)
    model = SplatModel.from_numpy(*arrays[:5], count=20, device="cpu")
    loc, tgt = np.array([0.3, -0.2, -8.0], np.float32), np.zeros(3, np.float32)
    got = render_oracle_model(model, Camera(loc, tgt, 60.0), 32, 32, [0.1, 0.2, 0.3],
                              row_chunk=16).numpy()
    want = np.asarray(j_oracle(jax_model(arrays, 20), JCamera(loc, tgt, 60.0), 32, 32,
                               jnp.asarray([0.1, 0.2, 0.3]), row_chunk=16))
    assert got.shape == (32, 32, 3) and np.ptp(got) > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


def _serial(host, cameras, samples, res, seed):
    c = len(cameras)
    return torch.stack([host.render(cameras[i % c], (1.0,) * 3 if i < c else (0.0,) * 3,
                                    samples, res, res, seed=frame_seed(seed, i))
                        for i in range(2 * c)])


@pytest.mark.parametrize("k", [1, 3, 4])
def test_local_capture_split_is_bit_equal_to_serial(k):
    """The 4 frames of 2 cameras over k CPU devices (renderers: the largest
    divisor of 4 no more than k, so 1, 2 and 4) equal serial renders seeded
    frame_seed(seed, i), whites then blacks."""
    host = runner.port_capture_host()
    cameras = runner.port_capture_cameras()
    res, samples, seed = runner.CAPTURE_RES, runner.CAPTURE_SAMPLES, runner.CAPTURE_SEED
    want = _serial(host, cameras, samples, res, seed)
    got = capture_images_local(host, cameras, samples, res, res, [torch.device("cpu")] * k,
                               seed=seed)
    assert not torch.equal(want[0], want[1]) and want.max() > 0
    assert torch.equal(got, want)
    assert host.replica("cpu") is host


def test_session_capture_without_a_group_splits_over_local_devices(monkeypatch):
    """capture_data_parallel and no process group: Session.capture takes the
    local split over the process's devices (here two CPU devices in place of
    two cards), bit-equal to serial renders of the capture's seed; without
    capture_data_parallel it renders serially."""
    calls = []
    real = parallel.capture_images_local

    def spy(*args, **kw):
        calls.append(len(args[5]))
        return real(*args, **kw)

    monkeypatch.setattr(parallel, "local_devices", lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setattr(parallel, "capture_images_local", spy)
    res = runner.CAPTURE_RES
    for dp in (True, False):
        runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=16,
                                splats_capacity=64, capture_data_parallel=dp)
        session = Session(project=runner.port_rig(2), runtime=runtime, device="cpu")
        session.project.rtSamples = runner.CAPTURE_SAMPLES
        session.rtx = runner.port_capture_host()
        assert parallel.world_size() == 1
        session.capture()
        if dp:
            want = _serial(runner.port_capture_host(), Camera.get_cameras(session.project),
                           runner.CAPTURE_SAMPLES, res, 1)
            assert torch.equal(session.trainer.truths, rt.image_to_tiles(want, 16))
    assert calls == [2]
