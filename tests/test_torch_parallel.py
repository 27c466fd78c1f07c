"""PyTorch port vs JAX package: the sharded train steps (parallel/dp.py,
parallel/fsdp.py, parallel/densify.py) and the device resolver.

The port's side runs once, at world 2 (two gloo ranks on the CPU), in
tests/torch_parallel_runner.py, started by a module fixture; the JAX side
runs here on 2 of the 8 virtual CPU devices with float32 fused cumsums
(train_mm_bf16 off, the port's arithmetic).  Tolerances: the JAX package's
own for its sharded steps (tests/test_parallel.py:164-171,207-214): loss
rtol 1e-5, var_loc and parameters atol 1e-5.  The non-fused DP step is held
to the port's single-device step at atol 1e-6: the two differ in the order
of their sums only (each rank's frames summed, then the two ranks' sums,
against one running sum of each frame over 2F)."""

import os
import subprocess
import sys
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_runner as runner
from torch_parity import jax_model

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops.raster_tiled import render_tiled
from gaussian_splatterer_tpu_torch.train import CameraBatch, LearningRates, make_train_step
from gaussian_splatterer_tpu_torch.train.trainer import _resolve_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, VAR_ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
NONFUSED_ATOL = 1e-6
FIELDS = ("means", "shs", "scales", "opacities", "rotations")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The runner's ``steps`` suite at world 2: a loader of each case's two
    ranks' npz files."""
    out = tmp_path_factory.mktemp("torch_parallel_steps")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_parallel_runner.py"),
                           "steps", str(out)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]

    def load(case):
        ranks = []
        for r in range(runner.WORLDS["steps"]):
            with np.load(out / f"{case}_rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        assert not any(bool(x["jax_loaded"]) for x in ranks), "a rank imported JAX"
        return ranks

    return load


def jax_step_inputs():
    """The runner's fused step scene for the JAX package: model, cameras,
    channel-major truth tiles, learning rates and runtime."""
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
    truths = jnp.asarray(runner.step_truths(res))
    tiles = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(truths)
    runtime = JRuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                             max_dup=2**12, train_mm_bf16=False)
    return jax_model(arrays, n), cams, tiles, JLearningRates.from_project(JProject()), runtime


def assert_step_matches(port_params, port_met, j_model, j_met):
    np.testing.assert_allclose(port_met["loss"], float(j_met.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_met["var_loc"], np.asarray(j_met.var_loc), atol=VAR_ATOL)
    for name in FIELDS:
        np.testing.assert_allclose(port_params[name], np.asarray(getattr(j_model, name)),
                                   atol=PARAM_ATOL, err_msg=name)


def test_dp_step_matches_jax_sharded_step(world2):
    """The port's camera-DP step at world 2 == JAX's make_dp_train_step on
    2 devices (fused, SH degree 1); both ranks end on the same model."""
    from gaussian_splatterer_tpu.parallel.dp import (
        make_camera_mesh, make_dp_train_step, shard_truths,
    )

    ranks = world2("dp")
    assert all(bool(r["fused"]) for r in ranks)
    assert [int(r["frames"]) for r in ranks] == [runner.STEP_CAMS] * 2  # 8 frames over 2
    for name in (*FIELDS, "var_loc"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    # one all-reduce of the flat buffer and one of num_dup a step
    assert [int(r["calls"]) for r in ranks] == [2, 2]
    model, cams, tiles, lrs, runtime = jax_step_inputs()
    mesh = make_camera_mesh(jax.devices()[:2])
    step = make_dp_train_step(mesh, runner.STEP_RES, runner.STEP_RES, 1, renderer="tiled",
                              runtime=runtime)
    j_model, j_met = step(model, shard_truths(mesh, tiles), cams, lrs)
    assert_step_matches(ranks[0], ranks[0], j_model, j_met)
    assert int(ranks[0]["num_dup"]) > 0


def test_fsdp_step_matches_jax_sharded_step(world2):
    """The port's splat-sharded step on a 1 x 2 mesh == JAX's
    make_fsdp_train_step on the same mesh: each rank holds capacity / 2
    rows, and its rows and var_loc are JAX's rows of the whole."""
    from gaussian_splatterer_tpu.parallel.fsdp import (
        make_2d_mesh, make_fsdp_train_step, shard_model, shard_truths_2d,
    )

    ranks = world2("fsdp")
    half = runner.STEP_CAP // 2
    assert [int(r["rows"]) for r in ranks] == [half, half]
    assert [int(r["offset"]) for r in ranks] == [0, half]
    assert all(r["means"].shape == (half, 3) and r["var_loc"].shape == (half,) for r in ranks)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    whole = {k: np.concatenate([r[k] for r in ranks]) for k in (*FIELDS, "var_loc")}
    model, cams, tiles, lrs, runtime = jax_step_inputs()
    mesh = make_2d_mesh(1, 2, jax.devices()[:2])
    step = make_fsdp_train_step(mesh, runner.STEP_RES, runner.STEP_RES, 1, renderer="tiled",
                                runtime=runtime)
    j_model, j_met = step(shard_model(mesh, model), shard_truths_2d(mesh, tiles), cams, lrs)
    assert_step_matches(whole, {"loss": ranks[0]["loss"], "var_loc": whole["var_loc"]},
                        j_model, j_met)


def test_densify_sharded_equals_densify_of_the_gathered_arrays(world2):
    """gather -> densify -> re-shard == densify on the gathered model and
    signals, bit for bit; the ranks keep capacity / 2 rows."""
    ranks = world2("densify")
    for r in ranks:
        assert int(r["count"]) == int(r["want_count"])
        assert int(r["rows"]) == runner.STEP_CAP // 2
        for name in FIELDS:
            np.testing.assert_array_equal(r[f"got_{name}"], r[f"want_{name}"], err_msg=name)
    assert int(ranks[0]["count"]) != runner.STEP_N  # densify changed the model


def test_nonfused_dp_step_matches_the_single_device_step(world2):
    """A DP step that cannot be fused (40 x 40 at tile 16: render_tiled under
    autograd, frame by frame) == the port's single-device step."""
    ranks = world2("nonfused")
    assert not any(bool(r["fused"]) for r in ranks)
    res = runner.NONFUSED_RES
    arrays, n = runner.step_arrays()
    model = SplatModel.from_numpy(*arrays, count=n, device="cpu")
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res,
                            tile_px=runner.STEP_TILE, max_dup=2**12)
    step = make_train_step(res, res, 1, renderer="tiled",
                           render_fn=partial(render_tiled, tile=runtime.tile_px,
                                             max_dup=runtime.max_dup, aa=False))
    cams = CameraBatch.from_cameras(Camera.get_cameras(runner.port_rig(runner.STEP_CAMS)), res,
                                    res, device="cpu")
    model, met = step(model, torch.from_numpy(runner.step_truths(res)), cams,
                      LearningRates.from_project(Project()))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(met.loss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["var_loc"], met.var_loc.numpy(), atol=NONFUSED_ATOL)
        for name in FIELDS:
            np.testing.assert_allclose(r[name], getattr(model, name).detach().numpy(),
                                       atol=NONFUSED_ATOL, err_msg=name)


def test_resolver_shrinks_to_a_frame_divisor_and_refuses_missing_cards():
    """JAX's Trainer._resolve_devices as a pure function: 5 devices cannot
    split 8 frames and shrink to 4 with JAX's warning; 1 (or 0) is one
    device; on cuda more ranks than cards raises, naming both numbers."""
    with pytest.warns(UserWarning, match="not divisible by 5 devices; training on 4"):
        assert _resolve_devices(5, 8) == 4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _resolve_devices(4, 8) == 4
        assert _resolve_devices(0, 8) == _resolve_devices(1, 8) == 1
        assert _resolve_devices(2, 8, "cuda", device_count=2) == 2
    with pytest.raises(RuntimeError, match="train_devices=3 but only 1 devices"):
        _resolve_devices(3, 8, "cuda", device_count=1)
