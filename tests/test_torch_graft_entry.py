"""PyTorch port vs JAX package: the graft entry points
(gaussian_splatterer_tpu_torch/graft_entry.py against the repository's
__graft_entry__.py).

``_example_scene`` draws the JAX dry run's arrays bit for bit; ``entry``'s
function is the port's render_tiled, held against JAX's render_tiled
(interpret mode) with the same arguments on a small scene at the port's
raster tests' forward tolerance (atol 1e-5), with a duplicate budget that
drops nothing; ``dryrun_multichip(4, "cpu")`` runs in a subprocess over 4
gloo ranks, reaches every branch, and its DP loss lands on JAX's
single-device fused step on the same scene (rtol 1e-5).  Both entry
points run on the card unless the CPU is asked for."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatterer_tpu_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("means", "shs", "scales", "opacities", "rotations")
ATOL = 1e-5  # tests/test_torch_raster.py's forward tolerance
BRANCHES = (
    "camera-DP: ok",
    "camera x splat FSDP: ok",
    "camera x tile bands: ok",
    "camera x tile x splat: ok",
    "routed camera x tile x splat (sub-transient): ok",
    "mesh3 densify-in-loop: ok",
    "product dp loop (capture->train->densify->recapture): ok",
    "product fsdp loop (capture->train->densify->recapture): ok",
)


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n_splats,cap,n_cams,size", [(48, 128, 4, 64), (20_000, 32_768, 1, 512)])
def test_example_scene_matches_jax(n_splats, cap, n_cams, size):
    """The dry run's scene and the entry's: parameters, count, the five
    camera arrays and the truths equal JAX's bit for bit."""
    model, cams, truths = graft_entry._example_scene(n_splats, cap, n_cams, size, size)
    j_model, j_cams, j_truths = _jax_entry_module()._example_scene(n_splats, cap, n_cams, size,
                                                                   size)
    assert model.count == int(j_model.count) == n_splats and model.capacity == cap
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(j_model, name)), err_msg=name)
    for a, b in zip(cams, j_cams):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(truths.numpy(), np.asarray(j_truths))


def test_entry_matches_jax_render_tiled():
    """entry's function on a small scene (60 splats in 64 slots at 64^2)
    against JAX's render_tiled with the same arguments, the entry's max_dup
    and JAX's default tile, in interpret mode."""
    from gaussian_splatterer_tpu.ops.raster_tiled import render_tiled as j_tiled

    fn, args = graft_entry.entry("cpu", n_splats=60, capacity=64, size=64)
    got = fn(*args).numpy()
    jargs = [jnp.asarray(a.numpy()) for a in args]
    want = np.asarray(j_tiled(*jargs[:11], 64, 64, jargs[11], 1, 1.0, max_dup=2**17,
                              interpret=True))
    assert got.shape == (64, 64, 3) and np.ptp(got) > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_entry_is_the_flagship_render():
    """entry() at its defaults on the CPU: 20,000 splats in 32,768 slots,
    one 512^2 render through the plain compositor, finite and lit, its
    duplicate budget the view's whole count, past JAX's static 2^17 (which
    would drop the rest)."""
    fn, args = graft_entry.entry("cpu")
    assert args[0].shape == (32_768, 3) and int(args[5].sum()) == 20_000
    assert all(a.device.type == "cpu" for a in args)
    assert fn.max_dup == fn.num_dup > 2**17
    img = fn(*args)
    assert img.shape == (512, 512, 3) and torch.isfinite(img).all() and img.max() > 0.1


def test_entry_points_default_to_the_card():
    """entry and dryrun_multichip take the card unless asked for the CPU;
    the command line has no quiet fallback to the CPU."""
    import inspect

    for f in (graft_entry.entry, graft_entry.dryrun_multichip):
        assert inspect.signature(f).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        assert graft_entry.main([]) == 1


def _jax_dp_loss():
    """JAX's single-device fused step on the dry run's scene (4 cameras,
    float32 fused cumsums)."""
    from gaussian_splatterer_tpu.config import Project
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm
    from gaussian_splatterer_tpu.train.trainer import LearningRates, make_train_step

    res, tile = graft_entry.DRY_RES, graft_entry.DRY_TILE
    model, cams, truths = _jax_entry_module()._example_scene(
        graft_entry.DRY_SPLATS, graft_entry.DRY_CAP, 4, res, res)
    tiles = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(truths)
    step = make_train_step(res, res, 1, renderer="tiled", fused=True,
                           fused_opts=dict(tile=tile, max_dup=graft_entry.DRY_MAX_DUP,
                                           mm_bf16=False))
    return float(step(model, tiles, cams, LearningRates.from_project(Project()))[1].loss)


def test_dryrun_multichip_4_reaches_every_branch():
    """dryrun_multichip(4, "cpu") in a subprocess: exit 0, one line a branch
    in order, densify grows the model, and the DP loss equals JAX's
    single-device fused step's (rtol 1e-5)."""
    code = ("import json\n"
            "from gaussian_splatterer_tpu_torch import graft_entry\n"
            "print(json.dumps(graft_entry.dryrun_multichip(4, 'cpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    got = [line for line in lines if line.startswith("dryrun_multichip(4) ")]
    assert len(got) == len(BRANCHES)
    for line, branch in zip(got, BRANCHES):
        assert line.startswith(f"dryrun_multichip(4) {branch}"), line
    result = json.loads(lines[-1])
    assert result["device"] == "cpu" and result["backend"] == "gloo"
    assert min(result["route_stats"]) > 0
    assert result["densify"][1] > result["densify"][0]
    for name in ("fsdp", "bands", "mesh3", "routed"):
        assert abs(result[name] - result["dp"]) < graft_entry.LOSS_ATOL
    np.testing.assert_allclose(result["dp"], _jax_dp_loss(), rtol=1e-5)


def test_mesh3_shape_covers_four_ranks():
    """The 3-axis branches: JAX's (2, 2, n / 4) at multiples of 8, and the
    (1, 2, 2) mesh at 4; none at 2 or 6."""
    assert graft_entry.mesh3_shape(8) == (2, 2, 2)
    assert graft_entry.mesh3_shape(16) == (2, 2, 4)
    assert graft_entry.mesh3_shape(4) == (1, 2, 2)
    assert graft_entry.mesh3_shape(2) is None and graft_entry.mesh3_shape(6) is None
