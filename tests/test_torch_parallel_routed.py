"""PyTorch port vs JAX package: the routed 3-axis step (parallel/routed3.py).

The port's step runs in tests/torch_parallel_runner.py's ``routed`` suite,
4 gloo ranks on a 1 x 2 x 2 (camera x tile x splat) mesh, on the runner's
step scene (24 splats in 64 slots, SH 1, 4 cameras, 64^2, tile 16: 2
bands of 2 tile rows), on both reduction routes.  Each is held against the
port's single-process fused step on its route and against JAX's
make_routed3_train_step on a 1 x 2 x 2 mesh of virtual CPU devices at caps
256 (where JAX drops nothing), at JAX's own bars for this step
(tests/test_parallel.py:302): loss rtol 1e-5, var_loc atol 5e-5,
parameters atol 1e-5.  RouteStats equal JAX's integer for integer.  The
port's step has no capacities: its exchanges are exact."""

import jax
import numpy as np
import pytest
import torch_parallel_runner as runner
from test_torch_parallel_bands import (
    FIELDS, ROUTES, _world, assert_matches, jax_fields, jax_step_inputs,
)

from gaussian_splatterer_tpu_torch.train import fused_kw_from_runtime, make_train_step

CAP = 256


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The runner's ``routed`` suite at world 4."""
    return _world(tmp_path_factory, "routed")


@pytest.fixture(scope="module")
def single():
    """The port's single-process fused step on the runner's scene, one
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


@pytest.fixture(scope="module")
def jax_routed():
    """JAX's make_routed3_train_step on a 1 x 2 x 2 mesh of virtual CPU
    devices at caps 256: (model, metrics, RouteStats)."""
    from gaussian_splatterer_tpu.parallel.mesh3 import (
        make_3d_mesh, shard_model_3d, shard_truths_3d,
    )
    from gaussian_splatterer_tpu.parallel.routed3 import make_routed3_train_step

    model, cams, tiles, lrs, runtime = jax_step_inputs()
    mesh = make_3d_mesh(1, 2, 2, devices=jax.devices()[:4])
    step = make_routed3_train_step(mesh, runner.STEP_RES, runner.STEP_RES, 1, runtime=runtime,
                                   route_cap1=CAP, route_cap2=CAP, virt_cap=CAP)
    return step(shard_model_3d(mesh, model), shard_truths_3d(mesh, tiles), cams, lrs)


def _whole(ranks):
    """The whole model and metrics from the splat shards (0, 0, s)."""
    whole = {k: np.concatenate([ranks[0][k], ranks[1][k]]) for k in (*FIELDS, "var_loc")}
    return whole, {"loss": ranks[0]["loss"], "var_loc": whole["var_loc"]}


@pytest.mark.parametrize("reduction", ROUTES)
def test_routed_step_matches_single_device_and_jax(world4, single, jax_routed, reduction):
    """Rank (0, t, s) projects 4 frames and composites 4 frames of band t
    (8 tiles) on rows [32 s, 32 s + 32); the two bands' copies of a shard
    are bit-equal, and the whole model, the loss and var_loc match the
    single-process step and JAX's routed step."""
    ranks = world4(f"routed_{reduction}")
    half = runner.STEP_CAP // 2
    assert [int(r["offset"]) for r in ranks] == [0, half, 0, half]
    assert all(int(r["frames"]) == 4 and int(r["tiles"]) == 8 and int(r["rows"]) == half
               for r in ranks)
    for s in range(2):
        for name in (*FIELDS, "var_loc", "avg_grad_loc", "loss"):
            np.testing.assert_array_equal(ranks[s][name], ranks[2 + s][name], err_msg=name)
    params, met = _whole(ranks)
    assert_matches(params, met, *single[reduction])
    assert_matches(params, met, *jax_fields(*jax_routed[:2]))
    np.testing.assert_allclose(np.concatenate([ranks[0]["avg_grad_loc"],
                                               ranks[1]["avg_grad_loc"]]),
                               np.asarray(jax_routed[1].avg_grad_loc), atol=1e-5)


def test_route_stats_equal_jax(world4, jax_routed):
    """RouteStats integer for integer: JAX's at caps 256 (nothing dropped
    there) and the port's on both routes; the collectives a step: the counts
    and rows of both hops out, the rows of both back, the gradients over
    tile (camera has one rank), the loss, and the maxima."""
    stats = jax_routed[2]
    want = [int(stats.route1_max), int(stats.route2_max), int(stats.frame_max)]
    assert 0 < max(want) <= CAP
    for reduction in ROUTES:
        ranks = world4(f"routed_{reduction}")
        for r in ranks:
            assert r["stats"].tolist() == want, reduction
            assert int(r["calls"]) == 9

