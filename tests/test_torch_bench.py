"""PyTorch port vs JAX package: the headline bench (scripts/bench.py) and
its scaling rows (scripts/bench_scale.py) on the CPU, at small sizes.

The bench scene is the JAX bench's bit for bit.  The gates run as the
card runs them, the device's path here being the kernels' plain versions
on the CPU.  The timed call's loss and gradients are held to JAX's
render_train_grads_batch in interpret mode with float32 cumsums at the
tolerances of tests/test_torch_train.py (loss rtol 1e-5; gradients and
var_loc 5e-5 of the largest)."""

import importlib
import json
import math
import os

import numpy as np
import pytest

from gaussian_splatterer_tpu_torch.scripts import bench, bench_scale, scenes

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "numerics_gate_max_err",
              "grad_gate_max_err"]
SMALL = ["--device", "cpu", "--splats", "500", "--capacity", "512", "--res", "64", "--frames",
         "2", "--reps", "1", "--max-dup", "4096"]


def _jax_bench(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.environ.get("JAX_COMPILATION_CACHE_DIR", str(tmp_path)))
    return importlib.import_module("bench")


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_bench_scene_matches_jax_bit_for_bit(monkeypatch, tmp_path, seed):
    jbench = _jax_bench(monkeypatch, tmp_path)
    j = jbench.build_scene(300, 512, 96, 64, 3, seed=seed)
    t = scenes.build_scene(300, 512, 96, 64, 3, seed=seed)
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    for a, b in zip(t[1:7], j[1:7]):  # active, views, proj_views, positions, tangents
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    for tc, jc in zip(t[7], j[7]):
        np.testing.assert_array_equal(tc.get_view(), jc.get_view())
        np.testing.assert_array_equal(tc.get_proj_view(1.0), jc.get_proj_view(1.0))
        assert tc.tan_fov(96, 64, train=True) == jc.tan_fov(96, 64, train=True)


@pytest.mark.parametrize("gate,bar", [("numerics_gate", bench.NUMERICS_ATOL),
                                      ("grad_gate", bench.GRAD_GATE_RTOL)])
def test_gates_pass_on_cpu(gate, bar):
    err = getattr(bench, gate)("cpu")
    assert 0.0 <= err < bar


def test_failed_gate_exits_with_the_reason(monkeypatch):
    monkeypatch.setattr(bench, "GRAD_GATE_RTOL", 0.0)
    with pytest.raises(SystemExit, match="CPU grad gate FAILED: .* gradient deviation"):
        bench.grad_gate("cpu")


def test_headline_prints_one_json_line(capsys):
    assert bench.main(SMALL) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert list(head) == BENCH_KEYS
    assert head["metric"] == "fwd+bwd rasterize ms/frame (500 splats, 64x64)"
    assert head["unit"] == "ms/frame" and math.isfinite(head["value"]) and head["value"] > 0
    assert head["vs_baseline"] == round(bench.REFERENCE_FRAME_BUDGET_MS / head["value"], 4)
    assert head["numerics_gate_max_err"] < bench.NUMERICS_ATOL
    assert head["grad_gate_max_err"] < bench.GRAD_GATE_RTOL
    # on the CPU the plain versions run: no kernel launch is counted
    assert json.loads(captured.err.strip().splitlines()[-1]) == {"launches": {
        "composite_fwd": 0, "composite_train": 0, "composite_bwd": 0, "cumsum_frames": 0,
        "mt_intersect": 0, "mt_culled": 0}}


def test_headline_call_matches_jax():
    """The timed call of ``main(SMALL + ["--tile", "16"])`` (500 splats,
    capacity 512, 64^2, 2 frames, max_dup 4096) against JAX's.  Tile 16,
    as tests/test_torch_train.py holds the fused call: at tile 32 the JAX
    side's tile-local moment products sit up to 8e-5 of the largest scale
    and rotation gradient off a float64 oracle."""
    import jax
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_batch as j_batch
    from test_torch_train import GRAD_NAMES, LOSS_RTOL, assert_rel_close
    from torch_parity import to_jax

    tile = 16
    inputs = bench.headline_inputs("cpu", 500, 512, 64, 2, tile)
    loss_t, g_t, var_t, _, nd_t, _ = bench.fwdbwd(inputs, 64, tile, 4096)

    params, active, views, pvs, poss, txs, tys, _ = scenes.build_scene(
        500, 512, 64, 64, 2)
    truths = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    tt = jax.vmap(lambda im: image_to_tiles_cm(im, tile))(to_jax([truths])[0])
    loss_j, g_j, var_j, _, nd_j, _ = j_batch(
        *to_jax(params), *to_jax([active, views, pvs, poss, txs, tys]), 64, 64, tt,
        to_jax([np.zeros((2, 3), np.float32)])[0], 1, tile=tile, max_dup=4096,
        interpret=True, mm_bf16=False)
    assert nd_t == int(nd_j) <= 4096
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    for name, a, b in zip(GRAD_NAMES, g_t, g_j):
        assert_rel_close(a.numpy(), b, f"gradient {name}")
    assert_rel_close(var_t.numpy(), var_j, "var_loc")


def test_bench_scale_sizes_max_dup_from_a_probe(capsys):
    assert bench_scale.main(["--device", "cpu", "--sizes", "800", "--res", "64", "--frames",
                             "2", "--reps", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    assert list(row) == ["n_splats", "capacity", "ms_per_frame", "num_dup", "max_dup",
                         "frame_group", "peak_mib", "densify_ms"]
    assert row["n_splats"] == 800 and row["capacity"] == 65_536 and row["frame_group"] == 2
    assert row["max_dup"] == bench.sized_max_dup(row["num_dup"])
    assert row["max_dup"] % bench.DUP_CHUNK == 0 and row["max_dup"] >= 1.25 * row["num_dup"]
    assert math.isfinite(row["ms_per_frame"]) and row["peak_mib"] is None
    # the probe counts what the scene makes: the shrunk scales of 800 splats
    inputs = bench.headline_inputs("cpu", 800, 65_536, 64, 2, bench.TILE,
                                   shrink=math.sqrt(50_000 / 800))
    assert bench.probe_num_dup(inputs, 64, bench.TILE) == row["num_dup"]
