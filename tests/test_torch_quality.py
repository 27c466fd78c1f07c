"""PyTorch port vs JAX package: the quality run (scripts/quality_run.py)
and the re-evaluation of its model (scripts/eval_model.py) on the CPU at a
small size, and the built-in scenes they share with the JAX package's
scripts (scripts/scenes.py), bit for bit."""

import importlib.util
import json
import math
import os
import re

import numpy as np
import pytest

from gaussian_splatterer_tpu_torch.io.checkpoint import digest
from gaussian_splatterer_tpu_torch.scripts import eval_model, quality_run, scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_KEYS = ["steps", "steps_per_s", "final_splats", "psnr_mean", "psnr_per_view",
               "ssim_mean", "train_time_s", "schedule"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scenes_match_the_jax_quality_run():
    jq = _jax_script("quality_run")
    for name in ("CROSS_OBJ_VERTS", "CROSS_TRIS", "CROSS_UV"):
        got, want = getattr(scenes, name), getattr(jq, name)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(scenes.checker_texture(), jq.checker_texture())
    for args in ((32, 16), (12, 6)):
        t, j = scenes.mushroom_mesh(*args), jq.mushroom_mesh(*args)
        for field in ("vertices", "triangles", "tri_uv"):
            np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert scenes.mushroom_mesh(32, 16).num_triangles == 960
    for alpha in (1.0, 0.5):
        np.testing.assert_array_equal(scenes.mushroom_texture(spot_alpha=alpha),
                                      jq.mushroom_texture(spot_alpha=alpha))


def test_quality_run_flags_are_the_jax_flags():
    """Every flag of the JAX quality run parses here, and the ns_r5 command
    line of runs/README.md runs as written."""
    src = open(os.path.join(REPO, "scripts", "quality_run.py")).read()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    ours = {o for a in quality_run.parser()._actions for o in a.option_strings}
    assert jax_flags and jax_flags <= ours
    assert ours - jax_flags == {"-h", "--help", "--device"}
    readme = open(os.path.join(REPO, "runs", "README.md")).read()
    line = re.search(r"`scripts/quality_run\.py (--scene mushroom[^`]*)`", readme).group(1)
    args = quality_run.parser().parse_args(line.split())
    assert (args.res, args.capacity, args.max_dup, args.work_cap) == (1024, 262_144, 786_432,
                                                                      6144)


def test_quality_run_resumes_and_eval_model_reads_it(tmp_path, capsys):
    """The cross at 32^2, 1 sample, 2 cameras: 2 steps with a checkpoint
    every 2, then --resume to 4, then eval_model on final.npz."""
    out = str(tmp_path / "run")
    flags = ["--device", "cpu", "--scene", "cross", "--res", "32", "--samples", "1",
             "--cams", "2", "--checkpoint-every", "2", "--out", out]
    assert quality_run.main(["--steps", "2", *flags]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = digest(os.path.join(out, "ckpt", "latest.npz"))
    assert quality_run.main(["--steps", "4", "--resume", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("resumed at iteration 2; 2 steps remain")
    assert lines[1].endswith(f"sha256 {want}")
    result = json.loads(lines[-1])
    assert json.load(open(os.path.join(out, "result.json"))) == result
    for r in (first, result):
        assert list(r) == RESULT_KEYS
        assert list(r["schedule"]) == ["total_s", "capture_s", "capture_frac", "recaptures"]
        assert len(r["psnr_per_view"]) == 2  # the first 4 cameras of a 2-camera rig
        assert all(math.isfinite(x) for x in (r["psnr_mean"], r["ssim_mean"], r["steps_per_s"]))
    assert result["steps"] == 4
    assert sorted(os.listdir(out)) == ["ckpt", "final.npz", "pred.png", "result.json",
                                       "truth.png"]

    assert eval_model.main([out, "--device", "cpu", "--samples", "1", "--views", "2",
                            "--res", "32", "--scene", "cross"]) == 0
    ev = json.loads(capsys.readouterr().out.strip())
    assert list(ev) == ["splats", "eval_samples", "psnr_mean", "psnr_per_view", "ssim_mean"]
    assert ev["splats"] == result["final_splats"] and len(ev["psnr_per_view"]) == 2
    assert math.isfinite(ev["psnr_mean"]) and 0.0 < ev["ssim_mean"] <= 1.0
