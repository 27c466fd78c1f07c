"""PyTorch port vs JAX package: SSIM, npz checkpoints across the two
packages, the watch page, and the long-run entry points of the session
and the CLI (checkpoints, resume, snapshots, the watch page) on the CPU.

Tolerances: SSIM within 1e-5 absolute of JAX's (both sum float32
products; the orders differ); checkpoints and the watch page exactly."""

import argparse
import json
import os
import random

import numpy as np
import pytest
import torch
from torch_parity import jax_model, model_arrays, random_splats

from gaussian_splatterer_tpu import config as jcfg
from gaussian_splatterer_tpu.io import checkpoint as jck
from gaussian_splatterer_tpu.io import watch as jwatch
from gaussian_splatterer_tpu_torch import config as tcfg
from gaussian_splatterer_tpu_torch.io import checkpoint as tck
from gaussian_splatterer_tpu_torch.io import watch as twatch
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.utils import metrics as tm

FIELDS = ("means", "shs", "scales", "opacities", "rotations")


def _image_pair(case):
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (37, 45, 3)).astype(np.float32)
    if case == "random":
        return a, rng.uniform(0, 1, a.shape).astype(np.float32)
    if case == "identical":
        return a, a.copy()
    # a smooth image and a blurred, noisier copy of it
    yy, xx = np.mgrid[0:37, 0:45] / 9.0
    s = (0.5 + 0.4 * np.sin(xx[..., None] + np.array([0.0, 1.0, 2.0])) * np.cos(yy[..., None]))
    s = s.astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    b = s.copy()
    for ax in (0, 1):
        b = sum(w * np.roll(b, sh, axis=ax) for w, sh in zip(k, (-1, 0, 1)))
    b = np.clip(b + rng.normal(0, 0.02, b.shape), 0, 1).astype(np.float32)
    return s, b


@pytest.mark.parametrize("case", ["random", "blurred", "identical"])
def test_ssim_matches_jax(case):
    from gaussian_splatterer_tpu.utils import metrics as jm

    a, b = _image_pair(case)
    got = float(tm.ssim(torch.from_numpy(a), b))
    want = float(jm.ssim(a, b))
    assert abs(got - want) <= 1e-5, (got, want)
    if case == "identical":
        assert got == pytest.approx(1.0, abs=1e-6)
    if case == "blurred":
        assert 0.5 < got < 0.999


def _project(mod):
    p = mod.Project.app_default()
    p.iterations, p.lrLocation, p.sphere1.count, p.previewTimer = 1234, 42e-6, 5, 3.25
    return p


def _files(tmp_path, with_project):
    """The same model and project written by each package: (jax path,
    port path, the arrays, count)."""
    arrays = random_splats(41, 3, cap=64, sh_coeffs=16)[:5]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_checkpoint(jpath, jax_model(arrays, 41, sh_degree=3),
                        _project(jcfg) if with_project else None)
    tck.save_checkpoint(tpath, SplatModel.from_numpy(*arrays, count=41, device="cpu"),
                        _project(tcfg) if with_project else None)
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]  # no .tmp left
    return jpath, tpath, arrays


@pytest.mark.parametrize("with_project", [True, False])
def test_jax_checkpoint_loads_in_port(tmp_path, with_project):
    jpath, _, arrays = _files(tmp_path, with_project)
    model, project = tck.load_checkpoint(jpath, device="cpu")
    got, count = model_arrays(model)
    for name, a, b in zip(FIELDS, got, arrays):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (count, model.sh_degree, model.capacity) == (41, 3, 64)
    if with_project:
        assert project.to_json() == _project(tcfg).to_json()
        assert project.iterations == 1234 and project.previewTimer == 3.25
    else:
        assert project is None


@pytest.mark.parametrize("with_project", [True, False])
def test_port_checkpoint_loads_in_jax(tmp_path, with_project):
    _, tpath, arrays = _files(tmp_path, with_project)
    model, project = jck.load_checkpoint(tpath)
    got, count = model_arrays(model)
    for name, a, b in zip(FIELDS, got, arrays):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (count, model.sh_degree) == (41, 3)
    if with_project:
        assert project.to_json() == _project(jcfg).to_json()
    else:
        assert project is None


def test_checkpoint_files_have_the_same_layout(tmp_path):
    jpath, tpath, _ = _files(tmp_path, True)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        for key in j.files:
            assert (j[key].dtype, j[key].shape) == (t[key].dtype, t[key].shape), key
            np.testing.assert_array_equal(j[key], t[key], err_msg=key)
        assert t["count"].shape == () and t["count"].dtype == np.int32
    assert tck.digest(tpath) == tck.digest(jpath)
    assert tck.digest(tck.load_checkpoint(jpath, device="cpu")[0]) == tck.digest(jpath)


def test_newer_checkpoint_format_is_refused(tmp_path):
    _, tpath, _ = _files(tmp_path, False)
    with np.load(tpath) as z:
        payload = {k: z[k] for k in z.files}
    payload["format_version"] = np.int32(tck.FORMAT_VERSION + 1)
    newer = str(tmp_path / "newer.npz")
    np.savez(newer, **payload)
    with pytest.raises(ValueError, match="newer than supported"):
        tck.load_checkpoint(newer, device="cpu")


def test_watch_page_bytes_match_jax(tmp_path):
    status = {"iteration": 40, "loss": "0.012345", "splats": "812 / 4096",
              "steps/s": "3.21", "elapsed": "12s", "devices": 1, "note": "<b>&"}
    history = [{"it": 5 * i, "loss": round(0.1 / (i + 1), 6), "splats": 100 + i}
               for i in range(15)]
    for mod, name in ((jwatch, "jax"), (twatch, "port")):
        mod.write_watch_page(str(tmp_path / name), status, history, refresh_s=3.0)
    for f in ("index.html", "status.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert sorted(os.listdir(tmp_path / "port")) == ["index.html", "status.json"]


def _tiny_scene(tmp_path):
    """A tent of two triangles and a 2x2 PNG texture."""
    from gaussian_splatterer_tpu_torch.io.image import save_png

    (tmp_path / "tent.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 0 1 0.6\nv 0 -0.2 -0.8\nvt 0 0\nvt 1 0\nvt 0.5 1\n"
        "f 1/1 2/2 3/3\nf 1/1 4/3 2/2\n")
    save_png(np.array([[[0.8, 0.2, 0.1], [0.1, 0.8, 0.2]], [[0.2, 0.1, 0.8], [0.9, 0.9, 0.9]]],
                      np.float32), str(tmp_path / "tent.png"))
    return str(tmp_path / "tent.obj"), str(tmp_path / "tent.png")


def test_cli_checkpoints_resumes_snapshots_and_watches_on_cpu(tmp_path, capsys):
    """new -> train --steps 4 (checkpoint, snapshot and watch page every 2)
    -> train --steps 2 --resume: the second run starts at iteration 4 from
    the checkpoint and ends at 6."""
    from gaussian_splatterer_tpu_torch.app import cli

    obj, png = _tiny_scene(tmp_path)
    proj = str(tmp_path / "proj")
    flags = ["--resolution", "32", "--capacity", "64", "--device", "cpu"]
    assert cli.main(["new", proj, "--obj", obj, "--texture", png, "--init-field", "model",
                     *flags]) == 0
    p = tcfg.Project.load(os.path.join(proj, "settings.json"))
    p.sphere1.count, p.rtSamples, p.intervalCapture = 2, 1, 3
    p.save(os.path.join(proj, "settings.json"))
    capsys.readouterr()
    assert cli.main(["train", proj, "--steps", "4", "--checkpoint-every", "2",
                     "--snapshot-every", "2", "--watch", "--watch-every", "2", *flags]) == 0
    out = capsys.readouterr().out
    assert "watch: open file://" in out
    ckpt = os.path.join(proj, "checkpoints", "latest.npz")
    assert sorted(os.listdir(os.path.join(proj, "snapshots"))) == [
        "iter_000002.png", "iter_000004.png"]
    assert sorted(os.listdir(os.path.join(proj, "watch"))) == [
        "index.html", "latest.png", "status.json"]
    status = json.loads((tmp_path / "proj" / "watch" / "status.json").read_text())
    assert status["iteration"] == 4 and status["devices"] == 1
    assert "latest.png?it=4" in (tmp_path / "proj" / "watch" / "index.html").read_text()
    _, project = tck.load_checkpoint(ckpt, device="cpu")
    assert project.iterations == 4 and project.previewTimer > 0.0

    # the saved project moves on (iterations 4); the resume must take the
    # checkpoint's model, not the saved splats
    assert cli.main(["train", proj, "--steps", "2", "--resume", *flags]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == f"resumed from {ckpt} at iter 4"
    assert json.loads(out[-1])["iterations"] == 6
    session = cli._make_session(argparse.Namespace(project=proj, device="cpu"), require=True)
    assert session.project.iterations == 6

    assert cli.main(["train", proj, "--steps", "1", "--resume", "--checkpoint-dir",
                     str(tmp_path / "none"), *flags]) == 0
    assert f"--resume: no checkpoint at {tmp_path / 'none' / 'latest.npz'}; starting fresh" \
        in capsys.readouterr().out


def test_jax_session_checkpoint_resumes_in_port_session(tmp_path):
    """A checkpoint that the JAX session's auto_train writes resumes in the
    port's session: the same model bit for bit and the same iteration
    count, and training goes on from there."""
    from gaussian_splatterer_tpu.app.session import Session as JSession
    from gaussian_splatterer_tpu_torch.app.session import Session

    obj, png = _tiny_scene(tmp_path)
    runtime = dict(render_resolution_x=32, render_resolution_y=32, splats_capacity=64,
                   max_dup=2**12)
    jproject = jcfg.Project.app_default()
    jproject.sphere1.count, jproject.rtSamples, jproject.intervalCapture = 1, 1, 0
    js = JSession(project=jproject, runtime=jcfg.RuntimeConfig(**runtime), renderer="oracle",
                  rng=random.Random(0))
    js.load_model_obj(obj)
    js.load_texture(png)
    js.init_field("model")
    ckpt_dir = str(tmp_path / "ckpt")
    js.auto_train(2, checkpoint_dir=ckpt_dir, checkpoint_every=2)

    s = Session(runtime=tcfg.RuntimeConfig(**runtime), device="cpu", renderer="oracle")
    s.load_model_obj(obj)
    s.load_texture(png)
    s.resume_from_checkpoint(ckpt_dir)
    assert s.project.iterations == 2 and s.trainer.project is s.project
    assert s.project.to_json() == js.project.to_json()
    got, count = model_arrays(s.model)
    want, jcount = model_arrays(js.model)
    assert count == jcount
    for name, a, b in zip(FIELDS, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    s.auto_train(1)
    assert s.project.iterations == 3 and bool(torch.isfinite(s.model.means).all())
