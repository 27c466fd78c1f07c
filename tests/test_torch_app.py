"""PyTorch port vs JAX package: configuration, cameras, file formats, the
render CLI end to end, and the port's import boundary."""

import argparse
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import random_splats

from gaussian_splatterer_tpu import config as jcfg
from gaussian_splatterer_tpu.io import gobj as jgobj
from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu.models import camera as jcam
from gaussian_splatterer_tpu.models.splats import SplatModelHost as JHost
from gaussian_splatterer_tpu_torch import config as tcfg
from gaussian_splatterer_tpu_torch.io import gobj as tgobj
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.models import camera as tcam
from gaussian_splatterer_tpu_torch.models.splats import SplatModel, SplatModelHost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _custom_project(mod):
    p = mod.Project.app_default()
    p.sphere1.count, p.sphere1.rotX, p.sphere2.fovDeg = 5, 12.5, 41.0
    p.lrSh, p.iterations, p.previewFreeRotX, p.renderResX = 3e-4, 1234, 17.0, 640
    return p


def _custom_runtime(mod):
    return mod.RuntimeConfig(render_resolution_x=320, splats_capacity=4096, sh_degree=3,
                             sh_coeffs=16, tile_px=16, max_dup=12345, mip_antialias=True,
                             train_work_cap=999, lr_location_decay=0.999)


@pytest.mark.parametrize("src,dst", [(jcfg, tcfg), (tcfg, jcfg)])
def test_config_files_roundtrip(tmp_path, src, dst):
    assert [f.name for f in dataclasses.fields(tcfg.Project)] == [
        f.name for f in dataclasses.fields(jcfg.Project)]
    assert [f.name for f in dataclasses.fields(tcfg.RuntimeConfig)] == [
        f.name for f in dataclasses.fields(jcfg.RuntimeConfig)]
    _custom_project(src).save(str(tmp_path / "settings.json"))
    _custom_runtime(src).save(str(tmp_path / "runtime.json"))
    project = dst.Project.load(str(tmp_path / "settings.json"))
    runtime = dst.RuntimeConfig.load(str(tmp_path / "runtime.json"))
    assert project.to_json() == _custom_project(src).to_json()
    assert dataclasses.asdict(runtime) == dataclasses.asdict(_custom_runtime(src))
    assert project.num_cameras == 5


def test_cameras_match_jax():
    project = _custom_project(jcfg)
    tproject = tcfg.Project.from_json(project.to_json())
    np.testing.assert_allclose(tcam.fibonacci_sphere(7, 3.0), jcam.fibonacci_sphere(7, 3.0),
                               atol=1e-6)
    jcams = jcam.Camera.get_cameras(project) + [jcam.Camera.get_preview_camera(project)]
    tcams = tcam.Camera.get_cameras(tproject) + [tcam.Camera.get_preview_camera(tproject)]
    assert len(tcams) == len(jcams) == 6
    for tc, jc in zip(tcams, jcams):
        np.testing.assert_allclose(tc.get_view(), jc.get_view(), atol=1e-6)
        np.testing.assert_allclose(tc.get_proj_view(1.5), jc.get_proj_view(1.5), atol=1e-6)
        for train in (True, False):
            np.testing.assert_allclose(tc.tan_fov(96, 64, train), jc.tan_fov(96, 64, train),
                                       atol=1e-6)


def test_gobj_roundtrip_both_ways(tmp_path):
    means, shs, scales, opac, rot, _ = random_splats(30, 9, sh_coeffs=16)
    j = JHost.from_arrays(means, shs, scales, opac, rot, capacity=64)
    jgobj.save_gobj(j, str(tmp_path / "j.gobj"))
    t = tgobj.load_gobj(str(tmp_path / "j.gobj"), capacity=64)
    j_back = jgobj.load_gobj(str(tmp_path / "j.gobj"), capacity=64)
    tgobj.save_gobj(t, str(tmp_path / "t.gobj"))
    t_back = jgobj.load_gobj(str(tmp_path / "t.gobj"), capacity=64)
    assert t.count == j_back.count == t_back.count == 30
    assert (t.capacity, t.sh_degree, t.sh_coeffs) == (64, 3, 16)
    for name in ("means", "shs", "scales", "opacities", "rotations"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j_back, name))
        np.testing.assert_array_equal(getattr(t_back, name), getattr(j_back, name))
    # the text keeps 6 significant digits, as the reference writes them
    np.testing.assert_allclose(t.means[:30], means, rtol=1e-5)


def test_splat_model_carries_jax_arrays():
    means, shs, scales, opac, rot, _ = random_splats(10, 1, cap=16)
    m = SplatModel.from_numpy(means, shs, scales, opac, rot, count=10, device="cpu")
    assert (m.capacity, m.sh_degree, m.sh_coeffs) == (16, 1, 4)
    assert m.active_mask().tolist() == [True] * 10 + [False] * 6
    host = m.to_host()
    np.testing.assert_array_equal(host.shs, shs)
    assert host.count == 10
    assert SplatModelHost.from_arrays(means[:10], shs[:10], scales[:10], opac[:10],
                                      rot[:10]).capacity == 1_000_000


def test_png_roundtrip_and_pillow_interop(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.1, 1.1, (37, 53, 3)).astype(np.float32)
    timage.save_png(img, str(tmp_path / "t.png"))
    expect = jimage.float_image_to_u8(img)[::-1]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), expect)
    np.testing.assert_array_equal(timage.load_png(str(tmp_path / "t.png")),
                                  jimage.load_png(str(tmp_path / "t.png")))
    # Pillow's own PNGs use the adaptive row filters and other colour types
    smooth = np.cumsum(rng.integers(0, 4, (29, 31, 4)), axis=1).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L"):
        buf = io.BytesIO()
        pil = Image.fromarray(smooth[..., :3]).convert(mode)
        pil.save(buf, format="PNG", optimize=True)
        np.testing.assert_array_equal(timage.decode_png(buf.getvalue()),
                                      np.asarray(pil.convert("RGB")))


def test_port_imports_no_jax_flax_or_pillow():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gaussian_splatterer_tpu_torch as p\n"
        "import gaussian_splatterer_tpu_torch.app.cli\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in ('jax', 'flax', 'PIL', 'gaussian_splatterer_tpu')"
        " if k in sys.modules)\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises(monkeypatch):
    from gaussian_splatterer_tpu_torch.app.session import Session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(device="cuda")


@pytest.mark.parametrize("flags", [
    {},
    {"resolution": 96, "runtime": ["tile_px=16", "mip_antialias=on"]},
    {"capacity": 300, "max_dup": 5000, "runtime": ["train_work_cap=none"]},
])
def test_cli_runtime_resolution_matches_jax(tmp_path, flags):
    """Flag overrides over a persisted runtime.json, and the max_dup sizing
    rule, resolve to the same RuntimeConfig in both CLIs."""
    from gaussian_splatterer_tpu.app import cli as jcli
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    jcfg.RuntimeConfig(render_resolution_x=64, render_resolution_y=64, splats_capacity=256,
                       max_dup=777, tile_px=32).save(str(tmp_path / "runtime.json"))
    args = argparse.Namespace(project=str(tmp_path), renderer="tiled", device="cpu",
                              **{"resolution": None, "capacity": None, "max_dup": None,
                                 "runtime": None, **flags})
    jrt = dataclasses.asdict(jcli._make_session(args).runtime)
    assert dataclasses.asdict(tcli._make_session(args).runtime) == jrt


def test_render_cli_matches_jax_cli(tmp_path, capsys):
    """The slice end to end: a project saved by the JAX Session, rendered by
    the JAX CLI (interpret-mode Pallas) and the port's CLI on the CPU; the
    PNGs agree within one 8-bit step, and ``info`` says the same."""
    from gaussian_splatterer_tpu.app import cli as jcli
    from gaussian_splatterer_tpu.app.session import Session as JSession
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    runtime = jcfg.RuntimeConfig(render_resolution_x=64, render_resolution_y=64,
                                 splats_capacity=256, max_dup=2**12, tile_px=16)
    session = JSession(project=jcfg.Project.app_default(), runtime=runtime)
    means, shs, scales, opac, rot, _ = random_splats(150, 12)
    session.model = JHost.from_arrays(means, shs, scales, opac, rot * 0.5 + np.float32(0.1),
                                      capacity=256).to_device()
    proj = str(tmp_path / "proj")
    session.save_project(proj)

    jpng, tpng = str(tmp_path / "jax.png"), str(tmp_path / "torch.png")
    assert jcli.main(["render", proj, jpng, "--mode", "splats", "--size", "64x48"]) == 0
    assert tcli.main(["render", proj, tpng, "--mode", "splats", "--size", "64x48",
                      "--device", "cpu"]) == 0
    a = np.asarray(Image.open(jpng), np.int32)
    b = np.asarray(Image.open(tpng), np.int32)
    assert a.shape == b.shape == (48, 64, 3)
    assert (a > 0).mean() > 0.2
    assert np.abs(a - b).max() <= 1

    capsys.readouterr()
    jcli.main(["info", proj])
    j_info = json.loads(capsys.readouterr().out)
    tcli.main(["info", proj, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == j_info
