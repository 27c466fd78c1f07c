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


OBJ_TEXT = """\
# quads, a triangle, negative indices, a corner without vt, normals
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
f -4/-4 -2/-2 -1/-1
v 0 0 2

f 1//1 2//1 5//1
f 2/2 3/3 5
"""


def test_obj_loader_matches_jax(tmp_path):
    """The parser against the JAX package's (its Python path and its C++
    fast path): quad split, negative indices, the (0, 0) UV fallback."""
    from gaussian_splatterer_tpu.io import obj as jobj
    from gaussian_splatterer_tpu_torch.io import obj as tobj

    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT)
    calls = []
    got = tobj.load_obj(str(path), progress=lambda: calls.append(1))
    assert got.num_triangles == 5 and len(calls) == OBJ_TEXT.count("\n")
    for ref in (jobj.load_obj(str(path), progress=lambda: None), jobj.load_obj(str(path))):
        for name in ("vertices", "triangles", "tri_uv"):
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert not got.tri_uv[3:].any()  # a corner without vt: (0, 0) on all three
    (tmp_path / "bad.obj").write_text("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="out of range"):
        tobj.load_obj(str(tmp_path / "bad.obj"))


@pytest.mark.parametrize("fmt,mode", [("png", "L"), ("png", "LA"), ("png", "RGB"),
                                      ("png", "RGBA"), ("tga", "RGB"), ("tga", "RGBA"),
                                      ("tga_rle", "RGBA")])
def test_texture_loader_matches_jax(tmp_path, fmt, mode):
    """load_texture_rgba against the JAX package's (Pillow's RGBA): the
    same floats, row 0 the top of the file, for the colour types and the
    TGA encodings the port reads; blank_texture equal."""
    from gaussian_splatterer_tpu.io import image as jimg_mod

    rng = np.random.default_rng(8)
    px = np.repeat(rng.integers(0, 256, (13, 1, 4)), 17, axis=1).astype(np.uint8)
    px[:, ::3] = rng.integers(0, 256, (13, 6, 4))  # runs and literals for RLE
    img = Image.fromarray(px, "RGBA").convert(mode)
    path = str(tmp_path / f"t.{fmt[:3]}")
    img.save(path, **({"compression": "tga_rle"} if fmt == "tga_rle" else {}))
    got = timage.load_texture_rgba(path)
    assert got.shape == (13, 17, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jimg_mod.load_texture_rgba(path))
    np.testing.assert_array_equal(timage.blank_texture(), jimg_mod.blank_texture())


def test_texture_loader_names_what_it_cannot_read(tmp_path):
    Image.new("RGB", (8, 8), (10, 20, 30)).save(tmp_path / "t.jpg")
    blob = bytearray((tmp_path / "t.jpg").read_bytes())
    # arithmetic-coded lossless (SOF11), which libjpeg-turbo refuses (SOF9,
    # arithmetic-coded sequential, is read, as Pillow reads it)
    blob[blob.index(b"\xff\xc0") + 1] = 0xCB
    (tmp_path / "t.jpg").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="JPEG"):
        timage.load_texture_rgba(str(tmp_path / "t.jpg"))
    (tmp_path / "t.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="BMP"):
        timage.load_texture_rgba(str(tmp_path / "t.bmp"))
    Image.new("1", (8, 8)).save(tmp_path / "t.xbm")  # read since XBM joined the readers
    np.testing.assert_array_equal(timage.load_texture_rgba(str(tmp_path / "t.xbm")),
                                  np.asarray(Image.open(tmp_path / "t.xbm").convert("RGBA"),
                                             np.float32) / 255.0)
    (tmp_path / "t.wmf").write_bytes(b"\x01\x00\x00\x00" + bytes(60))
    with pytest.raises(ValueError, match="WMF"):
        timage.load_texture_rgba(str(tmp_path / "t.wmf"))
    (tmp_path / "t.bin").write_bytes(b"\x01" * 40)
    with pytest.raises(ValueError, match="unknown texture format"):
        timage.load_texture_rgba(str(tmp_path / "t.bin"))


def test_field_initializers_match_jax():
    """grid (full and cut by the capacity), mono and model: the same host
    arrays as the JAX package's, exactly."""
    from gaussian_splatterer_tpu.models import splats as jsp
    from gaussian_splatterer_tpu_torch.models import splats as tsp

    rng = np.random.default_rng(6)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (40, 3)).astype(np.int32)
    tris[0] = (0, 0, 1)  # a degenerate triangle: normal 0, identity rotation
    cases = [(fn, args) for fn, args in (
        ("init_field_grid", (5000, 1, 4)), ("init_field_grid", (100, 3, 16)),
        ("init_field_mono", (64, 1, 4)), ("init_field_model", (verts, tris, 64, 1, 4)))]
    for fn, args in cases:
        a, b = getattr(tsp, fn)(*args), getattr(jsp, fn)(*args)
        assert (a.count, a.capacity) == (b.count, b.capacity), fn
        for name in ("means", "shs", "scales", "opacities", "rotations"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=fn)
    axis = np.array([0.3, -1.0, 2.0])
    np.testing.assert_array_equal(tsp.quat_from_axis_angle(axis, 0.7),
                                  jsp.quat_from_axis_angle(axis, 0.7))


def test_splat_model_empty_needs_a_device():
    """The entry point no longer lands on the CPU unless asked."""
    with pytest.raises(TypeError, match="device"):
        SplatModel.empty(16)
    m = SplatModel.empty(16, device="cpu")
    assert m.device.type == "cpu" and m.count == 0 and m.capacity == 16


def test_metrics_match_jax(tmp_path):
    """mse and psnr on the same images, and the JSONL step log."""
    from gaussian_splatterer_tpu.utils import metrics as jm
    from gaussian_splatterer_tpu_torch.utils import metrics as tm

    rng = np.random.default_rng(2)
    a, b = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tm.mse(a, b)), float(jm.mse(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.psnr(torch.from_numpy(a), b)),
                               float(jm.psnr(a, b)), rtol=1e-6)
    logs = []
    for mod in (tm, jm):
        with open(tmp_path / f"{mod.__name__}.jsonl", "w") as fh:
            log = mod.MetricsLogger(file=fh, log_every=2)
            for it in range(1, 6):
                log.log_step(it, np.float32(0.5 / it), 10 * it, psnr=20.0 + it, lr=np.array(1.5, np.float32))
        lines = [json.loads(x) for x in open(tmp_path / f"{mod.__name__}.jsonl")]
        logs.append([{k: v for k, v in x.items() if k != "steps_per_s"} for x in lines])
        assert [h.iteration for h in log.history] == [2, 4]
    assert logs[0] == logs[1]


def _tiny_scene(tmp_path):
    """A tent of two triangles and a 2x2 PNG texture, written for the CLI."""
    (tmp_path / "tent.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 0 1 0.6\nv 0 -0.2 -0.8\nvt 0 0\nvt 1 0\nvt 0.5 1\n"
        "f 1/1 2/2 3/3\nf 1/1 4/3 2/2\n")
    Image.fromarray(np.array([[[200, 40, 30], [30, 200, 40]], [[40, 30, 200], [220, 220, 220]]],
                             np.uint8)).save(tmp_path / "tent.png")
    return str(tmp_path / "tent.obj"), str(tmp_path / "tent.png")


def _set_rig(proj, cams=2, samples=2, capture=1):
    p = tcfg.Project.load(os.path.join(proj, "settings.json"))
    p.sphere1.count, p.rtSamples, p.intervalCapture = cams, samples, capture
    p.sphere1.distance = p.sphere2.distance = 4.0
    p.save(os.path.join(proj, "settings.json"))


def test_cli_new_train_render_rtx_on_cpu(tmp_path, capsys):
    """The tracer slice through the port's CLI on the CPU: new --obj
    --texture --init-field model, then train 2 steps capturing every step,
    then render --mode rtx.  The truths hold both backgrounds of every rig
    camera, the losses are finite, the PNG decodes, and the project loads
    in the JAX Session."""
    from gaussian_splatterer_tpu.app.session import Session as JSession
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    obj, png = _tiny_scene(tmp_path)
    proj = str(tmp_path / "proj")
    flags = ["--resolution", "32", "--capacity", "64", "--device", "cpu"]
    assert tcli.main(["new", proj, "--obj", obj, "--texture", png, "--init-field", "model",
                      *flags]) == 0
    _set_rig(proj)
    capsys.readouterr()
    assert tcli.main(["train", proj, "--steps", "2", "--log-every", "1", *flags]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    losses = [float(x.split()[3]) for x in out if x.startswith("iter ")]
    stats = json.loads(out[-1])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert stats["iterations"] == 2 and stats["recaptures"] == 1
    # on the CPU the plain versions run: no launch is counted
    assert stats["launches"] == {"mt_intersect": [0, 0], "mt_culled": [0, 0],
                                 "composite_train": [0, 0], "composite_fwd": [0, 0],
                                 "composite_bwd": [0, 0]}
    out_png = str(tmp_path / "rtx.png")
    assert tcli.main(["render", proj, out_png, "--mode", "rtx", "--size", "24x16",
                      "--samples", "4", "--device", "cpu"]) == 0
    img = timage.load_png(out_png)
    assert img.shape == (16, 24, 3) and img.max() > img.min()

    session = tcli._make_session(argparse.Namespace(project=proj, device="cpu"), require=True)
    assert session.rtx.mesh.num_triangles == 2 and session.model.count >= 2
    session.capture()
    assert session.trainer.truths.shape[0] == 2 * session.project.num_cameras == 4
    assert torch.isfinite(session.trainer.truths).all()
    jsession = JSession(runtime=jcfg.RuntimeConfig.load(os.path.join(proj, "runtime.json")))
    jsession.load_project(proj)
    assert jsession.rtx.mesh.num_triangles == 2 and jsession.project.iterations == 2
    jhost = JHost.from_device(jsession.model)
    np.testing.assert_array_equal(jhost.means, session.model.to_host().means)


def test_jax_project_trains_and_renders_in_the_port(tmp_path, capsys):
    """A project made by the JAX CLI's ``new`` (OBJ, texture, model field)
    trains one step and renders --mode rtx through the port's CLI."""
    from gaussian_splatterer_tpu.app import cli as jcli
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    obj, png = _tiny_scene(tmp_path)
    proj = str(tmp_path / "proj")
    flags = ["--resolution", "32", "--capacity", "64"]
    assert jcli.main(["new", proj, "--obj", obj, "--texture", png, "--init-field", "model",
                      *flags]) == 0
    _set_rig(proj, capture=0)
    capsys.readouterr()
    jcli.main(["info", proj])
    j_info = json.loads(capsys.readouterr().out)
    tcli.main(["info", proj, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == j_info
    assert tcli.main(["train", proj, "--steps", "1", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["iterations"] == 1
    assert tcli.main(["render", proj, str(tmp_path / "o.png"), "--mode", "rtx", "--size",
                      "16x16", "--samples", "2", "--device", "cpu"]) == 0


def test_project_saved_for_several_devices_opens_and_renders(tmp_path, capfd):
    """A project whose runtime.json asks for train_devices 2 (what the JAX
    CLI's ``train --devices 2`` persists) opens in the port's CLI: ``info``
    and ``render --mode splats`` work in one process on the CPU, and
    ``train`` runs 2 gloo ranks on the CPU, rank 0 printing the last line
    and writing the project."""
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    obj, png = _tiny_scene(tmp_path)
    proj = str(tmp_path / "proj")
    flags = ["--resolution", "32", "--capacity", "64", "--device", "cpu"]
    assert tcli.main(["new", proj, "--obj", obj, "--texture", png, "--init-field", "model",
                      *flags]) == 0
    _set_rig(proj)
    rt_path = os.path.join(proj, "runtime.json")
    runtime = tcfg.RuntimeConfig.load(rt_path)
    runtime.train_devices = 2
    runtime.save(rt_path)
    capfd.readouterr()
    assert tcli.main(["info", proj, "--device", "cpu"]) == 0
    info = json.loads(capfd.readouterr().out)
    assert info["splats"] >= 2 and info["iterations"] == 0
    out_png = str(tmp_path / "splats.png")
    assert tcli.main(["render", proj, out_png, "--mode", "splats", "--size", "32x32",
                      "--device", "cpu"]) == 0
    assert timage.load_png(out_png).shape == (32, 32, 3)
    capfd.readouterr()
    assert tcli.main(["train", proj, "--steps", "1", "--device", "cpu"]) == 0
    last = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert last["devices"] == 2 and last["iterations"] == 1
    assert tcfg.RuntimeConfig.load(rt_path).train_devices == 2
    assert tcfg.Project.load(os.path.join(proj, "settings.json")).iterations == 1


def test_port_imports_no_jax_flax_or_pillow():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gaussian_splatterer_tpu_torch as p\n"
        "import gaussian_splatterer_tpu_torch.app.cli\n"
        "import gaussian_splatterer_tpu_torch.rt\n"
        "import gaussian_splatterer_tpu_torch.rt.tracer\n"
        "import gaussian_splatterer_tpu_torch.utils.metrics\n"
        "import gaussian_splatterer_tpu_torch.io.checkpoint\n"
        "import gaussian_splatterer_tpu_torch.parallel\n"
        "import gaussian_splatterer_tpu_torch.parallel.route\n"
        "import gaussian_splatterer_tpu_torch.parallel.routed3\n"
        "import gaussian_splatterer_tpu_torch.graft_entry\n"
        "import gaussian_splatterer_tpu_torch.io.watch\n"
        "import gaussian_splatterer_tpu_torch.io.jpeg\n"
        "import gaussian_splatterer_tpu_torch.io.ply\n"
        "import gaussian_splatterer_tpu_torch.io.viewer\n"
        "import gaussian_splatterer_tpu_torch.io.webp\n"
        "import gaussian_splatterer_tpu_torch.io.pillow_open\n"
        "from gaussian_splatterer_tpu_torch.io import ccitt, cur, ico, pcx, psd, qoi, sgi\n"
        "from gaussian_splatterer_tpu_torch.io import jpeg_arith, jpeg_lossless, jpeg2000, xz, zstd\n"
        "from gaussian_splatterer_tpu_torch.io import (blp, dcx, fits, fli, ftex, gbr, icns, im,\n"
        "    imt, iptc, mcidas, msp, pcd, pixar, rawmode, spider, sun, xbm, xpm, xvthumb)\n"
        "import gaussian_splatterer_tpu_torch.native\n"
        "from gaussian_splatterer_tpu_torch.scripts import (\n"
        "    bench, bench_scale, eval_model, quality_run, scenes)\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in ('jax', 'flax', 'PIL', 'gaussian_splatterer_tpu', 'zstandard')"
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
