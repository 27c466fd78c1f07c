"""PyTorch port vs JAX package: the model's export and import (standard
3DGS .ply, the HTML viewer, .gobj), ``sh_eval_linear``, the CLI's
``export``, ``render --mode viewer`` and ``doctor`` on the CPU."""

import base64
import json
import os
import re
from functools import partial

import numpy as np
import pytest
import torch

from gaussian_splatterer_tpu.io import ply as jply
from gaussian_splatterer_tpu.io import viewer as jviewer
from gaussian_splatterer_tpu.models.splats import SplatModelHost as JHost
from gaussian_splatterer_tpu_torch import config as tcfg
from gaussian_splatterer_tpu_torch.io import ply as tply
from gaussian_splatterer_tpu_torch.io import viewer as tviewer
from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost


def _hosts(degree: int, n: int = 23, cap: int = 64, seed: int = 7):
    """The same random model as a port host and as a JAX host."""
    rng = np.random.default_rng(seed + degree)
    k = (degree + 1) ** 2
    arrays = (rng.uniform(-2, 2, (n, 3)), rng.normal(0, 0.5, (n, k, 3)),
              rng.uniform(0.01, 0.4, (n, 3)), rng.uniform(0.05, 0.95, n),
              rng.normal(0, 1, (n, 4)))
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return (SplatModelHost.from_arrays(*arrays, capacity=cap),
            JHost.from_arrays(*arrays, capacity=cap))


def _fields(host):
    n = host.count
    return [np.asarray(getattr(host, f))[:n]
            for f in ("means", "shs", "scales", "opacities", "rotations")]


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_save_ply_byte_equal_to_jax(tmp_path, degree):
    t, j = _hosts(degree)
    tply.save_ply(t, str(tmp_path / "t.ply"))
    jply.save_ply(j, str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ply_crosses_between_packages(tmp_path, writer):
    """A file written by one package reads back in both to equal arrays
    (the weights-across path, both ways), with the capacity asked for."""
    t, j = _hosts(2)
    path = str(tmp_path / "m.ply")
    (jply.save_ply(j, path) if writer == "jax" else tply.save_ply(t, path))
    got, ref = tply.load_ply(path, capacity=128), jply.load_ply(path, capacity=128)
    assert got.count == ref.count == 23 and got.capacity == ref.capacity == 128
    assert (got.sh_degree, got.sh_coeffs) == (ref.sh_degree, ref.sh_coeffs) == (2, 9)
    for a, b in zip(_fields(got), _fields(ref)):
        np.testing.assert_array_equal(a, b)


def test_ply_roundtrip_inria_layout(tmp_path):
    """The port's counterpart of tests/test_splats_io.py's: INRIA layout
    with logit opacity, log scales and channel-major f_rest; the round
    trip recovers the model to the activations' float error."""
    for degree in (1, 2):
        h, _ = _hosts(degree)
        n, k = h.count, h.sh_coeffs
        path = str(tmp_path / f"model_d{degree}.ply")
        tply.save_ply(h, path)
        back = tply.load_ply(path)
        assert back.count == n and (back.sh_degree, back.sh_coeffs) == (degree, k)
        np.testing.assert_allclose(back.means[:n], h.means[:n], atol=1e-6)
        np.testing.assert_allclose(back.shs[:n], h.shs[:n], atol=1e-6)
        np.testing.assert_allclose(back.scales[:n], h.scales[:n], rtol=1e-5)
        np.testing.assert_allclose(back.opacities[:n], h.opacities[:n], atol=1e-5)
        np.testing.assert_allclose(back.rotations[:n], h.rotations[:n], atol=1e-6)
        head = open(path, "rb").read(4000).decode("ascii", "ignore")
        assert "property float f_dc_0" in head and "property float opacity" in head
        assert f"f_rest_{3 * (k - 1) - 1}" in head
    big = tply.load_ply(path, capacity=256)
    assert big.capacity == 256 and big.count == n


def _header_and_body(tmp_path, host):
    """(header lines, record bytes) of ``host`` written by the port."""
    tply.save_ply(host, str(tmp_path / "m.ply"))
    head, _, body = (tmp_path / "m.ply").read_bytes().partition(b"end_header\n")
    return head.decode().splitlines(), body


def _write(path, lines, body) -> str:
    with open(path, "wb") as fh:
        fh.write(("\n".join(lines) + "\nend_header\n").encode())
        fh.write(body)
    return str(path)


def test_ply_loader_tolerates_ecosystem_headers(tmp_path):
    """Comment lines and a trailing empty face element load (the port's
    counterpart of tests/test_splats_io.py's)."""
    h = SplatModelHost(8, 1, 4)
    h.means[:2] = [[0, 0, 1], [1, 0, 2]]
    h.opacities[:2], h.scales[:2], h.rotations[:2], h.count = 0.5, 0.1, [1, 0, 0, 0], 2
    lines, body = _header_and_body(tmp_path, h)
    path = _write(tmp_path / "m2.ply", [lines[0], "comment Generated by some-ecosystem-tool",
                                        *lines[1:], "element face 0",
                                        "property list uchar int vertex_indices"], body)
    for load in (tply.load_ply, jply.load_ply):
        back = load(path)
        assert back.count == 2
        np.testing.assert_allclose(back.means[:2], h.means[:2], atol=1e-6)


@pytest.mark.parametrize("case", ["non_float", "big_endian", "two_vertex", "face_first",
                                  "no_vertex", "rest_not_3", "rest_not_square", "truncated"])
def test_ply_loader_errors_match_jax(tmp_path, case):
    """Each file the loaders refuse raises ValueError with the JAX
    package's message."""
    h, _ = _hosts(1, n=2, cap=8)
    lines, body = _header_and_body(tmp_path, h)
    props = [ln for ln in lines if ln.startswith("property")]
    edits = {
        "non_float": lines[:4] + ["property uchar red"] + lines[4:],
        "big_endian": [lines[0], "format binary_big_endian 1.0", *lines[2:]],
        "two_vertex": lines + ["element vertex 1", "property float x"],
        "face_first": [lines[0], lines[1], "element face 0", *lines[2:]],
        "no_vertex": [lines[0], lines[1], "element face 0"],
        "rest_not_3": [ln for ln in lines if ln != "property float f_rest_8"],
        "rest_not_square": lines[:3] + props[:9] + [f"property float f_rest_{i}"
                                                     for i in range(9, 15)] + props[9:],
    }
    if case == "truncated":
        path = str(tmp_path / "t.ply")
        (tmp_path / "t.ply").write_bytes("\n".join(lines).encode()[:40])
    else:
        path = _write(tmp_path / f"{case}.ply", edits[case], body)
    with pytest.raises(ValueError) as jerr:
        jply.load_ply(path)
    with pytest.raises(ValueError) as terr:
        tply.load_ply(path)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("degree", [1, 3])
def test_viewer_html_byte_equal_to_jax(tmp_path, degree):
    """The viewer file equals the JAX package's byte for byte at the same
    title (degree 3 bakes bands 2-3 through sh_eval_linear), from a host
    and from a model on the CPU, and embeds pack_viewer_arrays exactly."""
    t, j = _hosts(degree, n=37)
    tviewer.export_viewer_html(t, str(tmp_path / "t.html"), title="parity")
    tviewer.export_viewer_html(t.to_device("cpu"), str(tmp_path / "d.html"), title="parity")
    jviewer.export_viewer_html(j, str(tmp_path / "j.html"), title="parity")
    html = (tmp_path / "t.html").read_text()
    assert html == (tmp_path / "j.html").read_text() == (tmp_path / "d.html").read_text()
    assert "http://" not in html and "https://" not in html
    b64 = re.search(r'const B64 = "([^"]*)"', html).group(1)
    data = np.frombuffer(base64.b64decode(b64), np.float32).reshape(37, 23)
    np.testing.assert_array_equal(data, tviewer.pack_viewer_arrays(t))
    np.testing.assert_array_equal(data, jviewer.pack_viewer_arrays(j))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_eval_linear_matches_jax(degree):
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.ops.transforms import sh_eval_linear as jeval
    from gaussian_splatterer_tpu_torch.ops.transforms import sh_eval_linear as teval

    rng = np.random.default_rng(degree)
    n, k = 50, (degree + 1) ** 2
    shs = rng.normal(0, 0.5, (n, k, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = np.asarray(jeval(jnp.asarray(shs), jnp.asarray(dirs), degree))
    got_np = teval(shs, dirs, degree)
    got_t = teval(torch.from_numpy(shs), torch.from_numpy(dirs), degree)
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_np, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_np, jeval(shs, dirs, degree), atol=1e-6, rtol=0)


def test_viewer_shader_math_matches_projection():
    """The viewer's vertex-shader math (tests/test_splats_io.py's numpy
    transcription) agrees with the port's projection: the same near-cull
    decisions, the same dilated 2D covariance, the centred splat at NDC 0."""
    from test_splats_io import _viewer_shader_sim

    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    eye, tgt, up = np.array([0.0, 0.5, 4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0])
    z = (eye - tgt) / np.linalg.norm(eye - tgt)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, y, z
    view[:3, 3] = [-x @ eye, -y @ eye, -z @ eye]
    fovy, wpx = np.pi / 4, 256
    t = 1.0 / np.tan(fovy / 2)
    proj = np.array([[t, 0, 0, 0], [0, t, 0, 0],
                     [0, 0, (100.0 + 0.1) / (0.1 - 100.0), 2 * 100.0 * 0.1 / (0.1 - 100.0)],
                     [0, 0, -1, 0]])
    fl = 0.5 * wpx / np.tan(fovy / 2)
    rng = np.random.default_rng(0)
    n = 32
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    pts[0] = tgt
    scales = rng.uniform(0.05, 0.3, (n, 3))
    cam = Camera(eye.astype(np.float32), tgt.astype(np.float32), 45.0)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    pr = project_splat_components(
        f32(pts), f32(np.zeros((n, 4, 3))), f32(scales), torch.ones(n), f32(rot),
        torch.ones(n, dtype=torch.bool), cam.get_view(), cam.get_proj_view(1.0),
        cam.location, *cam.tan_fov(wpx, wpx, train=True), wpx, wpx, 0, 1.0)
    visible = 0
    for i in range(n):
        culled, ndc, cov = _viewer_shader_sim(pts[i], scales[i], view, proj, (fl, fl),
                                              (wpx, wpx))
        assert culled == (not bool(pr.valid[i])), f"cull mismatch splat {i}"
        if culled:
            continue
        visible += 1
        conic = np.array([[float(pr.ca[i]), float(pr.cb[i])],
                          [float(pr.cb[i]), float(pr.cc[i])]])
        cov_ref = np.linalg.inv(conic)
        np.testing.assert_allclose(cov[0, 0], cov_ref[0, 0], rtol=2e-3)
        np.testing.assert_allclose(cov[1, 1], cov_ref[1, 1], rtol=2e-3)
        np.testing.assert_allclose(abs(cov[0, 1]), abs(cov_ref[0, 1]), rtol=2e-3, atol=1e-3)
    assert visible >= 30
    _, ndc0, _ = _viewer_shader_sim(pts[0], scales[0], view, proj, (fl, fl), (wpx, wpx))
    np.testing.assert_allclose(ndc0, 0.0, atol=1e-6)


def _session(**kw):
    from gaussian_splatterer_tpu_torch.app.session import Session

    runtime = tcfg.RuntimeConfig(render_resolution_x=64, render_resolution_y=64,
                                 splats_capacity=256, max_dup=2**12, tile_px=16, **kw)
    return Session(runtime=runtime, device="cpu")


# the largest |difference| of the two renders measured on this test's scene:
# 1.79e-7 (the activations' float32 round trip)
PLY_RENDER_ATOL = 1e-4


def test_session_model_survives_a_ply_round_trip(tmp_path):
    """A CPU session's model written by save_splats_ply and read into a
    fresh session by load_splats_ply renders the same image to
    PLY_RENDER_ATOL, at the session's capacity on its device."""
    from torch_parity import random_splats

    session = _session()
    means, shs, scales, opac, rot, _ = random_splats(150, 12)
    session.model = SplatModelHost.from_arrays(means, shs, scales, opac, rot * 0.5 + 0.1,
                                               capacity=256).to_device("cpu")
    path = str(tmp_path / "m.ply")
    session.save_splats_ply(path)
    fresh = _session()
    fresh.load_splats_ply(path)
    assert fresh.model.count == 150 and fresh.model.capacity == 256
    assert fresh.model.device.type == "cpu"
    with torch.no_grad():
        a, b = session.render_splats(64, 64), fresh.render_splats(64, 64)
    assert float(a.max()) > 0.1
    assert float(torch.max(torch.abs(a - b))) < PLY_RENDER_ATOL


def test_cli_export_each_extension_and_render_viewer(tmp_path, capsys):
    """``export`` to .ply, .html and .gobj, and ``render --mode viewer``,
    through the port's CLI on the CPU; each file holds the project's model."""
    from gaussian_splatterer_tpu_torch.app import cli as tcli
    from gaussian_splatterer_tpu_torch.io.gobj import load_gobj

    proj = str(tmp_path / "proj")
    assert tcli.main(["new", proj, "--init-field", "grid", "--resolution", "32",
                      "--capacity", "64", "--device", "cpu"]) == 0
    host = load_gobj(os.path.join(proj, "splats.gobj"), capacity=64)
    for ext in ("ply", "html", "gobj"):
        assert tcli.main(["export", proj, str(tmp_path / f"m.{ext}"), "--device", "cpu"]) == 0
    viewer = str(tmp_path / "v.html")
    assert tcli.main(["render", proj, viewer, "--mode", "viewer", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("wrote ") == 4
    ply = tply.load_ply(str(tmp_path / "m.ply"))
    gobj = load_gobj(str(tmp_path / "m.gobj"))
    assert ply.count == gobj.count == host.count == 64
    np.testing.assert_allclose(ply.means[:64], host.means[:64], atol=1e-6)
    np.testing.assert_array_equal(gobj.means[:64], host.means[:64])
    html = (tmp_path / "m.html").read_text()
    assert html == open(viewer).read()
    b64 = re.search(r'const B64 = "([^"]*)"', html).group(1)
    np.testing.assert_array_equal(
        np.frombuffer(base64.b64decode(b64), np.float32).reshape(64, 23),
        tviewer.pack_viewer_arrays(host))


def test_doctor_on_the_cpu(capsys, monkeypatch):
    """``doctor --device cpu`` prints the JAX CLI's keys, passes its gate
    and times the micro step (two steps here: the CPU's plain versions)."""
    from gaussian_splatterer_tpu_torch.app import cli as tcli

    monkeypatch.setattr(tcli, "doctor_report", partial(tcli.doctor_report, reps=2))
    assert tcli.main(["doctor", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"platform", "numerics_gate", "tiled_vs_oracle_max_err",
                           "micro_step_per_s", "config"}
    assert report["platform"] == "cpu" and report["numerics_gate"] == "ok"
    assert report["micro_step_per_s"] > 0 and report["tiled_vs_oracle_max_err"] < 2e-2
    assert report["config"] == "128^2, 8192 splats, tile 16"
