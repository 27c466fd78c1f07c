"""PyTorch port's path tracer (gaussian_splatterer_tpu_torch.rt) vs the JAX
package's (gaussian_splatterer_tpu.rt) on the CPU, at the small scenes of
tests/test_rt.py: the same inputs from numpy seeds through both.  On the
JAX side the Pallas intersector runs in interpret mode.

What is held exactly: the scene tables, and the deterministic outcomes
(misses, transparency, no model).  What is held to float32 rounding: the
intersectors, one bounce step fed the JAX package's own random draws, a
one-bounce trace, and ray generation against a float64 evaluation.  Whole
renders draw from different generators and are held statistically.

JAX is imported inside the tests, so that the CUDA tests (marker ``cuda``,
skipped without a card) run on a machine without JAX."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401  (fixture)

from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.rt import tracer as tr
from gaussian_splatterer_tpu_torch.rt.tracer import RtxHost

RES = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 rounding of algebraically equal formulas summed in another order
T_RTOL, T_ATOL = 1e-5, 1e-6
UV_RTOL, UV_ATOL = 1e-4, 1e-5
STATE_ATOL = 1e-5  # a bounce's state: positions t*d, products of texels


def quad_mesh(z=0.0, half=2.0):
    """tests/test_rt.py's quad: two triangles facing -z, uv over [0, 1]^2."""
    v = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                 np.float32)
    uv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
    return TriangleMesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uv)


def icosphere_like(n=12):
    """tests/test_rt.py's UV sphere of radius 1.5, 2 n^2 triangles."""
    verts, tris = [], []
    for i in range(n + 1):
        for j in range(n):
            th, ph = np.pi * i / n, 2 * np.pi * j / n
            verts.append((1.5 * np.sin(th) * np.cos(ph), 1.5 * np.cos(th),
                          1.5 * np.sin(th) * np.sin(ph)))
    for i in range(n):
        for j in range(n):
            j2 = (j + 1) % n
            a, b, c, d = i * n + j, i * n + j2, (i + 1) * n + j, (i + 1) * n + j2
            tris += [(a, b, d), (a, d, c)]
    uv = np.full((len(tris), 3, 2), 0.1, np.float32)
    return TriangleMesh(np.array(verts, np.float32), np.array(tris, np.int32), uv)


def random_soup(n_tri, rng):
    """tests/test_rt.py's random triangle soup."""
    verts = rng.uniform(-2, 2, (3 * n_tri, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (n_tri, 3, 2)).astype(np.float32)
    return TriangleMesh(verts, np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3), uv)


def solid_texture(r, g, b, a=1.0):
    t = np.zeros((4, 4, 4), np.float32)
    t[...] = (r, g, b, a)
    return t


def front_camera(dist=6.0, fov=50.0):
    return Camera(np.array([0.0, 0.0, -dist], np.float32), np.zeros(3, np.float32), fov)


def jax_mesh(mesh):
    from gaussian_splatterer_tpu.io.obj import TriangleMesh as JMesh

    return JMesh(mesh.vertices, mesh.triangles, mesh.tri_uv)


def jax_camera(cam):
    from gaussian_splatterer_tpu.models.camera import Camera as JCamera

    return JCamera(cam.location, cam.target, cam.fov_deg_y)


def hosts(mesh, texture, tri_chunk, **load_kw):
    """(port host on the CPU, JAX host) with the same scene."""
    from gaussian_splatterer_tpu.rt import RtxHost as JHost

    port = RtxHost(tri_chunk=tri_chunk, device="cpu")
    jax_host = JHost(tri_chunk=tri_chunk, ray_chunk=RES * RES)
    port.load_model(mesh, **load_kw)
    jax_host.load_model(jax_mesh(mesh), **load_kw)
    if texture is not None:
        port.load_texture_diffuse(texture)
        jax_host.load_texture_diffuse(texture)
    return port, jax_host


def scattered_rays(rng, r, surface=1.5):
    """Origins around and on a sphere of radius ``surface`` (bounce
    origins on the mesh: t_num's cancellation case), half the directions
    aimed inward (tests/test_rt.py's mxu_general scene)."""
    o = rng.normal(scale=2.5, size=(r, 3)).astype(np.float32)
    k = r * 2 // 5
    o[:k] = o[:k] / np.linalg.norm(o[:k], axis=1, keepdims=True) * surface
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[:r // 2] = rng.normal(scale=0.4, size=(r // 2, 3)).astype(np.float32) - o[:r // 2] * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def components(a):
    return tuple(a[:, k] for k in range(3))


def assert_hits_match(port, ref, idx_share=0.95, exact=False):
    """Hit masks equal; winner indices equal but for exact rounding ties
    (at least ``idx_share`` of the hits, as tests/test_rt.py:402); t, u, v
    to float32 rounding where the winners agree."""
    t_p, i_p, u_p, v_p = (np.asarray(x) for x in port)
    t_r, i_r, u_r, v_r = (np.asarray(x) for x in ref)
    hit = np.isfinite(t_r)
    np.testing.assert_array_equal(np.isfinite(t_p), hit)
    same = i_p[hit] == i_r[hit]
    assert same.mean() >= (1.0 if exact else idx_share), same.mean()
    np.testing.assert_allclose(t_p[hit], t_r[hit], rtol=T_RTOL, atol=T_ATOL)
    for a, b in ((u_p, u_r), (v_p, v_r)):
        np.testing.assert_allclose(a[hit][same], b[hit][same], rtol=UV_RTOL, atol=UV_ATOL)
    return hit


@pytest.mark.parametrize("accel_min", [1, 10**9])
def test_scene_tables_match_jax(accel_min):
    """Every table the JAX package builds, equal exactly (Morton order with
    accel_min 1, brute force otherwise).  The JAX package's float valid row
    is the port's bool ``valid``, which the kernel reads as bytes."""
    port, jax_host = hosts(icosphere_like(6), None, 16, accel_min=accel_min, mt_kernel=True)
    assert ("validf" in jax_host._tris) == (accel_min > 1)  # the brute-force route's
    assert set(jax_host._tris) - {"validf"} <= set(port._tris)
    assert port._tris["valid"].dtype == torch.bool
    for key, ref in jax_host._tris.items():
        ref = np.asarray(ref)
        got = port._tris["valid" if key == "validf" else key].numpy()
        np.testing.assert_array_equal(got.astype(ref.dtype).reshape(ref.shape), ref,
                                      err_msg=key)


def test_intersect_reference_matches_jax_mxu_forms():
    """K5's plain twin against the Pallas kernel it replaces (interpret
    mode) and the XLA form, on tests/test_rt.py's random soup."""
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.rt import tracer as jt

    rng = np.random.default_rng(3)
    port, jax_host = hosts(random_soup(40, rng), None, 16, mt_kernel=True)
    r = 128
    o = rng.uniform(-4, 4, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = tuple(jnp.asarray(x) for x in components(o) + components(d))
    got = tr.intersect_reference(torch.from_numpy(o), torch.from_numpy(d), port._tris, 16)
    for ref in (jt._intersect_mxu_fused(*args, jax_host._tris, 16),
                jt._intersect_mxu_general(*args, jax_host._tris, 16)):
        t, i, u, v = ref
        hit = assert_hits_match(got, (t, i, u, v))
        assert hit.sum() >= 10


def test_intersect_component_matches_jax_chunked():
    """The component form against _intersect_chunked with scattered and
    on-surface origins: the same operations in the same order, so every
    winner agrees."""
    from gaussian_splatterer_tpu.rt import tracer as jt

    port, jax_host = hosts(icosphere_like(10), None, 32, accel_min=10**9)
    o, d = scattered_rays(np.random.default_rng(13), 512)
    ref = jt._intersect_chunked(*components(o), *components(d), jax_host._tris, 32)
    got = tr.intersect_component(torch.from_numpy(o), torch.from_numpy(d), port._tris, 32)
    hit = assert_hits_match(got, ref, exact=True)
    assert hit.sum() > 150
    # and the plain twin of K5 finds the same hits (the JAX package's
    # mxu-vs-component bar, tests/test_rt.py:251-255)
    twin = tr.intersect_reference(torch.from_numpy(o), torch.from_numpy(d), port._tris, 32)
    agree = np.isfinite(twin[0].numpy()) == hit
    assert agree.mean() > 0.99


def test_miss_contract_and_padding():
    """A miss is (inf, 0, 0, 0) in both forms, and the padded (invalid,
    zero) triangles are never hit: the quad pads 2 triangles to 8."""
    port = RtxHost(tri_chunk=8, device="cpu")
    port.load_model(quad_mesh())
    rng = np.random.default_rng(1)
    o = np.tile(np.array([[0.0, 0.0, -6.0]], np.float32), (64, 1))
    d = rng.normal(scale=0.1, size=(64, 3)).astype(np.float32)
    d[:, 2] = np.where(np.arange(64) < 32, 1.0, -1.0)  # half towards the quad, half away
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for fn in (tr.intersect_reference, tr.intersect_component):
        t, i, u, v = (x.numpy() for x in fn(torch.from_numpy(o), torch.from_numpy(d),
                                              port._tris, 8))
        assert np.isfinite(t[:32]).all() and set(i[:32]) <= {0, 1}
        assert np.isinf(t[32:]).all()
        assert (i[32:] == 0).all() and (u[32:] == 0).all() and (v[32:] == 0).all()


def test_intersect_rejects_other_devices():
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.intersect(o, o, {}, 8)


def test_cuda_host_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RtxHost(device="cuda")


@pytest.mark.parametrize("env,roulette_from", [(False, 0), (True, 1)])
def test_bounce_step_matches_jax(env, roulette_from):
    """One bounce of a mixed batch (alive and dead, reflected and not,
    partial alpha), fed the random numbers _bounce_step draws from its key
    (tracer.py:545-550, 607, 610, 639): the whole state tuple and t."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.rt import tracer as jt

    rng = np.random.default_rng(17)
    tex = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    tex[..., 3] = rng.choice([0.3, 1.0], (8, 8))
    port, jax_host = hosts(icosphere_like(8), tex, 32)
    sky = rng.uniform(0, 1, (6, 12, 3)).astype(np.float32) if env else None
    if env:
        port.load_environment(sky)
        jax_host.load_environment(sky)
    r = 256
    o, d = scattered_rays(rng, r)
    atten = rng.uniform(0.2, 1.0, (r, 3)).astype(np.float32)
    result = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    alive = rng.uniform(size=r) < 0.9
    reflected = rng.choice([0.0, 1.0, 2.0], r).astype(np.float32)
    bg = np.array([0.2, 0.3, 0.4], np.float32)

    key = jax.random.PRNGKey(9)
    if roulette_from:
        k_alpha, k_scatter, k_roul = jax.random.split(key, 3)
        u_roul = torch.from_numpy(np.array(jax.random.uniform(k_roul, (r,))))
    else:
        (k_alpha, k_scatter), u_roul = jax.random.split(key), None
    u_alpha = torch.from_numpy(np.array(jax.random.uniform(k_alpha, (r,))))
    sphere = torch.from_numpy(np.array(jt._unit_sphere(k_scatter, (r,))))

    tex_cm = jnp.moveaxis(jnp.asarray(tex), -1, 0)
    state_j, t_j = jt._bounce_step(
        jax_host._tris, tex_cm, jnp.asarray(bg), jax_host._env, 32,
        *components(o), *components(d), atten, result, alive, reflected, key,
        roulette_from=roulette_from, bounce_i=1)
    state_t, t_t = tr.bounce_step(
        port._tris, torch.from_numpy(tex).permute(2, 0, 1).contiguous(), torch.from_numpy(bg),
        port._env, 32, *(torch.from_numpy(x) for x in (o, d, atten, result, alive, reflected)),
        u_alpha, sphere, u_roul, roulette_from=roulette_from, bounce_i=1)

    t_j, t_t = np.asarray(t_j), t_t.numpy()
    np.testing.assert_array_equal(np.isfinite(t_t), np.isfinite(t_j))
    assert np.isfinite(t_j).sum() > 80
    np.testing.assert_allclose(t_t[np.isfinite(t_j)], t_j[np.isfinite(t_j)], atol=STATE_ATOL)
    ox, oy, oz, dx, dy, dz, atten_j, result_j, alive_j, refl_j = (np.asarray(x) for x in state_j)
    o_t, d_t, atten_t, result_t, alive_t, refl_t = (x.numpy() for x in state_t)
    np.testing.assert_allclose(o_t, np.stack([ox, oy, oz], 1), atol=STATE_ATOL)
    np.testing.assert_allclose(d_t, np.stack([dx, dy, dz], 1), atol=STATE_ATOL)
    np.testing.assert_allclose(atten_t, atten_j, atol=STATE_ATOL)
    np.testing.assert_allclose(result_t, result_j, atol=STATE_ATOL)
    np.testing.assert_array_equal(alive_t, alive_j)
    np.testing.assert_array_equal(refl_t, refl_j)


def test_trace_one_bounce_matches_jax():
    """trace_rays with one bounce on an opaque scene has no randomness that
    shows: hits stay alive and return black, misses the background."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.rt import tracer as jt

    tex = solid_texture(0.7, 0.4, 0.2)
    port, jax_host = hosts(icosphere_like(8), tex, 32)
    rng = np.random.default_rng(21)
    r = 256
    o = np.tile(np.array([[0.3, -0.2, -6.0]], np.float32), (r, 1))
    d = (rng.normal(scale=1.5, size=(r, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bg = (0.1, 0.6, 0.3)
    c_j, t_j = jt.trace_rays(jax_host._tris, tex, jnp.asarray(o), jnp.asarray(d), 1, bg,
                             jax.random.PRNGKey(0), 32)
    gen = torch.Generator().manual_seed(0)
    c_t, t_t = tr.trace_rays(port._tris, torch.from_numpy(tex), torch.from_numpy(o),
                             torch.from_numpy(d), 1, bg, gen, 32)
    t_j = np.asarray(t_j)
    hit = np.isfinite(t_j)
    assert 0 < hit.sum() < r
    np.testing.assert_array_equal(np.isfinite(t_t.numpy()), hit)
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)


def test_primary_rays_match_float64():
    """Ray generation from a fixed jitter (tracer.py:758-780) against a
    float64 evaluation of the same formula, on a non-square frame."""
    w, h = 24, 16
    cam = Camera(np.array([1.0, 2.0, -7.0], np.float32), np.zeros(3, np.float32), 55.0)
    inv_pv = np.linalg.inv(cam.get_proj_view(w / h).astype(np.float64)).astype(np.float32)
    jitter = np.random.default_rng(2).uniform(0, 1, (w * h, 2)).astype(np.float32)
    pix = np.arange(w * h)
    got = tr.primary_rays(torch.from_numpy(pix), torch.from_numpy(jitter), w, h, inv_pv,
                          cam.location).numpy()
    m = inv_pv.astype(np.float64)
    nx = ((pix % w) + jitter[:, 0].astype(np.float64) + 0.5) * 2.0 / w - 1.0
    ny = ((pix // w) + jitter[:, 1].astype(np.float64) + 0.5) * 2.0 / h - 1.0
    fw = [m[k, 0] * nx + m[k, 1] * ny + m[k, 2] + m[k, 3] for k in range(4)]
    dirs = np.stack([fw[k] / fw[3] - cam.location[k] for k in range(3)], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # float32 rounding of the projective w cancellation, times the far plane
    np.testing.assert_allclose(got, dirs, atol=1e-5)


def test_deterministic_renders_match_jax_exactly():
    """No model renders black; a corner ray that misses returns the
    background; a fully transparent surface passes every ray to it."""
    from gaussian_splatterer_tpu.rt import RtxHost as JHost

    cam = front_camera()
    empty_t, empty_j = RtxHost(device="cpu"), JHost()
    assert not empty_t.render(cam, (1.0, 1.0, 1.0), 8, RES, RES).any()
    assert not np.asarray(empty_j.render(jax_camera(cam), (1.0, 1.0, 1.0), 8, RES, RES)).any()
    for half, tex, check in ((0.4, solid_texture(1, 0, 0), "corner"),
                             (2.0, solid_texture(1, 1, 1, a=0.0), "all")):
        port, jax_host = hosts(quad_mesh(half=half), tex, 8)
        for bg in ((0.0, 0.0, 0.0), (0.2, 0.5, 0.9)):
            img_t = port.render(cam, bg, 8, RES, RES, seed=7).numpy()
            img_j = np.asarray(jax_host.render(jax_camera(cam), bg, 8, RES, RES, seed=7))
            # the background summed over the 8 samples in float32, then averaged
            acc = np.zeros(3, np.float32)
            for _ in range(8):
                acc += np.asarray(bg, np.float32)
            want = np.broadcast_to(acc / np.float32(8), img_t.shape)
            if check == "corner":
                img_t, img_j, want = img_t[0, 0], img_j[0, 0], want[0, 0]
            np.testing.assert_array_equal(img_t, img_j)
            np.testing.assert_array_equal(img_t, want)


@pytest.mark.parametrize("scene", ["quad", "icosphere"])
def test_renders_match_jax_statistically(scene):
    """Whole renders at 128 samples: the image means agree within 5e-3, the
    mean |port - JAX| is within 1.5x the mean |port - port| of two seeds
    (the Monte-Carlo noise of the same render) plus 1e-3, and the orbs
    invert the same pixels.  Both packages' orb masks are read off a render
    with and one without orbs from the same seed: the orbs consume no
    random numbers."""
    samples = 128
    if scene == "quad":
        mesh, tex, orbs = quad_mesh(), solid_texture(0.8, 0.5, 0.3), [
            np.array([1.0, 1.0, -3.0], np.float32), np.array([-0.8, 0.3, -2.5], np.float32)]
    else:
        mesh, tex, orbs = icosphere_like(12), solid_texture(0.7, 0.4, 0.2), None
    port, jax_host = hosts(mesh, tex, 32 if scene == "icosphere" else 8)
    cam, bg = front_camera(), (0.1, 0.2, 0.3)
    a = port.render(cam, bg, samples, RES, RES, splat_cameras=orbs, seed=5).numpy()
    b = port.render(cam, bg, samples, RES, RES, splat_cameras=orbs, seed=6).numpy()
    j = np.asarray(jax_host.render(jax_camera(cam), bg, samples, RES, RES,
                                   splat_cameras=orbs, seed=5))
    assert abs(float(a.mean()) - float(j.mean())) < 5e-3
    noise = float(np.abs(a - b).mean())
    assert 0.0 < noise and float(np.abs(a - j).mean()) <= 1.5 * noise + 1e-3
    if orbs:
        plain_t = port.render(cam, bg, samples, RES, RES, seed=5).numpy()
        plain_j = np.asarray(jax_host.render(jax_camera(cam), bg, samples, RES, RES, seed=5))
        mask_t = np.abs(a - plain_t).max(-1) > 1e-6
        mask_j = np.abs(j - plain_j).max(-1) > 1e-6
        assert mask_t.any() and (mask_t & mask_j).any()
        # a pixel barely grazed by an orb may catch a jittered ray in one
        # render and not the other
        assert (mask_t ^ mask_j).sum() <= 2


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel_vs_plain(host, o, d):
    """K5 against its plain twin on the card, through chip_smoke.py's gate
    (hit masks agree on 99.99% of rays; winners equal where both hit on
    99.99% of them, and every other winner an exact tie in float64; t rel
    1e-5; u, v abs 1e-5; the miss contract).  Returns the number of hits."""
    launches = tr.mt_intersect_launches
    k = tr.intersect(o, d, host._tris, host.tri_chunk)
    torch.cuda.synchronize()
    assert tr.mt_intersect_launches == launches + 1
    p = tr.intersect_reference(o, d, host._tris, host.tri_chunk)
    _load_chip_smoke().compare_hits("kernel vs plain", o, d, host._tris, k, p)
    return int(torch.isfinite(k[0]).sum())


@pytest.mark.cuda
def test_mt_kernel_matches_plain_on_soup(cuda_device):  # noqa: F811
    rng = np.random.default_rng(3)
    host = RtxHost(device=cuda_device)
    host.load_model(random_soup(1000, rng))
    r = 1 << 16
    o = torch.from_numpy(rng.uniform(-4, 4, (r, 3)).astype(np.float32)).to(cuda_device)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)), dim=1).to(cuda_device)
    assert _kernel_vs_plain(host, o, d) > r // 10


@pytest.mark.cuda
def test_mt_kernel_matches_plain_on_mushroom(cuda_device):  # noqa: F811
    """Bounce rays leaving the north-star mushroom's surface (chip_smoke's
    mesh), the cancellation case of t_num."""
    smoke = _load_chip_smoke()
    mesh = smoke.mushroom_mesh(32, 16)
    host = RtxHost(device=cuda_device)
    host.load_model(mesh)
    o, d = smoke.surface_rays(mesh, 1 << 16, seed=4)
    assert _kernel_vs_plain(host, o.to(cuda_device), d.to(cuda_device)) > 1000


def test_plain_render_is_counted_nowhere():
    """On the CPU the tracer takes the plain intersector: no launch."""
    host = RtxHost(tri_chunk=8, device="cpu")
    host.load_model(quad_mesh())
    before = tr.mt_intersect_launches
    img = host.render(front_camera(), (0.0, 0.0, 0.0), 2, 8, 8, seed=1)
    assert tr.mt_intersect_launches == before and math.isfinite(float(img.sum()))
