"""The PyTorch port's culled intersector (the Morton-chunk AABB march of
gaussian_splatterer_tpu.rt.tracer._intersect_culled) on the CPU, against the
JAX package's march and against the port's own brute force, at the small
scenes of tests/test_rt.py with ``accel_min=1`` (every scene Morton-ordered
into chunks of 32 triangles); and the kernel K9 against its plain twin on
the card (marker ``cuda``, skipped without one).

The gate of a hit set is chip_smoke.py's hit_winners (phase 9's: winners
equal on at least 99.99% of the hits, every other winner an exact tie, in
float64 the other triangle at the same distance, rel 1e-5, holding the hit
point; a miss is (inf, 0, 0, 0)), with the hit masks equal; t within rtol
1e-5 (plus an atol of 1e-6 against the JAX package, the float32 rounding of
t_num's cancellation for origins on the mesh, which XLA rounds in another
order); u and v within atol 1e-5.  Against the port's brute force the
arithmetic of a pair is the same, so where the winners agree t, u and v
are equal bit for bit."""

import numpy as np
import pytest
import torch
from test_torch_rt import (RES, _load_chip_smoke, components, front_camera, hosts,
                           icosphere_like, jax_camera, quad_mesh, random_soup, scattered_rays,
                           solid_texture)
from torch_parity import cuda_device  # noqa: F401  (fixture)

from gaussian_splatterer_tpu_torch.rt import tracer as tr
from gaussian_splatterer_tpu_torch.rt.tracer import RtxHost
from gaussian_splatterer_tpu_torch.scripts import scenes

TC = 32
T_RTOL, T_ATOL_JAX, UV_ATOL = 1e-5, 1e-6, 1e-5

def culled_scene(name):
    """(mesh, tolerance note): tests/test_rt.py's 288-triangle UV sphere or
    a 600-triangle random soup."""
    if name == "icosphere":
        return icosphere_like(12)
    return random_soup(600, np.random.default_rng(5))


def ray_sets(rng, r=1024):
    """Scattered rays (origins around and on the sphere, half aimed inward)
    and eye rays (one origin in front of the scene, directions spread over
    it)."""
    o, d = scattered_rays(rng, r)
    eye = np.tile(np.array([[0.3, -0.2, -6.0]], np.float32), (r, 1))
    aim = (rng.normal(scale=1.2, size=(r, 3)) - eye).astype(np.float32)
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    return {"scattered": (o, d), "eye": (eye, aim)}


def assert_gate(got, ref, o, d, tris, t_atol=0.0, exact=False):
    """The module's gate of ``got`` against ``ref`` (t, idx, u, v); with
    ``exact``, t, u and v where the winners agree are equal bit for bit.
    Returns the number of hits."""
    got, ref = ([torch.tensor(np.asarray(x)) for x in hits] for hits in (got, ref))
    w = _load_chip_smoke().hit_winners(torch.from_numpy(o), torch.from_numpy(d), tris, got, ref)
    assert w["mask_share"] == 1.0 and w["ok"], w["text"]
    hit, same = w["both"], w["same"]
    torch.testing.assert_close(got[0][hit], ref[0][hit], rtol=T_RTOL, atol=t_atol)
    for a, b in zip(got[2:], ref[2:]):
        torch.testing.assert_close(a[same], b[same], rtol=0, atol=UV_ATOL)
    if exact:
        for a, b in zip(got, ref):
            assert torch.equal(a[same], b[same])
    return w["hits"]


def test_tri12_holds_geo10_triangle_by_triangle():
    """K9's table: row i of tri12 is column i of geo10 (the JAX package's,
    held equal by test_scene_tables_match_jax) and two zeros."""
    port, jax_host = hosts(culled_scene("soup"), None, TC, accel_min=1)
    tri12, geo10 = port._tris["tri12"].numpy(), np.asarray(jax_host._tris["geo10"])
    assert tri12.shape == (geo10.shape[1], 12) and tri12.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(tri12[:, :10], geo10.T)
    assert not tri12[:, 10:].any()
    assert tri12.shape[0] % TC == 0 and not tri12[600:].any()  # padding: invalid, zero


@pytest.mark.parametrize("scene", ["icosphere", "soup"])
def test_culled_reference_matches_jax(scene):
    """intersect_culled_reference against the JAX package's
    _intersect_culled on the same Morton tables (32-triangle chunks), with
    scattered and eye rays."""
    from gaussian_splatterer_tpu.rt import tracer as jt

    port, jax_host = hosts(culled_scene(scene), None, TC, accel_min=1)
    assert "bb_minx" in port._tris and "bb_minx" in jax_host._tris
    for label, (o, d) in ray_sets(np.random.default_rng(13)).items():
        ref = jt._intersect_culled(*components(o), *components(d), jax_host._tris, TC)
        got = tr.intersect_culled_reference(torch.from_numpy(o), torch.from_numpy(d),
                                            port._tris, TC)
        assert all(x.dtype == y for x, y in zip(got, (torch.float32, torch.int32,
                                                      torch.float32, torch.float32)))
        n = assert_gate(got, ref, o, d, port._tris, t_atol=T_ATOL_JAX)
        assert n > 100, (label, n)


@pytest.mark.parametrize("scene", ["icosphere", "soup"])
def test_culled_route_matches_bruteforce(scene):
    """The port's culled route (intersect_culled, the plain twin on the CPU)
    against its component-form brute force on the same rays: the same
    arithmetic a pair, another order of visits (tests/test_rt.py's
    test_culled_matches_bruteforce, on hits).  The march visits fewer
    chunks than there are."""
    port = RtxHost(tri_chunk=TC, device="cpu")
    port.load_model(culled_scene(scene), accel_min=1)
    nc = port._tris["bb_minx"].shape[0]
    for label, (o, d) in ray_sets(np.random.default_rng(21)).items():
        ot, dt = torch.from_numpy(o), torch.from_numpy(d)
        got = tr.intersect_culled(ot, dt, port._tris, TC)
        brute = tr.intersect_component(ot, dt, port._tris, TC)
        n = assert_gate(got, brute, o, d, port._tris, exact=True)
        assert n > 100, (label, n)
        visits = tr.culled_march(ot, dt, port._tris, TC)[4]
        assert 0 < float(visits.float().mean()) < nc


def test_culled_miss_contract_and_padding():
    """A miss is (inf, 0, 0, 0), and the padded (invalid, zero) triangles of
    the last chunk are never hit: the quad pads 2 triangles to 8."""
    port = RtxHost(tri_chunk=8, device="cpu")
    port.load_model(quad_mesh(), accel_min=1)
    rng = np.random.default_rng(1)
    o = np.tile(np.array([[0.0, 0.0, -6.0]], np.float32), (64, 1))
    d = rng.normal(scale=0.1, size=(64, 3)).astype(np.float32)
    d[:, 2] = np.where(np.arange(64) < 32, 1.0, -1.0)  # half towards the quad, half away
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, i, u, v = (x.numpy() for x in tr.intersect_culled_reference(
        torch.from_numpy(o), torch.from_numpy(d), port._tris, 8))
    assert np.isfinite(t[:32]).all() and set(i[:32]) <= {0, 1}
    assert np.isinf(t[32:]).all()
    assert (i[32:] == 0).all() and (u[32:] == 0).all() and (v[32:] == 0).all()
    empty = tr.intersect_culled_reference(torch.zeros((0, 3)), torch.zeros((0, 3)),
                                          port._tris, 8)
    assert [x.shape for x in empty] == [(0,)] * 4


def test_culled_rejects_other_devices():
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.intersect_culled(o, o, {}, 8)


@pytest.mark.parametrize("env,roulette_from", [(False, 0), (True, 1)])
def test_culled_bounce_step_matches_jax(env, roulette_from):
    """One bounce on a Morton-ordered scene (accel_min 1), where both
    packages' bounce steps take the culled march, fed the random numbers
    _bounce_step draws from its key: test_bounce_step_matches_jax's
    pattern and tolerances."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatterer_tpu.rt import tracer as jt

    rng = np.random.default_rng(17)
    tex = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    tex[..., 3] = rng.choice([0.3, 1.0], (8, 8))
    port, jax_host = hosts(icosphere_like(8), tex, TC, accel_min=1)
    assert "bb_minx" in port._tris
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
        jax_host._tris, tex_cm, jnp.asarray(bg), jax_host._env, TC,
        *components(o), *components(d), atten, result, alive, reflected, key,
        roulette_from=roulette_from, bounce_i=1)
    state_t, t_t = tr.bounce_step(
        port._tris, torch.from_numpy(tex).permute(2, 0, 1).contiguous(), torch.from_numpy(bg),
        port._env, TC, *(torch.from_numpy(x) for x in (o, d, atten, result, alive, reflected)),
        u_alpha, sphere, u_roul, roulette_from=roulette_from, bounce_i=1)

    atol = 1e-5  # test_torch_rt.py's STATE_ATOL: positions t*d, products of texels
    t_j, t_t = np.asarray(t_j), t_t.numpy()
    np.testing.assert_array_equal(np.isfinite(t_t), np.isfinite(t_j))
    assert np.isfinite(t_j).sum() > 80
    np.testing.assert_allclose(t_t[np.isfinite(t_j)], t_j[np.isfinite(t_j)], atol=atol)
    ox, oy, oz, dx, dy, dz, atten_j, result_j, alive_j, refl_j = (np.asarray(x) for x in state_j)
    o_t, d_t, atten_t, result_t, alive_t, refl_t = (x.numpy() for x in state_t)
    np.testing.assert_allclose(o_t, np.stack([ox, oy, oz], 1), atol=atol)
    np.testing.assert_allclose(d_t, np.stack([dx, dy, dz], 1), atol=atol)
    np.testing.assert_allclose(atten_t, atten_j, atol=atol)
    np.testing.assert_allclose(result_t, result_j, atol=atol)
    np.testing.assert_array_equal(alive_t, alive_j)
    np.testing.assert_array_equal(refl_t, refl_j)


def _render(host, samples, seed, size=16, intersector=None):
    cam = front_camera()
    inv_pv = np.linalg.inv(cam.get_proj_view(1.0).astype(np.float64)).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    sums = tr.render_rtx_sums(host._tris, host._texture, cam.location, inv_pv, size, size,
                              samples, (0.1, 0.2, 0.3), gen, tri_chunk=host.tri_chunk,
                              sample_batch=host.sample_batch, intersector=intersector)
    return tr.finish_rtx(*sums, samples, size, size).numpy()


def test_culled_render_matches_bruteforce():
    """tests/test_rt.py's test_culled_matches_bruteforce: a 16^2 render,
    6 samples, seed 5, with accel_min 1 (the culled route for every ray)
    equals one with accel_min 10^9 within 1e-5, the brute side on the
    component intersector (the JAX test's mxu_bounce=False) so that a pair's
    arithmetic is the same on both sides."""
    imgs = []
    for accel_min, fn in ((1, None), (10**9, tr.intersect_component)):
        host = RtxHost(tri_chunk=TC, device="cpu")
        host.load_model(icosphere_like(12), accel_min=accel_min)
        host.load_texture_diffuse(solid_texture(0.7, 0.4, 0.2))
        assert ("bb_minx" in host._tris) == (accel_min == 1)
        imgs.append(_render(host, 6, 5, intersector=fn))
    assert imgs[0].max() > imgs[0].min()
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-5)


@pytest.mark.parametrize("scene", ["quad", "icosphere"])
def test_culled_renders_match_jax_statistically(scene):
    """test_torch_rt.py's test_renders_match_jax_statistically at accel_min
    1, where the JAX package's bounces take its culled march and the port's
    primaries and bounces take the port's: 128 samples, the image means
    within 5e-3, the mean |port - JAX| within 1.5x the mean |port - port|
    of two seeds plus 1e-3."""
    samples = 128
    if scene == "quad":
        mesh, tex = quad_mesh(), solid_texture(0.8, 0.5, 0.3)
    else:
        mesh, tex = icosphere_like(12), solid_texture(0.7, 0.4, 0.2)
    port, jax_host = hosts(mesh, tex, TC if scene == "icosphere" else 8, accel_min=1)
    assert "bb_minx" in port._tris and "bb_minx" in jax_host._tris
    cam, bg = front_camera(), (0.1, 0.2, 0.3)
    a = port.render(cam, bg, samples, RES, RES, seed=5).numpy()
    b = port.render(cam, bg, samples, RES, RES, seed=6).numpy()
    j = np.asarray(jax_host.render(jax_camera(cam), bg, samples, RES, RES, seed=5))
    assert abs(float(a.mean()) - float(j.mean())) < 5e-3
    noise = float(np.abs(a - b).mean())
    assert 0.0 < noise and float(np.abs(a - j).mean()) <= 1.5 * noise + 1e-3


@pytest.mark.parametrize("n_theta,culled", [(23, True), (22, False)])
def test_host_routes_by_accel_min(monkeypatch, n_theta, culled):
    """RtxHost with the default accel_min (1,024): a 1,058-triangle sphere
    sends every intersection, primaries and bounces, through
    intersect_culled and none through intersect; a 968-triangle one the
    reverse."""
    calls = {"intersect_culled": 0, "intersect": 0}

    def spy(name):
        real = getattr(tr, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapped

    for name in calls:
        monkeypatch.setattr(tr, name, spy(name))
    mesh = icosphere_like(n_theta)
    host = RtxHost(device="cpu")
    host.load_model(mesh)
    assert (mesh.num_triangles >= 1024) == culled == ("bb_minx" in host._tris)
    host.load_texture_diffuse(solid_texture(0.7, 0.4, 0.2))
    img = host.render(front_camera(), (0.0, 0.0, 0.0), 2, 8, 8, seed=1)
    assert np.isfinite(img.numpy()).all() and float(img.max()) > 0.0
    used, unused = ("intersect_culled", "intersect") if culled else ("intersect",
                                                                      "intersect_culled")
    assert calls[used] >= 2 and calls[unused] == 0, calls


@pytest.mark.parametrize("mesh_res,culled", [(32, False), (48, True)])
def test_quality_scene_routes_by_mesh_res(monkeypatch, mesh_res, culled):
    """quality_run's and eval_model's ``--mesh-res`` scene (load_scene, the
    default accel_min): the north star's 960 triangles keep the brute
    force, mesh-res 48 (2,208 triangles) takes the culled route for every
    intersection, with no new flag."""
    from gaussian_splatterer_tpu_torch.scripts import quality_run

    calls = []
    real = tr.intersect_culled
    monkeypatch.setattr(tr, "intersect_culled", lambda *a, **k: calls.append(1) or real(*a, **k))
    host = RtxHost(device="cpu")
    quality_run.load_scene(host, "mushroom", mesh_res)
    assert ("bb_minx" in host._tris) == culled
    img = host.render(front_camera(), (0.0, 0.0, 0.0), 2, 8, 8, seed=1)
    assert np.isfinite(img.numpy()).all()
    assert bool(calls) == culled


def test_plain_culled_render_is_counted_nowhere():
    """On the CPU the culled route takes the plain twin: no launch."""
    host = RtxHost(tri_chunk=8, device="cpu")
    host.load_model(quad_mesh(), accel_min=1)
    before = (tr.mt_culled_launches, tr.mt_intersect_launches)
    img = host.render(front_camera(), (0.0, 0.0, 0.0), 2, 8, 8, seed=1)
    assert (tr.mt_culled_launches, tr.mt_intersect_launches) == before
    assert np.isfinite(img.numpy()).all()


# -- on the card -----------------------------------------------------------------


def _culled_host(cuda_device, scene):
    """A Morton-ordered host on the card: the 600-triangle soup (accel_min 1,
    chunks of 32) or the mesh-res 64 mushroom (3,968 triangles, the default
    accel_min and chunk)."""
    if scene == "soup":
        host = RtxHost(tri_chunk=TC, device=cuda_device)
        host.load_model(culled_scene("soup"), accel_min=1)
    else:
        host = RtxHost(device=cuda_device)
        host.load_model(scenes.mushroom_mesh(64, 32))
    assert "bb_minx" in host._tris
    return host


def _rays(cuda_device, host, scene, r, seed=4):
    if scene == "soup":
        rng = np.random.default_rng(seed)
        o = torch.from_numpy(rng.uniform(-4, 4, (r, 3)).astype(np.float32))
        d = torch.nn.functional.normalize(torch.from_numpy(
            rng.normal(size=(r, 3)).astype(np.float32)), dim=1)
    else:
        o, d = _load_chip_smoke().surface_rays(host.mesh, r, seed=seed)
    return o.to(cuda_device), d.to(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["soup", "mushroom"])
@pytest.mark.parametrize("r", [1 << 10, 1 << 16])
def test_culled_kernel_matches_plain(cuda_device, scene, r):  # noqa: F811
    """K9 against its plain twin through chip_smoke.py's gate (phase 9's:
    masks, winners on 99.99% with the rest exact ties, t rel 1e-5, u and v
    1e-5, the miss contract), one launch counted."""
    host = _culled_host(cuda_device, scene)
    o, d = _rays(cuda_device, host, scene, r)
    launches = tr.mt_culled_launches
    k = tr.intersect_culled(o, d, host._tris, host.tri_chunk)
    torch.cuda.synchronize()
    assert tr.mt_culled_launches == launches + 1
    p = tr.intersect_culled_reference(o, d, host._tris, host.tri_chunk)
    _load_chip_smoke().compare_hits("K9 vs plain", o, d, host._tris, k, p)
    assert int(torch.isfinite(k[0]).sum()) > r // 64


@pytest.mark.cuda
def test_culled_kernel_launches_bit_equal(cuda_device):  # noqa: F811
    """Two launches of K9 on the same rays give the same hits bit for bit,
    and a prefix of the rays the prefix of the hits."""
    host = _culled_host(cuda_device, "mushroom")
    o, d = _rays(cuda_device, host, "mushroom", 1 << 16, seed=9)
    a = tr.intersect_culled(o, d, host._tris, host.tri_chunk)
    b = tr.intersect_culled(o, d, host._tris, host.tri_chunk)
    c = tr.intersect_culled(o[:777], d[:777], host._tris, host.tri_chunk)
    for x, y, z in zip(a, b, c):
        assert x.dtype == y.dtype and torch.equal(x, y) and torch.equal(x[:777], z)


@pytest.mark.cuda
def test_culled_kernel_reads_boxes_from_global_memory(cuda_device):  # noqa: F811
    """Chunks of 8 on the mesh-res 288 mushroom (82,368 triangles): 10,296
    boxes of 24 B do not fit in a block's shared memory, so K9 reads them
    from global memory, with the same hits as its plain twin bit for bit."""
    host = RtxHost(tri_chunk=8, device=cuda_device)
    host.load_model(scenes.mushroom_mesh(288, 144))
    nc = host._tris["bb_minx"].numel()
    assert 24 * nc > torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    o, d = _rays(cuda_device, host, "mushroom", 1 << 12)
    k = tr.intersect_culled(o, d, host._tris, host.tri_chunk)
    p = tr.intersect_culled_reference(o, d, host._tris, host.tri_chunk)
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    assert int(torch.isfinite(k[0]).sum()) > (1 << 12) // 2


@pytest.mark.cuda
def test_culled_kernel_matches_bruteforce_kernel(cuda_device):  # noqa: F811
    """K9 against K5 on the same rays and the same (Morton-ordered) tables,
    through chip_smoke.compare_forms: masks and winners at phase 9's gate,
    K9's t, u and v against float64 within their float32 condition (the
    two forms round the numerators' cancellations differently)."""
    host = _culled_host(cuda_device, "mushroom")
    o, d = _rays(cuda_device, host, "mushroom", 1 << 16, seed=5)
    k9 = tr.intersect_culled(o, d, host._tris, host.tri_chunk)
    k5 = tr.intersect(o, d, host._tris, host.tri_chunk, reject=False)
    _load_chip_smoke().compare_forms("K9 vs K5", o, d, host._tris, k9, k5)
