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
from gaussian_splatterer_tpu_torch.scripts import scenes

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


@pytest.mark.parametrize("accel_min", [1, 10**9])
def test_tri40_matches_feat10_and_jax(accel_min):
    """K5's table: one row per real triangle, in index order, holding that
    triangle's feat10 columns [det | u_num | v_num | t_num] x 10 features;
    tri_ids the real triangles' indices.  Held against the JAX package's
    tables at the shapes of test_scene_tables_match_jax: its feat10 and
    valid on the brute-force route; on the Morton route, which builds no
    feat10, the port's (held equal to JAX's there) and the det weights
    e2 x e1 from JAX's own edge tables."""
    port, jax_host = hosts(icosphere_like(6), None, 16, accel_min=accel_min, mt_kernel=True)
    jt = {k: np.asarray(v) for k, v in jax_host._tris.items()}
    feat = jt["feat10"] if "feat10" in jt else port._tris["feat10"].numpy()
    valid = jt.get("validf", jt["valid"]).reshape(-1) > 0
    tc, n = 16, valid.size
    real = np.nonzero(valid)[0]
    assert 0 < real.size < n  # 72 triangles padded to 80
    np.testing.assert_array_equal(port._tris["tri_ids"].numpy(), real)
    assert port._tris["tri_ids"].dtype == torch.int32
    tri40 = port._tris["tri40"].numpy()
    assert tri40.shape == (real.size, 40) and tri40.flags["C_CONTIGUOUS"]
    for row, i in enumerate(real):
        ck, j = divmod(int(i), tc)
        cols = [ck * 4 * tc + q * tc + j for q in range(4)]
        want = np.concatenate([feat[:, c] for c in cols])
        np.testing.assert_array_equal(tri40[row], want)
    e1, e2 = (np.stack([jt[f"{e}{c}"][real] for c in "xyz"], 1) for e in ("e1", "e2"))
    np.testing.assert_array_equal(tri40[:, 0:3], np.cross(e2, e1))
    assert not tri40[:, 3:10].any()  # det weighs the direction alone


def _tie_soup(rng):
    """24 triangles: the last 12 repeat the first 12 exactly, so a ray that
    hits one hits its twin at the same t: an exact tie across any split."""
    base = random_soup(12, rng)
    verts = np.concatenate([base.vertices, base.vertices])
    tris = np.arange(72, dtype=np.int32).reshape(24, 3)
    return TriangleMesh(verts, tris, np.concatenate([base.tri_uv, base.tri_uv]))


@pytest.mark.parametrize("scene", ["soup", "ties"])
def test_split_merge_equals_unsplit_bit_for_bit(scene):
    """The plain twin of K5's split: first hits over S contiguous slices of
    the real triangles, merged in slice order with a strict <, equal bit
    for bit to the unsplit first hit for S in {1, 2, 3, 7}, exact ties
    across slice boundaries included (they go to the lowest index); and the
    same hits as intersect_reference to float32 rounding."""
    rng = np.random.default_rng(8)
    mesh = random_soup(40, rng) if scene == "soup" else _tie_soup(rng)
    host = RtxHost(tri_chunk=16, device="cpu")
    host.load_model(mesh, accel_min=10**9)
    r = 512
    o = torch.from_numpy(rng.uniform(-4, 4, (r, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)), dim=1)
    whole = tr.first_hit_rows(o, d, host._tris["tri40"], host._tris["tri_ids"])
    hits = torch.isfinite(whole[0])
    assert int(hits.sum()) >= 20
    for s in (1, 2, 3, 7):
        got = tr.intersect_split_reference(o, d, host._tris, s)
        for a, b in zip(got, whole):
            assert a.dtype == b.dtype and torch.equal(a, b), s
    if scene == "ties":
        assert (whole[1][hits] < 12).all()
    assert_hits_match(whole, tr.intersect_reference(o, d, host._tris, 16), idx_share=0.99)


def _reject_and_accept(det, u_num, v_num, t_num, best_t):
    args = [torch.tensor(np.asarray(x, np.float32)) for x in (det, u_num, v_num, t_num, best_t)]
    return tr.reject_pairs(*args[:3]), tr.accept_pairs(*args)


def test_reject_never_refuses_an_accepted_pair_on_edges():
    """Crafted pairs at every edge of the epilogue: u_num so small that
    u_num x inv underflows to -0.0 (which passes u >= 0), |det| at and
    around 1e-12 on either side of zero (clamped to +1e-12), t at 1e-3,
    u + v at 1, t equal to best_t and one step either side."""
    f32 = np.float32
    eps = f32(1e-12)
    dets = [eps, -eps, np.nextafter(eps, f32(0)), -np.nextafter(eps, f32(0)),
            np.nextafter(eps, f32(1)), -np.nextafter(eps, f32(1)), f32(5e-13), f32(-5e-13),
            f32(0.0), f32(-0.0), f32(1.0), f32(-3.5), f32(1e30), f32(-1e30), f32(2e-7)]
    cases = []
    for det in dets:
        den = eps if abs(det) < eps else det
        for uf, vf in ((0.25, 0.25), (0.5, 0.5), (1.0, 0.0), (0.0, 1.0), (0.0, 0.0),
                       (-1e-30, 0.5), (1e-30, 0.5), (-1e-45, 0.3), (0.6, 0.4)):
            for tf in (1e-3, 2.0, 0.5e-3):
                u_num, v_num, t_num = (f32(x) * f32(den) for x in (uf, vf, tf))
                for du in (-1, 0, 1):  # a step either side of each edge
                    un = np.nextafter(u_num, f32(np.inf) if du > 0 else f32(-np.inf)) \
                        if du else u_num
                    for tn in (t_num, np.nextafter(t_num, f32(np.inf)),
                               np.nextafter(t_num, f32(-np.inf))):
                        cases.append((det, un, v_num, tn))
    # u_num x inv underflowing to -0.0: den 1e30, u_num -1e-20 (u = -1e-50)
    cases += [(f32(1e30), f32(-1e-20), f32(3e29), f32(5e30)),
              (f32(-1e30), f32(1e-20), f32(-3e29), f32(-5e30)),
              (f32(1e20), f32(-1e-30), f32(3e19), f32(5e20))]
    det, u_num, v_num, t_num = (np.array(c, np.float32) for c in zip(*cases))
    # best_t: none yet, the pair's own t, and a step either side of it
    inv = np.float32(1) / np.where(np.abs(det) < eps, eps, det)
    t_own = t_num * inv
    n_acc = 0
    for best in (np.full_like(t_own, np.inf), t_own, np.nextafter(t_own, f32(np.inf)),
                 np.nextafter(t_own, f32(-np.inf)), np.full_like(t_own, 1e-3)):
        rej, acc = _reject_and_accept(det, u_num, v_num, t_num, best)
        assert not bool((rej & acc).any())
        n_acc += int(acc.sum())
    assert n_acc > 100
    # the underflow cases are accepted (u = -0.0) and not rejected
    rej, acc = _reject_and_accept(det[-3:], u_num[-3:], v_num[-3:], t_num[-3:],
                                  np.full(3, np.inf, np.float32))
    assert acc.all() and not rej.any()


def test_reject_never_refuses_an_accepted_pair_at_random():
    """10^5 random pairs over 17 decades of |det|, numerators around the
    edges of the barycentric and t tests, and best_t from none to near:
    the reject refuses most pairs and never one the epilogue accepts."""
    rng = np.random.default_rng(12)
    n = 100_000
    det = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-14, 3, n)).astype(np.float32)
    det[rng.uniform(size=n) < 0.02] = 0.0
    den = np.where(np.abs(det) < 1e-12, np.float32(1e-12), det)
    u_num = (rng.uniform(-1.0, 1.5, n) * den).astype(np.float32)
    v_num = (rng.uniform(-1.0, 1.5, n) * den).astype(np.float32)
    t_num = (rng.uniform(-2e-3, 4.0, n) * den).astype(np.float32)
    best = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.uniform(1e-3, 4.0, n)).astype(np.float32)
    rej, acc = _reject_and_accept(det, u_num, v_num, t_num, best)
    assert not bool((rej & acc).any())
    assert int(acc.sum()) > 1000 and float(rej.float().mean()) > 0.5


def test_slice_plan():
    """The split over triangles: one slice when the ray tiles fill two waves
    of blocks; else the fewest slices whose blocks come within 5% of the
    best fill of their last wave, each of at least 8 triangles, none empty
    (the mushroom's 960 triangles, 132 blocks at once, 2048 rays a block)."""
    assert tr.slice_plan(8_388_608, 960, 132, 2048) == (1, 960)
    assert tr.slice_plan(1 << 20, 960, 132, 2048) == (1, 960)
    assert tr.slice_plan(1 << 16, 960, 132, 2048) == (4, 240)  # 128 blocks: one wave
    assert tr.slice_plan(1 << 13, 960, 132, 2048) == (32, 30)  # 128 blocks
    assert tr.slice_plan(1 << 10, 960, 132, 2048) == (107, 9)
    assert tr.slice_plan(5, 0, 132, 2048) == (1, 0)
    for r in (1, 100, 3000, 50_000, 300_000):
        for t in (1, 7, 9, 100, 961, 5000):
            s, per = tr.slice_plan(r, t, 132, 1024)
            assert per >= min(t, 8) and (s - 1) * per < t <= s * per
            assert s == 1 or s * r <= tr.K5_MAX_SCRATCH


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
@pytest.mark.parametrize("r", [1 << 10, 1 << 16])
def test_mt_kernel_matches_plain_on_soup(cuda_device, r):  # noqa: F811
    """1000 triangles (160 KB: resident in shared memory); 2^10 rays split
    over about a hundred slices of triangles, 2^16 over a few."""
    rng = np.random.default_rng(3)
    host = RtxHost(device=cuda_device)
    host.load_model(random_soup(1000, rng))
    o = torch.from_numpy(rng.uniform(-4, 4, (r, 3)).astype(np.float32)).to(cuda_device)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)), dim=1).to(cuda_device)
    assert _kernel_vs_plain(host, o, d) > r // 10


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1 << 10, 1 << 16])
def test_mt_kernel_matches_plain_on_mushroom(cuda_device, r):  # noqa: F811
    """Bounce rays leaving the north-star mushroom's surface (scenes.py's
    mesh), the cancellation case of t_num."""
    smoke = _load_chip_smoke()
    mesh = scenes.mushroom_mesh(32, 16)
    host = RtxHost(device=cuda_device)
    host.load_model(mesh)
    o, d = smoke.surface_rays(mesh, r, seed=4)
    assert _kernel_vs_plain(host, o.to(cuda_device), d.to(cuda_device)) > r // 64


def _mushroom_rays(cuda_device, r, seed=4):
    smoke = _load_chip_smoke()
    mesh = scenes.mushroom_mesh(32, 16)
    host = RtxHost(device=cuda_device)
    host.load_model(mesh)
    o, d = smoke.surface_rays(mesh, r, seed=seed)
    return host, o.to(cuda_device), d.to(cuda_device)


def _assert_same_hits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
def test_mt_kernel_split_equals_unsplit(cuda_device):  # noqa: F811
    """intersect(o[:k]) is intersect(o)[:k] bit for bit: launches of 1 to
    2^15 rays take the split over triangles into slice_plan's slices (from
    over a hundred down to a few) and the merge, 2^20 the unsplit launch;
    two launches are bit-equal."""
    host, o, d = _mushroom_rays(cuda_device, 1 << 20)
    tris, tc = host._tris, host.tri_chunk
    slots, t_real = tr.mt_slots(o.device), tris["tri40"].shape[0]
    assert tr.slice_plan(o.shape[0], t_real, slots, tr.K5_RAYS_PER_BLOCK)[0] == 1
    whole = tr.intersect(o, d, tris, tc)
    splits = set()
    for k in (1, 100, 1024, 5000, 8192, 1 << 15):
        splits.add(tr.slice_plan(k, t_real, slots, tr.K5_RAYS_PER_BLOCK)[0])
        _assert_same_hits(tr.intersect(o[:k], d[:k], tris, tc), [x[:k] for x in whole])
    assert len(splits) >= 3 and min(splits) > 1
    _assert_same_hits(tr.intersect(o, d, tris, tc), whole)


@pytest.mark.cuda
def test_mt_kernel_forms_agree(cuda_device):  # noqa: F811
    """Both forms of the kernel give the same hits bit for bit: with and
    without the reject, on bounce rays and on coherent rays (one point
    seeing the mesh), split and unsplit."""
    host, o, d = _mushroom_rays(cuda_device, 1 << 19, seed=9)
    tris, tc = host._tris, host.tri_chunk
    eye = torch.tensor([0.3, 0.4, 3.0], device=cuda_device).expand(o.shape[0], 3).contiguous()
    aim = torch.nn.functional.normalize(o - eye, dim=1)
    for ro, rd in ((o, d), (eye, aim)):
        ref = tr.intersect(ro, rd, tris, tc)
        for k in (ro.shape[0], 777):
            _assert_same_hits(tr.intersect(ro[:k], rd[:k], tris, tc, reject=False),
                              [x[:k] for x in ref])


@pytest.mark.cuda
def test_mt_kernel_ring_path_matches_plain(cuda_device):  # noqa: F811
    """2000 triangles (320 KB) do not fit in a block's shared memory, and a
    launch of two full waves of ray tiles takes them in one slice: they
    stream through the two-stage ring, and the hits match the plain twin.
    A small launch of the same rays splits them into slices that fit, and
    equals the ring's hits bit for bit."""
    rng = np.random.default_rng(6)
    host = RtxHost(device=cuda_device)
    host.load_model(random_soup(2000, rng))
    t_real = host._tris["tri40"].shape[0]
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert 160 * t_real > optin
    slots = tr.mt_slots(torch.device(cuda_device))
    r = tr.K5_WAVES * slots * tr.K5_RAYS_PER_BLOCK
    assert tr.slice_plan(r, t_real, slots, tr.K5_RAYS_PER_BLOCK) == (1, t_real)
    o = torch.from_numpy(rng.uniform(-4, 4, (r, 3)).astype(np.float32)).to(cuda_device)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)), dim=1).to(cuda_device)
    assert _kernel_vs_plain(host, o, d) > r // 10
    s, per = tr.slice_plan(500, t_real, slots, tr.K5_RAYS_PER_BLOCK)
    assert s > 1 and 160 * per < optin
    _assert_same_hits(tr.intersect(o[:500], d[:500], host._tris, host.tri_chunk),
                      [x[:500] for x in tr.intersect(o, d, host._tris, host.tri_chunk)])


def test_sass_loop_counts_reads_the_innermost_loop():
    """chip_smoke's SASS reader on a made-up listing: the kernel with the
    reject, whose loop over triangles the compiler unrolled twice (20
    LDS.128) beside its remainder (10): the unrolled body counts, at 2
    triangles x 4 rays."""
    body = "".join(f"        /*{0x100 + 16 * i:04x}*/                   {op} ;\n" for i, op in
                   enumerate(["LDS.128 R4, [R2]"] * 20 + ["FFMA R1, R2, R3, R1"] * 80
                             + ["@P0 BRA 0x100"]))
    rem_at = 0x100 + 16 * 101
    rem = "".join(f"        /*{rem_at + 16 * i:04x}*/                   {op} ;\n" for i, op in
                  enumerate(["LDS.128 R4, [R2]"] * 10 + ["FFMA R1, R2, R3, R1"] * 40
                            + [f"@!P1 BRA 0x{rem_at:x}"]))
    outer = f"        /*{rem_at + 16 * 51:04x}*/                   BRA 0x80 ;\n"
    sass = ("\tFunction : _ZN12_GLOBAL__N_119mt_intersect_kernelILb1EEvPKfS1_i\n"
            + body + rem + outer + "\tFunction : _Z5otherv\n" + body)
    (c,) = _load_chip_smoke().sass_loop_counts(sass)
    assert (c["rt"], c["reject"], c["pairs"], c["instructions"]) == (4, True, 8, 101)
    assert c["kinds"] == {"LDS": 20, "FFMA": 80, "BRA": 1}
    assert c["per_pair"] == 101 / 8


def test_plain_render_is_counted_nowhere():
    """On the CPU the tracer takes the plain intersector: no launch."""
    host = RtxHost(tri_chunk=8, device="cpu")
    host.load_model(quad_mesh())
    before = tr.mt_intersect_launches
    img = host.render(front_camera(), (0.0, 0.0, 0.0), 2, 8, 8, seed=1)
    assert tr.mt_intersect_launches == before and math.isfinite(float(img.sum()))
