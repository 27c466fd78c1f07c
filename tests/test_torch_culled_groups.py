"""K9's chunk-binned march and its two-level key scan.

On the CPU: the group boxes that scene_tables adds (bg_*, over consecutive
Morton chunks) hold their members' boxes exactly, and binned_march below, a
plain model of the kernel's schedule (the two-level scan, the rays binned
by chunk step by step, a ray's work split over threads), gives
culled_march's hits and visit counts bit for bit: on the random soup, the
UV sphere and the mushroom, with chunk counts that are not a multiple of
the group size, with one chunk a group, and with one group.  The visit
order itself is held against the JAX package's _intersect_culled by
tests/test_torch_culled.py::test_culled_reference_matches_jax.

On the card (marker ``cuda``, skipped without one): the kernel bit-equal
to its plain twin and two launches equal, on the mesh-res 256 mushroom's
bounce rays at 2^10 and 2^16 and on a primary batch, on chunks of 16 (4,064
boxes in the opt-in shared memory); its rays summed over the steps equal
the plain twin's visits; a refused launch raises and falls back to
nothing."""

import math

import numpy as np
import pytest
import torch
from test_torch_culled import TC, culled_scene, ray_sets
from test_torch_rt import _load_chip_smoke
from torch_parity import cuda_device  # noqa: F401  (fixture)

from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.rt import tracer as tr
from gaussian_splatterer_tpu_torch.rt.tracer import RtxHost
from gaussian_splatterer_tpu_torch.scripts import scenes

SCENES = ("soup", "icosphere", "mushroom")


def lex_min(a, b):
    """Of two (value, index, ...) tuples of (R,) tensors, per row the one
    first in (value, index) order."""
    take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return tuple(torch.where(take, y, x) for x, y in zip(a, b))


def next_chunks(o, d, tris: dict, last_k, last_c, best_t, parts: int = 1):
    """K9's key scan in two levels, in plain PyTorch: per ray the smallest
    (key, chunk id) above (last_k, last_c) with key below best_t, as
    (cand_k, cand_c), cand_c -1 where there is none.  Part p of ``parts``
    walks the groups p, p + parts, ... in order: a group whose box key
    (BG_KEYS) is not below the part's candidate, or whose exit is below
    last_k, is skipped, else its chunks are scanned one by one with a
    strict-less update; the parts are then folded by the lexicographic
    minimum, as the kernel folds the threads that share a ray."""
    nc, ng = tris[tr.BB_KEYS[0]].shape[0], tris[tr.BG_KEYS[0]].shape[0]
    size = tr.group_size(nc, ng)
    gkeys, gexits = tr._box_keys(o, d, [tris[k] for k in tr.BG_KEYS[:3]],
                                 [tris[k] for k in tr.BG_KEYS[3:]], exits=True)
    ckeys = tr.chunk_keys(o, d, tris)
    out = None
    for part in range(parts):
        cand_k, cand_c = best_t.clone(), torch.full_like(last_c, -1)
        for g in range(part, ng, parts):
            enter = (gkeys[:, g] < cand_k) & ~(gexits[:, g] < last_k)
            for c in range(g * size, min(nc, (g + 1) * size)):
                key = ckeys[:, c]
                above = (key > last_k) | ((key == last_k) & (c > last_c))
                take = enter & above & (key < cand_k)
                cand_k = torch.where(take, key, cand_k)
                cand_c = torch.where(take, torch.full_like(cand_c, c), cand_c)
        out = (cand_k, cand_c) if out is None else lex_min(out, (cand_k, cand_c))
    return out


def binned_march(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int,
                 parts: int = 1):
    """Plain model of K9's schedule: every ray finds its first chunk with
    the two-level scan (next_chunks); then, step by step, every ray with a
    chunk tests that chunk's triangles, its work split over ``parts``
    threads (part p the triangles p, p + parts, ... of each tile of at most
    512, each keeping the first minimum below the incoming best, folded by
    the lexicographic minimum of (t, triangle)), and finds its next chunk.
    Returns culled_march's (t, idx, u, v, visits), which it equals bit for
    bit (test_binned_march_matches_culled_march)."""
    r, dev, tc = o.shape[0], o.device, tri_chunk
    best = tr._miss(r, dev)
    visits = torch.zeros((r,), dtype=torch.int32, device=dev)
    cand_k, cand_c = next_chunks(o, d, tris, torch.full((r,), -math.inf, device=dev),
                                 torch.full((r,), -1, dtype=torch.int64, device=dev),
                                 best[0].clone())
    lanes = torch.arange(tc, device=dev)
    tile = min(tc, 512)  # K9's kTile
    owner = torch.cat([torch.arange(min(tile, tc - t0), device=dev) % parts
                       for t0 in range(0, tc, tile)])  # lane -> part
    geo = tris["geo10"]
    while bool((cand_c >= 0).any()):
        rows = (cand_c >= 0).nonzero()[:, 0]
        ck = cand_c[rows]
        g = geo[:, ck[:, None] * tc + lanes[None, :]]  # (10, n, Tc)
        t, u, v = tr.mt_hit_components(*tr._ray_columns(o[rows], d[rows]), *g[:9], g[9] > 0.5)
        incoming = tuple(x[rows] for x in best)
        acc = (incoming[0], torch.full_like(ck, -1), incoming[2], incoming[3])
        for part in range(parts):
            mine = torch.where(owner[None, :] == part, t, torch.full_like(t, math.inf))
            pt, pj, pu, pv = tr.best_lane(mine, u, v, 0)
            pj = pj.to(torch.int64)
            closer = pt < incoming[0]
            acc = lex_min(acc, (torch.where(closer, pt, incoming[0]),
                                torch.where(closer, pj, torch.full_like(pj, -1)), pu, pv))
        hit = acc[1] >= 0
        new = (acc[0], torch.where(hit, (ck * tc + acc[1]).to(torch.int32), incoming[1]),
               torch.where(hit, acc[2], incoming[2]), torch.where(hit, acc[3], incoming[3]))
        for x, y in zip(best, new):
            x[rows] = y
        visits[rows] += 1
        nk, nc_ = next_chunks(o[rows], d[rows], tris, cand_k[rows], ck, best[0][rows], parts)
        cand_k[rows], cand_c[rows] = nk, nc_
    return (*best, visits)


def scene_host(name, device="cpu", tri_chunk=TC):
    """A Morton-ordered host (accel_min 1): the 600-triangle soup, the
    288-triangle UV sphere or the mushroom at mesh-res 24, in chunks of
    ``tri_chunk``."""
    mesh = scenes.mushroom_mesh(24, 12) if name == "mushroom" else culled_scene(name)
    host = RtxHost(tri_chunk=tri_chunk, device=device)
    host.load_model(mesh, accel_min=1)
    assert "bb_minx" in host._tris and "bg_minx" in host._tris
    return host


def _planes(tris, keys):
    return torch.stack([tris[k] for k in keys], 1)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("group", [1, 3, tr.CHUNK_GROUP, 10**6])
def test_group_boxes_hold_their_members_exactly(scene, group):
    """Group g covers chunks [g G, (g + 1) G), the last one ragged, and its
    planes are the exact float32 min and max of its members' (so each
    member's box lies inside it); scene_tables' groups are
    with_groups(CHUNK_GROUP)'s."""
    tris = scene_host(scene)._tris
    if group == tr.CHUNK_GROUP:
        for k in tr.BG_KEYS:
            assert torch.equal(tris[k], tr.with_groups(tris, group)[k]), k
    tris = tr.with_groups(tris, group)
    bb_lo, bb_hi = _planes(tris, tr.BB_KEYS[:3]), _planes(tris, tr.BB_KEYS[3:])
    bg_lo, bg_hi = _planes(tris, tr.BG_KEYS[:3]), _planes(tris, tr.BG_KEYS[3:])
    nc, ng = bb_lo.shape[0], bg_lo.shape[0]
    size = tr.group_size(nc, ng)
    assert ng == -(-nc // min(group, nc)) and (ng - 1) * size < nc <= ng * size
    assert bg_lo.dtype == torch.float32 and torch.isfinite(bg_lo).all()
    for g in range(ng):
        lo, hi = bb_lo[g * size:(g + 1) * size], bb_hi[g * size:(g + 1) * size]
        assert (bg_lo[g] <= lo).all() and (bg_hi[g] >= hi).all()
        assert torch.equal(bg_lo[g], lo.amin(0)) and torch.equal(bg_hi[g], hi.amax(0))


def test_group_count_is_not_a_multiple():
    """The cases below cover a ragged last group: 19 chunks of the soup in
    groups of 3, 11 of the mushroom in groups of 3 and 16."""
    counts = {s: scene_host(s)._tris["bb_minx"].numel() for s in SCENES}
    assert counts["soup"] % 3 and counts["mushroom"] % 3, counts
    assert counts["mushroom"] > 1 and counts["soup"] > tr.CHUNK_GROUP, counts


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("group,parts", [(1, 1), (3, 1), (3, 4), (3, 32), (tr.CHUNK_GROUP, 1),
                                         (tr.CHUNK_GROUP, 8), (10**6, 2)])
def test_binned_march_matches_culled_march(scene, group, parts):
    """The kernel's schedule in plain PyTorch (two-level scan over groups of
    ``group`` chunks, each ray's triangles and groups split over ``parts``
    threads) against the sorted march, scattered and eye rays: t, idx, u, v
    and the chunks visited a ray bit for bit."""
    host = scene_host(scene)
    tris = tr.with_groups(host._tris, group)
    for label, (o, d) in ray_sets(np.random.default_rng(31)).items():
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        ref = tr.culled_march(o, d, tris, TC)
        got = binned_march(o, d, tris, TC, parts=parts)
        assert int(torch.isfinite(ref[0]).sum()) > 100, label
        for name, a, b in zip(("t", "idx", "u", "v", "visits"), got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b), (label, name)


@pytest.mark.parametrize("scene", SCENES)
def test_group_scan_skips_chunks(scene):
    """The two-level scan finds each ray's first chunk (next_chunks from
    (-inf, -1) below inf), the smallest (key, id) of chunk_keys, while the
    groups a ray misses or enters past the candidate keep some chunks
    untested: over the rays, fewer member tests than rays x chunks."""
    host = scene_host(scene)
    tris = tr.with_groups(host._tris, 3)
    o, d = (torch.from_numpy(x) for x in ray_sets(np.random.default_rng(37))["scattered"])
    r = o.shape[0]
    cand_k, cand_c = next_chunks(o, d, tris, torch.full((r,), -np.inf),
                                    torch.full((r,), -1, dtype=torch.int64),
                                    torch.full((r,), np.inf))
    keys = tr.chunk_keys(o, d, tris)
    k, c = keys.min(1)
    found = torch.isfinite(k)
    assert torch.equal(cand_c[found], c[found]) and torch.equal(cand_k[found], k[found])
    assert (cand_c[~found] == -1).all()
    gkeys = tr._box_keys(o, d, [tris[x] for x in tr.BG_KEYS[:3]],
                         [tris[x] for x in tr.BG_KEYS[3:]])
    missed = torch.isinf(gkeys)
    assert missed.any() and (~missed).any()


# -- on the card -------------------------------------------------------------------


def _mushroom(cuda_device, tri_chunk=512):
    host = RtxHost(tri_chunk=tri_chunk, device=cuda_device)
    host.load_model(scenes.mushroom_mesh(256, 128))
    return host


def _check(o, d, host):
    """K9 twice with its stats, against the plain march: bit for bit, two
    launches equal, one launch counted each, the stats' rays summed over
    the steps equal to the plain twin's visits."""
    tris, tc = host._tris, host.tri_chunk
    stats = torch.zeros((8,), dtype=torch.int64, device=o.device)
    before = tr.mt_culled_launches
    a = tr.intersect_culled(o, d, tris, tc, stats=stats)
    b = tr.intersect_culled(o, d, tris, tc)
    torch.cuda.synchronize()
    assert tr.mt_culled_launches == before + 2
    *plain, visits = tr.culled_march(o, d, tris, tc)
    for x, y, z in zip(a, b, plain):
        assert torch.equal(x, y) and torch.equal(x, z)
    steps, bins, rays, slices, *phase_ns = stats.tolist()
    assert rays == int(visits.long().sum()) and 0 < bins <= rays and bins <= slices
    assert steps == int(visits.max()) and all(t > 0 for t in phase_ns)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1 << 10, 1 << 16])
def test_binned_kernel_bounce_rays(cuda_device, r):  # noqa: F811
    """Bounce rays leaving the mesh-res 256 mushroom (65,024 triangles, 127
    chunks): at 2^10 every bin is small (slices split over threads), at
    2^16 bins hold hundreds of rays."""
    host = _mushroom(cuda_device)
    o, d = (x.to(cuda_device) for x in _load_chip_smoke().surface_rays(host.mesh, r, seed=3))
    hits = _check(o, d, host)
    assert int(torch.isfinite(hits[0]).sum()) > r // 4


@pytest.mark.cuda
def test_binned_kernel_primary_batch(cuda_device):  # noqa: F811
    """One 8-sample 1024^2 batch of primary rays from rig camera 0 (most
    rays enter no box; the others a few chunks)."""
    smoke = _load_chip_smoke()
    host = _mushroom(cuda_device)
    cam = Camera.get_cameras(smoke.ns_project())[0]
    o, d = smoke.camera_rays(cam, smoke.NS_RES, cuda_device, seed=1, samples=host.sample_batch)
    hits = _check(o, d, host)
    assert int(torch.isfinite(hits[0]).sum()) > 1000


@pytest.mark.cuda
def test_binned_kernel_opt_in_boxes(cuda_device):  # noqa: F811
    """Chunks of 16 on the mesh-res 256 mushroom: 4,064 boxes (97.5 KB)
    staged in the opt-in shared memory, beside 768 B of triangles."""
    host = _mushroom(cuda_device, tri_chunk=16)
    nc = host._tris["bb_minx"].numel()
    assert 2048 < nc < 9000
    assert 24 * nc > 48 * 1024
    o, d = (x.to(cuda_device) for x in _load_chip_smoke().surface_rays(host.mesh, 1 << 14,
                                                                       seed=6))
    _check(o, d, host)


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device, monkeypatch):  # noqa: F811
    """The wrapper raises on a refused launch with its cudaError_t, counts
    nothing and calls no other form; the next launch runs."""
    host = _mushroom(cuda_device)
    tris, tc = host._tris, host.tri_chunk
    o, d = (x.to(cuda_device) for x in _load_chip_smoke().surface_rays(host.mesh, 1 << 12,
                                                                       seed=8))
    lib = tr._culled_lib()

    class Refusing:
        def __init__(self, real):
            self.mt_culled_scratch_words = real.mt_culled_scratch_words

        @staticmethod
        def mt_culled(*args):
            return 720  # cudaErrorCooperativeLaunchTooLarge

    monkeypatch.setattr(tr, "_culled_lib", lambda: Refusing(lib))
    monkeypatch.setattr(tr, "intersect_culled_reference", None)  # no fallback to call
    before = tr.mt_culled_launches
    with pytest.raises(RuntimeError, match="cudaError_t 720"):
        tr.intersect_culled(o, d, tris, tc)
    assert tr.mt_culled_launches == before
    monkeypatch.undo()
    _check(o, d, host)
