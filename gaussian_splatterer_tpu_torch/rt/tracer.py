"""Monte-Carlo path tracer, the truth-photograph generator (counterpart of
gaussian_splatterer_tpu.rt.tracer).

Reference semantics (src/rtx/RtxDevice.cu), as the JAX package keeps them:
  * primary rays: sub-pixel jitter ``pixel + rand2 + 0.5``, the NDC point at
    the far plane pushed through the inverse proj-view matrix (:75-82);
  * up to 50 bounces; a ray past the cap returns black (:23, 57);
  * stochastic alpha: the surface is hit when ``texture.w > rand()``, else
    the ray passes on with attenuation 1 (:128-143);
  * lambertian scatter ``normal + randomUnitSphere()`` (:8-14, 130-133);
  * flat shading from the triangle's normal; nearest-neighbour texel with
    flipped V and wrap addressing (:113-123);
  * miss: sky ``min(1, 1 + dir.y)``; a primary ray that never reflected
    returns the background instead (:50, 149-158);
  * truth-camera orbs: a primary ray passing within 0.025 of a camera, not
    occluded by a nearer hit, inverts the averaged pixel (:36-47, 97);
  * per-sample clamp to [0, 1], then the average (:85-95).

Intersection, as the JAX package routes it (``_intersect``): on a scene of
``accel_min`` triangles or more, which scene_tables Morton-orders into
chunks with AABBs, every intersection goes through the culled march of the
JAX package's ``_intersect_culled``: per ray, the chunks in order of AABB
entry distance, stopping once the best hit comes before the next chunk's
entry.  On a CUDA tensor ``intersect_culled`` launches the hand-written
kernel csrc/mt_culled.cu (K9: a chunk-binned march whose rays share each
staged chunk, with a two-level key scan over group boxes); on a CPU tensor
it takes the plain version ``intersect_culled_reference``.  The JAX
package's primaries on such a
scene take its shared-origin MXU form; here they take the culled march too
(the same first hit).  On a smaller scene every intersection is
brute-force Möller-Trumbore in the JAX package's linear "feat10" form: the
four MT numerators (det, u, v, t) of a (ray, triangle) pair are dot
products of the ray features ``[d, o x d, o, 1]`` with ten per-triangle
columns built at scene load.  On a CUDA tensor ``intersect`` launches the
hand-written kernel csrc/mt_intersect.cu (K5); on a CPU tensor it takes
the plain version ``intersect_reference``.  ``first_hit`` is the router.
``intersect_component`` is the component form of the JAX package's
``_intersect_chunked``, the yardstick for hits in the tests.

Randomness: ``bounce_step`` takes its draws as tensors, so that a test can
hand it the JAX package's.  ``RtxHost.render`` draws them from one
``torch.Generator`` on the host's device, seeded as the JAX package seeds
its key.  The two generators give different numbers: renders agree with the
JAX package's in distribution, not bit for bit.

Left out, as TPU workarounds: the dispatch pipelining (``max_inflight``),
the chunked ray batches and phased compaction (here the live rays are
compacted after every bounce), and the shared-origin MXU intersector.
``sample_batch`` is the number of samples traced as one batch of rays.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from gaussian_splatterer_tpu_torch import resolve_device
from gaussian_splatterer_tpu_torch.io.image import blank_texture, load_texture_rgba
from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh, load_obj
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.ops import cuda_build

SPLAT_CAMERA_DOT_SIZE = 0.025  # reference src/rtx/RtxDevice.cuh:8
RAY_TMIN = 1e-3  # bounce ray offset (src/rtx/RtxDevice.cu:53)
MAX_BOUNCES = 50  # src/rtx/RtxDevice.cu:23
DET_EPS = 1e-12  # |det| below it is replaced by +DET_EPS (the JAX package's guard)
REF_RAY_CHUNK = 65536  # rays per product of the plain intersector

# Launches of the CUDA intersectors in this process.  Only the CUDA branch
# of intersect (K5), and of intersect_culled (K9), adds to its count; a run
# can read them to show that its path went through the kernels.
mt_intersect_launches = 0
mt_culled_launches = 0


# -- intersection --------------------------------------------------------------


def _ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, 10) ray features [d, o x d, o, 1], each product rounded on its own."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    c = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    return torch.stack([dx, dy, dz, *c, ox, oy, oz, torch.ones_like(dx)], dim=1)


def _fold(best, cand):
    """Keep ``best`` unless ``cand``'s t is strictly smaller: the earlier
    triangle chunk wins ties."""
    closer = cand[0] < best[0]
    return tuple(torch.where(closer, c, b) for b, c in zip(best, cand))


def best_lane(t, u, v, base):
    """Per-row first minimum of t (R, Tc) and its u, v and global index
    ``base`` + lane (the JAX package's ``_best_lane``); ``base`` is an int
    or an (R,) tensor, as the culled march gives each ray its chunk's."""
    j = torch.argmin(t, dim=1, keepdim=True)  # the first minimum, as jnp.argmin
    return (t.gather(1, j)[:, 0], (base + j[:, 0]).to(torch.int32),
            u.gather(1, j)[:, 0], v.gather(1, j)[:, 0])


def _miss(r: int, dev):
    return (torch.full((r,), math.inf, dtype=torch.float32, device=dev),
            torch.zeros((r,), dtype=torch.int32, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev))


def _guarded_inverse(det: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(det.abs() < DET_EPS, torch.full_like(det, DET_EPS), det)


def intersect_reference(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int):
    """Plain twin of K5: the first hit of each ray (o, d (R, 3) float32)
    over all triangles, in the feat10 form of the JAX package's
    ``_intersect_mxu_general``.  Per triangle chunk, one float32 product
    (R, 10) x (10, 4 Tc) gives [det | u_num | v_num | t_num]; the package
    pins ``torch.backends.cuda.matmul.allow_tf32 = False`` at import, so the
    product stays full float32 on a card too (a TF32 product would lose the
    cancellation-sensitive t_num).  Rays go in blocks of REF_RAY_CHUNK to
    bound the (R, 4 Tc) plane.

    Returns (t, idx int32, u, v) per ray; a miss is (inf, 0, 0, 0).  A hit
    needs |det| guarded to +1e-12, u >= 0, v >= 0, u + v <= 1, t > RAY_TMIN
    and a valid (not padding) triangle; ties go to the lowest index."""
    feats, valid = tris["feat10"], tris["valid"]
    r, tc = o.shape[0], tri_chunk
    n_chunks = valid.shape[0] // tc
    r10 = _ray_features(o, d)
    out = []
    for r0 in range(0, r, REF_RAY_CHUNK):
        rays = r10[r0:r0 + REF_RAY_CHUNK]
        best = _miss(rays.shape[0], o.device)
        for ck in range(n_chunks):
            nums = rays @ feats[:, ck * 4 * tc:(ck + 1) * 4 * tc]  # (Rb, 4 Tc)
            inv = _guarded_inverse(nums[:, 0:tc])
            u = nums[:, tc:2 * tc] * inv
            v = nums[:, 2 * tc:3 * tc] * inv
            t = nums[:, 3 * tc:] * inv
            hit = valid[None, ck * tc:(ck + 1) * tc] & (u >= 0.0) & (v >= 0.0) \
                & (u + v <= 1.0) & (t > RAY_TMIN)
            t = torch.where(hit, t, torch.full_like(t, math.inf))
            best = _fold(best, best_lane(t, u, v, ck * tc))
        out.append(best)
    if not out:
        return _miss(0, o.device)
    return tuple(torch.cat(x) for x in zip(*out))


def mt_hit_components(ox, oy, oz, dx, dy, dz, ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z,
                      valid):
    """Component-form Möller-Trumbore of broadcast ray and triangle
    components, operation for operation the JAX package's ``_mt_hit``, each
    product and sum rounded on its own in float32: (t, u, v), t = inf where
    the pair is no hit (|det| guarded to +1e-12; u >= 0, v >= 0,
    u + v <= 1, t > RAY_TMIN and a valid triangle)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    inv = _guarded_inverse(e1x * px + e1y * py + e1z * pz)
    tx, ty, tz = ox - ax, oy - ay, oz - az
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN)
    return torch.where(hit, t, torch.full_like(t, math.inf)), u, v


def _ray_columns(o, d):
    """The six (R, 1) components of rays o, d (R, 3)."""
    return tuple(x[:, None] for x in (*o.unbind(1), *d.unbind(1)))


def intersect_component(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int):
    """Component-form Möller-Trumbore over all triangles (the JAX package's
    ``_intersect_chunked`` + ``_mt_hit``), with the same contract as
    intersect_reference.  The tests' yardstick for hits."""
    r, tc = o.shape[0], tri_chunk
    n_chunks = tris["valid"].shape[0] // tc
    rays = _ray_columns(o, d)
    best = _miss(r, o.device)
    for ck in range(n_chunks):
        sl = slice(ck * tc, (ck + 1) * tc)
        t, u, v = mt_hit_components(*rays, *(tris[k][None, sl] for k in (
            "ax", "ay", "az", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z", "valid")))
        best = _fold(best, best_lane(t, u, v, ck * tc))
    return best


# -- the culled march (K9) -------------------------------------------------------

BB_KEYS = ("bb_minx", "bb_miny", "bb_minz", "bb_maxx", "bb_maxy", "bb_maxz")
# the group boxes of K9's two-level key scan, each over consecutive chunks
BG_KEYS = ("bg_minx", "bg_miny", "bg_minz", "bg_maxx", "bg_maxy", "bg_maxz")
CHUNK_GROUP = 16  # the most chunks a group box covers (scene_tables)


def group_size(num_chunks: int, num_groups: int) -> int:
    """Chunks a group: ``num_groups`` groups of consecutive chunks, the last
    one ragged.  scene_tables makes ceil(NC / CHUNK_GROUP) groups of this
    size, so the kernel reads it from the two tables' lengths."""
    return -(-num_chunks // num_groups)


def group_boxes(bb_min, bb_max, group: int):
    """(min, max) of ceil(NC / group) groups over the chunk boxes bb_min,
    bb_max (NC, 3): each group the exact float32 min and max of its
    members' planes, ``group_size`` chunks a group.  numpy or torch arrays."""
    nc = bb_min.shape[0]
    ng = -(-nc // group)
    size = group_size(nc, ng)
    lib = torch if isinstance(bb_min, torch.Tensor) else np
    return (lib.stack([lib.amin(bb_min[g * size:(g + 1) * size], 0) for g in range(ng)]),
            lib.stack([lib.amax(bb_max[g * size:(g + 1) * size], 0) for g in range(ng)]))


def with_groups(tris: dict, group: int) -> dict:
    """``tris`` with its group boxes remade for at most ``group`` chunks a
    group (the design variants and the tests; scene_tables uses
    CHUNK_GROUP)."""
    lo, hi = group_boxes(torch.stack([tris[k] for k in BB_KEYS[:3]], 1),
                         torch.stack([tris[k] for k in BB_KEYS[3:]], 1), group)
    out = dict(tris)
    for i, k in enumerate(BG_KEYS):
        out[k] = (lo if i < 3 else hi)[:, i % 3].contiguous()
    return out


def _box_keys(o: torch.Tensor, d: torch.Tensor, lo, hi, exits: bool = False):
    """(R, m) entry distance of each ray into each of m boxes, planes lo, hi
    (three (m,) tensors each), as the JAX package's ``_intersect_culled``
    computes it: slabs with inverse directions guarded like det (|d| <
    1e-12 -> +1e-12), the entry no nearer than RAY_TMIN, and inf where the
    ray misses the box (entry past exit); with ``exits``, (keys, exits)."""
    inv = [_guarded_inverse(x) for x in d.unbind(1)]
    near, far = [], []
    for oc, ic, a, b in zip(o.unbind(1), inv, lo, hi):
        t0 = (a[None, :] - oc[:, None]) * ic[:, None]
        t1 = (b[None, :] - oc[:, None]) * ic[:, None]
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    tmin = torch.tensor(RAY_TMIN, dtype=torch.float32, device=o.device)
    t_enter = torch.maximum(torch.maximum(near[0], near[1]), torch.maximum(near[2], tmin))
    t_exit = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    keys = torch.where(t_enter <= t_exit, t_enter, torch.full_like(t_enter, math.inf))
    return (keys, t_exit) if exits else keys


def chunk_keys(o: torch.Tensor, d: torch.Tensor, tris: dict) -> torch.Tensor:
    """(R, NC) entry distance of each ray into each chunk's AABB (_box_keys)."""
    return _box_keys(o, d, [tris[k] for k in BB_KEYS[:3]], [tris[k] for k in BB_KEYS[3:]])


def culled_march(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int):
    """The plain culled march with its work: (t, idx, u, v, visits), visits
    (R,) int32 the chunks each ray tested.  Rays go in blocks of
    REF_RAY_CHUNK; a ray's result depends on its own march alone."""
    parts = [_march_block(o[r0:r0 + REF_RAY_CHUNK], d[r0:r0 + REF_RAY_CHUNK], tris, tri_chunk)
             for r0 in range(0, o.shape[0], REF_RAY_CHUNK)]
    if not parts:
        return (*_miss(0, o.device), torch.zeros((0,), dtype=torch.int32, device=o.device))
    return tuple(torch.cat(x) for x in zip(*parts))


def _march_block(o, d, tris, tc: int):
    """One block of culled_march.  Each ray's chunks sorted by (key, chunk
    id); the rays march their sorted lists in lockstep, a ray taking step
    s only while that chunk's entry comes before its best hit (the JAX
    package's ``useful``; the others are left out of the step rather than
    masked), a later chunk's first minimum replacing the best only when
    strictly closer, until no ray's next entry comes before its best."""
    r, dev = o.shape[0], o.device
    key_sorted, order = torch.sort(chunk_keys(o, d, tris), dim=1, stable=True)
    best = _miss(r, dev)
    visits = torch.zeros((r,), dtype=torch.int32, device=dev)
    lanes = torch.arange(tc, device=dev)
    geo = tris["geo10"]
    for s in range(key_sorted.shape[1]):
        rows = (key_sorted[:, s] < best[0]).nonzero()[:, 0]
        if rows.numel() == 0:
            break
        ck = order[rows, s]
        g = geo[:, ck[:, None] * tc + lanes[None, :]]  # (10, n, Tc)
        t, u, v = mt_hit_components(*_ray_columns(o[rows], d[rows]), *g[:9], g[9] > 0.5)
        new = _fold(tuple(x[rows] for x in best), best_lane(t, u, v, ck * tc))
        for x, y in zip(best, new):
            x[rows] = y
        visits[rows] += 1
    return (*best, visits)


def intersect_culled_reference(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int):
    """Plain twin of K9: the first hit of each ray through the culled march
    of the JAX package's ``_intersect_culled`` over the Morton chunks of
    ``tris`` (bb_* and geo10 from scene_tables), with the contract of
    intersect_reference (a miss is (inf, 0, 0, 0)).  Ties within a chunk go
    to the lowest index; across chunks, to the chunk visited first."""
    return culled_march(o, d, tris, tri_chunk)[:4]


def intersect_culled(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int, *,
                     stats: Optional[torch.Tensor] = None):
    """First hit of each ray through the culled march: the CUDA kernel K9
    (csrc/mt_culled.cu, one cooperative launch) for CUDA tensors,
    intersect_culled_reference for CPU tensors (same contract).  ``stats``,
    an int64 (8,) tensor on the rays' device, takes the launch's steps, its
    bins, rays and slices summed over the steps, and the nanoseconds of its
    phases (init, offsets, scatter, tests; each to the end of its grid
    barrier)."""
    global mt_culled_launches
    if o.device.type == "cpu":
        return intersect_culled_reference(o, d, tris, tri_chunk)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_culled: unsupported device {o.device}")
    r = o.shape[0]
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (r, 3) or not x.is_contiguous() \
                or x.device != o.device:
            raise ValueError(f"intersect_culled: {name} must be contiguous ({r}, 3) float32 "
                             f"on {o.device}")
    tri12, bbs, bgs = tris.get("tri12"), [tris.get(k) for k in BB_KEYS], \
        [tris.get(k) for k in BG_KEYS]
    nc = bbs[0].shape[0] if bbs[0] is not None else 0
    ng = bgs[0].shape[0] if bgs[0] is not None else 0
    if tri12 is None or any(b is None for b in (*bbs, *bgs)) or nc == 0 or ng == 0 \
            or tri_chunk <= 0 or tuple(tri12.shape) != (nc * tri_chunk, 12) \
            or any(x.device != o.device or x.dtype != torch.float32 or not x.is_contiguous()
                   for x in (tri12, *bbs, *bgs)) \
            or any(tuple(b.shape) != (nc,) for b in bbs) \
            or any(tuple(b.shape) != (ng,) for b in bgs) or ng > nc \
            or 6 * r >= 2**31 or 12 * nc * tri_chunk >= 2**31:
        raise ValueError("intersect_culled: scene tables not laid out by scene_tables with "
                         "the Morton order on the rays' device, or too many rays or triangles")
    if stats is not None and (stats.dtype != torch.int64 or tuple(stats.shape) != (8,)
                              or stats.device != o.device):
        raise ValueError(f"intersect_culled: stats must be an int64 (8,) tensor on {o.device}")
    out_t, out_i, out_u, out_v = (torch.empty((r,), dtype=dt, device=o.device) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32))
    if r == 0:
        return out_t, out_i, out_u, out_v
    lib = _culled_lib()
    scratch = torch.empty((lib.mt_culled_scratch_words(r, nc),), dtype=torch.int32,
                          device=o.device)
    with torch.cuda.device(o.device):
        err = lib.mt_culled(
            o.data_ptr(), d.data_ptr(), r, tri12.data_ptr(), nc, tri_chunk,
            *(b.data_ptr() for b in (*bbs, *bgs)), ng, group_size(nc, ng),
            scratch.data_ptr(), stats.data_ptr() if stats is not None else None,
            out_t.data_ptr(), out_i.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mt_culled: shared-memory request or cooperative launch refused, "
                           f"or launch failed ({nc} chunks of {tri_chunk} triangles): "
                           f"cudaError_t {err}")
    mt_culled_launches += 1
    return out_t, out_i, out_u, out_v


def _culled_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("mt_culled")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mt_culled.argtypes = [p, p, i, p, i, i, *[p] * 12, i, i, p, p, p, p, p, p, p]
    lib.mt_culled.restype = ctypes.c_int
    lib.mt_culled_scratch_words.argtypes = [i, i]
    lib.mt_culled_scratch_words.restype = ctypes.c_longlong
    return lib


def _chain_nums(r10: torch.Tensor, rows: torch.Tensor):
    """(R, n) det, u_num, v_num, t_num of every (ray, tri40 row) pair, each
    a chain over the ten features in feature order, element by element, so
    that a pair's value does not depend on the other pairs."""
    nums = []
    for q in range(4):
        w = rows[:, 10 * q:10 * q + 10]
        acc = r10[:, 0:1] * w[None, :, 0]
        for k in range(1, 10):
            acc = acc + r10[:, k:k + 1] * w[None, :, k]
        nums.append(acc)
    return nums


def first_hit_rows(o: torch.Tensor, d: torch.Tensor, tri40: torch.Tensor,
                   tri_ids: torch.Tensor):
    """Plain first hit of each ray over the rows of a ``tri40`` table (or a
    contiguous slice of it) in row order, with the contract of
    intersect_reference; ``idx`` is the row's ``tri_ids`` entry."""
    r = o.shape[0]
    if tri40.shape[0] == 0 or r == 0:
        return _miss(r, o.device)
    det, u_num, v_num, t_num = _chain_nums(_ray_features(o, d), tri40)
    inv = _guarded_inverse(det)
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN)
    t = torch.where(hit, t, torch.full_like(t, math.inf))
    bt, j, bu, bv = best_lane(t, u, v, 0)
    idx = torch.where(torch.isfinite(bt), tri_ids.to(o.device)[j.long()],
                      torch.zeros_like(j))
    return (bt, idx, torch.where(torch.isfinite(bt), bu, torch.zeros_like(bu)),
            torch.where(torch.isfinite(bt), bv, torch.zeros_like(bv)))


def merge_slices(parts):
    """The slices' first minima (t, idx, u, v), folded in slice order with a
    strict <: the first minimum over all of them (the kernel's
    merge_slices_kernel)."""
    best = parts[0]
    for cand in parts[1:]:
        best = _fold(best, cand)
    return best


def _even_slices(t_real: int, slices: int) -> tuple[int, int]:
    """(slices, triangles a slice) for about ``slices`` contiguous slices of
    ``t_real`` triangles, none empty, as the kernel cuts them."""
    if t_real == 0:
        return 1, 0
    per = -(-t_real // slices)
    return -(-t_real // per), per


def intersect_split_reference(o: torch.Tensor, d: torch.Tensor, tris: dict, slices: int):
    """Plain twin of K5's split: the real triangles cut into ``slices``
    contiguous slices as the kernel cuts them, a first hit per slice,
    merged in slice order.  Equal bit for bit to ``slices`` = 1."""
    tri40, tri_ids = tris["tri40"], tris["tri_ids"]
    slices, per = _even_slices(tri40.shape[0], slices)
    return merge_slices([first_hit_rows(o, d, tri40[s * per:(s + 1) * per],
                                        tri_ids[s * per:(s + 1) * per])
                         for s in range(slices)])


REJECT_SIGN_MARGIN = 2.0 ** -60  # |u_num| past |den| 2^-60: u cannot round to -0.0


def reject_pairs(det, u_num, v_num) -> torch.Tensor:
    """K5's conservative reject of a lane, in float32 as the kernel computes
    it: True where u_num or v_num has the strict opposite sign of the
    clamped det, by a margin past |den| 2^-60, so that the exact epilogue
    provably refuses the pair (csrc/mt_intersect.cu, the header's proof)."""
    den = torch.where(det.abs() < DET_EPS, torch.full_like(det, DET_EPS), det)
    m = den.abs() * torch.tensor(REJECT_SIGN_MARGIN, dtype=torch.float32)
    sign_bits = den.view(torch.int32) & torch.tensor(-2**31, dtype=torch.int32)
    u1, v1 = ((x.view(torch.int32) ^ sign_bits).view(torch.float32) for x in (u_num, v_num))
    return (u1 <= -m) | (v1 <= -m)


def accept_pairs(det, u_num, v_num, t_num, best_t) -> torch.Tensor:
    """The exact epilogue: True where the pair is a hit nearer than
    ``best_t``."""
    inv = _guarded_inverse(det)
    u, v, t = u_num * inv, v_num * inv, t_num * inv
    return (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_TMIN) \
        & (t < torch.as_tensor(best_t, dtype=torch.float32))


K5_RAYS_PER_THREAD = 4  # csrc/mt_intersect.cu's kRT: rays a thread holds in registers
K5_RAYS_PER_BLOCK = 512 * K5_RAYS_PER_THREAD  # its kThreads x kRT: rays a block takes at a time
K5_WAVES = 2  # a launch with fewer ray tiles than this many waves of blocks is split
K5_MIN_SLICE_TRIS = 8  # the fewest triangles a slice walks
K5_MAX_SCRATCH = 1 << 22  # rays x slices of the split's scratch (64 MiB)


@functools.lru_cache(maxsize=4096)
def slice_plan(r: int, t_real: int, slots: int, rays_per_block: int) -> tuple[int, int]:
    """(slices, triangles a slice) of K5's split over triangles.  ``slots``
    is the number of blocks the card runs at once.  A launch whose ray
    tiles fill K5_WAVES waves of them takes one slice; a smaller one takes
    the fewest slices whose blocks come within 5% of the best fill of their
    last wave (work a block: 1 / slices; time: the waves), each of at least
    K5_MIN_SLICE_TRIS triangles and within K5_MAX_SCRATCH.  No slice is
    empty."""
    tiles = max(1, -(-r // rays_per_block))
    s = 1
    if tiles < K5_WAVES * slots:
        s_max = max(1, min(t_real // K5_MIN_SLICE_TRIS, K5_MAX_SCRATCH // max(r, 1)))
        cost = [-(-tiles * k // slots) / k for k in range(1, s_max + 1)]
        s = next(k for k, c in enumerate(cost, 1) if c <= 1.05 * min(cost))
    return _even_slices(t_real, s)


_mt_slots: dict[int, int] = {}


def mt_slots(device: torch.device) -> int:
    """Blocks of K5 that the card runs at once (csrc/mt_intersect.cu's
    mt_intersect_slots), read once a device."""
    with torch.cuda.device(device):
        i = torch.cuda.current_device()
        if i not in _mt_slots:
            _mt_slots[i] = _mt_lib().mt_intersect_slots()
    return _mt_slots[i]


def intersect(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int, *,
              reject: bool = True):
    """First hit of each ray: the CUDA kernel K5 (csrc/mt_intersect.cu) for
    CUDA tensors, intersect_reference for CPU tensors (same contract).

    ``reject`` turns on the kernel's conservative reject before the
    reciprocal, which never changes a hit: it pays on coherent rays and
    costs scattered ones.  The split over triangles is chosen by slice_plan
    from the rays and the card's SMs, the ring from the table's size."""
    global mt_intersect_launches
    if o.device.type == "cpu":
        return intersect_reference(o, d, tris, tri_chunk)
    if o.device.type != "cuda":
        raise ValueError(f"intersect: unsupported device {o.device}")
    tri40, tri_ids = tris["tri40"], tris["tri_ids"]
    r, t_real = o.shape[0], tri40.shape[0]
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (r, 3) or not x.is_contiguous() \
                or x.device != o.device:
            raise ValueError(f"intersect: {name} must be contiguous ({r}, 3) float32 on {o.device}")
    if tri40.device != o.device or tri_ids.device != o.device or tri40.dtype != torch.float32 \
            or tri_ids.dtype != torch.int32 or tuple(tri40.shape) != (t_real, 40) \
            or tuple(tri_ids.shape) != (t_real,) or not tri40.is_contiguous() \
            or not tri_ids.is_contiguous() or r >= 2**31 or 40 * t_real >= 2**31:
        raise ValueError("intersect: scene tables not laid out by scene_tables on the rays' "
                         "device, or too many rays or triangles")
    out_t, out_i, out_u, out_v = (torch.empty((r,), dtype=dt, device=o.device) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32))
    if r == 0:
        return out_t, out_i, out_u, out_v
    slices, slice_len = slice_plan(r, t_real, mt_slots(o.device), K5_RAYS_PER_BLOCK)
    scratch = [None] * 4
    if slices > 1:
        scratch = [torch.empty((slices, r), dtype=dt, device=o.device) for dt in (
            torch.float32, torch.int32, torch.float32, torch.float32)]
    with torch.cuda.device(o.device):
        err = _mt_lib().mt_intersect(
            o.data_ptr(), d.data_ptr(), r, tri40.data_ptr(), tri_ids.data_ptr(), t_real,
            int(reject), slices, slice_len,
            out_t.data_ptr(), out_i.data_ptr(), out_u.data_ptr(), out_v.data_ptr(),
            *(x.data_ptr() if x is not None else None for x in scratch),
            torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mt_intersect: shared-memory request refused or launch failed "
                           f"({slices} slices of {slice_len} triangles): cudaError_t {err}")
    mt_intersect_launches += 1
    return out_t, out_i, out_u, out_v


def first_hit(o: torch.Tensor, d: torch.Tensor, tris: dict, tri_chunk: int, *,
              bounce: bool = False):
    """The tracer's intersector, routed as the JAX package's ``_intersect``:
    the culled march (intersect_culled, K9) on a Morton-ordered scene
    (``bb_minx`` in its tables), else the brute force (intersect, K5).
    Scattered ``bounce`` rays seldom let a whole warp take K5's reject,
    which then only costs them (PERF.md §6): they run K5 without it."""
    if "bb_minx" in tris:
        return intersect_culled(o, d, tris, tri_chunk)
    return intersect(o, d, tris, tri_chunk, reject=not bounce)


def _mt_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("mt_intersect")
    fn = lib.mt_intersect
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, i, i, i, p, p, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.mt_intersect_slots.argtypes = []
    lib.mt_intersect_slots.restype = ctypes.c_int
    return lib


# -- one bounce ----------------------------------------------------------------


def unit_sphere(normal: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """A uniform sample inside the unit ball from (R, 3) standard-normal and
    (R,) uniform draws: the normal's direction times the uniform's cube root
    (the JAX package's ``_unit_sphere``)."""
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return normal / torch.clamp(norm, min=1e-12) * (uniform ** (1.0 / 3.0))[:, None]


def draws(r: int, generator: torch.Generator, roulette_from: int = 0):
    """One bounce's random numbers for ``r`` rays, in bounce_step's order:
    (alpha uniform, unit-ball sample, roulette uniform or None)."""
    dev = generator.device
    u_alpha = torch.rand((r,), generator=generator, device=dev)
    sphere = unit_sphere(torch.randn((r, 3), generator=generator, device=dev),
                         torch.rand((r,), generator=generator, device=dev))
    u_roul = torch.rand((r,), generator=generator, device=dev) if roulette_from else None
    return u_alpha, sphere, u_roul


def bounce_step(tris, tex_cm, background, env, tri_chunk: int,
                o, d, atten, result, alive, reflected,
                u_alpha, sphere, u_roul=None, roulette_from: int = 0, bounce_i: int = 0,
                intersector=first_hit):
    """One path-tracing bounce of a flat ray batch (the reference's device
    loop body, RtxDevice.cu:105-158; the JAX package's ``_bounce_step``).

    State: o, d, atten, result (R, 3); alive (R,) bool; reflected (R,)
    float, 0 for never reflected, else the roulette boost (1 with roulette
    off).  ``tex_cm`` is the texture channel-major (4, th, tw); ``env`` an
    optional (He, We, 3) sky for bounced misses.  Draws: ``u_alpha`` (R,)
    uniforms for the stochastic alpha, ``sphere`` (R, 3) unit-ball samples
    for the scatter, ``u_roul`` (R,) uniforms when ``roulette_from`` is set
    (opt-in Russian roulette from that bounce on: reflected rays die with
    probability 1/2 and survivors double their boost).

    Returns the new state and this step's hit distance t (inf on a miss)."""
    t, tri, bu, bv = intersector(o, d, tris, tri_chunk)
    finite = torch.isfinite(t)
    hit = alive & finite
    dx, dy, dz = d.unbind(1)

    # miss: sky colour; never-reflected primary rays get the background
    if env is None:
        sky = torch.clamp(1.0 + dy, max=1.0)[:, None]
    else:
        eh, ew = env.shape[0], env.shape[1]
        su = torch.atan2(dz, dx) * (0.5 / math.pi) + 0.5
        sv = torch.arccos(torch.clamp(dy, -1.0, 1.0)) * (1.0 / math.pi)
        exi = torch.clamp((su * ew).to(torch.int64), 0, ew - 1)
        eyi = torch.clamp((sv * eh).to(torch.int64), 0, eh - 1)
        sky = env[eyi, exi]
    # the boost multiplies after the physical throughput, so that the
    # per-sample clamp keeps the roulette estimator unbiased
    miss_color = atten * sky * torch.clamp(reflected, min=1.0)[:, None]
    miss_out = torch.where((reflected > 0.0)[:, None], miss_color, background[None, :])
    result = torch.where((alive & ~finite)[:, None], miss_out, result)

    # surface at the hit: uv corners and normal of the triangle (index 0
    # for misses, which the masks below discard)
    att = tris["attr9"][:, tri.long()]  # (9, R)
    w0 = 1.0 - bu - bv
    uvx = w0 * att[0] + bu * att[2] + bv * att[4]
    uvy = w0 * att[1] + bu * att[3] + bv * att[5]
    th, tw = tex_cm.shape[1], tex_cm.shape[2]
    # nearest texel, wrap addressing (remainder, as jnp.mod, for negative
    # uv), flipped V
    px = torch.remainder(torch.floor(uvx * tw), tw).to(torch.int64)
    py = torch.remainder(torch.floor((1.0 - uvy) * th), th).to(torch.int64)
    texel = tex_cm.reshape(4, th * tw)[:, py * tw + px]  # (4, R)

    solid = hit & (texel[3] > u_alpha)  # stochastic alpha
    scatter = att[6:9].T + sphere
    tsafe = torch.where(finite, t, torch.zeros_like(t))
    o = torch.where(hit[:, None], o + tsafe[:, None] * d, o)
    d = torch.where(solid[:, None], scatter, d)
    atten = torch.where(solid[:, None], atten * texel[0:3].T, atten)
    reflected = torch.maximum(reflected, solid.to(torch.float32))
    alive = alive & hit  # misses are done; hits continue

    if roulette_from:
        gate = (bounce_i >= roulette_from) & (reflected > 0.0)
        kill = alive & gate & (u_roul >= 0.5)
        boost = alive & gate & ~kill
        reflected = torch.where(boost, reflected * 2.0, reflected)
        alive = alive & ~kill
    return (o, d, atten, result, alive, reflected), t


def _initial_state(o, d):
    r, dev = o.shape[0], o.device
    return (o, d, torch.ones((r, 3), dtype=torch.float32, device=dev),
            torch.zeros((r, 3), dtype=torch.float32, device=dev),
            torch.ones((r,), dtype=torch.bool, device=dev),
            torch.zeros((r,), dtype=torch.float32, device=dev))


def trace_rays(tris, texture, origins, dirs, bounces: int, background,
               generator: torch.Generator, tri_chunk: int, env=None, roulette_from: int = 0):
    """Trace one batch of rays (R, 3) to completion, all rays every bounce
    (the JAX package's ``trace_rays``).  Returns (colour (R, 3), primary_t
    (R,)), the first-hit distance, inf on a miss.  Rays alive after
    ``bounces`` steps return black.  render_rtx_sums is the capture path."""
    tex_cm = texture.permute(2, 0, 1).contiguous()
    bg = torch.as_tensor(background, dtype=torch.float32, device=origins.device)
    state = _initial_state(origins, dirs)
    primary_t = torch.full((origins.shape[0],), math.inf, device=origins.device)
    i = 0
    while i < bounces and bool(state[4].any()):
        state, t = bounce_step(tris, tex_cm, bg, env, tri_chunk, *state,
                               *draws(origins.shape[0], generator, roulette_from),
                               roulette_from=roulette_from, bounce_i=i)
        if i == 0:
            primary_t = torch.where(torch.isfinite(t), t, primary_t)
        i += 1
    result = torch.where(state[4][:, None], torch.zeros_like(state[3]), state[3])
    return result, primary_t


# -- a capture -------------------------------------------------------------------


def primary_rays(pix: torch.Tensor, jitter: torch.Tensor, width: int, height: int,
                 inv_proj_view, cam_location) -> torch.Tensor:
    """(R, 3) unit directions of camera rays through flat pixel indices
    ``pix`` with sub-pixel ``jitter`` (R, 2) in [0, 1): the NDC point at the
    far plane through the inverse proj-view matrix (RtxDevice.cu:75-82).
    The 4x4 apply is component-wise float32: the projective w cancels
    (about 4.995 - 5.005), and a reduced-precision product turns it into
    garbage."""
    m = [[float(x) for x in row] for row in np.asarray(inv_proj_view, np.float32)]
    cx, cy, cz = (float(x) for x in np.asarray(cam_location, np.float32))
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    nx = (px + jitter[:, 0] + 0.5) * 2.0 / width - 1.0
    ny = (py + jitter[:, 1] + 0.5) * 2.0 / height - 1.0
    fw = [m[k][0] * nx + m[k][1] * ny + m[k][2] + m[k][3] for k in range(4)]
    inv_w = 1.0 / fw[3]
    dx = fw[0] * inv_w - cx
    dy = fw[1] * inv_w - cy
    dz = fw[2] * inv_w - cz
    dn = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    return torch.stack([dx * dn, dy * dn, dz * dn], dim=1)


def _orbs(o, d, primary_t, splat_cameras) -> torch.Tensor:
    """(R,) primary rays passing within SPLAT_CAMERA_DOT_SIZE of a truth
    camera in front of the eye and not behind their first hit (the tproj >
    1e-6 test keeps a rig camera at the eye from inverting every pixel)."""
    orb = torch.zeros_like(primary_t, dtype=torch.bool)
    for cam in splat_cameras:
        rel = cam[None, :] - o
        tproj = (d * rel).sum(-1)
        delta = cam[None, :] - (o + d * tproj[:, None])
        near = (delta * delta).sum(-1) < SPLAT_CAMERA_DOT_SIZE**2
        orb |= near & (tproj > 1e-6) & (tproj <= primary_t)
    return orb


def _bounce_phase(tris, tex_cm, bg, env, tri_chunk, state, bounces, generator,
                  roulette_from, intersector):
    """Bounces 1 .. bounces-1 of the rays alive after the primary step,
    compacted to the live rays before every bounce.  Returns the (R, 3)
    colour of every ray: the primary result for rays done at bounce 0,
    black for rays alive past the cap."""
    alive = state[4]
    out = torch.where(alive[:, None], torch.zeros_like(state[3]), state[3])
    ids = alive.nonzero()[:, 0]
    state = tuple(x[ids] for x in state)
    i = 1
    while i < bounces and ids.numel():
        state, _ = bounce_step(tris, tex_cm, bg, env, tri_chunk, *state,
                               *draws(ids.numel(), generator, roulette_from),
                               roulette_from=roulette_from, bounce_i=i, intersector=intersector)
        live = state[4]
        out[ids[~live]] = state[3][~live]
        ids = ids[live]
        state = tuple(x[live] for x in state)
        i += 1
    return out


def render_rtx_sums(tris, texture, cam_location, inv_proj_view, width: int, height: int,
                    samples: int, background, generator: torch.Generator,
                    splat_cameras: Optional[torch.Tensor] = None, bounces: int = MAX_BOUNCES,
                    tri_chunk: int = 512, env: Optional[torch.Tensor] = None,
                    roulette_from: int = 0, sample_batch: int = 8, intersector=None):
    """``samples`` paths per pixel, ``sample_batch`` samples traced as one
    ray batch: the primary step for every ray, then the bounces of the live
    rays.  Returns the flat (n_pix, 3) colour sum and the (n_pix,) orb mask.
    ``texture`` is (th, tw, 4) RGBA on the device that traces; the draws
    come from ``generator`` on that device.  ``intersector`` is None for
    the tracer's route (first_hit, told which rays bounce), or one function
    for every intersection, to compare a kernel with its plain version."""
    dev = texture.device
    tex_cm = texture.permute(2, 0, 1).contiguous()
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    eye = torch.as_tensor(np.asarray(cam_location, np.float32), device=dev)
    bounce_hits = intersector or functools.partial(first_hit, bounce=True)
    intersector = intersector or first_hit
    n_pix = width * height
    color_acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    orb_acc = torch.zeros((n_pix,), dtype=torch.bool, device=dev)
    done = 0
    while done < samples:
        b = min(sample_batch, samples - done)
        r = b * n_pix
        pix = torch.arange(n_pix, device=dev).repeat(b)  # sample-major
        jitter = torch.rand((r, 2), generator=generator, device=dev)
        d = primary_rays(pix, jitter, width, height, inv_proj_view, cam_location)
        o = eye.expand(r, 3).contiguous()
        state, primary_t = bounce_step(tris, tex_cm, bg, env, tri_chunk, *_initial_state(o, d),
                                       *draws(r, generator, roulette_from),
                                       roulette_from=roulette_from, bounce_i=0,
                                       intersector=intersector)
        color = _bounce_phase(tris, tex_cm, bg, env, tri_chunk, state, bounces, generator,
                              roulette_from, bounce_hits)
        # roulette estimates may exceed 1 by design: clipping them would
        # bring back the bias the boost avoids
        color = torch.clamp(color, min=0.0) if roulette_from else torch.clamp(color, 0.0, 1.0)
        # the batch's samples summed one after another from zero, then added
        # to the total: the JAX package's order of float32 additions
        batch_sum = torch.zeros_like(color_acc)
        for s in color.view(b, n_pix, 3):
            batch_sum += s
        color_acc += batch_sum
        if splat_cameras is not None and splat_cameras.shape[0] > 0:
            orb_acc |= _orbs(o, d, primary_t, splat_cameras).view(b, n_pix).any(0)
        done += b
    return color_acc, orb_acc


def finish_rtx(color_sum, orb, samples: int, width: int, height: int) -> torch.Tensor:
    """Sample sums -> the (H, W, 3) image, orb pixels inverted."""
    color = color_sum / samples
    color = torch.where(orb[:, None], 1.0 - color, color)
    return color.reshape(height, width, 3)


def render_rtx(*args, samples: int, width: int, height: int, **kwargs) -> torch.Tensor:
    """One truth photograph, (H, W, 3) float32 in [0, 1]: render_rtx_sums +
    finish_rtx."""
    color_sum, orb = render_rtx_sums(*args, width=width, height=height, samples=samples,
                                     **kwargs)
    return finish_rtx(color_sum, orb, samples, width, height)


# -- the scene -------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton3(q: np.ndarray) -> np.ndarray:
    """(T, 3) int64 coords in [0, 1024) -> interleaved Morton codes."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def scene_tables(mesh: TriangleMesh, tri_chunk: int, accel_min: int) -> dict:
    """The scene's per-triangle tables as numpy arrays, laid out as the JAX
    package's ``RtxHost.load_model`` lays them out, so that triangle
    indices agree: triangles padded to a multiple of ``tri_chunk`` (padding
    is invalid and zero), Morton-ordered from ``accel_min`` triangles on.

    ax..e2z, valid: corner a and the two edges, component by component;
    attr9 (9, T): the corners' uv and the unit normal; feat10 (10, 4 T): per
    chunk the column blocks [det | u_num | v_num | t_num], each linear in
    the ray features [d, o x d, o, 1], read by the plain intersector; tri40
    (T_real, 40) the same columns triangle by triangle for the real
    triangles only, and tri_ids (T_real,) int32 their indices, read by K5;
    with the Morton order also the per-chunk AABBs bb_* (NC,), the group
    boxes bg_* (ceil(NC / CHUNK_GROUP),) over them (group_boxes), and geo10
    (10, T) = [a, e1, e2, valid] component by component, read by the plain
    culled march, and tri12 (T, 12), the same triangle by triangle with two
    zeros, read by K9 (intersect_culled, which first_hit routes such a
    scene to)."""
    t = mesh.num_triangles
    tc = max(tri_chunk, _round_up(t, tri_chunk))
    v, tri, tri_uv = mesh.vertices, mesh.triangles, mesh.tri_uv
    use_accel = t >= accel_min
    if use_accel and t > 0:
        cent = (v[tri[:, 0]] + v[tri[:, 1]] + v[tri[:, 2]]) / 3.0
        lo, hi = cent.min(0), cent.max(0)
        q = np.clip(((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0), 0, 1023).astype(np.int64)
        order = np.argsort(_morton3(q), kind="stable")
        tri, tri_uv = tri[order], tri_uv[order]
    a, e1, e2, nrm = (np.zeros((tc, 3), np.float32) for _ in range(4))
    a[:t] = v[tri[:, 0]]
    e1[:t] = v[tri[:, 1]] - v[tri[:, 0]]
    e2[:t] = v[tri[:, 2]] - v[tri[:, 0]]
    n = np.cross(e1[:t], e2[:t])
    nrm[:t] = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    uv = np.zeros((tc, 3, 2), np.float32)
    uv[:t] = tri_uv
    valid = np.zeros((tc,), bool)
    valid[:t] = True
    out = {k: np.ascontiguousarray(x[:, i]) for x, names in (
        (a, ("ax", "ay", "az")), (e1, ("e1x", "e1y", "e1z")), (e2, ("e2x", "e2y", "e2z")))
        for i, k in enumerate(names)}
    out["valid"] = valid
    out["attr9"] = np.stack([uv[:, 0, 0], uv[:, 0, 1], uv[:, 1, 0], uv[:, 1, 1],
                             uv[:, 2, 0], uv[:, 2, 1], nrm[:, 0], nrm[:, 1], nrm[:, 2]])
    fdet = np.cross(e2, e1)
    featq = np.zeros((4, tc, 10), np.float32)
    featq[0, :, 0:3] = fdet
    featq[1, :, 0:3] = np.cross(a, e2)
    featq[1, :, 3:6] = e2
    featq[2, :, 0:3] = -np.cross(a, e1)
    featq[2, :, 3:6] = -e1
    featq[3, :, 6:9] = -fdet
    featq[3, :, 9] = np.sum(a * fdet, axis=-1)
    ncb = tc // tri_chunk
    out["feat10"] = np.ascontiguousarray(
        featq.reshape(4, ncb, tri_chunk, 10).transpose(3, 1, 0, 2).reshape(10, 4 * tc))
    # K5's table: the real triangles only, in index order, each row the same
    # columns [det | u_num | v_num | t_num] x 10 features, and their indices
    real = np.nonzero(valid)[0]
    out["tri40"] = np.ascontiguousarray(featq[:, real].transpose(1, 0, 2).reshape(-1, 40))
    out["tri_ids"] = real.astype(np.int32)
    if use_accel:
        corners = np.stack([a, a + e1, a + e2])  # (3, tc, 3)
        mn = np.where(valid[None, :, None], corners, np.float32(np.inf)).min(0)
        mx = np.where(valid[None, :, None], corners, np.float32(-np.inf)).max(0)
        mn = mn.reshape(ncb, tri_chunk, 3).min(1)
        mx = mx.reshape(ncb, tri_chunk, 3).max(1)
        for i, ax in enumerate("xyz"):
            out[f"bb_min{ax}"], out[f"bb_max{ax}"] = mn[:, i].copy(), mx[:, i].copy()
        # K9's group boxes over CHUNK_GROUP consecutive chunks, for its
        # two-level key scan
        gmn, gmx = group_boxes(mn, mx, CHUNK_GROUP)
        for i, ax in enumerate("xyz"):
            out[f"bg_min{ax}"], out[f"bg_max{ax}"] = gmn[:, i].copy(), gmx[:, i].copy()
        out["geo10"] = np.ascontiguousarray(
            np.concatenate([a.T, e1.T, e2.T, valid[None].astype(np.float32)]))
        # K9's table: the same ten values triangle by triangle, padded to 48
        # bytes, so that a thread reads a triangle as three 16-byte loads
        out["tri12"] = np.ascontiguousarray(np.concatenate(
            [a, e1, e2, valid[:, None].astype(np.float32), np.zeros((tc, 2), np.float32)], 1))
    return out


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: the current card for a bare "cuda"."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class RtxHost:
    """Scene owner and capture entry point (reference RtxHost,
    src/rtx/RtxHost.{h,cpp}; the JAX package's ``RtxHost``): loads the mesh
    and texture onto ``device``, renders black with no model, and falls
    back to a mid-grey texture.  ``device`` "cuda" without CUDA raises.

    ``bounce_chunk`` and ``bounce_round`` tune the JAX package's bounce
    phase on the TPU and are accepted without effect; ``sample_batch`` is
    the number of samples traced as one batch of rays."""

    def __init__(self, tri_chunk: int = 512, sample_batch: int = 8,
                 bounce_chunk: int = 4096, bounce_round: Optional[int] = None,
                 roulette_from: int = 0, *, device="cuda"):
        self.device = resolve_device(device)
        self.tri_chunk = tri_chunk
        self.sample_batch = sample_batch
        self.roulette_from = roulette_from
        self.mesh: Optional[TriangleMesh] = None
        self._tris: Optional[dict] = None
        self._texture = self._to_device(blank_texture())
        self._env: Optional[torch.Tensor] = None
        self._seed = 0

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.float32)).to(self.device)

    def load_model(self, source, progress=None, accel_min: int = 2 * 512,
                   mxu_bounce: bool = True, mt_kernel: bool = False) -> None:
        """An OBJ path or a TriangleMesh.  ``accel_min`` is the triangle
        count from which the Morton-chunk AABB march replaces brute force,
        as in the JAX package: every intersection of such a mesh, primaries
        and bounces, goes through K9 (intersect_culled), a smaller mesh's
        through K5 (intersect), each its plain twin on the CPU.
        ``mxu_bounce`` and ``mt_kernel`` choose among the JAX package's TPU
        intersectors and are accepted without effect."""
        mesh = source if isinstance(source, TriangleMesh) else load_obj(source, progress)
        self.mesh = mesh
        self._tris = {k: torch.from_numpy(x).to(self.device)
                      for k, x in scene_tables(mesh, self.tri_chunk, accel_min).items()}

    def load_texture_diffuse(self, source) -> None:
        tex = source if isinstance(source, np.ndarray) else load_texture_rgba(source)
        self._texture = self._to_device(tex)

    def load_environment(self, source) -> None:
        """Equirectangular sky for bounced misses: an (H, W, 3) array in
        [0, 1] or an image path; None restores the reference's gradient sky."""
        if source is None:
            self._env = None
        elif isinstance(source, (str, bytes)):
            self._env = self._to_device(load_texture_rgba(source)[..., :3])
        else:
            self._env = self._to_device(source)

    def reset(self) -> None:
        self.mesh = None
        self._tris = None
        self._texture = self._to_device(blank_texture())
        self._env = None

    def replica(self, device) -> "RtxHost":
        """This host on ``device``: a copy holding its scene, texture and sky
        there (itself on its own device), for a capture split over the
        cards of one process (parallel.capture_images_local)."""
        device = _indexed(resolve_device(device))
        if device == _indexed(self.device):
            return self
        twin = copy.copy(self)
        twin.device = device
        twin._tris = None if self._tris is None else {
            k: x.to(device) for k, x in self._tris.items()}
        twin._texture = self._texture.to(device)
        twin._env = None if self._env is None else self._env.to(device)
        return twin

    def render(self, camera: Camera, background, samples: int, width: int = 1024,
               height: int = 1024, splat_cameras=None, bounces: int = MAX_BOUNCES,
               seed: Optional[int] = None) -> torch.Tensor:
        """(H, W, 3) float32 on the host's device.  The draws come from one
        generator seeded with ``seed``; without one, the host counts its
        renders as the JAX package does (1, 2, ...)."""
        if self._tris is None:
            return torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        inv_pv = np.linalg.inv(camera.get_proj_view(width / height).astype(np.float64)
                               ).astype(np.float32)
        if seed is None:
            self._seed += 1
            seed = self._seed
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        cams = None
        if splat_cameras is not None and len(splat_cameras):
            cams = self._to_device(np.stack([np.asarray(c, np.float32) for c in splat_cameras]))
        color_sum, orb = render_rtx_sums(
            self._tris, self._texture, camera.location, inv_pv, width, height, samples,
            background, generator, splat_cameras=cams, bounces=bounces,
            tri_chunk=self.tri_chunk, env=self._env, roulette_from=self.roulette_from,
            sample_batch=self.sample_batch)
        return finish_rtx(color_sum, orb, samples, width, height)
