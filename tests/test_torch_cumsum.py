"""PyTorch port vs JAX package: the cumsum route of the fused step's
duplicate-gradient reduction (ops.raster_tiled.cumsum_frames, kernel K4, and
dup_grads_to_rows_cumsum) and the binning fields it reads.

On the CPU cumsum_frames is its plain twin (torch.cumsum); the JAX side runs
its Pallas carry-cumsum in interpret mode (GSPLAT_PALLAS_CUMSUM=1; shapes
with no multiple-of-128 divisor of D take jnp.cumsum there).  Tolerances:
the scan rtol 2e-5, atol 2e-3 on inputs x 100 (tests/test_raster_tiled.py's);
the train core's loss rtol 1e-5, gradients and var_loc atol 2e-4 x the
largest value (the segment differences subtract two running prefixes, so
summation-order noise lands as absolute error of the prefix's size:
tests/test_raster_tiled.py:872-884).

The kernel's order of addition is held here through design_order_scan, a
torch twin of csrc/cumsum_frames.cu's sums (the chunk totals in float64, the
fixed-order prefix of the totals, the float32 in-chunk scan); on the card
the kernel equals it bit for bit.

The CUDA kernel's tests (marker ``cuda``) need a card and skip here."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import (  # noqa: F401
    W, H, camera_stack, cuda_device, jax_model, model_arrays, random_splats, random_truths,
    to_jax, to_torch,
)

from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.binning import bin_frames, bin_splats, bin_splats_batch
from gaussian_splatterer_tpu_torch.ops.transforms import SplatComponents, project_splat_components
from gaussian_splatterer_tpu_torch.train import Trainer

LOSS_RTOL, ROUTE_ATOL = 1e-5, 2e-4
GRAD_NAMES = ("means", "shs", "scales", "opacities", "rotations")
SCAN_SHAPES = [(9, 3, 512), (9, 1, 384), (2, 2, 1024), (9, 2, 96), (9, 2, 1000)]


def _kernel_constant(name: str) -> int:
    src = (Path(rt.__file__).resolve().parents[1] / "csrc" / "cumsum_frames.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


K4_CHUNK, K4_WARPS = _kernel_constant("kChunk"), _kernel_constant("kThreads") // 32


def assert_within(a, b, err_msg=""):
    """|a - b| <= ROUTE_ATOL * the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1e-3, float(np.max(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=ROUTE_ATOL * scale, err_msg=err_msg)


def scan_input(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 100


def project_stack(arrays, cams, width=W, height=H):
    views, pvs, poss, txs, tys = cams
    frames = [project_splat_components(*to_torch(arrays), views[i], pvs[i], poss[i],
                                       float(txs[i]), float(tys[i]), width, height, 1)
              for i in range(len(views))]
    return SplatComponents(*(torch.stack(xs) for xs in zip(*frames)))


def project_batch(arrays, cams, width=W, height=H):
    """The batched twin of project_stack: the F frames in one frame-batched
    call, every field (F, N)."""
    return project_splat_components(*to_torch(arrays), *to_torch(cams), width, height, 1)


def jax_tiles(imgs, tile):
    import jax
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.raster_tiled import image_to_tiles_cm

    return jax.vmap(lambda im: image_to_tiles_cm(im, tile))(jnp.asarray(imgs))


# -- the scan --------------------------------------------------------------------


def _xor_tree(t):
    """The xor-shuffle sum of 32 lanes on the last axis: lane 0's bits,
    which are every lane's."""
    lanes = torch.arange(32, device=t.device)
    for off in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ off]
    return t[..., 0]


def design_order_scan(x, chunk=K4_CHUNK, warps=K4_WARPS):
    """K4's order of addition: each row cut into chunks of ``chunk``, each
    chunk into ``warps`` segments scanned in warp-strided steps of 32.
    Chunk totals: each lane down its column in float64, an xor tree over the
    lanes, the warps in sequence (their running sum is each warp's offset);
    a total is published with its lowest mantissa bit set (the ready flag).
    A chunk's prefix: its predecessors' published totals 32 at a time, each
    group by an xor tree, the groups in sequence.  The in-chunk scan in
    float32: per step a shuffle scan of 32 lanes plus the warp's carry of the
    earlier steps.  y = hi + (lo + scan), hi + lo the float64 base (prefix
    + the warp's offset) split into two floats.  Reads zeros past D."""
    k, f, d = x.shape
    rows, chunks = k * f, -(-d // chunk)
    steps = chunk // warps // 32
    xp = torch.zeros((rows, chunks * chunk), dtype=torch.float32, device=x.device)
    xp[:, :d] = x.reshape(rows, d)
    v = xp.view(rows, chunks, warps, steps, 32)
    col = torch.zeros((rows, chunks, warps, 32), dtype=torch.float64, device=x.device)
    for s in range(steps):
        col = col + v[:, :, :, s].double()
    col = _xor_tree(col)
    offset = torch.zeros_like(col)
    total = torch.zeros((rows, chunks), dtype=torch.float64, device=x.device)
    for w in range(warps):
        offset[..., w] = total
        total = total + col[..., w]
    published = (total.view(torch.int64) | 1).view(torch.float64)
    prefix = torch.zeros_like(total)
    for c in range(1, chunks):
        p = torch.zeros((rows,), dtype=torch.float64, device=x.device)
        for g in range(0, c, 32):
            group = torch.zeros((rows, 32), dtype=torch.float64, device=x.device)
            group[:, :min(32, c - g)] = published[:, g:min(c, g + 32)]
            p = p + _xor_tree(group)
        prefix[:, c] = p
    scan = torch.empty_like(v)
    carry = torch.zeros((rows, chunks, warps, 1), dtype=torch.float32, device=x.device)
    for s in range(steps):
        t = v[:, :, :, s]
        for off in (1, 2, 4, 8, 16):
            t = torch.cat([t[..., :off], t[..., off:] + t[..., :-off]], dim=-1)
        scan[:, :, :, s] = carry + t
        carry = carry + t[..., 31:]
    base = prefix[..., None] + offset
    hi = base.float()
    lo = (base - hi.double()).float()
    y = hi[..., None, None] + (lo[..., None, None] + scan)
    return y.reshape(rows, chunks * chunk)[:, :d].reshape(k, f, d)


def assert_full_size_rule(y, x):
    """chip_smoke.py phase 15's full-size rule: y against a float64 scan no
    worse than max(twice torch.cumsum's error on the same device, one ulp of
    the largest prefix)."""
    ref64 = torch.cumsum(x.double(), dim=2)
    err = float((y.double() - ref64).abs().max())
    err_lib = float((torch.cumsum(x, dim=2).double() - ref64).abs().max())
    floor = float(torch.finfo(torch.float32).eps * ref64.abs().max())
    assert err <= max(2 * err_lib, floor), (err, err_lib, floor)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_cumsum_frames_matches_jax(monkeypatch, shape):
    """The JAX test's four shapes and D = 1000 (no multiple-of-128 divisor)."""
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.raster_tiled import cumsum_frames as j_cumsum

    monkeypatch.setenv("GSPLAT_PALLAS_CUMSUM", "1")
    x = scan_input(shape)
    got = rt.cumsum_frames(torch.from_numpy(x))
    ref = np.asarray(j_cumsum(jnp.asarray(x), interpret=True))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_design_order_matches_jax(monkeypatch, shape):
    """K4's order of addition against JAX's Pallas scan (interpret mode) at
    the JAX test's shapes, within its tolerance."""
    import jax.numpy as jnp
    from gaussian_splatterer_tpu.ops.raster_tiled import cumsum_frames as j_cumsum

    monkeypatch.setenv("GSPLAT_PALLAS_CUMSUM", "1")
    x = scan_input(shape)
    got = design_order_scan(torch.from_numpy(x))
    ref = np.asarray(j_cumsum(jnp.asarray(x), interpret=True))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("shape,chunk", [((2, 3, 70_001), K4_CHUNK), ((1, 2, 256 * 70 + 5), 256)])
def test_design_order_within_the_full_size_rule(shape, chunk):
    """K4's order of addition against a float64 scan under phase 15's
    full-size rule: at the kernel's chunk (9 chunks a row) and at chunks of
    256 (71 a row, so a prefix sums three groups of 32 totals)."""
    x = torch.from_numpy(scan_input(shape))
    assert_full_size_rule(design_order_scan(x, chunk=chunk), x)


def test_cumsum_frames_on_cpu_is_the_plain_twin():
    x = torch.from_numpy(scan_input((3, 2, 100)))
    before = rt.cumsum_frames_launches
    assert torch.equal(rt.cumsum_frames(x), rt.cumsum_frames_reference(x))
    assert torch.equal(rt.cumsum_frames_reference(x), torch.cumsum(x, dim=2))
    assert rt.cumsum_frames_launches == before  # only a launch counts


def test_cumsum_frames_rejects_bad_arguments():
    with pytest.raises(ValueError, match="float32"):
        rt.cumsum_frames(torch.zeros((9, 4)))
    with pytest.raises(ValueError, match="float32"):
        rt.cumsum_frames(torch.zeros((9, 2, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="reduction"):
        rt.reduce_dup_grads(torch.zeros((9, 0)), None, 4, "segment")


# -- the binning fields ---------------------------------------------------------


@pytest.mark.parametrize("binner", ["bin_frames", "bin_splats_batch"])
@pytest.mark.parametrize("max_dup", [2**12, 100])
def test_frame_bins_fields_match_jax(max_dup, binner):
    """Per frame, for the kept duplicates: the depth position of each
    tile-sorted duplicate (JAX presort_pos), each depth slot's range (JAX's
    gated seg_start_g / seg_end_g), the depth inverse (inv_depth_flat) and
    the gather; at 100 the frames overflow and drop their deepest.  Both
    of the port's binners: frame by frame (bin_frames) and in one pass
    (bin_splats_batch)."""
    from gaussian_splatterer_tpu.ops.binning import bin_splats_batch as j_bin_batch
    from gaussian_splatterer_tpu.ops.transforms import SplatComponents as JComps

    f, n, tile = 2, 40, 16
    if binner == "bin_frames":
        comps = project_stack(random_splats(n, 21), camera_stack(f))
        fb = bin_frames([SplatComponents(*(x[i] for x in comps)) for i in range(f)], W, H,
                        tile, max_dup)
    else:
        comps = project_batch(random_splats(n, 21), camera_stack(f))
        fb = bin_splats_batch(comps, W, H, tile, max_dup)
    jb = j_bin_batch(JComps(*to_jax([x.numpy() for x in comps])), W, H, tile, max_dup,
                     min(128, max_dup))
    assert fb.num_dup == int(np.max(np.asarray(jb.num_dup)))
    assert (fb.num_dup > max_dup) == (max_dup == 100)
    off = 0
    for i, dc in enumerate(fb.frame_dups):
        assert dc == min(int(jb.num_dup[i]), max_dup)
        np.testing.assert_array_equal(fb.presort_pos[off:off + dc].numpy() - off,
                                      np.asarray(jb.presort_pos)[i, :dc])
        np.testing.assert_array_equal(fb.gather_idx[off:off + dc].numpy(),
                                      np.asarray(jb.gather_flat)[i * max_dup:i * max_dup + dc])
        slots = slice(i * n, (i + 1) * n)
        for mine, theirs in ((fb.seg_start, jb.seg_start_g), (fb.seg_end, jb.seg_end_g)):
            np.testing.assert_array_equal(mine[slots].numpy() - off,
                                          np.asarray(theirs)[slots] - i * max_dup)
        off += dc
    inv = torch.empty_like(fb.depth_order)
    inv[fb.depth_order] = torch.arange(f * n)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jb.inv_depth_flat))


def test_tile_bins_fields_match_jax():
    """One frame: presort_pos, seg_start, seg_end against JAX bin_splats's
    dup_presort and gated segments, past a max_dup cut."""
    from gaussian_splatterer_tpu.ops import binning as jbin
    from gaussian_splatterer_tpu.ops.transforms import SplatComponents as JComps

    comps = project_stack(random_splats(60, 4), camera_stack(1))
    one = SplatComponents(*(x[0] for x in comps))
    for max_dup in (2**12, 100):
        tb = bin_splats(one, W, H, 8, max_dup)
        jb = jbin.bin_splats(JComps(*to_jax([x[0].numpy() for x in comps])), W, H, 8, max_dup,
                             chunk=min(128, max_dup))
        d = tb.gather_idx.shape[0]
        np.testing.assert_array_equal(tb.presort_pos.numpy(), np.asarray(jb.dup_presort)[:d])
        np.testing.assert_array_equal(tb.seg_start.numpy(), np.asarray(jb.seg_start))
        np.testing.assert_array_equal(tb.seg_end.numpy(), np.asarray(jb.seg_end))
        # the segments tile [0, d) in depth order
        assert int(tb.seg_start[0]) == 0 and int(tb.seg_end[-1]) == d
        assert torch.equal(tb.seg_start[1:], tb.seg_end[:-1])


# -- the route ------------------------------------------------------------------


def _jax_batch(arrays, cams, truths, bgs, tile, max_dup):
    from gaussian_splatterer_tpu.ops.raster_tiled import render_train_grads_batch as j_batch

    return j_batch(*to_jax(arrays), *to_jax(cams), W, H, jax_tiles(truths, tile),
                   to_jax([bgs])[0], 1, tile=tile, max_dup=max_dup, interpret=True,
                   mm_bf16=False)


@pytest.mark.parametrize("n,max_dup", [(40, 2**12), (80, 128)])
def test_cumsum_route_batch_matches_jax(n, max_dup):
    """64^2, two frames, tile 32: loss, the five gradients and var_loc; 80
    splats make 145 duplicates in a frame, so at max_dup 128 the frames
    drop their deepest."""
    tile = 32
    arrays = random_splats(n, 31)
    cams = camera_stack(2)
    truths, bgs = random_truths(2, 5)
    loss_t, g_t, var_t, _, nd_t, _ = rt.render_train_grads_batch(
        *to_torch(arrays), *cams, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
        torch.from_numpy(bgs), 1, tile=tile, max_dup=max_dup, reduction="cumsum")
    loss_j, g_j, var_j, _, nd_j, _ = _jax_batch(arrays, cams, truths, bgs, tile, max_dup)
    assert nd_t == int(nd_j) and (nd_t > max_dup) == (max_dup == 128)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    for name, a, b in zip(GRAD_NAMES, g_t, g_j):
        assert a.shape == b.shape
        assert_within(a.numpy(), b, f"gradient {name}")
    assert_within(var_t.numpy(), var_j, "var_loc")


@pytest.mark.parametrize("frames,tile,max_dup", [(1, 16, 2**12), (3, 16, 2**12),
                                                  (3, 8, 300), (2, 32, 2**12)])
def test_cumsum_route_matches_index_add_route(frames, tile, max_dup):
    arrays = random_splats(60, 9)
    cams = camera_stack(frames)
    truths, bgs = random_truths(frames, 2)
    out = {}
    for reduction in rt.REDUCTIONS:
        out[reduction] = rt.render_train_grads_batch(
            *to_torch(arrays), *cams, W, H, rt.image_to_tiles(torch.from_numpy(truths), tile),
            torch.from_numpy(bgs), 1, tile=tile, max_dup=max_dup, reduction=reduction)
    (loss_i, g_i, var_i, res_i, nd_i, _), (loss_c, g_c, var_c, res_c, nd_c, _) = out.values()
    assert nd_i == nd_c > 0
    assert torch.equal(res_i, res_c) and float(loss_i) == float(loss_c)
    for name, a, b in zip(GRAD_NAMES, g_c, g_i):
        assert_within(a.numpy(), b.numpy(), f"gradient {name}")
    assert_within(var_c.numpy(), var_i.numpy(), "var_loc")


def test_cumsum_route_with_an_empty_frame():
    """render_train_grads_rows with a middle frame whose splats are all
    invalid: the group's padded width comes from the other frames, and the
    empty frame's rows get exactly zero."""
    tile = 16
    comps = project_stack(random_splats(50, 3), camera_stack(3))
    valid = comps.valid.clone()
    valid[1] = False
    comps = comps._replace(valid=valid)
    truths, bgs = random_truths(3, 8)
    tiles = rt.image_to_tiles(torch.from_numpy(truths), tile)
    d = {red: rt.render_train_grads_rows(comps, W, H, tiles, torch.from_numpy(bgs), tile=tile,
                                         max_dup=2**12, reduction=red)[1]
         for red in rt.REDUCTIONS}
    assert not d["cumsum"][1].any() and d["cumsum"][0].abs().max() > 0
    assert_within(d["cumsum"].numpy(), d["index_add"].numpy(), "d_rows")


def test_segment_sums_read_the_frame_not_a_modulo():
    """Two frames of three splats; the first fills the padded width exactly,
    so its empty last slot starts at the width, where a position modulo the
    width would take a zero prefix and put the frame's whole sum on that
    slot.  The second frame's first segment starts at its own first column
    and takes a zero prefix."""
    fb = rt.FrameBins(
        gather_idx=torch.tensor([1, 0, 0, 0, 4, 4]), tile_start=None, tile_end=None,
        num_dup=4, frame_dups=(4, 2),
        presort_pos=torch.tensor([3, 0, 1, 2, 4, 5]),
        # frame 0: [0, 3), [3, 4), [4, 4); frame 1 (from 4): [4, 6), [6, 6), [6, 6)
        seg_start=torch.tensor([0, 3, 4, 4, 6, 6]), seg_end=torch.tensor([3, 4, 4, 6, 6, 6]),
        depth_order=torch.tensor([0, 1, 2, 4, 3, 5]))
    d_feat = torch.arange(1.0, 7.0).expand(9, 6).contiguous()
    out = rt.dup_grads_to_rows_cumsum(d_feat, fb, 6)
    # depth order: frame 0 [2, 3, 4, 1], frame 1 [5, 6]
    expected = torch.tensor([2.0 + 3.0 + 4.0, 1.0, 0.0, 0.0, 5.0 + 6.0, 0.0])
    assert torch.equal(out, expected.expand(9, 6))
    assert torch.equal(rt.dup_grads_to_rows(d_feat, fb, 6), out)


def test_trainer_cumsum_step_matches_jax(monkeypatch):
    """One fused step of Trainer(reduction="cumsum") (4-camera rig, 8
    frames, frame_group 4: two scans) against the JAX package's Trainer:
    loss, var_loc and the parameters after the SGD step."""
    from gaussian_splatterer_tpu.config import Project as JProject
    from gaussian_splatterer_tpu.config import RuntimeConfig as JRuntimeConfig
    from gaussian_splatterer_tpu.train import Trainer as JTrainer

    res, tile, n, cap = 32, 16, 30, 40
    arrays = random_splats(n, 17, cap=cap)
    p = Project.app_default()
    p.sphere1.count = 4
    p.lrLocation, p.lrSh, p.lrScale, p.lrOpacity, p.lrRotation = 1e-2, 2.5e-2, 5e-3, 2.5e-2, 5e-3
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                            max_dup=2**12, frame_group=4, train_mm_bf16=False,
                            splats_capacity=cap)
    truths = random_truths(2, 9, res, res)[0]

    class Rtx:
        def render(self, camera, background, samples, width, height):
            return truths[0 if background[0] > 0.5 else 1]

    scans = []
    scan = rt.cumsum_frames
    monkeypatch.setattr(rt, "cumsum_frames", lambda x: scans.append(x.shape) or scan(x))
    port = Trainer(p, runtime, SplatModel.from_numpy(*arrays[:5], count=n, device="cpu"),
                   renderer="tiled", reduction="cumsum")
    jax_ = JTrainer(JProject.from_json(p.to_json()), JRuntimeConfig(**dataclasses.asdict(runtime)),
                    jax_model(arrays, n), renderer="tiled")
    for t in (port, jax_):
        t.capture_truths(Rtx())
    m_t, m_j = port.train(), jax_.train()
    assert port._fused and len(scans) == 2 and scans[0][:2] == (9, 4)
    np.testing.assert_allclose(float(m_t.loss), float(m_j.loss), rtol=LOSS_RTOL)
    assert_within(m_t.var_loc.numpy(), m_j.var_loc, "var_loc")
    (a_t, _), (a_j, _) = model_arrays(port.model), model_arrays(jax_.model)
    for name, a, b, old in zip(GRAD_NAMES, a_t, a_j, arrays):
        assert_within(a - old, b - old, f"update of {name}")


def test_reduction_is_checked():
    model = SplatModel.from_numpy(*random_splats(4, 1, cap=8)[:5], count=4, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        Trainer(Project.app_default(), RuntimeConfig(), model, renderer="tiled",
                reduction="atomic")
    trainer = Trainer(Project.app_default(), RuntimeConfig(), model, renderer="tiled")
    assert trainer.reduction == "index_add"  # the default route
    arrays = random_splats(10, 2)
    truths, bgs = random_truths(1, 2)
    with pytest.raises(ValueError, match="reduction"):
        rt.render_train_grads_batch(
            *to_torch(arrays), *camera_stack(1), W, H,
            rt.image_to_tiles(torch.from_numpy(truths), 16), torch.from_numpy(bgs), 1,
            tile=16, max_dup=2**10, reduction="sort")


# -- CUDA kernel (needs a card) ---------------------------------------------------


# the kernel's edge shapes: D a chunk and either side of it, D % 4 in {0, 1,
# 2, 3} over several chunks (rows off the 16-byte grid), the fused step's
# group, more blocks than the card holds at once, and one row of 2^22
CUDA_SCAN_SHAPES = SCAN_SHAPES + [
    (9, 2, 100), (3, 2, 1), (9, 8, 2049), (2, 3, 70_001),
    (3, 2, K4_CHUNK - 1), (3, 2, K4_CHUNK), (3, 2, K4_CHUNK + 1),
    (5, 3, 20_000), (5, 3, 20_001), (5, 3, 20_002), (5, 3, 20_003),
    (9, 8, 202_689), (9, 64, 4096), (9, 64, 20_000), (1, 1, 2**22)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SCAN_SHAPES)
def test_cumsum_kernel_matches_plain_and_repeats(cuda_device, shape):
    """Any D, ragged chunks included: two launches bit-equal; against a
    float64 scan no worse than twice the plain twin's error (or one ulp of
    the largest prefix), and at the JAX test's lengths (D <= 1024) within
    its tolerance of the plain twin.  (Past that the prefixes grow with
    sqrt(D) and so does any float32 scan's error.)"""
    x = torch.from_numpy(scan_input(shape)).to(cuda_device)
    before = rt.cumsum_frames_launches
    y1, y2 = rt.cumsum_frames(x), rt.cumsum_frames(x)
    torch.cuda.synchronize()
    assert rt.cumsum_frames_launches == before + 2
    assert torch.equal(y1, y2)
    plain = rt.cumsum_frames_reference(x)
    ref64 = torch.cumsum(x.double(), dim=2)
    err_k, err_p = (float((y.double() - ref64).abs().max()) for y in (y1, plain))
    assert err_k <= max(2 * err_p, float(torch.finfo(torch.float32).eps * ref64.abs().max()))
    if shape[2] <= 1024:
        np.testing.assert_allclose(y1.cpu().numpy(), plain.cpu().numpy(), rtol=2e-5, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 2, 1), (9, 2, 1000), (5, 3, 20_001), (2, 3, 70_001),
                                   (9, 8, 202_689), (1, 1, 2**18 + 3)])
def test_cumsum_kernel_follows_the_design_order(cuda_device, shape):
    """The kernel's sums are design_order_scan's, in its order: equal bit
    for bit (float32 and float64 adds only, nothing contracted)."""
    x = torch.from_numpy(scan_input(shape)).to(cuda_device)
    y = rt.cumsum_frames(x)
    assert torch.equal(y, design_order_scan(x))


@pytest.mark.cuda
def test_cumsum_kernel_launches_bit_equal_back_to_back(cuda_device):
    """50 launches queued back to back, then 50 on a stream of their own:
    every output equal to the first bit for bit."""
    x = torch.from_numpy(scan_input((9, 8, 30_001))).to(cuda_device)
    before = rt.cumsum_frames_launches
    ys = [rt.cumsum_frames(x) for _ in range(50)]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        ys += [rt.cumsum_frames(x) for _ in range(50)]
    torch.cuda.synchronize()
    assert rt.cumsum_frames_launches == before + 100
    assert all(torch.equal(y, ys[0]) for y in ys[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4096, 30_001])
def test_cumsum_kernel_on_an_input_off_the_16_byte_grid(cuda_device, d):
    """A contiguous input whose data_ptr is 4 bytes past the 16-byte grid
    (its rows' alignment differs from y's): the same bits as on an aligned
    copy, and the full-size rule."""
    k, f = 3, 2
    x = torch.from_numpy(scan_input((k, f, d))).to(cuda_device)
    off = torch.empty(k * f * d + 1, device=cuda_device)[1:].view(k, f, d)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    y = rt.cumsum_frames(off)
    assert torch.equal(y, rt.cumsum_frames(x))
    assert_full_size_rule(y, x)


@pytest.mark.cuda
def test_cumsum_route_on_card(cuda_device):
    """The route on the card: bit-equal from call to call, within the route
    tolerance of the CPU's index_add route."""
    tile = 32
    arrays = random_splats(120, 31)
    cams = camera_stack(3)
    truths, bgs = random_truths(3, 5)
    tiles = rt.image_to_tiles(torch.from_numpy(truths), tile)

    def run(dev, reduction):
        return rt.render_train_grads_batch(
            *to_torch(arrays, dev), *cams, W, H, tiles.to(dev), torch.from_numpy(bgs).to(dev),
            1, tile=tile, max_dup=2**12, reduction=reduction)

    before = rt.cumsum_frames_launches
    a, b = run(cuda_device, "cumsum"), run(cuda_device, "cumsum")
    torch.cuda.synchronize()
    assert rt.cumsum_frames_launches == before + 2
    for x, y in zip(a[1] + (a[2],), b[1] + (b[2],)):
        assert torch.equal(x, y)
    c = run("cpu", "index_add")
    for name, x, y in zip(GRAD_NAMES + ("var_loc",), a[1] + (a[2],), c[1] + (c[2],)):
        assert_within(x.cpu().numpy(), y.numpy(), name)
