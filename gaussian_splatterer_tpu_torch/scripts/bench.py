"""Headline benchmark of the port: fwd+bwd rasterize ms/frame at 50k
splats, 1024x1024 (counterpart of the JAX package's root bench.py).

    python -m gaussian_splatterer_tpu_torch.scripts.bench [--tile 16 --max-dup N]

Prints ONE JSON line on standard output: ``metric``, ``value`` (ms/frame),
``unit``, ``vs_baseline`` and the two gate errors.  ``vs_baseline`` is the
reference's frame budget over the measured time: its 100 steps/s
auto-train budget (src/Config.h:10) at the default 16-camera rig, 32
frames a step, is 1000 / (100 * 32) = 0.3125 ms/frame; above 1 is faster.
The kernels' launch counts go to standard error as one JSON line.

The timed path is the fused training step's core,
``ops.raster_tiled.render_train_grads_batch``: one frame-batched
projection, binning, the fused compositor composite_train (K3), the
reduction and the backward through the projection, for 8 frames, the
Trainer's frame group.  Before timing, two gates hold the device's path
against the exact oracle, which runs on the CPU: the forward
(``render_tiled``, composite_fwd, K1) within NUMERICS_ATOL and the fused
gradients within GRAD_GATE_RTOL of each parameter's largest oracle
gradient.  A failed gate exits nonzero.  The JAX bench's TPU-only options
(``CHUNK``, ``WORK_CAP``, ``mm_bf16`` and its kernel-options gate) have no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gaussian_splatterer_tpu_torch import resolve_device
from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
from gaussian_splatterer_tpu_torch.rt import tracer
from gaussian_splatterer_tpu_torch.scripts.scenes import build_scene

W = H = 1024
N_SPLATS = 50_000
CAPACITY = 65_536
TILE = 32
MAX_DUP = 180_224  # ~168k duplicates at this scene and tile, with ~7% headroom
FRAMES = 8  # frames per fused launch (the trainer's default frame_group)
REPS = 30
REFERENCE_FRAME_BUDGET_MS = 1000.0 / (100.0 * 32.0)
NUMERICS_ATOL = 2e-2  # forward: max |tiled - oracle|
GATE_RES = 128
GATE_SPLATS = 150
GRAD_GATE_RTOL = 5e-2  # gradients: max deviation over the oracle's largest, per parameter
PROBE_MAX_DUP = 2**30  # a probe keeps every duplicate: the bins are sized by the true count
DUP_CHUNK = 256  # a sized max_dup is a multiple of this (RuntimeConfig.train_chunk)
GRAD_NAMES = ("means", "shs", "scales", "opacities", "rotations")


def scene_tensors(n_splats: int, capacity: int, width: int, height: int, frames: int,
                  seed: int, device):
    """build_scene's arrays as tensors on ``device``: (params, active,
    (views, proj_views, positions, tan_fovx, tan_fovy))."""
    params, active, views, pvs, poss, txs, tys, _ = build_scene(
        n_splats, capacity, width, height, frames, seed=seed)
    to = _to(device)
    return tuple(map(to, params)), to(active), tuple(map(to, (views, pvs, poss, txs, tys)))


def _to(device):
    return lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)


def numerics_gate(device="cuda") -> float:
    """The forward through the device's path (render_tiled, tile 16)
    against the exact oracle on the CPU, on the gate scene (150 splats,
    128^2, seed 7).  Returns max |tiled - oracle|; exits on failure."""
    dev = resolve_device(device)
    params, active, cams = scene_tensors(GATE_SPLATS, 256, GATE_RES, GATE_RES, 1, 7, "cpu")
    view, proj_view, pos, tx, ty = (c[0] for c in cams)
    frame = (view, proj_view, pos, float(tx), float(ty), GATE_RES, GATE_RES)
    bg = torch.tensor([0.2, 0.3, 0.4], dtype=torch.float32)
    with torch.no_grad():
        img_t = rt.render_tiled(*(x.to(dev) for x in (*params, active)), *frame, bg.to(dev),
                                1, 1.0, tile=16, max_dup=2**13).cpu()
        img_o = render_oracle(*params, active, *frame, bg, 1, 1.0, row_chunk=16, tile_cull=16)
    err = float((img_t - img_o).abs().max())
    if not bool(torch.isfinite(img_t).all()) or err > NUMERICS_ATOL:
        raise SystemExit(f"{dev.type.upper()} numerics gate FAILED: max|tiled-oracle| = "
                         f"{err:.2e} (allowed {NUMERICS_ATOL}) or non-finite output")
    return err


def grad_gate(device="cuda") -> float:
    """The fused gradients (render_train_grads_batch, composite_train) on
    the device against autograd of the oracle's -1/2 squared error on the
    CPU (the quantity the fused step defines its gradients as, J^T
    residual; reference src/Trainer.cu:33-44): 150 splats, 128^2, seed 11,
    2 frames, uniform truths from seed 3, black background, tile 32.
    Returns the largest deviation over a parameter's largest oracle
    gradient; exits on failure."""
    dev = resolve_device(device)
    params, active, cams = scene_tensors(GATE_SPLATS, 256, GATE_RES, GATE_RES, 2, 11, "cpu")
    truths = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, GATE_RES, GATE_RES, 3)).astype(np.float32))
    tiles = rt.image_to_tiles(truths, 32).contiguous()
    bgs = torch.zeros((2, 3), dtype=torch.float32)
    _, g_t, *_ = rt.render_train_grads_batch(
        *(x.to(dev) for x in (*params, active, *cams)), GATE_RES, GATE_RES, tiles.to(dev),
        bgs.to(dev), 1, tile=32, max_dup=2**13)

    leaves = [p.clone().requires_grad_(True) for p in params]
    total = torch.zeros(())
    for i in range(2):
        img = render_oracle(*leaves, active, *(c[i] for c in cams), GATE_RES, GATE_RES,
                            bgs[i], 1, 1.0, row_chunk=16, tile_cull=32)
        total = total - 0.5 * torch.sum(torch.square(img - truths[i]))
    g_o = torch.autograd.grad(total, leaves)

    worst = 0.0
    for name, a, b in zip(GRAD_NAMES, g_t, g_o):
        a = a.detach().cpu()
        scale = max(1e-3, float(b.abs().max()))
        deviation = float((a - b).abs().max()) / scale
        if not bool(torch.isfinite(a).all()):
            raise SystemExit(f"{dev.type.upper()} grad gate FAILED: non-finite {name} gradients")
        if deviation > GRAD_GATE_RTOL:
            raise SystemExit(f"{dev.type.upper()} grad gate FAILED: {name} gradient deviation "
                             f"{deviation:.2e} (allowed {GRAD_GATE_RTOL}) vs CPU oracle")
        worst = max(worst, deviation)
    return worst


def headline_inputs(device, n_splats: int = N_SPLATS, capacity: int = CAPACITY,
                    res: int = W, frames: int = FRAMES, tile: int = TILE, shrink: float = 1.0):
    """The timed call's inputs on ``device``: the bench scene (seed 0) with
    its scales times ``shrink``, uniform truths from seed 1 tiled at
    ``tile``, black backgrounds.  Returns (params, active, cams, truth
    tiles, backgrounds)."""
    dev = resolve_device(device)
    params, active, views, pvs, poss, txs, tys, _ = build_scene(
        n_splats, capacity, res, res, frames)
    if shrink != 1.0:
        params = (params[0], params[1], params[2] * np.float32(shrink), *params[3:])
    to = _to(dev)
    truths = np.random.default_rng(1).uniform(0, 1, (frames, res, res, 3)).astype(np.float32)
    tiles = rt.image_to_tiles(to(truths), tile).contiguous()
    bgs = torch.zeros((frames, 3), dtype=torch.float32, device=dev)
    return (tuple(map(to, params)), to(active), tuple(map(to, (views, pvs, poss, txs, tys))),
            tiles, bgs)


def fwdbwd(inputs, res: int, tile: int, max_dup: int):
    """One fused fwd+bwd of every frame: render_train_grads_batch's
    (loss_sum, grads, var_loc, res, num_dup, num_work)."""
    params, active, cams, tiles, bgs = inputs
    return rt.render_train_grads_batch(*params, active, *cams, res, res, tiles, bgs, 1,
                                       tile=tile, max_dup=max_dup)


def sized_max_dup(num_dup: int) -> int:
    """A max_dup with 25% headroom over ``num_dup``, a multiple of DUP_CHUNK."""
    return -(-int(num_dup * 1.25) // DUP_CHUNK) * DUP_CHUNK


def probe_num_dup(inputs, res: int, tile: int) -> int:
    """The most duplicates any frame of ``inputs`` makes: one fwd+bwd that
    keeps them all."""
    return int(fwdbwd(inputs, res, tile, PROBE_MAX_DUP)[4])


def time_fwdbwd(inputs, res: int, tile: int, max_dup: int, reps: int) -> tuple[float, int]:
    """(ms per frame of ``reps`` fwd+bwd calls back to back, num_dup).  One
    warm-up call first (it builds the kernels); on a card, one pair of CUDA
    events around the whole run and one synchronize at its end."""
    frames = inputs[3].shape[0]
    num_dup = int(fwdbwd(inputs, res, tile, max_dup)[4])
    if num_dup > max_dup:
        raise SystemExit(f"the bench scene overflows the binning buffer: {num_dup} > "
                         f"max_dup {max_dup}")
    cuda = inputs[3].is_cuda
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fwdbwd(inputs, res, tile, max_dup)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    return ms / (reps * frames), num_dup


def splats_label(n: int) -> str:
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def launches() -> dict[str, int]:
    """The port's kernel launch counters (each wrapper adds one a launch)."""
    return {"composite_fwd": rt.composite_fwd_launches,
            "composite_train": rt.composite_train_launches,
            "composite_bwd": rt.composite_bwd_launches,
            "cumsum_frames": rt.cumsum_frames_launches,
            "mt_intersect": tracer.mt_intersect_launches,
            "mt_culled": tracer.mt_culled_launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--splats", type=int, default=N_SPLATS)
    ap.add_argument("--capacity", type=int, default=None,
                    help=f"default max({CAPACITY}, --splats)")
    ap.add_argument("--res", type=int, default=W)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--tile", type=int, default=TILE)
    ap.add_argument("--max-dup", type=int, default=MAX_DUP,
                    help="duplicates a frame keeps; size it from a probe "
                         "(probe_num_dup) for another scene or tile")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    capacity = args.capacity or max(CAPACITY, args.splats)

    gate_err = numerics_gate(device)
    grad_err = grad_gate(device)
    inputs = headline_inputs(device, args.splats, capacity, args.res, args.frames, args.tile)
    ms_per_frame, _ = time_fwdbwd(inputs, args.res, args.tile, args.max_dup, args.reps)
    print(json.dumps({
        "metric": f"fwd+bwd rasterize ms/frame ({splats_label(args.splats)} splats, "
                  f"{args.res}x{args.res})",
        "value": round(ms_per_frame, 4),
        "unit": "ms/frame",
        "vs_baseline": round(REFERENCE_FRAME_BUDGET_MS / ms_per_frame, 4),
        "numerics_gate_max_err": gate_err,
        "grad_gate_max_err": grad_err,
    }), flush=True)
    print(json.dumps({"launches": launches()}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
