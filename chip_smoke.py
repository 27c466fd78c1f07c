"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
gaussian_splatterer_tpu_torch/csrc/, holds each against its plain PyTorch
version, drives the serving path (``render --mode splats`` through the CLI)
and the training path (``Trainer`` under ``auto_train``) at full size,
times the stages with CUDA events, and exits nonzero at the first phase
that fails.  It imports nothing of JAX.

Phases:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: one nvcc per kernel source, all started together, into
     build/torch_kernels/, with the build seconds and the ptxas lines;
  serve path (kernel composite_fwd):
  3. kernel against plain and oracle on the numerics-gate scene of the JAX
     package's bench (150 splats, 128^2, seed 7) at tile 16 and 32;
  4. main path: the CLI renders the 50k-splat bench scene at 1024^2 and
     2048^2 and a 262,144-splat scene at 2048^2 from a project directory;
  5. times: median of REPS runs after WARMUP warm-ups per scene and size;
  training path (kernel composite_train):
  6. gate scene of the JAX package's bench grad gate (150 splats, 128^2,
     2 frames, seed 11, uniform truths from seed 3, black background,
     tile 32): kernel against plain, the fused gradients against autograd
     through the oracle, the loss against the oracle's;
  7. main path: auto_train for TRAIN_STEPS steps of the 50k-splat bench
     scene at 1024^2 on the 16-camera rig (32 frames a step, 8 frames a
     kernel launch), truths rendered by the serve path from a perturbed
     teacher; then kernel against plain on one launch of the trained model;
  8. times: per-layer step times, steps/s, the bench headline (fwd+bwd
     ms/frame) and the device's busy share of a step.

Bounds: the least time the card could take for a kernel's work, the larger
of its FP32 operations over 67 TFLOP/s and its bytes (each input read once,
each output written once) over 3.35 TB/s.  The operations are counted from
the (pixel, duplicate) pairs that these inputs evaluate before their pixel
terminates, which the plain version counts, times the operations per pair
of the kernel's source (an expf counts as one operation).

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernel summary.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

GATE_ATOL_PLAIN = 1e-4  # kernel vs plain version on the gate scenes
GATE_ATOL_ORACLE = 2e-2  # kernel vs exact oracle: the forward gate of the JAX package's bench
MAIN_MAX_ATOL = 1e-2  # kernel vs plain at full size: isolated threshold flips
MAIN_MEAN_ATOL = 1e-5
GRAD_GATE_RTOL = 5e-2  # fused gradients vs the oracle's: the JAX package's bench grad gate
LOSS_GATE_RTOL = 1e-3  # fused loss vs the oracle's on the gate scene
BG_GATE = (0.2, 0.3, 0.4)
WARMUP, REPS = 3, 20
SCENES = (  # (label, splats, capacity, render sizes)
    ("bench50k", 50_000, 65_536, (1024, 2048)),
    ("large262k", 262_144, 262_144, (2048,)),
)
TRAIN_SPLATS, TRAIN_CAPACITY = 50_000, 65_536  # the bench scene, trained
TRAIN_RES, TRAIN_TILE, TRAIN_GROUP, TRAIN_STEPS = 1024, 32, 8, 6
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# operations per (pixel, duplicate) pair, counted in the kernels' sources
K1_OPS_VISITED = 16  # dx, dy, power (9), power test, expf, alpha, clamp, alpha test
K1_OPS_COMPOSITED = 10  # transmittance (2), stop test, weight, rgb (6)
K3_OPS_VISITED = 2 * K1_OPS_VISITED  # both passes evaluate the Gaussian
K3_OPS_COMPOSITED = K1_OPS_COMPOSITED + 47  # + pass 2: transmittance, d_alpha, nine sums
K3_OPS_PIXEL = 20  # residual (9), g_t (5), g_ctot (5), g_t T_final


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=120)
    return proc.stdout.strip()


def build_scene(n_splats: int, capacity: int, seed: int):
    """The JAX package's bench scene generator (bench.py build_scene), in numpy."""
    rng = np.random.default_rng(seed)
    means = np.zeros((capacity, 3), np.float32)
    means[:n_splats] = rng.uniform(-3, 3, (n_splats, 3))
    shs = np.zeros((capacity, 4, 3), np.float32)
    shs[:n_splats] = rng.normal(0, 0.5, (n_splats, 4, 3))
    scales = np.zeros((capacity, 3), np.float32)
    scales[:n_splats] = rng.uniform(0.01, 0.08, (n_splats, 3))
    opac = np.zeros((capacity,), np.float32)
    opac[:n_splats] = rng.uniform(0.2, 1.0, n_splats)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    rot[:n_splats] = rng.normal(0, 1, (n_splats, 4))
    return means, shs, scales, opac, rot


def bench_cameras(n_frames: int):
    """The bench's frame cameras (bench.py build_scene)."""
    from gaussian_splatterer_tpu_torch.models.camera import Camera

    return [Camera(np.array([0.3 + 0.2 * i, -0.2, -10.0 - 0.5 * i], np.float32),
                   np.zeros(3, np.float32), 60.0) for i in range(n_frames)]


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS, setup=None) -> float:
    """Median milliseconds of fn() by CUDA events, one event pair per run;
    ``setup()``, untimed, runs before each."""
    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
            torch.cuda.synchronize()
        if i < warmup:
            fn()
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(args, stats) -> tuple[float, str]:
    feat, tile_start, _, tile, _ = args
    ops = K1_OPS_VISITED * stats["pairs"] + K1_OPS_COMPOSITED * stats["composited"]
    nbytes = 4 * feat.numel() + 8 * tile_start.numel() + 16 * tile_start.numel() * tile * tile
    return bound_ms(ops, nbytes)


def k3_bound(args, stats) -> tuple[float, str]:
    feat, tile_start, _, truth, bg, *_ = args
    pixels = truth.shape[0] * truth.shape[1]
    ops = (K3_OPS_VISITED * stats["pairs"] + K3_OPS_COMPOSITED * stats["composited"]
           + K3_OPS_PIXEL * pixels)
    # feat in, d_feat out, ranges, truth in, residual out, backgrounds
    nbytes = 2 * 4 * feat.numel() + 8 * tile_start.numel() + (12 + 16) * pixels + 4 * bg.numel()
    return bound_ms(ops, nbytes)


def compare_train(args, out_k, stats=None):
    """Kernel outputs against the plain version's on the same launch:
    (finite, max |res|, mean |res|, max |d_feat|, max and mean of |d_feat|
    over its row's largest magnitude)."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    res_p, d_p = rt.composite_train_reference(*args, stats=stats)
    res_k, d_k = out_k
    dr = (res_k - res_p).abs()
    dd = (d_k - d_p).abs()
    rel = dd / d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    finite = bool(torch.isfinite(res_k).all() and torch.isfinite(d_k).all())
    return (finite, float(dr.max()), float(dr.mean()), float(dd.max()), float(rel.max()),
            float(rel.mean()))


def render_args(model, cam, w, h, train_fov, bg, dev):
    tx, ty = cam.tan_fov(w, h, train=train_fov)
    return (
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), cam.get_view(), cam.get_proj_view(w / h), cam.location,
        tx, ty, w, h, torch.tensor(bg, dtype=torch.float32, device=dev), model.sh_degree, 1.0,
    )


def launch_args(model, cams, width, height, truth_tiles, bgs, tile, max_dup):
    """Projection, binning and gather of one fused-step group: the
    arguments of its composite_train launch."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    with torch.no_grad():
        comps, rows9 = rt.project_frames(
            model.means.expand(cams.num_frames, -1, -1), model.shs, model.scales,
            model.opacities, model.rotations, model.active_mask(), *cams,
            width, height, model.sh_degree)
        return rt.train_launch_inputs(rows9, comps, width, height, truth_tiles, bgs, tile,
                                      max_dup)[1]


class Cell:
    """One scene at one size as the main path renders it: the session's
    preview camera, runtime tile and duplicate budget, black background,
    the serve path's x-FOV.  Holds one projection and binning for the
    kernel-vs-plain comparison and times every stage."""

    def __init__(self, session, size: int):
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        self.session, self.size = session, size
        self.tile = session.runtime.tile_px
        self.max_dup = session.runtime.max_dup
        self.args = render_args(session.model, session.preview_camera(), size, size, False,
                                (0.0, 0.0, 0.0), session.device)
        with torch.no_grad():
            self.comps = self.project()
            self.bins = self.bin()
            self.feat = rt.gather_features(self.comps, self.bins)
        self.composite_args = (self.feat, self.bins.tile_start, self.bins.tile_end,
                               self.tile, -(-size // self.tile))
        self.stats: dict = {}

    def project(self):
        from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

        return project_splat_components(*self.args[:13], self.session.model.sh_degree, 1.0)

    def bin(self):
        from gaussian_splatterer_tpu_torch.ops.binning import bin_splats

        return bin_splats(self.comps, self.size, self.size, self.tile, self.max_dup)

    @torch.no_grad()
    def times(self) -> dict[str, float]:
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        return {
            "projection": cuda_ms(self.project),
            "binning": cuda_ms(self.bin),
            "gather": cuda_ms(lambda: rt.gather_features(self.comps, self.bins)),
            "composite_kernel": cuda_ms(lambda: rt.composite_fwd(*self.composite_args)),
            "composite_plain": cuda_ms(lambda: rt.composite_fwd_reference(*self.composite_args)),
            "render": cuda_ms(lambda: self.session.render_splats(self.size, self.size)),
        }


class TeacherRtx:
    """Truth source of the training cells: the serve path (kernel
    composite_fwd) rendering a teacher model at the training FOV."""

    def __init__(self, teacher, tile: int, max_dup: int):
        self.teacher, self.tile, self.max_dup = teacher, tile, max_dup

    @torch.no_grad()
    def render(self, camera, background, samples, width, height):
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        bg = torch.tensor(background, dtype=torch.float32, device=self.teacher.device)
        return rt.render_tiled_model(self.teacher, camera, width, height, bg, train_fov=True,
                                     tile=self.tile, max_dup=self.max_dup)


def serve_phases(dev, card) -> dict:
    """Phases 3-5.  Returns the kernel summary entry of composite_fwd."""
    from gaussian_splatterer_tpu_torch.app import cli
    from gaussian_splatterer_tpu_torch.app.session import Session
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.io.image import load_png
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    phase("3. serve kernel vs plain vs oracle (gate scene: 150 splats, 128^2, seed 7)")
    arrays = build_scene(150, 256, seed=7)
    gate_model = SplatModel.from_numpy(*arrays, count=150, device=dev, sh_degree=1)
    gate_cam = Camera(np.array([0.3, -0.2, -10.0], np.float32), np.zeros(3, np.float32), 60.0)
    gate_args = render_args(gate_model, gate_cam, 128, 128, True, BG_GATE, dev)
    max_err = 0.0
    for tile in (16, 32):
        with torch.no_grad():
            comps = project_splat_components(*gate_args[:13], 1, 1.0)
            bins = bin_splats(comps, 128, 128, tile, 2**13)
            feat = rt.gather_features(comps, bins)
            out_k = rt.composite_fwd(feat, bins.tile_start, bins.tile_end, tile, -(-128 // tile))
            out_p = rt.composite_fwd_reference(feat, bins.tile_start, bins.tile_end, tile,
                                               -(-128 // tile))
            torch.cuda.synchronize()
            err_plain = float((out_k - out_p).abs().max())
            img_k = rt.render_tiled(*gate_args, tile=tile, max_dup=2**13)
            img_o = render_oracle(*gate_args, row_chunk=16, tile_cull=tile)
            err_oracle = float((img_k - img_o).abs().max())
        finite = bool(torch.isfinite(img_k).all())
        print(f"tile {tile}: num_dup {bins.num_dup}  max|kernel - plain| {err_plain:.3e} "
              f"(<= {GATE_ATOL_PLAIN})  max|kernel - oracle| {err_oracle:.3e} "
              f"(<= {GATE_ATOL_ORACLE})  finite {finite}")
        if not (finite and err_plain <= GATE_ATOL_PLAIN and err_oracle <= GATE_ATOL_ORACLE):
            raise SystemExit("phase 3 failed")
        max_err = max(max_err, err_plain)

    phase("4. serve main path: gsplat-torch render --mode splats")
    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE / "build"))
    projects = {}
    for label, n, cap, _ in SCENES:
        runtime = RuntimeConfig(render_resolution_x=1024, render_resolution_y=1024,
                                splats_capacity=cap, sh_degree=1, sh_coeffs=4,
                                max_dup=2**24)
        session = Session(project=Project.app_default(), runtime=runtime, device=dev)
        session.model = SplatModel.from_numpy(*build_scene(n, cap, seed=0), count=n,
                                              device=dev, sh_degree=1)
        session.save_project(str(work / label))
        projects[label] = str(work / label)
        print(f"{label}: wrote project with {n} splats (capacity {cap}) to {work / label}")
    runs = [(label, size) for label, _, _, sizes in SCENES for size in sizes]
    rt.composite_fwd_launches = 0
    for label, size in runs:
        out_png = str(work / f"{label}_{size}.png")
        t0 = time.perf_counter()
        cli.main(["render", projects[label], out_png, "--mode", "splats",
                  "--size", f"{size}x{size}", "--device", "cuda"])
        print(f"  {label} {size}^2: CLI render + PNG write {time.perf_counter() - t0:.3f} s "
              "(host clock, first call)")
    launches = rt.composite_fwd_launches
    print(f"composite_fwd launches in the serve main path: {launches}")
    if launches < len(runs):
        raise SystemExit("phase 4 failed: the main path did not launch the kernel")

    main_max_err, cells = 0.0, {}
    for label, size in runs:
        img = load_png(str(work / f"{label}_{size}.png"))
        share = float((img.max(axis=2) > 0).mean())
        session = cli._make_session(
            argparse.Namespace(project=projects[label], device="cuda"), require=True)
        cell = Cell(session, size)
        cells[(label, size)] = cell
        print(f"  {label} {size}^2: png {img.shape}, non-background share {share:.3f}, "
              f"num_dup {cell.bins.num_dup} (max_dup {session.runtime.max_dup})")
        if img.shape != (size, size, 3) or share < 0.05:
            raise SystemExit("phase 4 failed: PNG check")
        if not 0 < cell.bins.num_dup <= session.runtime.max_dup:
            raise SystemExit("phase 4 failed: num_dup out of range")
        with torch.no_grad():
            diff = (rt.composite_fwd(*cell.composite_args)
                    - rt.composite_fwd_reference(*cell.composite_args, stats=cell.stats)).abs()
        d_max, d_mean = float(diff.max()), float(diff.mean())
        print(f"  {label} {size}^2 kernel vs plain on the same binning: max {d_max:.3e} "
              f"(<= {MAIN_MAX_ATOL})  mean {d_mean:.3e} (<= {MAIN_MEAN_ATOL})  "
              f"pairs visited {cell.stats['pairs']} composited {cell.stats['composited']}")
        if d_max > MAIN_MAX_ATOL or d_mean > MAIN_MEAN_ATOL:
            raise SystemExit("phase 4 failed: kernel vs plain at full size")
        main_max_err = max(main_max_err, d_max)

    phase(f"5. serve times (CUDA events, median of {REPS} after {WARMUP} warm-ups; {card})")
    times = {}
    for (label, size), cell in cells.items():
        t = cell.times()
        times[(label, size)] = t
        b_ms, b_by = k1_bound(cell.composite_args, cell.stats)
        print(f"  {label} {size}^2 tile {cell.tile}: " + "  ".join(
            f"{k} {v:.3f} ms" for k, v in t.items())
            + f"  kernel bound {b_ms:.4f} ms ({b_by})  [{card}]", flush=True)

    head = cells[("bench50k", 1024)]
    b_ms, b_by = k1_bound(head.composite_args, head.stats)
    print("(composite_fwd ms / plain_ms / bound: the 50k-splat bench scene at 1024^2, tile 32)")
    return {
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:340",
        "launches": launches,
        "max_abs_err": max(max_err, main_max_err),
        "ms": times[("bench50k", 1024)]["composite_kernel"],
        "plain_ms": times[("bench50k", 1024)]["composite_plain"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call composites splats
    }


def train_gate(dev) -> float:
    """Phase 6.  Returns the largest kernel-vs-plain error."""
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.train import CameraBatch

    phase("6. train gate scene (150 splats, 128^2, 2 frames, seed 11, truths seed 3, tile 32)")
    res, tile = 128, 32
    model = SplatModel.from_numpy(*build_scene(150, 256, seed=11), count=150, device=dev,
                                  sh_degree=1)
    cams = CameraBatch.from_cameras(bench_cameras(2), res, res, device=dev)
    truths = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, res, res, 3))
                              .astype(np.float32)).to(dev)
    tiles = rt.image_to_tiles(truths, tile).contiguous()
    bgs = torch.zeros((2, 3), device=dev)

    args = launch_args(model, cams, res, res, tiles, bgs, tile, 2**13)
    out_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    finite, r_max, _, d_max, rel_max, _ = compare_train(args, out_k)
    print(f"kernel vs plain: max|res| {r_max:.3e} (<= {GATE_ATOL_PLAIN})  max|d_feat| "
          f"{d_max:.3e}, over the row's largest {rel_max:.3e} (<= {GATE_ATOL_PLAIN})  "
          f"finite {finite}")
    if not (finite and r_max <= GATE_ATOL_PLAIN and rel_max <= GATE_ATOL_PLAIN):
        raise SystemExit("phase 6 failed: kernel vs plain")

    params = (model.means, model.shs, model.scales, model.opacities, model.rotations)
    loss_f, g_f, var_f, res_f, num_dup, _ = rt.render_train_grads_batch(
        *params, model.active_mask(), *cams, res, res, tiles, bgs, 1, tile=tile,
        max_dup=2**13)
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    total, loss_o = 0.0, 0.0
    with torch.enable_grad():
        for i in range(2):
            img = render_oracle(*leaves, model.active_mask(), cams.view[i], cams.proj_view[i],
                                cams.cam_pos[i], float(cams.tan_fovx[i]),
                                float(cams.tan_fovy[i]), res, res, bgs[i], 1, 1.0,
                                row_chunk=16, tile_cull=tile)
            diff = img - truths[i]
            total = total - 0.5 * torch.sum(diff * diff)
            loss_o += float(torch.mean(diff.detach() * diff.detach()))
        g_o = torch.autograd.grad(total, leaves)
    worst = 0.0
    for name, a, b in zip(("means", "shs", "scales", "opacities", "rotations"), g_f, g_o):
        scale = max(1e-3, float(b.abs().max()))
        dev_rel = float((a - b).abs().max()) / scale
        ok = bool(torch.isfinite(a).all()) and dev_rel <= GRAD_GATE_RTOL
        print(f"  gradient {name}: max deviation over the oracle's largest {dev_rel:.3e} "
              f"(<= {GRAD_GATE_RTOL})  finite {bool(torch.isfinite(a).all())}")
        if not ok:
            raise SystemExit(f"phase 6 failed: {name} gradient against the oracle")
        worst = max(worst, dev_rel)
    loss_rel = abs(float(loss_f) - loss_o) / abs(loss_o)
    finite = bool(torch.isfinite(var_f).all() and torch.isfinite(res_f).all())
    print(f"  loss {float(loss_f):.6f} vs oracle {loss_o:.6f}: rel {loss_rel:.3e} "
          f"(<= {LOSS_GATE_RTOL})  num_dup {num_dup}  var_loc and residual finite {finite}")
    if not (finite and loss_rel <= LOSS_GATE_RTOL):
        raise SystemExit("phase 6 failed: loss against the oracle")
    return max(r_max, d_max)


def train_main(dev, card):
    """Phases 7 and 8.  Returns the kernel summary entry of composite_train."""
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.train import (
        CameraBatch, DensifyParams, LearningRates, auto_train, densify,
    )
    from gaussian_splatterer_tpu_torch.train.trainer import Trainer, _apply_sgd

    n, cap, res, tile = TRAIN_SPLATS, TRAIN_CAPACITY, TRAIN_RES, TRAIN_TILE
    phase(f"7. train main path: auto_train, {n} splats, {res}^2, tile {tile}, "
          f"frame_group {TRAIN_GROUP}, 16-camera rig")
    arrays = build_scene(n, cap, seed=0)
    t_arrays = [a.copy() for a in arrays]
    rng = np.random.default_rng(1)
    t_arrays[1][:n] += rng.normal(0, 0.2, t_arrays[1][:n].shape).astype(np.float32)
    t_arrays[3][:n] *= np.float32(0.7)
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res,
                            splats_capacity=cap, sh_degree=1, sh_coeffs=4, tile_px=tile,
                            frame_group=TRAIN_GROUP)
    project = Project.app_default()
    project.intervalDensify = 3
    rtx = TeacherRtx(SplatModel.from_numpy(*t_arrays, count=n, device=dev, sh_degree=1),
                     tile, runtime.max_dup)
    trainer = Trainer(project, runtime,
                      SplatModel.from_numpy(*arrays, count=n, device=dev, sh_degree=1),
                      renderer="tiled")
    frames = 2 * project.num_cameras
    groups = frames // TRAIN_GROUP
    log = []

    def on_step(it, m):
        log.append((it, float(m.loss), trainer.model.count, int(m.num_dup)))
        print(f"  step {it}: loss {log[-1][1]:.6f}  splats {log[-1][2]}  num_dup "
              f"{log[-1][3]} (max_dup {runtime.max_dup})", flush=True)

    rt.composite_fwd_launches = rt.composite_train_launches = 0
    stats = auto_train(trainer, rtx, TRAIN_STEPS, rng=random.Random(0), on_step=on_step)
    torch.cuda.synchronize()
    launches = rt.composite_train_launches
    print(f"auto_train: {stats}  composite_train launches {launches} (= {TRAIN_STEPS} steps "
          f"x {groups} groups of {TRAIN_GROUP} of {frames} frames)  composite_fwd launches "
          f"(truth capture) {rt.composite_fwd_launches}")
    m = trainer.model
    params = (m.means, m.shs, m.scales, m.opacities, m.rotations)
    finite = all(np.isfinite(x[1]) for x in log) and all(bool(torch.isfinite(p).all())
                                                        for p in params)
    if launches != TRAIN_STEPS * groups or not finite or len(log) != TRAIN_STEPS:
        raise SystemExit("phase 7 failed: launches, or a non-finite loss or parameter")
    if not all(0 < x[3] <= runtime.max_dup for x in log) or rt.composite_fwd_launches < frames:
        raise SystemExit("phase 7 failed: num_dup out of range, or no truth capture")

    # one launch of the trained model: the first group of the step
    cams = CameraBatch(*(x[:TRAIN_GROUP] for x in trainer.truth_cams.twice()))
    truth_g = trainer.truths[:TRAIN_GROUP]
    bgs = torch.ones((TRAIN_GROUP, 3), device=dev)
    args = launch_args(m, cams, res, res, truth_g, bgs, tile, runtime.max_dup)
    k3_stats: dict = {}
    out_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    finite, r_max, r_mean, d_max, rel_max, rel_mean = compare_train(args, out_k, k3_stats)
    print(f"kernel vs plain, one launch ({TRAIN_GROUP} frames, {args[0].shape[1]} duplicates): "
          f"max|res| {r_max:.3e} (<= {MAIN_MAX_ATOL}) mean {r_mean:.3e} (<= {MAIN_MEAN_ATOL})  "
          f"max|d_feat| {d_max:.3e}, over the row's largest: max {rel_max:.3e} "
          f"(<= {MAIN_MAX_ATOL}) mean {rel_mean:.3e} (<= {MAIN_MEAN_ATOL})  finite {finite}  "
          f"pairs visited {k3_stats['pairs']} composited {k3_stats['composited']}")
    if not (finite and r_max <= MAIN_MAX_ATOL and r_mean <= MAIN_MEAN_ATOL
            and rel_max <= MAIN_MAX_ATOL and rel_mean <= MAIN_MEAN_ATOL):
        raise SystemExit("phase 7 failed: kernel vs plain at full size")

    phase(f"8. train times (CUDA events, median; {card})")
    reps = 10
    leaves = [m.means.detach().expand(TRAIN_GROUP, -1, -1).clone()] + [
        p.detach() for p in params[1:]]
    for x in leaves:
        x.requires_grad_(True)

    def project_fn():
        with torch.enable_grad():
            return rt.project_frames(*leaves, m.active_mask(), *cams, res, res, 1)

    comps, rows9 = project_fn()
    fb, _ = rt.train_launch_inputs(rows9.detach(), comps, res, res, truth_g, bgs, tile,
                                   runtime.max_dup)
    _, d_feat = out_k
    d_rows9 = rt.dup_grads_to_rows(d_feat, fb, rows9.shape[1])

    graph = {}  # a fresh projection graph for each backward

    dp = DensifyParams.from_project(project)
    lrs = LearningRates.from_project(project)
    zero_grads = [torch.zeros_like(p) for p in params]
    var = trainer.last_metrics.var_loc
    avg = trainer.last_metrics.avg_grad_loc
    group = {  # one group of TRAIN_GROUP frames
        "projection forward": cuda_ms(project_fn, reps=reps),
        "binning": cuda_ms(lambda: rt.bin_frames(comps, res, res, tile, runtime.max_dup),
                           reps=reps),
        "gather": cuda_ms(lambda: rt.gather_rows(rows9.detach(), fb), reps=reps),
        "composite_train kernel": cuda_ms(lambda: rt.composite_train(*args), reps=reps),
        "reduction": cuda_ms(lambda: rt.dup_grads_to_rows(d_feat, fb, rows9.shape[1]),
                             reps=reps),
        "projection backward": cuda_ms(
            lambda: torch.autograd.grad(graph["rows"], leaves, d_rows9), reps=reps,
            setup=lambda: graph.update(rows=project_fn()[1])),
    }
    step = {k: v * groups for k, v in group.items()}
    step["sgd"] = cuda_ms(lambda: _apply_sgd(m, zero_grads, lrs), reps=reps)
    step["densify"] = cuda_ms(lambda: densify(m, var, avg, dp), reps=reps)
    step["whole step"] = cuda_ms(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs),
        warmup=1, reps=5)
    print(f"  per group of {TRAIN_GROUP} frames: " + "  ".join(
        f"{k} {v:.3f} ms" for k, v in group.items()) + f"  [{card}]")
    print(f"  per step of {frames} frames ({groups} groups): " + "  ".join(
        f"{k} {v:.3f} ms" for k, v in step.items()) + f"  [{card}]")
    print(f"  train steps/s {1e3 / step['whole step']:.3f}  [{card}]")

    plain_ms = cuda_ms(lambda: rt.composite_train_reference(*args), warmup=0, reps=2)
    b_ms, b_by = k3_bound(args, k3_stats)
    k3_ms = group["composite_train kernel"]
    print(f"  composite_train per launch ({TRAIN_GROUP} frames): kernel {k3_ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}, {k3_stats['pairs']} pairs visited, "
          f"{k3_stats['composited']} composited)  kernel at {b_ms / k3_ms:.3f} of the bound  "
          f"[{card}]")

    # the bench headline: render_train_grads_batch, 8 bench frames, uniform truths
    b_arrays = [torch.from_numpy(a).to(dev) for a in arrays]
    b_cams = CameraBatch.from_cameras(bench_cameras(TRAIN_GROUP), res, res, device=dev)
    b_truths = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (TRAIN_GROUP, res, res, 3)).astype(np.float32)).to(dev)
    b_tiles = rt.image_to_tiles(b_truths, tile).contiguous()
    b_active = torch.arange(cap, device=dev) < n
    headline = cuda_ms(lambda: rt.render_train_grads_batch(
        *b_arrays, b_active, *b_cams, res, res, b_tiles, torch.zeros((TRAIN_GROUP, 3), device=dev),
        1, tile=tile, max_dup=runtime.max_dup), reps=reps) / TRAIN_GROUP
    print(f"  fwd+bwd ms/frame (render_train_grads_batch, {n} splats, {res}^2, F = "
          f"{TRAIN_GROUP}, tile {tile}): {headline:.3f}  [{card}]")

    busy_ms, profiled_ms = device_busy_ms(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs))
    print(f"  device busy time of a step (torch.profiler): {busy_ms:.3f} ms, busy share "
          f"{busy_ms / step['whole step']:.3f} of the {step['whole step']:.3f} ms step "
          f"({busy_ms / profiled_ms:.3f} of the {profiled_ms:.3f} ms profiled step)  [{card}]")
    if busy_ms <= 0.0:
        raise SystemExit("phase 8 failed: the profiler recorded no device time")
    return {
        "name": "composite_train",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_train.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:583",
        "launches": launches,
        "max_abs_err": max(r_max, d_max),
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call composites splats
    }


def device_busy_ms(fn) -> tuple[float, float]:
    """(milliseconds in which the device ran a kernel or a copy, wall
    milliseconds) of one fn() under torch.profiler's CUDA activity, after
    one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:  # the union of the device's busy intervals
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy_us / 1e3, wall_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import gaussian_splatterer_tpu_torch as port
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script: {exc}",
              file=sys.stderr)
        return 2
    if Path(port.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported the port from {port.__file__}, not from {HERE}",
              file=sys.stderr)
        return 2
    from gaussian_splatterer_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1. environment")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0].strip()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print("nvcc:", run([cuda_build.find_nvcc(), "--version"]).splitlines()[-1])
    print(f"device: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {card}")

    phase("2. build")
    t0 = time.perf_counter()
    kernels = ("composite_fwd", "composite_train")
    cuda_build.build(kernels)
    print(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s (wall)")
    for name in kernels:
        info = cuda_build.build_info[name]
        print(f"{name}: {info['seconds']:.2f} s -> {info['path']}")
        print(info["ptxas"])

    fwd = serve_phases(dev, card)
    gate_err = train_gate(dev)
    train = train_main(dev, card)
    train["max_abs_err"] = max(train["max_abs_err"], gate_err)
    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: jax was imported")

    print(json.dumps({"kernels": [fwd, train]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
