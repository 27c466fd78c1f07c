"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernel from
gaussian_splatterer_tpu_torch/csrc/, holds it against its plain PyTorch
version and the exact oracle, drives the serving path (``render --mode
splats`` through the CLI) at full size, times the stages with CUDA events,
and exits nonzero at the first phase that fails.  It imports nothing of
JAX.

Phases:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: nvcc -> build/torch_kernels/, with the build seconds;
  3. kernel against plain and oracle on the numerics-gate scene of the JAX
     package's bench (150 splats, 128^2, seed 7) at tile 16 and 32;
  4. main path: the CLI renders the 50k-splat bench scene at 1024^2 and
     2048^2 and a 262,144-splat scene at 2048^2 from a project directory;
  5. times: median of 20 runs after 3 warm-ups per scene and size.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernel summary.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

GATE_ATOL_PLAIN = 1e-4  # kernel vs plain version on the gate scene
GATE_ATOL_ORACLE = 2e-2  # kernel vs exact oracle: the forward gate of the JAX package's bench
MAIN_MAX_ATOL = 1e-2  # kernel vs plain at full size: isolated threshold flips
MAIN_MEAN_ATOL = 1e-5
BG_GATE = (0.2, 0.3, 0.4)
WARMUP, REPS = 3, 20
SCENES = (  # (label, splats, capacity, render sizes)
    ("bench50k", 50_000, 65_536, (1024, 2048)),
    ("large262k", 262_144, 262_144, (2048,)),
)


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


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> float:
    """Median milliseconds of fn() by CUDA events, one event pair per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def render_args(model, cam, w, h, train_fov, bg, dev):
    tx, ty = cam.tan_fov(w, h, train=train_fov)
    return (
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), cam.get_view(), cam.get_proj_view(w / h), cam.location,
        tx, ty, w, h, torch.tensor(bg, dtype=torch.float32, device=dev), model.sh_degree, 1.0,
    )


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
    from gaussian_splatterer_tpu_torch.app import cli
    from gaussian_splatterer_tpu_torch.app.session import Session
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.io.image import load_png
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import cuda_build, raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: jax was imported")
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
    cuda_build.load_library("composite_fwd")
    info = cuda_build.build_info["composite_fwd"]
    print(f"composite_fwd built in {info['seconds']:.2f} s -> {info['path']}")
    print(info["ptxas"])

    phase("3. kernel vs plain vs oracle (gate scene: 150 splats, 128^2, seed 7)")
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

    phase("4. main path: gsplat-torch render --mode splats")
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
    print(f"composite_fwd launches in the main path: {launches}")
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
                    - rt.composite_fwd_reference(*cell.composite_args)).abs()
        d_max, d_mean = float(diff.max()), float(diff.mean())
        print(f"  {label} {size}^2 kernel vs plain on the same binning: max {d_max:.3e} "
              f"(<= {MAIN_MAX_ATOL})  mean {d_mean:.3e} (<= {MAIN_MEAN_ATOL})")
        if d_max > MAIN_MAX_ATOL or d_mean > MAIN_MEAN_ATOL:
            raise SystemExit("phase 4 failed: kernel vs plain at full size")
        main_max_err = max(main_max_err, d_max)

    phase(f"5. times (CUDA events, median of {REPS} after {WARMUP} warm-ups; {card})")
    times = {}
    for (label, size), cell in cells.items():
        t = cell.times()
        times[(label, size)] = t
        print(f"  {label} {size}^2 tile {cell.tile}: " + "  ".join(
            f"{k} {v:.3f} ms" for k, v in t.items()) + f"  [{card}]", flush=True)

    headline = times[("bench50k", 1024)]
    summary = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:340",
        "launches": launches,
        "max_abs_err": max(max_err, main_max_err),
        "ms": headline["composite_kernel"],
        "plain_ms": headline["composite_plain"],
    }]}
    print("(kernel ms / plain_ms: the 50k-splat bench scene at 1024^2, tile 32)")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
