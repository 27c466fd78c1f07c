"""Splat-count scaling of the headline bench: fwd+bwd ms/frame at 50k to
1M active splats (counterpart of the JAX package's scripts/bench_scale.py;
the reference's SPLATS_LIMIT envelope, src/Config.h:17).

    python -m gaussian_splatterer_tpu_torch.scripts.bench_scale [--sizes 200000,1000000]

Screen coverage is held roughly constant by shrinking the splats' scales
by sqrt(50k / N), as a densified model covers the object with more,
smaller splats; the duplicates then grow about linearly with N.  Per size:
a probe run that keeps every duplicate reads the true count, then the
timed run keeps 1.25 times it (a multiple of 256).  The port's frame group
is the trainer's 8 frames (the JAX script's max_frame_group is the TPU's
scalar-memory cap).  One JSON line per size, with the device's peak
memory of the timed run (``torch.cuda.max_memory_allocated``) and the
time of one densify of the scene.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from gaussian_splatterer_tpu_torch import resolve_device
from gaussian_splatterer_tpu_torch.config import Project
from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.scripts import bench
from gaussian_splatterer_tpu_torch.train.densify import DensifyParams, densify

REPS = 10


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_size(n_splats: int, frames: int = bench.FRAMES, device="cuda", res: int = bench.W,
             tile: int = bench.TILE, reps: int = REPS) -> dict:
    dev = resolve_device(device)
    capacity = max(65_536, -(-n_splats // 4096) * 4096)
    shrink = math.sqrt(50_000 / n_splats)  # constant coverage: radius ~ sqrt(50k / N)
    inputs = bench.headline_inputs(dev, n_splats, capacity, res, frames, tile, shrink=shrink)
    num_dup = bench.probe_num_dup(inputs, res, tile)
    max_dup = bench.sized_max_dup(num_dup)
    print(f"n={n_splats}: num_dup={num_dup} -> max_dup={max_dup} frame_group={frames}",
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ms_per_frame, _ = bench.time_fwdbwd(inputs, res, tile, max_dup, reps)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None

    params = inputs[0]
    _, grads, var, *_ = bench.fwdbwd(inputs, res, tile, max_dup)
    model = SplatModel(*params, count=n_splats, sh_degree=1)
    dp = DensifyParams.from_project(Project())
    densify(model, var, grads[0], dp)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        densify(model, var, grads[0], dp)
    _sync(dev)
    densify_ms = (time.perf_counter() - t0) * 1e3 / 3
    return {"n_splats": n_splats, "capacity": capacity, "ms_per_frame": round(ms_per_frame, 4),
            "num_dup": num_dup, "max_dup": max_dup, "frame_group": frames,
            "peak_mib": None if peak is None else round(peak, 1),
            "densify_ms": round(densify_ms, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="50000,200000,500000,1000000")
    ap.add_argument("--frames", type=int, default=bench.FRAMES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=bench.W)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    for s in args.sizes.split(","):
        row = run_size(int(s), args.frames, args.device, args.res, reps=args.reps)
        print(json.dumps(row), flush=True)
    print(json.dumps({"launches": bench.launches()}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
