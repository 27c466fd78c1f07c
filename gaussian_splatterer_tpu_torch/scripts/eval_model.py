"""Re-evaluate a quality run's model without retraining (counterpart of
the JAX package's scripts/eval_model.py).

    python -m gaussian_splatterer_tpu_torch.scripts.eval_model RUN_DIR
        [--samples 128] [--views 4] [--res 1024] [--scene mushroom --mesh-res 32]

Loads RUN_DIR/final.npz (model and project, written by quality_run),
rotates the rig with a seeded generator (--seed, 123 by default: the held-
out rig of the JAX package's evaluations), captures fresh truths of its
first --views cameras at --samples against a black background, and prints
one JSON line: the splats, the samples, and the mean and per-view PSNR and
mean SSIM of the splat render against them.  Training truths are Monte
Carlo noisy; more samples here keep the metric from being capped by that
noise.  The kernels' launch counts go to standard error as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import numpy as np

from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.io.checkpoint import load_checkpoint
from gaussian_splatterer_tpu_torch.rt import RtxHost
from gaussian_splatterer_tpu_torch.scripts import bench
from gaussian_splatterer_tpu_torch.scripts.quality_run import held_out_scores, load_scene
from gaussian_splatterer_tpu_torch.train.trainer import Trainer, randomize_rig_rotations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", help="quality_run --out dir with final.npz")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--scene", choices=["cross", "mushroom"], default="mushroom")
    ap.add_argument("--mesh-res", type=int, default=32)
    ap.add_argument("--seed", type=int, default=123,
                    help="rig-rotation seed for the held-out views")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    model, project = load_checkpoint(os.path.join(args.run_dir, "final.npz"),
                                     device=args.device)
    if project is None:
        raise SystemExit("final.npz carries no project settings")
    runtime = RuntimeConfig(
        render_resolution_x=args.res, render_resolution_y=args.res,
        splats_capacity=model.capacity, sh_degree=model.sh_degree,
        sh_coeffs=model.sh_coeffs,
    )
    trainer = Trainer(project, runtime, model, renderer="tiled")
    rtx = RtxHost(device=args.device)
    load_scene(rtx, args.scene, args.mesh_res)
    randomize_rig_rotations(project, random.Random(args.seed))
    psnrs, ssims = held_out_scores(rtx, trainer, project, args.views, args.samples, args.res)
    print(json.dumps({
        "splats": int(model.count),
        "eval_samples": args.samples,
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "psnr_per_view": [round(p, 2) for p in psnrs],
        "ssim_mean": round(float(np.mean(ssims)), 4),
    }), flush=True)
    print(json.dumps({"launches": bench.launches()}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
