"""Quality run: train a textured mesh to N splats, report held-out PSNR,
SSIM and steps/s (counterpart of the JAX package's scripts/quality_run.py,
with the same flags and the same result.json).

    python -m gaussian_splatterer_tpu_torch.scripts.quality_run [--steps 600]
        [--res 256] [--scene cross|mushroom] [--obj path.obj] [--out run_dir]
        [--checkpoint-every N] [--resume] [--device cuda]

Without --obj a built-in scene is traced: the two-plane cross with a
checker texture, or the procedural mushroom (scripts/scenes.py).  Training
truths come from the path tracer on the rig; after training, the rig is
rotated at random and its first 4 cameras are captured afresh against a
black background as held-out views.  The run writes ``final.npz`` (model
and project, io/checkpoint.py), ``truth.png`` and ``pred.png`` (the first
held-out view) and ``result.json`` into --out.

``--resume`` continues from ``--out/ckpt/latest.npz`` (written every
--checkpoint-every iterations) and trains the steps that remain up to
--steps.  The checkpoint restores the saved project wholesale; the
schedule flags given (--densify-variance, --interval-densify,
--interval-capture) are applied again, and the LR scales are not (they are
already in the saved rates).  ``--fast-exp``, ``--mm-power`` and
``--work-cap`` set the RuntimeConfig fields of the JAX package's TPU
kernel, which the port accepts and ignores.  A resumed run also prints
the SHA-256 of the model it loaded (io/checkpoint.digest), and the
kernels' launch counts go to standard error as one JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gaussian_splatterer_tpu_torch.app.session import Session
from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
from gaussian_splatterer_tpu_torch.io.checkpoint import digest, save_checkpoint
from gaussian_splatterer_tpu_torch.io.image import save_png
from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
from gaussian_splatterer_tpu_torch.models.camera import Camera
from gaussian_splatterer_tpu_torch.scripts import bench, scenes
from gaussian_splatterer_tpu_torch.train.trainer import randomize_rig_rotations
from gaussian_splatterer_tpu_torch.utils.metrics import psnr, ssim


def load_scene(rtx, scene: str, mesh_res: int, spot_alpha: float = 1.0) -> None:
    """Put a built-in scene into the tracer ``rtx``."""
    if scene == "mushroom":
        rtx.load_model(scenes.mushroom_mesh(mesh_res, max(mesh_res // 2, 6)))
        rtx.load_texture_diffuse(scenes.mushroom_texture(spot_alpha=spot_alpha))
    else:
        rtx.load_model(TriangleMesh(scenes.CROSS_OBJ_VERTS, scenes.CROSS_TRIS, scenes.CROSS_UV))
        rtx.load_texture_diffuse(scenes.checker_texture())


def held_out_scores(rtx, trainer, project: Project, views: int, samples: int, res: int,
                    out_dir: str | None = None) -> tuple[list[float], list[float]]:
    """(PSNR, SSIM) of each of the first ``views`` cameras of the (already
    rotated) rig: the traced truth at ``samples`` against the splat render,
    clipped to [0, 1].  With ``out_dir``, the first view's truth.png and
    pred.png are written there."""
    psnrs, ssims = [], []
    for i, cam in enumerate(Camera.get_cameras(project)[:views]):
        truth = rtx.render(cam, (0, 0, 0), samples, res, res)
        pred = torch.clamp(trainer.render(cam, res, res), 0, 1)
        psnrs.append(float(psnr(truth, pred)))
        ssims.append(float(ssim(truth, pred)))
        if i == 0 and out_dir is not None:
            save_png(truth.cpu().numpy(), os.path.join(out_dir, "truth.png"))
            save_png(pred.cpu().numpy(), os.path.join(out_dir, "pred.png"))
    return psnrs, ssims


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=65_536)
    ap.add_argument("--max-dup", type=int, default=2**17)
    ap.add_argument("--obj")
    ap.add_argument("--texture")
    ap.add_argument("--scene", choices=["cross", "mushroom"], default="cross",
                    help="built-in scene when no --obj is given")
    ap.add_argument("--mesh-res", type=int, default=32,
                    help="mushroom mesh resolution (n_theta; tris ~= 2*n*n/2)")
    ap.add_argument("--out", default="quality_run_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--densify-variance", type=float,
                    help="override paramDensifyVariance (growth trigger)")
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="scale all five per-feature learning rates")
    ap.add_argument("--lr-scale-opacity", type=float, default=None,
                    help="override --lr-scale for the opacity rate only")
    ap.add_argument("--lr-location-decay", type=float, default=1.0,
                    help="exponential location-LR decay per iteration (1.0 = flat)")
    ap.add_argument("--lr-res-ref", type=int, default=0,
                    help="resolution the LR/densify recipe was tuned at: scales LRs by "
                         "(ref/res)^2 and the densify trigger by (res/ref)^2 (0 = off)")
    ap.add_argument("--spot-alpha", type=float, default=1.0,
                    help="alpha of the mushroom cap spots (<1: stochastic transparency)")
    ap.add_argument("--fast-exp", action="store_true",
                    help="RuntimeConfig.train_fast_exp (a TPU kernel option; ignored here)")
    ap.add_argument("--mm-power", action="store_true",
                    help="RuntimeConfig.train_mm_power (a TPU kernel option; ignored here)")
    ap.add_argument("--mip-aa", action="store_true",
                    help="train and serve with mip-splatting anti-aliasing")
    ap.add_argument("--densify-variance-decay", type=float, default=1.0,
                    help="exponential decay of the densify trigger per iteration (1.0 = flat)")
    ap.add_argument("--sh-degree", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--interval-densify", type=int)
    ap.add_argument("--interval-capture", type=int)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write <out>/ckpt/latest.npz every N iterations")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out>/ckpt/latest.npz; trains the remaining steps "
                         "up to --steps")
    ap.add_argument("--roulette-from", type=int, default=0,
                    help="russian-roulette start bounce for captures (0 = off)")
    ap.add_argument("--eval-samples", type=int, default=0,
                    help="RT samples for the held-out truths (0 = same as --samples)")
    ap.add_argument("--work-cap", type=int, default=None,
                    help="RuntimeConfig.train_work_cap (the TPU work list; ignored here)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    proj = Project.app_default()
    proj.sphere1.count = args.cams
    proj.rtSamples = args.samples
    if args.densify_variance is not None:
        proj.paramDensifyVariance = args.densify_variance
    if args.interval_densify is not None:
        proj.intervalDensify = args.interval_densify
    if args.interval_capture is not None:
        proj.intervalCapture = args.interval_capture
    proj.lrLocation *= args.lr_scale
    proj.lrSh *= args.lr_scale
    proj.lrScale *= args.lr_scale
    proj.lrOpacity *= args.lr_scale if args.lr_scale_opacity is None else args.lr_scale_opacity
    proj.lrRotation *= args.lr_scale
    runtime = RuntimeConfig(
        render_resolution_x=args.res, render_resolution_y=args.res,
        splats_capacity=args.capacity, max_dup=args.max_dup,
        sh_degree=args.sh_degree, sh_coeffs=(args.sh_degree + 1) ** 2,
        lr_location_decay=args.lr_location_decay,
        lr_resolution_ref=args.lr_res_ref,
        densify_variance_decay=args.densify_variance_decay,
        mip_antialias=args.mip_aa,
        train_fast_exp=args.fast_exp,
        train_mm_power=args.mm_power,
        train_work_cap=args.work_cap,
        auto_shrink_buffers=args.work_cap is None,
        rt_roulette_from=args.roulette_from,
    )
    s = Session(project=proj, runtime=runtime, device=args.device, renderer="tiled")
    if args.obj:
        s.load_model_obj(args.obj)
        if args.texture:
            s.load_texture(args.texture)
    else:
        load_scene(s.rtx, args.scene, args.mesh_res, args.spot_alpha)
    s.init_field("model")

    steps_to_run = args.steps
    ckpt_dir = os.path.join(args.out, "ckpt")
    if args.resume:
        s.resume_from_checkpoint(ckpt_dir)
        # the schedule flags given apply again; the LR scales are already
        # in the saved rates and would compound
        if args.densify_variance is not None:
            s.project.paramDensifyVariance = args.densify_variance
        if args.interval_densify is not None:
            s.project.intervalDensify = args.interval_densify
        if args.interval_capture is not None:
            s.project.intervalCapture = args.interval_capture
        steps_to_run = max(args.steps - s.project.iterations, 0)
        print(f"resumed at iteration {s.project.iterations}; {steps_to_run} steps remain "
              f"(densify_variance={s.project.paramDensifyVariance})", flush=True)
        print(f"resumed model: {s.model.count} splats, sha256 {digest(s.model)}", flush=True)

    t0 = time.time()
    s.capture()
    print(f"capture: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    it0 = s.project.iterations

    def on_step(it, metrics):
        if it % 25 == 0:
            rate = (it - it0) / max(time.time() - t0, 1e-9)
            print(json.dumps(dict(it=it, loss=float(metrics.loss), splats=int(s.model.count),
                                  steps_per_s=rate)), flush=True)

    schedule_stats = s.auto_train(
        steps_to_run, on_step=on_step,
        checkpoint_dir=ckpt_dir if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
    )
    train_time = time.time() - t0
    steps_per_s = steps_to_run / max(train_time, 1e-9)

    randomize_rig_rotations(s.project)
    os.makedirs(args.out, exist_ok=True)
    save_checkpoint(os.path.join(args.out, "final.npz"), s.model, s.project)
    psnrs, ssims = held_out_scores(s.rtx, s.trainer, s.project, 4,
                                   args.eval_samples or args.samples, args.res, args.out)
    result = {
        "steps": args.steps,
        "steps_per_s": round(steps_per_s, 2),
        "final_splats": int(s.model.count),
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "psnr_per_view": [round(p, 2) for p in psnrs],
        "ssim_mean": round(float(np.mean(ssims)), 4),
        "train_time_s": round(train_time, 1),
        "schedule": schedule_stats,  # capture-vs-train wall split
    }
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result), flush=True)
    print(json.dumps({"launches": bench.launches()}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
