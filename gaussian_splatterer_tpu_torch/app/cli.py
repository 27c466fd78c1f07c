"""Command-line interface of the PyTorch/CUDA port (counterpart of
gaussian_splatterer_tpu.app.cli):

    gsplat-torch new PROJECT_DIR [--obj model.obj --texture tex.png] [--init-field grid|mono|model]
    gsplat-torch train PROJECT_DIR --steps N [--renderer tiled|oracle] [--log-every K]
        [--devices N] [--checkpoint-every N [--checkpoint-dir D]] [--resume]
        [--snapshot-every N [--snapshot-dir D]] [--watch [--watch-every N]]
    gsplat-torch render PROJECT_DIR OUT [--mode splats|rtx|viewer] [--size WxH] [--samples S]
    gsplat-torch export PROJECT_DIR OUT.ply|OUT.html|OUT.gobj
    gsplat-torch info PROJECT_DIR
    gsplat-torch doctor

Every subcommand takes ``--device`` (default cuda; cpu runs the kernels'
plain PyTorch versions).  Flags keep the JAX CLI's names and meaning,
including ``--runtime KEY=VALUE`` and the rule that sizes ``max_dup`` from
the scene.  ``train`` writes npz checkpoints (``--checkpoint-every``, into
PROJECT/checkpoints by default) and resumes from the latest one
(``--resume``), writes a PNG snapshot series (``--snapshot-every``) and a
live watch page (``--watch``: PROJECT/watch/index.html).  ``export``
writes the model as standard 3DGS ``.ply``, as a self-contained HTML
viewer (``.html``, also ``render --mode viewer``) or as the reference's
``.gobj`` (any other name).  ``doctor`` is the backend's health check: the
numerics gate of the tiled renderer against the oracle and a timed micro
train step, as one JSON object; it exits 1 when the gate fails.

``train --devices N`` trains on N devices (``train_mesh`` "dp", the
default, or "fsdp" through ``--runtime train_mesh=fsdp``) and persists
``train_devices`` with the project, and ``capture_data_parallel`` when N >
1; ``--devices 1`` goes back to one device.  N > 1 starts N worker
processes (spawned, a process group on 127.0.0.1 at a free port): rank r on
``cuda:r`` over nccl, or on the CPU over gloo with ``--device cpu``.  The
kernels are built once, before the workers start.  On ``cuda`` N above the
card count is refused.  Rank 0 alone prints and writes; a failed worker
fails the command.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from gaussian_splatterer_tpu_torch.config import RuntimeConfig


def _apply_runtime_overrides(runtime: RuntimeConfig, pairs) -> bool:
    """``--runtime key=value`` pairs; returns True when one changed the
    resolution or capacity."""
    fields = {f.name for f in dataclasses.fields(RuntimeConfig)}
    resized = False
    for kv in pairs or []:
        key, sep, val = kv.partition("=")
        if key not in fields or not sep:
            raise SystemExit(
                f"--runtime {kv!r}: unknown key (valid: {', '.join(sorted(fields))})"
            )
        cur = getattr(runtime, key)
        if val.lower() == "none":
            new = None
        elif isinstance(cur, bool):
            new = val.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, (int, float)):
            new = type(cur)(val)
        else:
            # default-None fields: numeric if it parses
            try:
                new = int(val)
            except ValueError:
                try:
                    new = float(val)
                except ValueError:
                    new = val
        setattr(runtime, key, new)
        resized = resized or key in (
            "render_resolution_x", "render_resolution_y", "splats_capacity"
        )
    return resized


def _make_session(args, require: bool = False):
    from gaussian_splatterer_tpu_torch.app.session import RUNTIME_FILE, SETTINGS_FILE, Session

    directory = args.project
    # runtime knobs persist with the project in runtime.json; explicit
    # flags override the persisted values
    rt_path = os.path.join(directory, RUNTIME_FILE)
    persisted = os.path.exists(rt_path)
    runtime = RuntimeConfig.load(rt_path) if persisted else RuntimeConfig()
    resized = False
    if getattr(args, "resolution", None):
        runtime.render_resolution_x = runtime.render_resolution_y = args.resolution
        resized = True
    if getattr(args, "capacity", None):
        runtime.splats_capacity = args.capacity
        resized = True
    if getattr(args, "devices", None) is not None:
        # persists with the project like every runtime knob
        runtime.train_devices = args.devices
        if args.devices > 1:
            runtime.capture_data_parallel = True
    resized = _apply_runtime_overrides(runtime, getattr(args, "runtime", None)) or resized
    if getattr(args, "max_dup", None):
        runtime.max_dup = args.max_dup
    elif not persisted or resized:
        # scale the binning buffer with the scene: ~128 duplicate slots per
        # tile plus one per splat of capacity, rounded up to a power of two
        tiles = (runtime.render_resolution_x // runtime.tile_px) * (
            runtime.render_resolution_y // runtime.tile_px
        )
        want = max(2**12, tiles * 128 + runtime.splats_capacity)
        runtime.max_dup = 1 << (want - 1).bit_length()
    session = Session(runtime=runtime, device=getattr(args, "device", "cuda"),
                      renderer=getattr(args, "renderer", "tiled"))
    settings = os.path.join(directory, SETTINGS_FILE)
    if os.path.exists(settings):
        session.load_project(directory, runtime=runtime)
    elif require:
        raise SystemExit(f"no project at {directory} (missing {settings})")
    return session


def cmd_new(args):
    session = _make_session(args)
    if args.obj:
        session.load_model_obj(args.obj)
    if args.texture:
        session.load_texture(args.texture)
    if args.init_field:
        session.init_field(args.init_field)
    session.save_project(args.project)
    print(f"created project at {args.project}")


# the kernels of the training path, built before the workers start
TRAIN_KERNELS = ("composite_fwd", "composite_train", "composite_bwd", "cumsum_frames",
                 "mt_intersect", "mt_culled")


def train_devices(args) -> int:
    """The ranks ``train`` runs on: ``--devices``, else the project's
    persisted train_devices, resolved against 2 x its cameras; on cuda, N
    above the card count exits nonzero."""
    import torch

    from gaussian_splatterer_tpu_torch.app.session import RUNTIME_FILE, SETTINGS_FILE
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.train.trainer import _resolve_devices

    n = args.devices
    rt_path = os.path.join(args.project, RUNTIME_FILE)
    if n is None and os.path.exists(rt_path):
        n = RuntimeConfig.load(rt_path).train_devices
    settings = os.path.join(args.project, SETTINGS_FILE)
    if not n or n <= 1 or not os.path.exists(settings):
        return 1
    kind = torch.device(args.device).type
    count = torch.cuda.device_count() if kind == "cuda" else None
    try:
        return _resolve_devices(n, 2 * Project.load(settings).num_cameras, kind, count)
    except RuntimeError as exc:
        raise SystemExit(f"train --devices {n} on {kind}: {exc}") from None


def cmd_train(args):
    n = train_devices(args)
    if n > 1:
        return spawn_train(args, n)
    run_train(args)
    return 0


def spawn_train(args, n: int) -> int:
    """``train`` on ``n`` worker processes, one a device."""
    import torch

    from gaussian_splatterer_tpu_torch import parallel

    kind = torch.device(args.device).type
    if kind == "cuda":
        from gaussian_splatterer_tpu_torch.ops import cuda_build

        cuda_build.build(TRAIN_KERNELS)  # once here, not once a rank
    parallel.spawn_ranks(_train_worker, n, args, n, kind)
    return 0


def _train_worker(rank: int, init_method: str, args, n: int, kind: str) -> None:
    """Rank ``rank`` of ``spawn_train``: rank r on cuda:r over nccl, or on
    the CPU over gloo."""
    import torch
    import torch.distributed as dist

    from gaussian_splatterer_tpu_torch import parallel

    if kind == "cuda":
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    parallel.init_distributed(rank=rank, world_size=n, init_method=init_method,
                              backend=parallel.backend_for(kind))
    try:
        run_train(args)
    finally:
        dist.destroy_process_group()


def run_train(args):
    """The body of ``train`` on one process, or on each rank of a process
    group, which rank 0 alone prints from.  Returns the session."""
    from gaussian_splatterer_tpu_torch import parallel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled
    from gaussian_splatterer_tpu_torch.rt import tracer

    say = print if parallel.rank() == 0 else (lambda *a, **k: None)
    session = _make_session(args, require=True)
    if session.rtx.mesh is None:
        raise SystemExit("project has no OBJ model; run `new --obj` first")
    ckpt_dir = args.checkpoint_dir or os.path.join(args.project, "checkpoints")
    if args.resume:
        latest = os.path.join(ckpt_dir, "latest.npz")
        if os.path.exists(latest):
            session.resume_from_checkpoint(ckpt_dir)
            say(f"resumed from {latest} at iter {session.project.iterations}")
        else:
            say(f"--resume: no checkpoint at {latest}; starting fresh")
    t0 = time.perf_counter()
    last = {"it": session.project.iterations, "t": t0}
    # kernel launches of each step, the capture before it included: the
    # fused step launches composite_train, the non-fused one (a resolution
    # that is not a multiple of the tile) composite_fwd and composite_bwd
    counters = {"mt_intersect": lambda: tracer.mt_intersect_launches,
                "mt_culled": lambda: tracer.mt_culled_launches,
                "composite_train": lambda: raster_tiled.composite_train_launches,
                "composite_fwd": lambda: raster_tiled.composite_fwd_launches,
                "composite_bwd": lambda: raster_tiled.composite_bwd_launches}
    launches = {name: [] for name in counters}
    seen = {name: count() for name, count in counters.items()}

    def on_step(it, metrics):
        for name, count in counters.items():
            now = count()
            launches[name].append(now - seen[name])
            seen[name] = now
        if it % args.log_every == 0:
            now = time.perf_counter()
            rate = (it - last["it"]) / max(now - last["t"], 1e-9)
            last["it"], last["t"] = it, now
            # cadence countdowns, as the reference's train panel shows them
            # (src/ui/tools/UiPanelToolsTrain.cpp:98-107)
            p = session.project
            cadence = "  ".join(f"{name} in {iv - (it % iv)}" for name, iv in (
                ("capture", p.intervalCapture), ("densify", p.intervalDensify)) if iv)
            say(f"iter {it}  loss {float(metrics.loss):.6f}  splats "
                f"{int(session.trainer.model.count)}  {rate:.1f} steps/s"
                + (f"  [{cadence}]" if cadence else ""), flush=True)

    watch_dir = os.path.join(args.project, "watch")
    if args.watch:
        say(f"watch: open file://{os.path.abspath(watch_dir)}/index.html "
            "in a browser (auto-refreshes)", flush=True)
    stats = session.auto_train(
        args.steps, on_step=on_step,
        checkpoint_dir=ckpt_dir if args.checkpoint_every else None,
        checkpoint_every=args.checkpoint_every,
        snapshot_dir=args.snapshot_dir or os.path.join(args.project, "snapshots"),
        snapshot_every=args.snapshot_every,
        watch_dir=watch_dir if args.watch else None,
        watch_every=args.watch_every if args.watch else 0,
    )
    session.save_project(args.project)
    say(f"trained {args.steps} steps in {time.perf_counter() - t0:.1f}s; saved")
    say(json.dumps({**stats, "iterations": session.project.iterations,
                    "splats": int(session.trainer.model.count), "devices": session.devices or 1,
                    "launches": launches}), flush=True)
    return session


def cmd_render(args):
    session = _make_session(args, require=True)
    w, h = (int(x) for x in args.size.split("x")) if args.size else (None, None)
    if args.mode == "rtx":
        session.export_rtx_png(args.output, w, h, samples=args.samples)
    elif args.mode == "viewer":
        session.export_viewer_html(args.output)
    else:
        if args.samples:
            print(
                "warning: --samples only applies to --mode rtx "
                "(the splat rasterizer is deterministic); ignoring",
                file=sys.stderr,
            )
        session.export_splats_png(args.output, w, h)
    print(f"wrote {args.output}")


def cmd_export(args):
    session = _make_session(args, require=True)
    out = args.output
    if out.endswith(".ply"):
        session.save_splats_ply(out)
    elif out.endswith(".html"):
        session.export_viewer_html(out)
    else:
        session.save_splats(out)  # .gobj text, which the reference reads
    print(f"wrote {out}")


DOCTOR_RES, DOCTOR_TILE, DOCTOR_CAPACITY, DOCTOR_MAX_DUP = 128, 16, 8192, 2**13
DOCTOR_ATOL = 2e-2  # tiled vs oracle: the forward gate of the bench


def doctor_report(device="cuda", reps: int = 20) -> dict:
    """The health check of a backend (the JAX CLI's ``doctor``): the
    kernels it uses built first (a failed build raises), the 17^3 grid
    field rendered at 128^2 through ``render_tiled`` (K1 on the card) and
    through ``render_oracle`` on the CPU, gated on a finite image within
    DOCTOR_ATOL of the oracle, then ``reps`` fused train steps (K3 on the
    card) timed after one warm-up, the device synchronised around the
    timed window."""
    import numpy as np
    import torch

    from gaussian_splatterer_tpu_torch import resolve_device
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import init_field_grid
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.ops.raster_tiled import image_to_tiles, render_tiled
    from gaussian_splatterer_tpu_torch.train.trainer import (
        CameraBatch,
        LearningRates,
        make_train_step,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        from gaussian_splatterer_tpu_torch.ops import cuda_build

        cuda_build.build(("composite_fwd", "composite_train"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res, tile, cap = DOCTOR_RES, DOCTOR_TILE, DOCTOR_CAPACITY
    host = init_field_grid(cap, 1, 4)  # the reference's 17^3 boot grid
    cam = Camera(np.array([0.3, -0.2, -8.0], np.float32), np.zeros(3, np.float32), 60.0)
    tx, ty = cam.tan_fov(res, res, train=True)

    def render_args(model):
        bg = torch.tensor([0.2, 0.3, 0.4], dtype=torch.float32, device=model.device)
        return (model.means, model.shs, model.scales, model.opacities, model.rotations,
                model.active_mask(), cam.get_view(), cam.get_proj_view(1.0), cam.location,
                tx, ty, res, res, bg, 1, 1.0)

    model = host.to_device(dev)
    with torch.no_grad():
        img_t = render_tiled(*render_args(model), tile=tile, max_dup=DOCTOR_MAX_DUP)
        img_o = render_oracle(*render_args(host.to_device("cpu")), row_chunk=16,
                              tile_cull=tile)
    img_t = img_t.cpu()
    err = float(torch.max(torch.abs(img_t - img_o)))
    gate_ok = bool(torch.isfinite(img_t).all()) and err < DOCTOR_ATOL

    cams = CameraBatch.from_cameras([cam], res, res, device=dev)
    truths = image_to_tiles(torch.zeros((2, res, res, 3), dtype=torch.float32, device=dev),
                            tile).contiguous()
    step = make_train_step(res, res, 1, renderer="tiled", fused=True,
                           fused_opts=dict(tile=tile, max_dup=DOCTOR_MAX_DUP))
    lrs = LearningRates.from_project(Project())
    step(model, truths, cams, lrs)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(model, truths, cams, lrs)
    sync()
    sps = reps / (time.perf_counter() - t0)
    return {
        "platform": dev.type,
        "numerics_gate": "ok" if gate_ok else f"FAILED (max err {err:.2e})",
        "tiled_vs_oracle_max_err": round(err, 6),
        "micro_step_per_s": round(sps, 2),
        "config": f"{res}^2, {cap} splats, tile {tile}",
    }


def cmd_doctor(args) -> int:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled

    report = doctor_report(args.device)
    print(json.dumps(report, indent=2))
    # the kernels' launches, on standard error as the measuring scripts give them
    print(json.dumps({"launches": {"composite_fwd": raster_tiled.composite_fwd_launches,
                                   "composite_train": raster_tiled.composite_train_launches}}),
          file=sys.stderr, flush=True)
    return 0 if report["numerics_gate"] == "ok" else 1


def cmd_info(args):
    session = _make_session(args, require=True)
    p = session.project
    print(
        json.dumps(
            {
                "iterations": p.iterations,
                "splats": int(session.model.count),
                "capacity": session.model.capacity,
                "cameras": p.num_cameras,
                "model_obj": p.pathModel,
                "texture": p.pathTextureDiffuse,
                "lr": {
                    "location": p.lrLocation,
                    "sh": p.lrSh,
                    "scale": p.lrScale,
                    "opacity": p.lrOpacity,
                    "rotation": p.lrRotation,
                },
            },
            indent=2,
        )
    )


def _add_runtime_flags(p):
    p.add_argument("--resolution", type=int)
    p.add_argument("--capacity", type=int)
    p.add_argument("--max-dup", type=int, dest="max_dup")
    p.add_argument("--runtime", action="append", metavar="KEY=VALUE",
                   help="set any RuntimeConfig field (repeatable), e.g. "
                        "--runtime tile_px=16")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gsplat-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_new = sub.add_parser("new", help="create a project directory")
    p_new.add_argument("project")
    p_new.add_argument("--obj", help="OBJ mesh to trace as truth")
    p_new.add_argument("--texture", help="diffuse texture (PNG, JPEG, TGA, BMP, TIFF, DDS, "
                       "GIF, PNM or WebP)")
    p_new.add_argument("--init-field", choices=["grid", "mono", "model"], default="grid")
    _add_runtime_flags(p_new)
    p_new.set_defaults(fn=cmd_new)

    p_tr = sub.add_parser("train", help="run auto-training")
    p_tr.add_argument("project")
    p_tr.add_argument("--steps", type=int, default=200)
    p_tr.add_argument("--renderer", choices=["tiled", "oracle"], default="tiled")
    p_tr.add_argument("--devices", type=int,
                      help="train on N devices, one worker process each (camera-DP; "
                           "--runtime train_mesh=fsdp for splat-sharded parameters). "
                           "Persists with the project; --devices 1 reverts")
    p_tr.add_argument("--log-every", type=int, default=10)
    p_tr.add_argument("--checkpoint-every", type=int, default=0,
                      help="crash-recovery .npz checkpoint every N iters")
    p_tr.add_argument("--checkpoint-dir",
                      help="checkpoint directory (default PROJECT/checkpoints)")
    p_tr.add_argument("--resume", action="store_true",
                      help="resume from the latest checkpoint if present")
    p_tr.add_argument("--snapshot-every", type=int, default=0,
                      help="export a splat-render PNG every N iters (the "
                           "headless live-preview equivalent)")
    p_tr.add_argument("--snapshot-dir",
                      help="snapshot directory (default PROJECT/snapshots)")
    p_tr.add_argument("--watch", action="store_true",
                      help="live-watch mode: rewrite PROJECT/watch/index.html + "
                           "latest.png every --watch-every iters; open it in a "
                           "browser to track the run")
    p_tr.add_argument("--watch-every", type=int, default=25)
    _add_runtime_flags(p_tr)
    p_tr.set_defaults(fn=cmd_train)

    p_re = sub.add_parser("render", help="export a PNG, or the HTML viewer")
    p_re.add_argument("project")
    p_re.add_argument("output")
    p_re.add_argument("--mode", choices=["splats", "rtx", "viewer"], default="splats",
                      help="splats; rtx: the path-traced truth view; viewer: a "
                           "self-contained interactive HTML viewer")
    p_re.add_argument("--size", help="WxH, e.g. 1024x1024")
    p_re.add_argument("--samples", type=int)
    p_re.add_argument("--renderer", choices=["tiled", "oracle"], default="tiled")
    _add_runtime_flags(p_re)
    p_re.set_defaults(fn=cmd_render)

    p_ex = sub.add_parser("export", help="export the splats (.ply, .html or .gobj)")
    p_ex.add_argument("project")
    p_ex.add_argument("output", help="OUT.ply (standard 3DGS), OUT.html (viewer), "
                                     "else .gobj text")
    _add_runtime_flags(p_ex)
    p_ex.set_defaults(fn=cmd_export)

    p_in = sub.add_parser("info", help="print project summary")
    p_in.add_argument("project")
    p_in.add_argument("--device", default="cuda")
    p_in.set_defaults(fn=cmd_info)

    p_dr = sub.add_parser("doctor", help="backend health check: numerics gate and a "
                                         "timed micro train step")
    p_dr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p_dr.set_defaults(fn=cmd_doctor)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
