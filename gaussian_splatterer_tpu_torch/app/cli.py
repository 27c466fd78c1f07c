"""Command-line interface of the PyTorch/CUDA port (counterpart of
gaussian_splatterer_tpu.app.cli; the ``render`` and ``info`` subcommands):

    gsplat-torch render PROJECT_DIR OUT.png [--mode splats] [--size WxH] [--device cuda]
    gsplat-torch info PROJECT_DIR

Flags keep the JAX CLI's names and meaning, including ``--runtime
KEY=VALUE`` and the rule that sizes ``max_dup`` from the scene.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

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


def cmd_render(args):
    session = _make_session(args, require=True)
    w, h = (int(x) for x in args.size.split("x")) if args.size else (None, None)
    if args.samples:
        print(
            "warning: --samples only applies to --mode rtx "
            "(the splat rasterizer is deterministic); ignoring",
            file=sys.stderr,
        )
    session.export_splats_png(args.output, w, h)
    print(f"wrote {args.output}")


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
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch compositor)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gsplat-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_re = sub.add_parser("render", help="export a PNG")
    p_re.add_argument("project")
    p_re.add_argument("output")
    p_re.add_argument("--mode", choices=["splats"], default="splats",
                      help="splats (the ray-traced and viewer modes are not ported yet)")
    p_re.add_argument("--size", help="WxH, e.g. 1024x1024")
    p_re.add_argument("--samples", type=int)
    p_re.add_argument("--renderer", choices=["tiled", "oracle"], default="tiled")
    _add_runtime_flags(p_re)
    p_re.set_defaults(fn=cmd_render)

    p_in = sub.add_parser("info", help="print project summary")
    p_in.add_argument("project")
    p_in.add_argument("--device", default="cuda")
    p_in.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
