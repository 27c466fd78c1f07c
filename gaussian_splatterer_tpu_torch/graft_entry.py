"""The graft entry points of the PyTorch port: a single-card compile
and run check, and a multi-rank dry run of every sharded step (counterpart
of the repository's ``__graft_entry__.py``, which drives the JAX package).

    python -m gaussian_splatterer_tpu_torch.graft_entry [--devices N] [--device cuda|cpu]

runs ``entry(device)`` (one call of its function) and then
``dryrun_multichip(N, device)`` (4 ranks by default), on the card unless
``--device cpu`` is given; without a card the CUDA run fails.

``entry(device)`` returns ``(fn, args)``: the tiled forward render
(ops.raster_tiled.render_tiled, kernel K1 on the card) of a 20,000-splat
scene in 32,768 slots at 512^2, its duplicate budget sized from the
binning's true count so that no duplicate is dropped (JAX's static 2^17
would drop more than half of them).  ``dryrun_multichip(n, device)``
starts n ranks, one process a rank: on the CPU over gloo; on ``cuda``
over nccl with rank r on cuda:r where there are n cards, else over gloo
with the ranks sharing the cards (rank r on cuda:r mod cards; NCCL refuses
two ranks on one card, gloo stages CUDA tensors through host memory).  It
drives, on a 48-splat scene at 64^2, tile 16, as the JAX dry run does:
the camera-DP step; for an even n of 4 or more the FSDP step and the band
(tp) step; the 3-axis step, the routed 3-axis step and densify inside the
sharded loop (densify_sharded, then one more 3-axis step); and the
product loops, Trainer(train_devices=n) with train_mesh "dp" and "fsdp"
under auto_train, against a single-process Trainer.  The JAX dry run
runs the 3-axis branches when n >= 8 (a multiple of 8) on a (2, 2, n / 4)
mesh; this one does too, and also at n = 4 on the (1, 2, 2) mesh, so that
four ranks reach every branch.  Rank 0 prints one line a branch, worded as
JAX's; the function returns rank 0's numbers, the kernel launches of its
whole run among them.  Each branch is held to the JAX dry run's own bars;
tests/test_torch_parallel*.py hold the same steps against JAX at tighter
ones.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

# the dry run's scene and options (the JAX dry run's)
DRY_RES, DRY_TILE, DRY_SPLATS, DRY_CAP, DRY_MAX_DUP = 64, 16, 48, 128, 2**10
ENTRY_TILE = 16  # entry()'s render: render_tiled's tile, as JAX's entry
LOSS_ATOL = 1e-4  # each sharded step's loss against the DP step's
LOOP_ATOL = 2e-5  # the product loops' means and opacities against one process
LOOP_STEPS = 5


def _example_scene(n_splats: int, cap: int, n_cams: int, width: int, height: int,
                   seed: int = 0, device="cpu"):
    """(model, cameras, truths (2F, H, W, 3)): ``n_splats`` random splats in
    ``cap`` slots, the rig of ``n_cams`` cameras on sphere 1 and uniform
    truths, drawn from one numpy generator in the JAX dry run's order, so
    that the arrays equal its own bit for bit."""
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost
    from gaussian_splatterer_tpu_torch.train import CameraBatch

    rng = np.random.default_rng(seed)
    m = SplatModelHost(cap)
    for i in range(n_splats):
        m.means[i] = rng.uniform(-1.5, 1.5, 3)
        m.shs[i] = rng.normal(0, 0.3, (4, 3))
        m.scales[i] = rng.uniform(0.05, 0.3, 3)
        m.opacities[i] = rng.uniform(0.3, 1.0)
    m.count = n_splats
    proj = Project()
    proj.sphere1.count = n_cams
    proj.sphere2.count = 0
    cams = CameraBatch.from_cameras(Camera.get_cameras(proj), width, height, device=device)
    truths = torch.from_numpy(
        rng.uniform(0, 1, (2 * n_cams, height, width, 3)).astype(np.float32)).to(device)
    return m.to_device(device), cams, truths


def entry(device="cuda", *, n_splats: int = 20_000, capacity: int = 32_768, size: int = 512):
    """(fn, args): fn(*args) is the tiled forward render (H, W, 3) of the
    flagship scene, ``n_splats`` splats in ``capacity`` slots at
    ``size``^2, from the first rig camera over a black background: one K1
    launch on the card, its plain version on the CPU.  ``fn.max_dup`` is
    the render's duplicate budget, the binning's count of this view's
    duplicates (``fn.num_dup``), so that it drops none."""
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.raster_tiled import render_tiled
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    width = height = size
    model, cams, _ = _example_scene(n_splats, capacity, 1, width, height, device=device)
    args = (model.means, model.shs, model.scales, model.opacities, model.rotations,
            model.active_mask(), cams.view[0], cams.proj_view[0], cams.cam_pos[0],
            cams.tan_fovx[0], cams.tan_fovy[0],
            torch.zeros(3, dtype=torch.float32, device=device))
    with torch.no_grad():  # the count alone: a budget of 0 keeps no duplicate
        num_dup = bin_splats(project_splat_components(*args[:11], width, height, 1, 1.0),
                             width, height, ENTRY_TILE, 0).num_dup
    max_dup = max(num_dup, 1)

    def fn(means, shs, scales, opacities, rotations, active,
           view, proj_view, cam_pos, tan_fovx, tan_fovy, background):
        return render_tiled(means, shs, scales, opacities, rotations, active,
                            view, proj_view, cam_pos, tan_fovx, tan_fovy,
                            width, height, background, 1, 1.0, tile=ENTRY_TILE,
                            max_dup=max_dup)

    fn.num_dup, fn.max_dup = num_dup, max_dup
    return fn, args


def mesh3_shape(n_devices: int) -> Optional[tuple[int, int, int]]:
    """The (camera, tile, splat) mesh of the dry run's 3-axis branches:
    JAX's (2, 2, n / 4) for a multiple of 8, (1, 2, 2) for 4, else none."""
    if n_devices >= 8 and n_devices % 8 == 0:
        return (2, 2, n_devices // 4)
    if n_devices == 4:
        return (1, 2, 2)
    return None


class _StubRtx:
    """The JAX dry run's deterministic photograph of (camera, background):
    no traced scene (no ``_tris``), so every trainer captures the same
    truths frame by frame."""

    def render(self, camera, background, samples, width, height):
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        loc = np.asarray(camera.location, np.float32)
        img = np.stack([0.5 + 0.4 * np.sin(xx / 7.0 + loc[0]),
                        0.5 + 0.4 * np.cos(yy / 9.0 + loc[1]),
                        np.full_like(xx, 0.4)], -1)
        bg = np.asarray(background, np.float32)
        mask = ((xx // 8) + (yy // 8)) % 2 == 0
        return np.where(mask[..., None], img, bg).astype(np.float32)


def _loop_trainer(n_devices: int, n_dev: int, mesh_kind: str, device):
    """The JAX dry run's product loop: LOOP_STEPS steps of auto_train
    (capture, train, densify, recapture) on ``n_dev`` training devices."""
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.train import Trainer, auto_train

    proj = Project()
    proj.sphere1.count = n_devices
    proj.sphere2.count = 0
    proj.rtSamples = 1
    proj.intervalCapture = 3
    proj.intervalDensify = 2
    proj.paramDensifyVariance = 1e-6
    rt = RuntimeConfig(render_resolution_x=DRY_RES, render_resolution_y=DRY_RES,
                       splats_capacity=DRY_CAP, tile_px=DRY_TILE, max_dup=DRY_MAX_DUP,
                       train_devices=n_dev, train_mesh=mesh_kind)
    model, _, _ = _example_scene(DRY_SPLATS, DRY_CAP, 1, DRY_RES, DRY_RES, device=device)
    t = Trainer(proj, rt, model, renderer="tiled")
    auto_train(t, _StubRtx(), LOOP_STEPS, rng=random.Random(0))
    return t


def _launches() -> dict[str, int]:
    """This process's kernel launches so far, by kernel."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    return {name: getattr(rt, f"{name}_launches")
            for name in ("composite_fwd", "composite_train", "composite_bwd", "cumsum_frames")}


def _dryrun_rank(rank: int, init_method: str, n_devices: int, device_type: str, cards: int,
                 backend: str, out: str) -> None:
    """One rank of dryrun_multichip: every branch, rank 0 printing."""
    import torch.distributed as dist

    from gaussian_splatterer_tpu_torch import parallel
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops.raster_tiled import image_to_tiles
    from gaussian_splatterer_tpu_torch.parallel.collectives import all_gather_rows
    from gaussian_splatterer_tpu_torch.train import DensifyParams, LearningRates, densify

    if device_type == "cuda":
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the device is set up before the meshes
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // n_devices)))
    parallel.init_distributed(rank=rank, world_size=n_devices, init_method=init_method,
                              backend=backend)

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    try:
        width = height = DRY_RES
        n = n_devices
        scene, cams, truths = _example_scene(DRY_SPLATS, DRY_CAP, n, width, height, device=dev)
        arrays = [getattr(scene, k).detach().cpu().numpy()
                  for k in ("means", "shs", "scales", "opacities", "rotations")]

        def fresh() -> SplatModel:  # the steps update their model in place
            return SplatModel.from_numpy(*arrays, count=scene.count, device=dev)

        tiles = image_to_tiles(truths, DRY_TILE).contiguous()
        runtime = RuntimeConfig(tile_px=DRY_TILE, max_dup=DRY_MAX_DUP)
        lrs = LearningRates.from_project(Project())
        result = {}

        def check(name: str, loss: float) -> None:
            assert np.isfinite(loss), f"non-finite {name} loss {loss}"
            assert abs(loss - result["dp"]) < LOSS_ATOL, (result["dp"], loss)
            result[name] = loss

        # 1-D camera mesh: data parallelism over the truth frames
        mesh = parallel.make_camera_mesh(dev.type)
        step = parallel.make_dp_train_step(mesh, width, height, 1, runtime=runtime)
        new_model, metrics = step(fresh(), parallel.shard_truths(mesh, tiles), cams, lrs)
        result["dp"] = float(metrics.loss)
        assert np.isfinite(result["dp"]), f"non-finite DP loss {result['dp']}"
        say(f"dryrun_multichip({n}) camera-DP: ok, loss={result['dp']:.6f}, "
            f"count={new_model.count}")

        if n % 2 == 0 and n >= 4:
            # (camera, splat): the parameters' rows sharded over splat
            mesh2 = parallel.make_2d_mesh(dev.type, 2, n // 2)
            fstep = parallel.make_fsdp_train_step(mesh2, width, height, 1, runtime=runtime)
            _, met2 = fstep(parallel.shard_model(mesh2, fresh()),
                            parallel.shard_truths_2d(mesh2, tiles), cams, lrs)
            check("fsdp", float(met2.loss))
            say(f"dryrun_multichip({n}) camera x splat FSDP: ok, loss={result['fsdp']:.6f}")

            # (camera, tile): each rank rasterizes a horizontal band
            mesh_t = parallel.make_tile_mesh(dev.type, n // 2, 2)
            tstep = parallel.make_tp_train_step(mesh_t, width, height, 1, runtime=runtime)
            _, met3 = tstep(fresh(), parallel.shard_truths_tp(mesh_t, tiles), cams, lrs)
            check("bands", float(met3.loss))
            say(f"dryrun_multichip({n}) camera x tile bands: ok, loss={result['bands']:.6f}")

        shape = mesh3_shape(n)
        if shape is not None:
            # (camera, tile, splat): the three composed
            mesh4 = parallel.make_3d_mesh(dev.type, *shape)
            truths4 = parallel.shard_truths_3d(mesh4, tiles)
            step4 = parallel.make_3d_train_step(mesh4, width, height, 1, runtime=runtime)
            new4, met4 = step4(parallel.shard_model_3d(mesh4, fresh()), truths4, cams, lrs)
            check("mesh3", float(met4.loss))
            say(f"dryrun_multichip({n}) camera x tile x splat: ok, loss={result['mesh3']:.6f}")

            # routed records, no parameter gather anywhere
            step5 = parallel.make_routed3_train_step(mesh4, width, height, 1, runtime=runtime)
            _, met5, stats5 = step5(parallel.shard_model_3d(mesh4, fresh()), truths4, cams,
                                    lrs)
            check("routed", float(met5.loss))
            result["route_stats"] = list(stats5)
            say(f"dryrun_multichip({n}) routed camera x tile x splat (sub-transient): ok, "
                f"loss={result['routed']:.6f}")

            # densify inside the sharded loop: gathered, densified exactly as
            # one device would, re-sharded; then the 3-axis step trains on
            dproj = Project()
            dproj.paramDensifyVariance = 1e-6  # appends at toy scale
            dpar = DensifyParams.from_project(dproj)
            group = mesh4.get_group(parallel.SPLAT_AXIS)
            expect = densify(parallel.gather_model(mesh4, new4),
                             all_gather_rows(met4.var_loc, group),
                             all_gather_rows(met4.avg_grad_loc, group), dpar)
            count_before = new4.count
            got = parallel.densify_sharded(mesh4, new4, met4.var_loc, met4.avg_grad_loc, dpar,
                                           parallel.shard_model_3d)
            assert got.count == expect.count, (got.count, expect.count)
            np.testing.assert_allclose(parallel.gather_model(mesh4, got).means.cpu().numpy(),
                                       expect.means.cpu().numpy(), atol=1e-6)
            _, met4b = step4(got, truths4, cams, lrs)
            assert np.isfinite(float(met4b.loss))
            result["densify"] = [count_before, got.count]
            say(f"dryrun_multichip({n}) mesh3 densify-in-loop: ok, "
                f"count {count_before} -> {got.count}")

        # the product loop: Trainer(train_devices=n) under auto_train lands on
        # the single-process Trainer's model
        base = _loop_trainer(n, 0, "dp", dev).model
        result["product"] = {}
        for mesh_kind in ("dp", "fsdp"):
            t = _loop_trainer(n, n, mesh_kind, dev)
            whole = t._gathered_model()
            assert whole.count == base.count, (whole.count, base.count)
            for name in ("means", "opacities"):
                np.testing.assert_allclose(getattr(whole, name).detach().cpu().numpy(),
                                           getattr(base, name).detach().cpu().numpy(),
                                           atol=LOOP_ATOL, err_msg=name)
            result["product"][mesh_kind] = whole.count
            say(f"dryrun_multichip({n}) product {mesh_kind} loop "
                f"(capture->train->densify->recapture): ok, count={whole.count} == "
                "single-device")
        result["device"], result["backend"] = str(dev), backend
        result["launches"] = _launches()
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(result, fh)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run every sharded step once over ``n_devices`` ranks on ``device``'s
    type (module docstring) and return rank 0's numbers: each branch's
    loss, the routed step's RouteStats, densify's counts, the product
    loops' counts, the rank's device and backend, and its kernel launches.
    A failed branch raises (the rank's error); so does ``cuda`` without a
    card."""
    from gaussian_splatterer_tpu_torch import parallel

    device_type = torch.device(device).type
    cards, backend = 0, "gloo"
    if device_type == "cuda":
        from gaussian_splatterer_tpu_torch.app.cli import TRAIN_KERNELS
        from gaussian_splatterer_tpu_torch.ops import cuda_build

        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda: no CUDA device")
        backend = "nccl" if n_devices <= cards else "gloo"
        cuda_build.build(TRAIN_KERNELS)  # once here, not once a rank
    fd, out = tempfile.mkstemp(prefix="dryrun_multichip_", suffix=".json")
    os.close(fd)
    try:
        parallel.spawn_ranks(_dryrun_rank, n_devices, n_devices, device_type, cards, backend,
                             out)
        with open(out) as fh:
            return json.load(fh)
    finally:
        os.unlink(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4, help="ranks of the dry run (4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where both run (cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("graft_entry: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry(): ok {tuple(out.shape)}, {fn.num_dup} duplicates")
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
