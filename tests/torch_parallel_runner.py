"""Multi-rank runs of the PyTorch port's sharded training on the CPU, for
tests/test_torch_parallel.py (``steps``), tests/test_torch_product_parallel.py
(``product``), tests/test_torch_parallel_bands.py (``bands`` and
``bands3d``), tests/test_torch_route.py (``route``) and
tests/test_torch_parallel_routed.py (``routed``):

    python tests/torch_parallel_runner.py SUITE OUT_DIR

starts WORLDS[suite] ranks (torch.multiprocessing, spawn; a gloo group on
127.0.0.1): 2, and 4 for ``bands3d``, ``route`` and ``routed``; each writes
OUT_DIR/<case>_rank<r>.npz, with ``jax_loaded`` saying whether JAX got
imported in it.  The scenes are made here from seeds with numpy,
so that the tests build the JAX side from the same functions.  This module
imports nothing of JAX and is not collected (like tests/multihost_runner.py).
"""

import os
import random
import sys

# run as `python tests/torch_parallel_runner.py`, which puts tests/ and not
# the repository's root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

WORLDS = {"steps": 2, "product": 2, "bands": 2, "bands3d": 4, "route": 4, "routed": 4}
RANK_THREADS = 2
# the steps: tests/test_parallel.py's fused scene (24 splats in 64 slots,
# SH 1, 4 cameras, 64^2, tile 16); the non-fused step at 40^2, tile 16
STEP_RES, STEP_TILE, STEP_CAP, STEP_N, STEP_CAMS = 64, 16, 64, 24, 4
NONFUSED_RES = 40
# the product loops: tests/test_product_parallel.py:26-92
RES, TILE, CAP, CAMS, STEPS = 32, 16, 128, 4, 6
# the sharded capture: a quad at 16^2, 2 cameras, 2 samples
CAPTURE_RES, CAPTURE_SAMPLES, CAPTURE_SEED = 16, 2, 7
# the record routes: tests/test_route.py's records (96 a rank, 4 payload
# rows) over the 4 ranks, every 7th record sent out of range
ROUTE_L, ROUTE_K, ROUTE_DROP = 96, 4, 7


# -- scenes (numpy) ---------------------------------------------------------------


def step_arrays(cap=STEP_CAP, n=STEP_N, seed=0):
    """(means, shs, scales, opacities, rotations) capacity-padded, and n."""
    rng = np.random.default_rng(seed)
    means, shs = np.zeros((cap, 3), np.float32), np.zeros((cap, 4, 3), np.float32)
    scales, opac = np.zeros((cap, 3), np.float32), np.zeros((cap,), np.float32)
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    means[:n] = rng.uniform(-1.5, 1.5, (n, 3))
    shs[:n] = rng.normal(0, 0.3, (n, 4, 3))
    scales[:n] = rng.uniform(0.1, 0.4, (n, 3))
    opac[:n] = rng.uniform(0.3, 1.0, n)
    return (means, shs, scales, opac, rot), n


def route_records(seed, skew=None, shards=4):
    """tests/test_route.py's make_records: per-rank (dst (S, L), payload
    (S, K, L)), payload row 0 = source x 1000 + local index; then every
    ROUTE_DROP-th record's destination put out of range, -1 or S in turn."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, shards, size=(shards, ROUTE_L)).astype(np.int32)
    if skew is not None:
        dst[:, : ROUTE_L // 2] = skew
    payload = rng.normal(size=(shards, ROUTE_K, ROUTE_L)).astype(np.float32)
    payload[:, 0] = (np.arange(shards, dtype=np.float32)[:, None] * 1000
                     + np.arange(ROUTE_L, dtype=np.float32)[None, :])
    drop = np.arange(0, ROUTE_L, ROUTE_DROP)
    dst[:, drop] = np.where(np.arange(drop.size) % 2 == 0, -1, shards)
    return dst, payload


def route_slots(seed=4, slots=2, shards=4):
    """Per-rank (dst (S, slots, L), payload (S, K, L)): route_records(seed)'s
    payload, each row sent from ``slots`` slots, slot b's destinations
    those of route_records(seed + b)."""
    payload = route_records(seed, shards=shards)[1]
    dst = np.stack([route_records(seed + b, shards=shards)[0] for b in range(slots)], 1)
    return dst, payload


def step_truths(res, cams=STEP_CAMS, seed=1):
    """(2F, res, res, 3) uniform truth images."""
    return np.random.default_rng(seed).uniform(0, 1, (2 * cams, res, res, 3)).astype(np.float32)


def product_arrays():
    """tests/test_product_parallel.py's 24 splats in CAP slots (seed 7)."""
    rng = np.random.default_rng(7)
    means, shs = np.zeros((CAP, 3), np.float32), np.zeros((CAP, 4, 3), np.float32)
    scales, opac = np.zeros((CAP, 3), np.float32), np.zeros((CAP,), np.float32)
    rot = np.zeros((CAP, 4), np.float32)
    rot[:, 0] = 1.0
    for i in range(24):
        means[i] = rng.uniform(-1.2, 1.2, 3)
        shs[i] = rng.normal(0, 0.3, (4, 3))
        scales[i] = rng.uniform(0.05, 0.3, 3)
        opac[i] = rng.uniform(0.3, 1.0)
    return (means, shs, scales, opac, rot), 24


class StubRtx:
    """tests/test_product_parallel.py's deterministic photograph: a smooth
    function of the camera's location and the background, no traced scene
    (no ``_tris``), so every rank and the JAX trainer see the same truths."""

    def render(self, camera, background, samples, width, height):
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        loc = np.asarray(camera.location, np.float32)
        img = np.stack([
            0.5 + 0.4 * np.sin(xx / 7.0 + loc[0]),
            0.5 + 0.4 * np.cos(yy / 9.0 + loc[1]),
            np.full_like(xx, 0.3) + 0.05 * loc[2] % 0.4,
        ], -1)
        bg = np.asarray(background, np.float32)
        mask = ((xx // 8) + (yy // 8)) % 2 == 0
        return np.where(mask[..., None], img, bg).astype(np.float32)


def product_settings():
    """(Project JSON fields, RuntimeConfig fields) of the product loops, the
    same for the port and the JAX package (float32 fused cumsums on the
    JAX side: train_mm_bf16 off)."""
    project = {"rtSamples": 1, "intervalCapture": 3, "intervalDensify": 2,
               "paramDensifyVariance": 1e-6}  # splits and clones at toy scale
    runtime = dict(render_resolution_x=RES, render_resolution_y=RES, splats_capacity=CAP,
                   max_dup=2**10, tile_px=TILE, train_mm_bf16=False)
    return project, runtime


def quad_arrays(half=2.0):
    """tests/test_rt.py's quad: vertices, triangles, uv."""
    v = np.array([[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]],
                 np.float32)
    uv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uv


def capture_texture(alpha=1.0):
    t = np.zeros((4, 4, 4), np.float32)
    t[...] = (0.8, 0.5, 0.3, alpha)
    t[0, 0, :3] = (0.1, 0.9, 0.2)
    return t


def capture_camera_specs():
    """(location, target, fov) of the capture's two cameras."""
    return [((0.0, 0.0, -6.0), (0.0, 0.0, 0.0), 50.0), ((1.0, 0.5, -5.0), (0.0, 0.0, 0.0), 50.0)]


# -- the port's side (torch) ------------------------------------------------------


def port_rig(cams):
    from gaussian_splatterer_tpu_torch.config import Project

    p = Project()
    p.sphere1.count = cams
    p.sphere2.count = 0
    return p


def port_capture_host(alpha=1.0, model=True):
    from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
    from gaussian_splatterer_tpu_torch.rt import RtxHost

    host = RtxHost(tri_chunk=8, device="cpu")
    if model:
        host.load_model(TriangleMesh(*quad_arrays()))
        host.load_texture_diffuse(capture_texture(alpha))
    return host


def port_capture_cameras():
    from gaussian_splatterer_tpu_torch.models.camera import Camera

    return [Camera(np.array(loc, np.float32), np.array(tgt, np.float32), fov)
            for loc, tgt, fov in capture_camera_specs()]


def _save(out_dir, case, rank, **arrays):
    arrays["jax_loaded"] = np.bool_(any(k == "jax" or k.startswith("jax.") or
                                        k.startswith("gaussian_splatterer_tpu.") or
                                        k == "gaussian_splatterer_tpu" for k in sys.modules))
    np.savez(os.path.join(out_dir, f"{case}_rank{rank}.npz"), **arrays)


def _model_arrays(model):
    return {name: getattr(model, name).detach().cpu().numpy()
            for name in ("means", "shs", "scales", "opacities", "rotations")}


def _metrics(met):
    return dict(loss=float(met.loss), var_loc=met.var_loc.detach().cpu().numpy(),
                avg_grad_loc=met.avg_grad_loc.detach().cpu().numpy(), num_dup=met.num_dup)


def _step_scene():
    """The fused step scene (model maker, cameras, pre-tiled truths,
    learning rates, runtime) at STEP_RES, tile STEP_TILE."""
    import torch

    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops.raster_tiled import image_to_tiles
    from gaussian_splatterer_tpu_torch.train import CameraBatch, LearningRates

    arrays, n = step_arrays()
    res, tile = STEP_RES, STEP_TILE
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                            max_dup=2**12)
    cams = CameraBatch.from_cameras(Camera.get_cameras(port_rig(STEP_CAMS)), res, res,
                                    device="cpu")
    tiles = image_to_tiles(torch.from_numpy(step_truths(res)), tile).contiguous()

    def model():
        return SplatModel.from_numpy(*arrays, count=n, device="cpu")

    return model, cams, tiles, LearningRates.from_project(Project()), runtime


def steps_suite(rank, out_dir):
    import torch

    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.parallel import (
        densify_sharded, gather_model, make_2d_mesh, make_camera_mesh, make_dp_train_step,
        make_fsdp_train_step, shard_model, shard_truths, shard_truths_2d,
    )
    from gaussian_splatterer_tpu_torch.parallel.collectives import all_gather_rows
    from gaussian_splatterer_tpu_torch.train import CameraBatch, DensifyParams, densify

    model, cams, tiles, lrs, runtime = _step_scene()
    res, tile = STEP_RES, STEP_TILE
    cameras = Camera.get_cameras(port_rig(STEP_CAMS))

    mesh = make_camera_mesh("cpu")
    step = make_dp_train_step(mesh, res, res, 1, runtime=runtime)
    m, met = step(model(), shard_truths(mesh, tiles), cams, lrs)
    _save(out_dir, "dp", rank, fused=step.fused, frames=shard_truths(mesh, tiles).shape[0],
          calls=step.comm.calls, bytes=step.comm.bytes, **_model_arrays(m), **_metrics(met))

    mesh2 = make_2d_mesh("cpu", 1, WORLDS["steps"])
    step = make_fsdp_train_step(mesh2, res, res, 1, runtime=runtime)
    shard, met = step(shard_model(mesh2, model()), shard_truths_2d(mesh2, tiles), cams, lrs)
    _save(out_dir, "fsdp", rank, offset=shard.offset, rows=shard.rows,
          **_model_arrays(shard), **_metrics(met))

    # densify of the sharded model against densify of the gathered arrays
    project = Project()
    project.paramDensifyVariance = 1e-6
    dparams = DensifyParams.from_project(project)
    group = mesh2.get_group("splat")
    want = densify(gather_model(mesh2, shard), all_gather_rows(met.var_loc, group),
                   all_gather_rows(met.avg_grad_loc, group), dparams)
    got = densify_sharded(mesh2, shard, met.var_loc, met.avg_grad_loc, dparams, shard_model)
    got_full = gather_model(mesh2, got)
    _save(out_dir, "densify", rank, count=got.count, want_count=want.count, rows=got.rows,
          **{f"got_{k}": v for k, v in _model_arrays(got_full).items()},
          **{f"want_{k}": v for k, v in _model_arrays(want).items()})

    # the non-fused step (40 x 40 is not a multiple of the tile)
    res = NONFUSED_RES
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res, tile_px=tile,
                            max_dup=2**12)
    cams = CameraBatch.from_cameras(cameras, res, res, device="cpu")
    truths = torch.from_numpy(step_truths(res))
    step = make_dp_train_step(mesh, res, res, 1, runtime=runtime)
    m, met = step(model(), shard_truths(mesh, truths), cams, lrs)
    _save(out_dir, "nonfused", rank, fused=step.fused, **_model_arrays(m), **_metrics(met))


def product_suite(rank, out_dir):
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.parallel import capture_images_sharded
    from gaussian_splatterer_tpu_torch.train import Trainer, auto_train

    project_kw, runtime_kw = product_settings()
    arrays, n = product_arrays()
    for kind in ("dp", "fsdp"):
        project = port_rig(CAMS)
        for key, value in project_kw.items():
            setattr(project, key, value)
        runtime = RuntimeConfig(**runtime_kw, train_devices=WORLDS["product"], train_mesh=kind)
        trainer = Trainer(project, runtime, SplatModel.from_numpy(*arrays, count=n, device="cpu"),
                          renderer="tiled")
        # each rank's rng draws its own rig: the recaptures must take rank 0's
        stats = auto_train(trainer, StubRtx(), STEPS, rng=random.Random(rank))
        rig = [(s.rotX, s.rotY) for s in (project.sphere1, project.sphere2)]
        local = trainer.model
        _save(out_dir, kind, rank, devices=trainer.devices, count=local.count,
              iterations=project.iterations, recaptures=stats["recaptures"],
              rig=np.array(rig, np.float64), local_rows=local.means.shape[0],
              truth_frames=trainer.truths.shape[0], **_model_arrays(trainer._gathered_model()))

    cameras = port_capture_cameras()
    res, samples, seed = CAPTURE_RES, CAPTURE_SAMPLES, CAPTURE_SEED
    host = port_capture_host()
    local = capture_images_sharded(host, cameras, samples, res, res, seed=seed)
    full = capture_images_sharded(host, cameras, samples, res, res, seed=seed, gather=True)
    clear = capture_images_sharded(port_capture_host(alpha=0.0), cameras, samples, res, res,
                                   seed=seed, gather=True)
    empty = capture_images_sharded(port_capture_host(model=False), cameras, samples, res, res,
                                   seed=seed, gather=True)
    _save(out_dir, "capture", rank, local=local.numpy(), full=full.numpy(),
          clear=clear.numpy(), empty=empty.numpy())


def bands_suite(rank, out_dir):
    """The band step on a 1 x 2 (camera x tile) mesh on both reduction
    routes, and the sharded checkpoint of an FSDP shard."""
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.io.checkpoint import (
        load_checkpoint_sharded, save_checkpoint, save_checkpoint_sharded,
    )
    from gaussian_splatterer_tpu_torch.parallel import (
        gather_model, make_2d_mesh, make_tile_mesh, make_tp_train_step, shard_model,
        shard_truths_tp,
    )

    model, cams, tiles, lrs, runtime = _step_scene()
    res = STEP_RES
    mesh = make_tile_mesh("cpu", 1, WORLDS["bands"])
    for reduction in ("index_add", "cumsum"):
        step = make_tp_train_step(mesh, res, res, 1, runtime=runtime, reduction=reduction)
        truths = shard_truths_tp(mesh, tiles)
        m, met = step(model(), truths, cams, lrs)
        _save(out_dir, f"tp_{reduction}", rank, tiles=truths.shape[1], frames=truths.shape[0],
              calls=step.comm.calls, bytes=step.comm.bytes, **_model_arrays(m), **_metrics(met))

    # the FSDP shard of a stepped model, saved sharded and loaded into its rows
    mesh2 = make_2d_mesh("cpu", 1, WORLDS["bands"])
    shard = shard_model(mesh2, m)
    project = Project()
    project.iterations = 17
    ckpt = os.path.join(out_dir, "ckpt_sharded")
    save_checkpoint_sharded(ckpt, shard, project)
    like = shard_model(mesh2, model())  # other rows of the same shape
    back, back_project = load_checkpoint_sharded(ckpt, like=like)
    whole = gather_model(mesh2, shard)
    if rank == 0:
        save_checkpoint(os.path.join(out_dir, "ckpt_gathered.npz"), whole, project)
    _save(out_dir, "ckpt", rank, offset=shard.offset, count=back.count,
          iterations=back_project.iterations, back_offset=back.offset,
          **{f"saved_{k}": v for k, v in _model_arrays(shard).items()},
          **{f"back_{k}": v for k, v in _model_arrays(back).items()})


def bands3d_suite(rank, out_dir):
    """The 3-axis step on a 1 x 2 x 2 (camera x tile x splat) mesh on both
    reduction routes."""
    from gaussian_splatterer_tpu_torch.parallel import (
        make_3d_mesh, make_3d_train_step, shard_model_3d, shard_truths_3d,
    )

    model, cams, tiles, lrs, runtime = _step_scene()
    res = STEP_RES
    mesh = make_3d_mesh("cpu", 1, 2, 2)
    for reduction in ("index_add", "cumsum"):
        step = make_3d_train_step(mesh, res, res, 1, runtime=runtime, reduction=reduction)
        truths = shard_truths_3d(mesh, tiles)
        shard, met = step(shard_model_3d(mesh, model()), truths, cams, lrs)
        _save(out_dir, f"mesh3_{reduction}", rank, offset=shard.offset, rows=shard.rows,
              tiles=truths.shape[1], frames=truths.shape[0], calls=step.comm.calls,
              **_model_arrays(shard), **_metrics(met))


def route_suite(rank, out_dir):
    """bucket_route and route_back over the 4 ranks on route_records: the
    records of seed 0, of seed 1 with half of every rank's to rank 3, of
    seed 3 sent there and back (the receiver doubles them), and the rows of
    seed 4 in two slots each (route_slots) sent there and back."""
    import torch

    from gaussian_splatterer_tpu_torch.parallel import bucket_route, route_back
    from gaussian_splatterer_tpu_torch.parallel.collectives import CommStats

    group = None  # the default group: every rank
    for case, seed, skew in (("exact", 0, None), ("skew", 1, 3), ("back", 3, None)):
        dst, payload = route_records(seed, skew)
        d = torch.from_numpy(dst[rank]).long()
        p = torch.from_numpy(payload[rank].T.copy())  # (L, K) rows
        stats = CommStats()
        recv, counts, max_count = bucket_route(d, p, group, stats)
        arrays = dict(recv=recv.numpy(), counts=np.array(counts), max_count=max_count)
        if case == "back":
            back = route_back(d, recv * 2.0, counts, group, stats)
            arrays["back"] = back.numpy()
        _save(out_dir, f"route_{case}", rank, calls=stats.calls, bytes=stats.bytes, **arrays)
    dst, payload = route_slots()
    d = torch.from_numpy(dst[rank]).long()
    p = torch.from_numpy(payload[rank].T.copy())
    stats = CommStats()
    recv, counts, max_count = bucket_route(d, p, group, stats)
    back = route_back(d, recv * 2.0, counts, group, stats)
    _save(out_dir, "route_slots", rank, calls=stats.calls, bytes=stats.bytes, recv=recv.numpy(),
          counts=np.array(counts), max_count=max_count, back=back.numpy())


def routed_suite(rank, out_dir):
    """The routed 3-axis step on a 1 x 2 x 2 (camera x tile x splat) mesh on
    both reduction routes."""
    from gaussian_splatterer_tpu_torch.parallel import (
        make_3d_mesh, make_routed3_train_step, shard_model_3d, shard_truths_3d,
    )

    model, cams, tiles, lrs, runtime = _step_scene()
    res = STEP_RES
    mesh = make_3d_mesh("cpu", 1, 2, 2)
    truths = shard_truths_3d(mesh, tiles)
    for reduction in ("index_add", "cumsum"):
        step = make_routed3_train_step(mesh, res, res, 1, runtime=runtime, reduction=reduction)
        shard, met, stats = step(shard_model_3d(mesh, model()), truths, cams, lrs)
        _save(out_dir, f"routed_{reduction}", rank, offset=shard.offset, rows=shard.rows,
              tiles=truths.shape[1], frames=truths.shape[0], calls=step.comm.calls,
              bytes=step.comm.bytes, stats=np.array(stats), **_model_arrays(shard),
              **_metrics(met))


SUITES = {"steps": steps_suite, "product": product_suite, "bands": bands_suite,
          "bands3d": bands3d_suite, "route": route_suite, "routed": routed_suite}


def _rank_main(rank, init_method, suite, out_dir):
    import torch
    import torch.distributed as dist

    from gaussian_splatterer_tpu_torch import parallel

    torch.set_num_threads(RANK_THREADS)  # the test workers share the cores
    parallel.init_distributed(rank=rank, world_size=WORLDS[suite], init_method=init_method,
                              backend="gloo")
    try:
        SUITES[suite](rank, out_dir)
    finally:
        dist.destroy_process_group()


def main(argv):
    from gaussian_splatterer_tpu_torch.parallel import spawn_ranks

    suite, out_dir = argv
    spawn_ranks(_rank_main, WORLDS[suite], suite, out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
