"""PyTorch port vs JAX package: multi-device training as a product path
(the Trainer under auto_train, the sharded capture, ``gsplat-torch train
--devices N``).

The port's DP and FSDP loops run at world 2 (two gloo ranks on the CPU) in
tests/torch_parallel_runner.py, started once by a module fixture, as
tests/test_product_parallel.py:26-92 builds them: 32^2, tile 16, capacity
128, 4 cameras, 6 steps, a recapture every 3 and densify every 2.  Each is
held against ONE single-device JAX loop (float32 fused cumsums,
train_mm_bf16 off, the port's arithmetic) at that test's atol 2e-5, with
equal splat counts above the 24 it starts from.  Each rank draws its own
rig from its own rng, so the recapture must take rank 0's.

The sharded capture is held bit for bit to serial renders with the same
frame seeds, in the whites-then-blacks order; against JAX's
capture_images_sharded, whose fold_in streams torch cannot reproduce, only
on scenes that leave nothing to chance (no model; a transparent surface
that passes every ray to the background)."""

import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_parallel_runner as runner
from torch_parity import jax_model

from gaussian_splatterer_tpu_torch.app import cli as tcli
from gaussian_splatterer_tpu_torch.config import RuntimeConfig
from gaussian_splatterer_tpu_torch.parallel import frame_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_ATOL = 2e-5
FIELDS = ("means", "shs", "scales", "opacities", "rotations")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The runner's ``product`` suite at world 2: a loader of each case's
    two ranks' npz files."""
    out = tmp_path_factory.mktemp("torch_parallel_product")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_parallel_runner.py"),
                           "product", str(out)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]

    def load(case):
        ranks = []
        for r in range(runner.WORLDS["product"]):
            with np.load(out / f"{case}_rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        assert not any(bool(x["jax_loaded"]) for x in ranks), "a rank imported JAX"
        return ranks

    return load


@pytest.fixture(scope="module")
def jax_loop():
    """One single-device JAX Trainer through the same 6-step loop."""
    from gaussian_splatterer_tpu.config import Project as JProject
    from gaussian_splatterer_tpu.config import RuntimeConfig as JRuntimeConfig
    from gaussian_splatterer_tpu.train.schedule import auto_train
    from gaussian_splatterer_tpu.train.trainer import Trainer as JTrainer

    project_kw, runtime_kw = runner.product_settings()
    project = JProject.from_json(runner.port_rig(runner.CAMS).to_json())
    for key, value in project_kw.items():
        setattr(project, key, value)
    arrays, n = runner.product_arrays()
    trainer = JTrainer(project, JRuntimeConfig(**runtime_kw), jax_model(arrays, n),
                       renderer="tiled")
    auto_train(trainer, runner.StubRtx(), runner.STEPS, rng=random.Random(0),
               capture_first=True)
    return trainer


def assert_loop_matches(ranks, jax_trainer):
    j_count = int(jax_trainer.model.count)
    for r in ranks:
        assert int(r["devices"]) == runner.WORLDS["product"]
        assert int(r["iterations"]) == jax_trainer.project.iterations == runner.STEPS
        assert int(r["recaptures"]) == 1
        assert int(r["count"]) == j_count > 24  # densify grew the model
        assert int(r["truth_frames"]) == runner.CAMS  # 8 frames over 2 ranks
        for name in FIELDS:
            np.testing.assert_allclose(r[name], np.asarray(getattr(jax_trainer.model, name)),
                                       atol=MODEL_ATOL, err_msg=name)


def test_dp_product_loop_matches_the_jax_single_device_loop(world2, jax_loop):
    """Camera-DP Trainer at world 2: the replicated copies stay bit-equal and
    land on the JAX single-device model."""
    ranks = world2("dp")
    for name in FIELDS:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    assert [int(r["local_rows"]) for r in ranks] == [runner.CAP, runner.CAP]
    assert_loop_matches(ranks, jax_loop)


def test_fsdp_product_loop_matches_the_jax_single_device_loop(world2, jax_loop):
    """Splat-sharded Trainer at world 2 (gathered densify): each rank rests
    on capacity / 2 rows, and the gathered model is the JAX one."""
    ranks = world2("fsdp")
    assert [int(r["local_rows"]) for r in ranks] == [runner.CAP // 2] * 2
    for name in FIELDS:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    assert_loop_matches(ranks, jax_loop)


def test_ranks_take_rank_0s_rig_at_a_randomized_recapture(world2, jax_loop):
    """Each rank's rng (random.Random(rank)) draws another rig; after the
    recapture every rank holds rank 0's, the JAX loop's Random(0) rig."""
    want = [(s.rotX, s.rotY) for s in (jax_loop.project.sphere1, jax_loop.project.sphere2)]
    other = random.Random(1)
    assert other.uniform(0.0, 360.0) != want[0][0]
    for case in ("dp", "fsdp"):
        for r in world2(case):
            np.testing.assert_array_equal(r["rig"], np.array(want, np.float64))


def test_sharded_capture_equals_serial_renders(world2):
    """Rank r renders frames [2r, 2r + 2) of the 4 (2 cameras, whites then
    blacks), each bit-equal to a serial render seeded frame_seed(7, i); the
    gathered capture is all of them in that order."""
    ranks = world2("capture")
    host = runner.port_capture_host()
    cameras = runner.port_capture_cameras()
    res, samples, seed = runner.CAPTURE_RES, runner.CAPTURE_SAMPLES, runner.CAPTURE_SEED
    c = len(cameras)
    serial = np.stack([
        host.render(cameras[i % c], (1.0, 1.0, 1.0) if i < c else (0.0, 0.0, 0.0), samples,
                    res, res, seed=frame_seed(seed, i)).numpy() for i in range(2 * c)])
    assert len({frame_seed(seed, i) for i in range(2 * c)}) == 2 * c
    assert not np.array_equal(serial[0], serial[1]) and serial.max() > 0
    for r, x in enumerate(ranks):
        np.testing.assert_array_equal(x["local"], serial[2 * r:2 * r + 2])
        np.testing.assert_array_equal(x["full"], serial)


def test_sharded_capture_matches_jax_on_deterministic_scenes(world2):
    """No model renders zeros; a transparent quad passes every ray to the
    background: the port's gathered capture equals JAX's
    capture_images_sharded on 2 devices exactly."""
    from gaussian_splatterer_tpu.io.obj import TriangleMesh as JMesh
    from gaussian_splatterer_tpu.models.camera import Camera as JCamera
    from gaussian_splatterer_tpu.parallel.capture import capture_images_sharded
    from gaussian_splatterer_tpu.rt import RtxHost as JHost

    ranks = world2("capture")
    res, samples, seed = runner.CAPTURE_RES, runner.CAPTURE_SAMPLES, runner.CAPTURE_SEED
    cameras = [JCamera(np.array(loc, np.float32), np.array(tgt, np.float32), fov)
               for loc, tgt, fov in runner.capture_camera_specs()]
    clear = JHost(tri_chunk=8, ray_chunk=res * res)
    clear.load_model(JMesh(*runner.quad_arrays()))
    clear.load_texture_diffuse(runner.capture_texture(alpha=0.0))
    for case, host in (("clear", clear), ("empty", JHost())):
        want = np.asarray(capture_images_sharded(host, cameras, samples, res, res,
                                                 devices=jax.devices()[:2], seed=seed))
        for r in ranks:
            np.testing.assert_array_equal(r[case], want, err_msg=case)
    assert ranks[0]["clear"][:2].min() == 1.0 and ranks[0]["clear"][2:].max() == 0.0


def _quad_project(tmp_path):
    """tests/test_product_parallel.py's CLI project: a quad, 32^2, capacity
    256, tile 16, 4 cameras, 2 samples, no recapture or densify."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1.5 -1.5 0\nv 1.5 -1.5 0\nv 1.5 1.5 0\nv -1.5 1.5 0\n"
                   "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\n")
    proj = tmp_path / "proj"
    common = ["--resolution", "32", "--capacity", "256", "--max-dup", "1024", "--runtime",
              "tile_px=16", "--device", "cpu"]
    assert tcli.main(["new", str(proj), "--obj", str(obj), "--init-field", "mono",
                      *common]) == 0
    settings = json.loads((proj / "settings.json").read_text())
    settings["sphere1"]["count"] = 4
    settings["sphere2"]["count"] = 0
    settings["rtSamples"] = 2
    settings["intervalCapture"] = 0
    settings["intervalDensify"] = 0
    (proj / "settings.json").write_text(json.dumps(settings))
    return proj, common


def test_cli_devices_flag(tmp_path, capfd):
    """gsplat-torch train --devices 2 --device cpu: two gloo workers train
    end to end, rank 0 prints the last line and writes the watch page (2
    devices), and the project persists train_devices 2 and
    capture_data_parallel."""
    assert "train --devices N" in tcli.__doc__
    proj, common = _quad_project(tmp_path)
    capfd.readouterr()
    assert tcli.main(["train", str(proj), "--steps", "2", "--devices", "2", "--log-every", "1",
                      "--watch", "--watch-every", "2", *common]) == 0
    assert json.loads((proj / "watch" / "status.json").read_text())["devices"] == 2
    out = capfd.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last["devices"] == 2 and last["iterations"] == 2 and last["splats"] >= 1
    assert sum(line.startswith("iter ") for line in out) == 2  # rank 0 alone prints
    rt = json.loads((proj / "runtime.json").read_text())
    assert rt["train_devices"] == 2
    assert rt["capture_data_parallel"] is True
    assert json.loads((proj / "settings.json").read_text())["iterations"] == 2


def test_cli_refuses_more_devices_than_cards(tmp_path, monkeypatch):
    """On cuda, --devices above the card count exits nonzero naming both
    numbers, before anything runs or is written."""
    proj, _ = _quad_project(tmp_path)
    before = (proj / "runtime.json").read_text()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="train_devices=2 but only 1 devices"):
        tcli.main(["train", str(proj), "--steps", "1", "--devices", "2"])
    assert (proj / "runtime.json").read_text() == before
    assert RuntimeConfig.load(str(proj / "runtime.json")).train_devices == 0
