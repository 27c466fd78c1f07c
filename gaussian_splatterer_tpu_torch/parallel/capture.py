"""Camera-data-parallel truth capture: the path tracer's frames split over
the ranks, or over the cards of one process (counterpart of
gaussian_splatterer_tpu.parallel.capture).

The reference re-captures every truth view every ``intervalCapture``
iterations (src/ui/UiFrame.cpp:283-298).  Frames are independent, so the
2C frames of a capture (every camera against white, then every camera
against black: src/Trainer.cu:218-250) are split into contiguous blocks,
one a renderer, each rendered with ``RtxHost.render``: over the ranks of a
process group (``capture_images_sharded``), or, in one process, over a
list of local devices, one thread and one ``RtxHost`` replica a device
(``capture_images_local``, JAX's split over ``jax.devices()`` in one
process).  Either way the renderers are the largest divisor of 2C that is
no more than the ranks or devices.

Frame i draws from a generator seeded with ``frame_seed(seed, i)``, a
function of the capture's seed and the frame's index only, never of the
rank: any number of ranks, and a serial ``RtxHost.render(..., seed=
frame_seed(seed, i))`` of each frame, give the same frames bit for bit,
and so do any number of local devices.
JAX's ``fold_in(PRNGKey(seed), i)`` streams cannot be reproduced with
torch generators, so against the JAX package the frames agree in
distribution, and exactly only where a scene leaves nothing to chance.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Sequence

import torch
import torch.distributed as dist

from gaussian_splatterer_tpu_torch.parallel.collectives import all_gather_rows
from gaussian_splatterer_tpu_torch.rt.tracer import MAX_BOUNCES

_MASK64 = (1 << 64) - 1


def frame_seed(seed: int, i: int) -> int:
    """The generator seed of frame ``i`` of a capture seeded ``seed``:
    splitmix64 of the pair, kept to 63 bits."""
    z = ((int(seed) << 32) + int(i) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _renderers(available: int, frames: int) -> int:
    """The largest divisor of ``frames`` that is no more than ``available``."""
    n = max(1, min(available, frames))
    while frames % n:
        n -= 1
    return n


def _render_block(rtx, cameras: Sequence, frames: range, samples: int, width: int,
                  height: int, seed: int, bounces: int) -> list:
    c = len(cameras)
    return [rtx.render(cameras[i % c], (1.0, 1.0, 1.0) if i < c else (0.0, 0.0, 0.0),
                       samples, width, height, bounces=bounces, seed=frame_seed(seed, i))
            for i in frames]


def local_devices(device) -> list:
    """The devices of this process that a capture on ``device`` splits
    over: every CUDA card for a CUDA device, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def capture_images_local(rtx, cameras: Sequence, samples: int, width: int, height: int,
                         devices: Sequence, seed: int = 0,
                         bounces: int = MAX_BOUNCES) -> torch.Tensor:
    """Render every camera against white AND black backgrounds in one
    process, the 2C frames split in contiguous blocks over ``devices``
    (the first n, n the largest divisor of 2C no more than their number):
    one thread a device, rendering on its replica of ``rtx``
    (``RtxHost.replica``).  Returns the (2C, H, W, 3) float32 frames on
    ``rtx.device`` in the Trainer's order, bit-equal to serial renders
    seeded ``frame_seed(seed, i)``.  With no model: zeros."""
    f = 2 * len(cameras)
    if rtx._tris is None:
        return torch.zeros((f, height, width, 3), dtype=torch.float32, device=rtx.device)
    n = _renderers(len(devices), f)
    k = f // n

    def render(j: int) -> torch.Tensor:
        dev = torch.device(devices[j])
        host = rtx.replica(dev)
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            frames = _render_block(host, cameras, range(j * k, (j + 1) * k), samples, width,
                                   height, seed, bounces)
            return torch.stack(frames).to(rtx.device)

    if n == 1:
        return render(0)
    with ThreadPoolExecutor(max_workers=n) as pool:
        return torch.cat(list(pool.map(render, range(n))))


def capture_images_sharded(rtx, cameras: Sequence, samples: int, width: int, height: int,
                           group=None, seed: int = 0, bounces: int = MAX_BOUNCES,
                           gather: bool = False) -> torch.Tensor:
    """Render every camera against white AND black backgrounds, frames split
    over the ranks of ``group`` (the default group when None; one process
    without one).  Returns this rank's block of the (2C, H, W, 3) float32
    frames in the Trainer's order (all whites, then all blacks), or all 2C
    frames with ``gather``.  Ranks past the largest divisor of 2C render
    nothing.  With no model the reference renders black
    (src/rtx/RtxHost.cpp:220): zeros, no rank renders."""
    f = 2 * len(cameras)
    distributed = dist.is_initialized()
    world = dist.get_world_size(group) if distributed else 1
    rank = dist.get_rank(group) if distributed else 0
    n = _renderers(world, f)  # the ranks that render
    k = f // n
    mine = range(rank * k, (rank + 1) * k) if rank < n else range(0)
    dev = rtx.device
    if rtx._tris is None:
        return torch.zeros((f if gather else len(mine), height, width, 3), dtype=torch.float32,
                           device=dev)
    frames = _render_block(rtx, cameras, mine, samples, width, height, seed, bounces)
    local = (torch.stack(frames) if frames
             else torch.zeros((0, height, width, 3), dtype=torch.float32, device=dev))
    if not gather or world == 1:
        return local
    if rank >= n:
        local = torch.zeros((k, height, width, 3), dtype=torch.float32, device=dev)
    return all_gather_rows(local, group)[:f]

