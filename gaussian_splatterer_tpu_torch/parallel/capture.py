"""Camera-data-parallel truth capture: the path tracer's frames split over
the ranks (counterpart of gaussian_splatterer_tpu.parallel.capture).

The reference re-captures every truth view every ``intervalCapture``
iterations (src/ui/UiFrame.cpp:283-298).  Frames are independent, so the
2C frames of a capture (every camera against white, then every camera
against black: src/Trainer.cu:218-250) are split over the ranks, each
rendering its contiguous block with ``RtxHost.render``.

Frame i draws from a generator seeded with ``frame_seed(seed, i)``, a
function of the capture's seed and the frame's index only, never of the
rank: any number of ranks, and a serial ``RtxHost.render(..., seed=
frame_seed(seed, i))`` of each frame, give the same frames bit for bit.
JAX's ``fold_in(PRNGKey(seed), i)`` streams cannot be reproduced with
torch generators, so against the JAX package the frames agree in
distribution, and exactly only where a scene leaves nothing to chance.
"""

from __future__ import annotations

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
    c = len(cameras)
    f = 2 * c
    distributed = dist.is_initialized()
    world = dist.get_world_size(group) if distributed else 1
    rank = dist.get_rank(group) if distributed else 0
    n = max(1, min(world, f))  # the ranks that render: the largest divisor of 2C
    while f % n:
        n -= 1
    k = f // n
    mine = range(rank * k, (rank + 1) * k) if rank < n else range(0)
    dev = rtx.device
    if rtx._tris is None:
        return torch.zeros((f if gather else len(mine), height, width, 3), dtype=torch.float32,
                           device=dev)
    frames = [rtx.render(cameras[i % c], (1.0, 1.0, 1.0) if i < c else (0.0, 0.0, 0.0),
                         samples, width, height, bounces=bounces, seed=frame_seed(seed, i))
              for i in mine]
    local = (torch.stack(frames) if frames
             else torch.zeros((0, height, width, 3), dtype=torch.float32, device=dev))
    if not gather or world == 1:
        return local
    if rank >= n:
        local = torch.zeros((k, height, width, 3), dtype=torch.float32, device=dev)
    return all_gather_rows(local, group)[:f]

