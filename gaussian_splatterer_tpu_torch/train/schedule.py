"""Auto-training schedule: the headless equivalent of the reference UI loop
(counterpart of gaussian_splatterer_tpu.train.schedule).

The reference drives training from the wx idle handler (src/ui/UiFrame.cpp:
266-298): BEFORE the step it checks the current iteration counter: every
``intervalCapture`` iterations it randomizes all rig rotations and
re-captures truth, and every ``intervalDensify`` iterations the step runs
with densification.  The reference's rate limit (AUTO_TRAIN_BUDGET steps/s)
only keeps its UI responsive; this loop runs unthrottled.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

import torch

from gaussian_splatterer_tpu_torch.train.trainer import Trainer, randomize_rig_rotations


def auto_train(
    trainer: Trainer,
    rtx,
    num_steps: int,
    rng: Optional[random.Random] = None,
    on_step: Optional[Callable[[int, object], None]] = None,
    capture_devices=None,
) -> dict:
    """Run ``num_steps`` auto-training iterations, capturing truth first if
    the trainer has none.  Returns the wall-clock split: total seconds,
    capture seconds and their share, and the number of re-captures.

    ``capture_devices`` splits every (re)capture's frames: a count > 1 over
    the ranks of the process group, a list of devices over those devices
    in this process (Trainer.capture_truths, parallel/capture.py).  On a sharded
    trainer every rank runs this loop; each recapture's randomized rig is
    rank 0's."""

    def _fenced_capture():
        """Capture, then wait for the device, so that the capture's device
        time counts as capture."""
        t0 = time.perf_counter()
        if capture_devices is not None:
            trainer.capture_truths(rtx, devices=capture_devices)
        else:
            trainer.capture_truths(rtx)
        if trainer.truths.is_cuda:
            torch.cuda.synchronize(trainer.truths.device)
        return time.perf_counter() - t0

    p = trainer.project
    capture_s = 0.0
    t_start = time.perf_counter()
    recaptures = 0
    if trainer.truths is None:
        capture_s += _fenced_capture()
    for _ in range(num_steps):
        capture = p.intervalCapture > 0 and p.iterations % p.intervalCapture == 0
        densify_now = p.intervalDensify > 0 and p.iterations % p.intervalDensify == 0
        if capture and p.iterations > 0:
            randomize_rig_rotations(p, rng)
            trainer.share_rig()
            capture_s += _fenced_capture()
            recaptures += 1
        metrics = trainer.train(densify_now=densify_now)
        if on_step is not None:
            on_step(p.iterations, metrics)
    total_s = time.perf_counter() - t_start
    return {
        "total_s": round(total_s, 2),
        "capture_s": round(capture_s, 2),
        "capture_frac": round(capture_s / max(total_s, 1e-9), 4),
        "recaptures": recaptures,
    }
