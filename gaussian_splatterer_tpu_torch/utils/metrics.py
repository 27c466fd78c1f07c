"""Training observability: loss, PSNR, throughput (counterpart of
gaussian_splatterer_tpu.utils.metrics, without SSIM yet).

``mse`` and ``psnr`` take tensors or numpy arrays and return 0-d float32
tensors on the inputs' device.  ``MetricsLogger`` keeps a step history and
optionally writes one JSON line per logged step.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Optional, TextIO

import numpy as np
import torch


def mse(a, b) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return torch.mean((a - b) ** 2)


def psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse(a, b), min=1e-12))


@dataclass
class StepLog:
    iteration: int
    loss: float
    splat_count: int
    steps_per_s: float
    psnr: Optional[float] = None
    extra: dict[str, Any] = field(default_factory=dict)


class MetricsLogger:
    """JSONL step logger with wall-clock throughput.  Only every
    ``log_every``-th iteration is recorded, and only then is the loss read,
    so the training loop does not wait on the device to log."""

    def __init__(self, file: Optional[TextIO] = None, log_every: int = 10):
        self.file = file
        self.log_every = log_every
        self._t_last = time.perf_counter()
        self._steps_since = 0
        self.history: list[StepLog] = []

    def log_step(self, iteration: int, loss, splat_count: int, **extra) -> None:
        self._steps_since += 1
        if iteration % self.log_every:
            return
        now = time.perf_counter()
        rate = self._steps_since / max(now - self._t_last, 1e-9)
        self._t_last, self._steps_since = now, 0
        entry = StepLog(
            iteration=iteration,
            loss=float(loss),
            splat_count=int(splat_count),
            steps_per_s=float(rate),
            psnr=float(extra.pop("psnr")) if "psnr" in extra else None,
            extra={k: _tofloat(v) for k, v in extra.items()},
        )
        self.history.append(entry)
        if self.file is not None:
            rec = {"iteration": entry.iteration, "loss": entry.loss,
                   "splats": entry.splat_count, "steps_per_s": entry.steps_per_s}
            if entry.psnr is not None:
                rec["psnr"] = entry.psnr
            rec.update(entry.extra)
            self.file.write(json.dumps(rec) + "\n")
            self.file.flush()


def _tofloat(v):
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return float(v)
    return v
