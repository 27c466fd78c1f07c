"""Training observability: loss, PSNR, SSIM, throughput (counterpart of
gaussian_splatterer_tpu.utils.metrics).

``mse``, ``psnr`` and ``ssim`` take tensors or numpy arrays and return 0-d
float32 tensors on the first input's device.  ``ssim`` blurs with float32
multiply-adds of shifted slices, not a convolution: cuDNN may run a
convolution in TF32, which the parity with the JAX package's float32
convolution would not survive.  ``MetricsLogger`` keeps a step history and
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


def _blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian filter of (C, H, W) with the window ``g``,
    "valid" padding: (C, H - w + 1, W - w + 1)."""
    win = g.shape[0]
    for dim in (1, 2):
        n = x.shape[dim] - win + 1
        out = g[0] * x.narrow(dim, 0, n)
        for k in range(1, win):
            out = out + g[k] * x.narrow(dim, k, n)
        x = out
    return x


def ssim(a, b, max_val: float = 1.0, win: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) with the standard 11-tap
    Gaussian window, sigma 1.5, valid padding, C1 = 0.01^2, C2 = 0.03^2.
    a, b: (H, W, 3) in [0, max_val]."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    a = torch.movedim(a / max_val, -1, 0)
    b = torch.movedim(b / max_val, -1, 0)
    r = torch.arange(win, dtype=torch.float32, device=a.device) - (win - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / torch.sum(g)
    c1 = 0.01**2
    c2 = 0.03**2
    mu_a, mu_b = _blur(a, g), _blur(b, g)
    var_a = _blur(a * a, g) - mu_a * mu_a
    var_b = _blur(b * b, g) - mu_b * mu_b
    cov = _blur(a * b, g) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


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
