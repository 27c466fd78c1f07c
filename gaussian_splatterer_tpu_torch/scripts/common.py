"""What the probes share: the card check, CUDA-event timing and the bound."""

from __future__ import annotations

import statistics
import subprocess

import torch

# H100 SXM data sheet: FP32 outside the tensor cores, and HBM3
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def require_cuda() -> torch.device:
    """The card the probe measures.  A probe has no CPU mode: without a
    card it exits nonzero."""
    if not torch.cuda.is_available():
        raise SystemExit("this probe measures a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.splitlines()[0].strip()


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of fn() by CUDA events, one event pair a run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for ``ops`` operations and ``nbytes`` bytes: the
    larger of ops over the FP32 rate and bytes over the HBM rate."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
