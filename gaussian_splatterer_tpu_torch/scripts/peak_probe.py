"""H100 probe: measured FP32, exp and log rates beside the data sheet's
(counterpart of the JAX package's scripts/peak_probe.py, whose Pallas kernel
run -> kern is ported as csrc/peak_fma.cu).

    python -m gaussian_splatterer_tpu_torch.scripts.peak_probe [--reps N]

On one CUDA card it runs each form of the kernel (see csrc/peak_fma.cu):

  * at the reference's shape, (256, 1024, 256), with its chain lengths (64
    FMAs; 16 exps or logs).  64 FMAs an element are 16 FLOP a byte, under
    the FP32 ridge of 67e12 / 3.35e12 = 20: this shape measures device
    memory, and the script says so (the exp and log chains there are held
    against the ridge of their own measured resident rate);
  * register-resident: 2^22 elements with chains thousands of steps long
    (the length read at run time), one output an element; exp is timed as
    expf (what the compositors call) and as __expf;

then runs the resident ILP FMA form back to back for about two seconds,
whose sustained rate is the card's measured FP32 peak, with the SM clock
and the power sampled by nvidia-smi beside it, and times, as plain PyTorch
context,
the reference's XLA probes: dependent FMA (Horner) and exp chains, and
4096^3 matrix products in float32 (TF32 off) and bf16.  The published
67 TFLOP/s assumes about 1.98 GHz on 132 SMs x 128 lanes.  The last line is
one JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.scripts.common import (
    FP32_OPS_PER_S, HBM_BYTES_PER_S, bound_ms, card, cuda_ms, require_cuda,
)

# form -> (kernel code, what a step counts as, operations a step)
FORMS = {
    "fma": (0, "FLOP", 2), "fma_ilp": (1, "FLOP", 2), "exp": (2, "exp", 1),
    "exp_ilp": (3, "exp", 1), "fast_exp_ilp": (4, "exp", 1), "log": (5, "log", 1),
    "exp_bf16": (6, "exp", 1), "log_bf16": (7, "log", 1),
}
REFERENCE_SHAPE = (256, 1024, 256)  # the reference's (G, P, C)
REFERENCE_RUNS = (("fma", 64), ("fma_ilp", 64), ("exp", 16), ("exp_ilp", 16), ("log", 16),
                  ("exp_bf16", 16), ("log_bf16", 16))
RESIDENT_N = 1 << 22
RESIDENT_RUNS = (("fma", 4096), ("fma_ilp", 4096), ("exp_ilp", 1024), ("fast_exp_ilp", 1024),
                 ("log", 1024), ("exp_bf16", 256), ("log_bf16", 256))
WINDOW_S = 2.0
PEAK_FORM = ("fma_ilp", 4096)  # the resident form whose sustained rate is the FP32 peak
RIDGE_FORMS = {"exp": "exp_ilp"}  # the resident form whose rate sets a reference form's ridge

# Launches of the CUDA kernel in this process: only peak's CUDA branch adds
# to it.
peak_launches = 0


def _check(x, form, kk):
    if form not in FORMS:
        raise ValueError(f"form {form!r} is not one of {tuple(FORMS)}")
    want = _dtype(form)
    if x.dtype != want:
        raise ValueError(f"form {form} takes {want}, got {x.dtype}")
    ilp = {"fma_ilp": 8, "exp_ilp": 4, "fast_exp_ilp": 4}.get(form, 1)
    if kk < 0 or kk % ilp:
        raise ValueError(f"kk {kk} must be a nonnegative multiple of {ilp} for {form}")


def peak_reference(x: torch.Tensor, form: str, kk: int) -> torch.Tensor:
    """Plain twin: the form's chain written out in PyTorch, elementwise."""
    _check(x, form, kk)
    y = x
    if form == "fma":
        for _ in range(kk):
            y = y * x + 0.3
    elif form == "fma_ilp":
        acc = [y * (0.9 + 0.01 * i) for i in range(8)]
        for _ in range(kk // 8):
            acc = [a * x + 0.3 for a in acc]
        y = acc[0]
        for a in acc[1:]:
            y = y + a
    elif form in ("exp_ilp", "fast_exp_ilp"):
        acc = [y * (0.9 + 0.01 * i) for i in range(4)]
        for _ in range(kk // 4):
            acc = [torch.exp(-a) * 0.5 for a in acc]
        y = acc[0] + acc[1] + acc[2] + acc[3]
    elif form in ("exp", "exp_bf16"):
        for _ in range(kk):
            y = torch.exp(-y) * 0.5
    else:
        for _ in range(kk):
            y = torch.log(y * 0.5 + 1.5)
    return y


def peak(x: torch.Tensor, form: str, kk: int) -> torch.Tensor:
    """The form's chain of ``kk`` steps on every element: the CUDA kernel
    for CUDA tensors, the plain twin for CPU tensors."""
    global peak_launches
    if x.device.type == "cpu":
        return peak_reference(x, form, kk)
    if x.device.type != "cuda":
        raise ValueError(f"peak: unsupported device {x.device}")
    _check(x, form, kk)
    if not x.is_contiguous():
        raise ValueError("peak: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.peak_run(x.data_ptr(), y.data_ptr(), x.numel(), FORMS[form][0], kk, stream)
    if err != 0:
        raise RuntimeError(f"peak kernel launch failed: cudaError_t {err}")
    peak_launches += 1
    return y


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("peak_fma")
    fn = lib.peak_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ops(form: str, kk: int, n: int) -> float:
    """Operations the chain does on n elements (an FMA counts two)."""
    ilp = {"fma_ilp": 8, "exp_ilp": 4, "fast_exp_ilp": 4}.get(form, 1)
    return float(FORMS[form][2] * (kk // ilp) * ilp * n)


def _dtype(form: str) -> torch.dtype:
    return torch.bfloat16 if form.endswith("bf16") else torch.float32


def probe_input(shape, form: str, device, seed: int = 0) -> torch.Tensor:
    """Uniform [0.5, 0.6) elements, the reference's, made with numpy, in
    the form's type."""
    x = np.random.default_rng(seed).uniform(0.5, 0.6, shape).astype(np.float32)
    return torch.from_numpy(x).to(device).to(_dtype(form))


def _measure(x, form, kk, reps):
    ms = cuda_ms(lambda: peak(x, form, kk), reps=reps)
    n = x.numel()
    nbytes = 2 * x.element_size() * n
    b_ms, b_by = bound_ms(ops(form, kk, n), nbytes)
    return {"form": form, "kk": kk, "shape": list(x.shape), "unit": FORMS[form][1],
            "ms": ms, "rate_per_s": ops(form, kk, n) / (ms * 1e-3),
            "bytes_per_s": nbytes / (ms * 1e-3), "ops_per_byte": ops(form, kk, n) / nbytes,
            "bound_ms": b_ms, "bound_by": b_by}


def sample_clocks(fn) -> dict:
    """SM clock (MHz), power draw and limit (W) that nvidia-smi samples every
    100 ms while fn() runs; medians, or "not measured" without samples."""
    cmd = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
           "--format=csv,noheader,nounits", "-lms", "100"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        fn()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return {"samples": 0, "sm_clock_mhz": "not measured", "power_w": "not measured",
                "power_limit_w": "not measured"}
    clock, power, limit = (statistics.median(col) for col in zip(*rows))
    return {"samples": len(rows), "sm_clock_mhz": clock, "power_w": power,
            "power_limit_w": limit, "sm_clock_min_mhz": min(r[0] for r in rows)}


def window(device, seconds: float = WINDOW_S) -> dict:
    """The resident ILP FMA form launched back to back for about
    ``seconds``: its sustained rate, with the clock and power beside it."""
    form, kk = PEAK_FORM
    x = probe_input((RESIDENT_N,), form, device, seed=1)
    launches = max(1, int(seconds * 1e3 / cuda_ms(lambda: peak(x, form, kk), reps=3)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def body():
        start.record()
        for _ in range(launches):
            peak(x, form, kk)
        end.record()
        torch.cuda.synchronize()

    clocks = sample_clocks(body)
    ms = start.elapsed_time(end)
    return dict(clocks, form=form, kk=kk, launches=launches, ms=ms,
                rate_per_s=launches * ops(form, kk, RESIDENT_N) / (ms * 1e-3))


def context(device, reps: int) -> dict:
    """The reference's XLA probes as plain PyTorch timings: FMA (Horner)
    and exp chains on 2048^2 elements, and 4096^3 products."""
    x = probe_input((2048 * 2048,), "fma", device)
    out = {}
    out["horner_256_tflops"] = 2.0 * 256 * x.numel() / (cuda_ms(
        lambda: peak_reference(x, "fma", 256), warmup=1, reps=3) * 1e-3) / 1e12
    out["exp_chain_32_texp_s"] = 32.0 * x.numel() / (cuda_ms(
        lambda: peak_reference(x * 0.001, "exp", 32), warmup=1, reps=3) * 1e-3) / 1e12
    g = torch.Generator(device=device).manual_seed(0)
    a, b = (torch.randn((4096, 4096), generator=g, device=device) for _ in range(2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["mm_fp32_tflops"] = 2.0 * 4096**3 / (cuda_ms(lambda: a @ b, reps=reps) * 1e-3) / 1e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ab, bb = a.bfloat16(), b.bfloat16()
    out["mm_bf16_tflops"] = 2.0 * 4096**3 / (cuda_ms(lambda: ab @ bb, reps=reps) * 1e-3) / 1e12
    return out


def run(device, reps: int = 10) -> dict:
    """Every form at the reference's shape and register-resident, the
    sustained window with clock and power, and the context timings."""
    out = {}
    for key, shape, runs, seed in (("reference", REFERENCE_SHAPE, REFERENCE_RUNS, 0),
                                   ("resident", (RESIDENT_N,), RESIDENT_RUNS, 1)):
        x = probe_input(shape, "fma", device, seed)
        inputs = {torch.float32: x, torch.bfloat16: x.bfloat16()}
        out[key] = [_measure(inputs[_dtype(form)], form, kk, reps) for form, kk in runs]
    return dict(out, window=window(device), context=context(device, reps))


def fp32_rate(results: dict) -> float:
    """The measured FP32 peak (FLOP/s): the resident ILP FMA form's
    sustained rate over the window, launched back to back."""
    return results["window"]["rate_per_s"]


def _ridge(results: dict, r: dict) -> tuple[float, str]:
    """(operations a byte where a reference-shape form stops being
    memory-bound, what sets it): the published FP32 rate for FMAs; for exp
    and log the measured resident rate of the same kind and type."""
    if r["unit"] == "FLOP":
        return FP32_OPS_PER_S / HBM_BYTES_PER_S, "the published FP32 rate"
    form = RIDGE_FORMS.get(r["form"], r["form"])
    rate = next(x["rate_per_s"] for x in results["resident"] if x["form"] == form)
    return rate / HBM_BYTES_PER_S, f"the measured resident {form} rate"


def report(results: dict, name: str) -> None:
    for r in results["reference"]:
        ridge, by = _ridge(results, r)
        note = (f"memory-bound: {r['ops_per_byte']:.1f} operations a byte, under the ridge "
                f"{ridge:.1f} of {by}" if r["ops_per_byte"] < ridge else
                f"bound by its unit: {r['ops_per_byte']:.1f} operations a byte, over the ridge "
                f"{ridge:.1f} of {by}")
        print(f"reference shape {tuple(r['shape'])}, {r['form']} x {r['kk']}: {r['ms']:.4f} ms  "
              f"{r['rate_per_s'] / 1e12:.3f} T{r['unit']}/s  {r['bytes_per_s'] / 1e12:.3f} TB/s "
              f"of {HBM_BYTES_PER_S / 1e12} ({note})  [{name}]")
    for r in results["resident"]:
        share = (f", {r['rate_per_s'] / FP32_OPS_PER_S:.3f} of the published "
                 f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s" if r["unit"] == "FLOP" else "")
        print(f"register-resident {r['shape'][0]} elements, {r['form']} x {r['kk']}: "
              f"{r['ms']:.4f} ms  {r['rate_per_s'] / 1e12:.3f} T{r['unit']}/s{share}  [{name}]")
    w = results["window"]
    print(f"sustained {w['form']} x {w['kk']}, {w['launches']} launches in {w['ms']:.1f} ms: "
          f"{w['rate_per_s'] / 1e12:.3f} TFLOP/s; nvidia-smi ({w['samples']} samples): SM clock "
          f"{w['sm_clock_mhz']} MHz, power {w['power_w']} W of {w['power_limit_w']} W  [{name}]")
    print("context (plain PyTorch): " + "  ".join(
        f"{k} {v:.3f}" for k, v in results["context"].items()) + f"  [{name}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    results = run(dev, args.reps)
    report(results, name)
    print(json.dumps(dict(results, card=name)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
