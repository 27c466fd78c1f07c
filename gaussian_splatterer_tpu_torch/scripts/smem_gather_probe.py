"""H100 probe: a column gather from a table resident in fast memory
(counterpart of the JAX package's scripts/vmem_gather_probe.py, whose Pallas
kernels take_axis1 -> take_kernel and take_along -> tala_kernel are ported
as one kernel, csrc/smem_gather.cu).

    python -m gaussian_splatterer_tpu_torch.scripts.smem_gather_probe [--reps N]

The TPU probe asked whether a dynamic gather from a VMEM-resident table
compiles.  On one CUDA card this asks whether a gather from a table staged
in shared memory builds, runs and beats the device-memory gather: on the
reference's (16, 4096) float32 table (256 KiB, more than a block's 227 KB,
so the rows are split over blocks), with indices in both of its layouts,
(D/128, 128) and (D,), at the probe's D = 8192 and the bench's D = 2^21,
against gather_cols (csrc/gather_cols.cu), ``torch.index_select`` and the
bound.  The kernel equals its plain twin exactly.  The last line is one JSON
object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import torch

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.scripts import gather_probe
from gaussian_splatterer_tpu_torch.scripts.common import bound_ms, card, cuda_ms, require_cuda

ROWS, COLS = 16, 4096  # the reference's table
PROBE_IDS, BENCH_IDS = 8192, 1 << 21
MAX_SMEM_BYTES = 232_448  # an H100 block's dynamic shared memory, opted in

# Launches of the CUDA kernel in this process: only smem_gather's CUDA
# branch adds to it.
smem_gather_launches = 0


def split_rows(rows: int, cols: int, max_bytes: int = MAX_SMEM_BYTES) -> int:
    """Rows a block stages: the fewest row groups whose rows fit in
    ``max_bytes``, the rows shared evenly among them (16 rows of 4096 ->
    two groups of 8).  Raises when one row does not fit."""
    fit = max_bytes // (4 * cols)
    if fit < 1:
        raise ValueError(f"one row of {cols} float32 columns ({4 * cols} B) exceeds a block's "
                         f"{max_bytes} B of shared memory")
    return math.ceil(rows / math.ceil(rows / fit))


def smem_gather_reference(tab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain twin: tab[:, ids], shape (K, *ids.shape)."""
    gather_probe.check_gather_args(tab, ids)
    return tab[:, ids.long()]


def smem_gather(tab: torch.Tensor, ids: torch.Tensor,
                rows_per_block: int | None = None) -> torch.Tensor:
    """out[k, ...] = tab[k, ids[...]], (K, *ids.shape), with the table staged
    in shared memory: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors.  ``rows_per_block`` overrides split_rows; a split
    whose shared memory the card refuses raises."""
    global smem_gather_launches
    if tab.device.type == "cpu":
        return smem_gather_reference(tab, ids)
    if tab.device.type != "cuda":
        raise ValueError(f"smem_gather: unsupported device {tab.device}")
    gather_probe.check_gather_args(tab, ids)
    if not (tab.is_contiguous() and ids.is_contiguous()):
        raise ValueError("smem_gather: inputs must be contiguous")
    rows, cols = tab.shape
    out = torch.empty((rows, *ids.shape), dtype=torch.float32, device=tab.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    index = tab.device.index if tab.device.index is not None else torch.cuda.current_device()
    r = rows_per_block or split_rows(rows, cols, lib.smem_gather_max_bytes(index))
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.smem_gather(tab.data_ptr(), cols, ids.data_ptr(), out.data_ptr(), ids.numel(),
                              rows, r, stream)
    if err != 0:
        raise RuntimeError(f"smem_gather: {r} rows of {cols} columns a block "
                           f"({4 * r * cols} B of shared memory) refused or launch failed: "
                           f"cudaError_t {err}")
    smem_gather_launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("smem_gather")
    fn = lib.smem_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.smem_gather_max_bytes.argtypes = [ctypes.c_int]
    lib.smem_gather_max_bytes.restype = ctypes.c_int
    return lib


def run(device, reps: int = 20) -> dict:
    """Times at D = 8192 and 2^21 on the (16, 4096) table, both index
    layouts for the kernel, beside gather_cols and index_select; in
    milliseconds on ``device``."""
    tab, ids, _ = gather_probe.probe_inputs(device, ROWS, COLS, BENCH_IDS, seed=1)
    cases = []
    for d in (PROBE_IDS, BENCH_IDS):
        flat = ids[:d].contiguous()
        lanes = flat.view(d // 128, 128)
        b_ms, b_by = bound_ms(0, gather_probe.gather_bytes(ROWS, COLS, d))
        cases.append({
            "rows": ROWS, "cols": COLS, "ids": d,
            "rows_per_block": split_rows(ROWS, COLS),
            "kernel_ms": cuda_ms(lambda: smem_gather(tab, flat), reps=reps),
            "kernel_lanes_ms": cuda_ms(lambda: smem_gather(tab, lanes), reps=reps),
            "gather_cols_ms": cuda_ms(lambda: gather_probe.gather_cols(tab, flat), reps=reps),
            "index_select_ms": cuda_ms(lambda: torch.index_select(tab, 1, flat), reps=reps),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    return {"cases": cases}


def report(out: dict, name: str) -> None:
    for c in out["cases"]:
        print(f"({c['rows']}, {c['cols']}) table in shared memory, {c['rows_per_block']} rows a "
              f"block, {c['ids']} ids: kernel {c['kernel_ms']:.4f} ms ((D/128, 128) ids "
              f"{c['kernel_lanes_ms']:.4f} ms)  gather_cols {c['gather_cols_ms']:.4f} ms  "
              f"index_select {c['index_select_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']})  [{name}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    tab, ids, _ = gather_probe.probe_inputs(dev, ROWS, COLS, PROBE_IDS, seed=1)
    exact = all(bool(torch.equal(smem_gather(tab, x), smem_gather_reference(tab, x)))
                for x in (ids, ids.view(-1, 128)))
    out = run(dev, args.reps)
    report(out, name)
    print(f"kernel equals its plain twin in both index layouts: {exact}")
    print(json.dumps(dict(out, card=name, exact=exact)))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
