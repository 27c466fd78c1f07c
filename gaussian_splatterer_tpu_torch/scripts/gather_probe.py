"""H100 probe: the feature column gather at the bench scale (counterpart of
the JAX package's scripts/gather_probe.py, whose Pallas kernel
take_pallas -> take_kernel is ported as csrc/gather_cols.cu).

    python -m gaussian_splatterer_tpu_torch.scripts.gather_probe [--reps N]

On one CUDA card, for a float32 table of 9 real rows (and the reference's
16, sublane-padded) by 2^19 columns and 2^21 int32 indices, random and
sorted, it times ``gather_cols`` (the kernel), ``torch.index_select(tab, 1,
ids)``, the row-major ``tab_rows[ids]`` and the bound (indices in, the table
once, the output out, over 3.35 TB/s); then, as context, the reference's
other candidates as plain PyTorch calls (a key sort with nine payload
gathers, the key sort alone, six cummaxes).  The kernel equals its plain
twin exactly.  The last line is one JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.scripts.common import bound_ms, card, cuda_ms, require_cuda

COLS, IDS = 1 << 19, 1 << 21  # F * N columns and F * max_dup indices at the bench scale
ROWS, PADDED_ROWS = 9, 16  # the nine feature rows; the reference's (16, N) table

# Launches of the CUDA gather in this process: only gather_cols's CUDA
# branch adds to it.
gather_cols_launches = 0


def check_gather_args(tab: torch.Tensor, ids: torch.Tensor) -> None:
    if tab.dtype != torch.float32 or tab.dim() != 2:
        raise ValueError(f"tab must be (K, N) float32, got {tuple(tab.shape)} {tab.dtype}")
    if ids.dtype != torch.int32 or ids.device != tab.device:
        raise ValueError(f"ids must be int32 on {tab.device}, got {ids.dtype} on {ids.device}")


def gather_cols_reference(tab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain twin: tab[:, ids], shape (K, *ids.shape)."""
    check_gather_args(tab, ids)
    return tab[:, ids.long()]


def gather_cols(tab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[k, j] = tab[k, ids[j]], (K, *ids.shape): the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors.  On the card an index outside
    [0, N) gives NaN there."""
    global gather_cols_launches
    if tab.device.type == "cpu":
        return gather_cols_reference(tab, ids)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_cols: unsupported device {tab.device}")
    check_gather_args(tab, ids)
    if not (tab.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_cols: inputs must be contiguous")
    out = torch.empty((tab.shape[0], *ids.shape), dtype=torch.float32, device=tab.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.gather_cols(tab.data_ptr(), tab.shape[1], ids.data_ptr(), out.data_ptr(),
                              ids.numel(), tab.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"gather_cols kernel launch failed: cudaError_t {err}")
    gather_cols_launches += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("gather_cols")
    fn = lib.gather_cols
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gather_bytes(rows: int, cols: int, n_ids: int) -> int:
    """Indices in, the table once, the output out."""
    return 4 * n_ids + 4 * rows * cols + 4 * rows * n_ids


def l2_sector_bytes(rows: int, n_ids: int) -> int:
    """L2 traffic of the table reads on random indices: one 32-byte sector
    for every (row, index), since the rows lie far apart and neighbouring
    indices rarely share a sector.  Not part of the bound."""
    return 32 * rows * n_ids


def probe_inputs(device, rows: int = PADDED_ROWS, cols: int = COLS, n_ids: int = IDS,
                 seed: int = 0):
    """(table (rows, cols) float32, random ids, the same ids sorted), made
    with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, cols, n_ids).astype(np.int32)).to(device)
    return tab, ids, torch.sort(ids).values


def run(device, reps: int = 20) -> dict:
    """Times of the kernel and the library calls at the bench scale: a
    case for each of 9 and 16 rows and random and sorted ids, then the
    context timings.  Every number is in milliseconds on ``device``."""
    tab16, ids, ids_sorted = probe_inputs(device, PADDED_ROWS, COLS, IDS)
    cases = []
    for rows in (ROWS, PADDED_ROWS):
        tab = tab16[:rows].contiguous()
        tab_rows = tab.t().contiguous()
        b_ms, b_by = bound_ms(0, gather_bytes(rows, COLS, IDS))
        for order, idx in (("random", ids), ("sorted", ids_sorted)):
            idx64 = idx.long()
            cases.append({
                "rows": rows, "cols": COLS, "ids": IDS, "order": order,
                "kernel_ms": cuda_ms(lambda: gather_cols(tab, idx), reps=reps),
                "index_select_ms": cuda_ms(lambda: torch.index_select(tab, 1, idx), reps=reps),
                "rows_major_ms": cuda_ms(lambda: tab_rows[idx64], reps=reps),
                "bound_ms": b_ms, "bound_by": b_by,
            })
    pay = [tab16[k, :IDS // 8].repeat(8) for k in range(ROWS)]

    def sort_payload():  # a key sort carrying nine payloads: the sort, nine gathers
        order = torch.sort(ids, stable=True).indices
        return [p[order] for p in pay]

    context = {
        "sort_payload_ms": cuda_ms(sort_payload, reps=reps),
        "key_sort_only_ms": cuda_ms(lambda: torch.sort(ids, stable=True), reps=reps),
        "cummax_6x_ms": cuda_ms(lambda: [torch.cummax(ids + k, 0) for k in range(6)], reps=reps),
    }
    return {"cases": cases, "context": context}


def report(out: dict, name: str) -> None:
    for c in out["cases"]:
        l2 = ""
        if c["order"] == "random":
            sectors = l2_sector_bytes(c["rows"], c["ids"])
            l2 = (f"  L2 sectors {sectors / 1e6:.1f} MB, {sectors / c['kernel_ms'] / 1e9:.3f} "
                  f"TB/s at the kernel's time")
        print(f"{c['rows']} x {c['cols']} table, {c['ids']} {c['order']} ids: kernel "
              f"{c['kernel_ms']:.4f} ms  index_select {c['index_select_ms']:.4f} ms  "
              f"(N, K)[ids] {c['rows_major_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}){l2}  [{name}]")
    print("context (plain PyTorch): " + "  ".join(
        f"{k} {v:.4f}" for k, v in out["context"].items()) + f"  [{name}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    tab, ids, _ = probe_inputs(dev)
    exact = bool(torch.equal(gather_cols(tab, ids), gather_cols_reference(tab, ids)))
    out = run(dev, args.reps)
    report(out, name)
    print(f"kernel equals its plain twin: {exact}")
    print(json.dumps(dict(out, card=name, exact=exact)))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
