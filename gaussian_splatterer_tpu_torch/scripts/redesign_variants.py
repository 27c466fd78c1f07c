"""Design variants of the compositors (csrc/composite_fwd.cu K1,
csrc/composite_bwd.cu K2, csrc/composite_train.cu K3), the per-frame scan
(csrc/cumsum_frames.cu K4), the shared-memory gather (csrc/smem_gather.cu
K6) and the culled intersector (csrc/mt_culled.cu K9), each with one part
of its design taken out or changed, timed beside the shipped kernel on one
card.

    python -m gaussian_splatterer_tpu_torch.scripts.redesign_variants [--only k1|k2|k3|k4|k6|k9]

A variant is the shipped source, its local headers inlined
(composite_common.cuh for the compositors), with the edits of K1_VARIANTS,
K2_VARIANTS, K3_VARIANTS, K4_VARIANTS or K6_VARIANTS, or a whole source of
its own (K4's earlier three-pass design, variants/cumsum_frames_three_pass.cu),
built by nvcc into build/variants/
and called through the shipped wrapper (its library swapped in for the
call), so every variant takes the same inputs and checks: K1 on the three
serve cells of chip_smoke.py's phase 4 (50k splats at 1024^2 and 2048^2,
262,144 at 2048^2), equal to its plain twin; K2 on chip_smoke.k2_frame (one
1000^2 frame of the bench scene), held against the plain twin at phase
13's full-size gate; K3 on one launch of chip_smoke.py's fused train cell
(phase 7: the bench scene trained for TRAIN_STEPS steps, 8 frames at
1024^2), held against the plain twin at phase 7's full-size gate; K4 on
chip_smoke.k4_input (a synthetic (9, 8, 202,689) group), held to phase 15's
gate shapes and its full-size rule, launches bit-equal; K6 on the (16, 4096)
table at D = 2^21, at 8 and 4 rows a block, equal to its plain twin; K9 on
the mesh-res 256 mushroom (chip_smoke.K9_MESH) at 2^10, 2^13, 2^16 and 2^20
bounce rays and on a primary batch, and on the mesh-res 1024 one
(K9_BIG_MESH) at 2^16 bounce rays and a primary batch, equal to its plain
twin bit for bit, and the 32-sample 1024^2 capture frame at both meshes
(chip_smoke.culled_frame_s, two rounds): the shipped chunk-binned kernel,
its slices never split over threads, group boxes of 8 and 32 chunks and one
group (K9_GROUPS, tables remade by tracer.with_groups), the first design
(variants/mt_culled_thread_per_ray.cu, first_design_intersect) and the first design on rays
reordered by their first chunk (design 2, the reorder timed with it).
Times are CUDA-event medians of 20 launches (K4 and K9: the device time of
one call, chip_smoke.queued_ms; K9's reorder: events around one call) in
ROUNDS rounds, the variants in alternating orders.
Needs a card and nvcc; the last line is one JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import random
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.scripts.common import card, cuda_ms, require_cuda

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "variants"
ROUNDS = 4

_REDUCE9 = """  float a[5], b[3], c[2], d[1];
  scatter_step<5, 9>(g, a, lane, 16);
  scatter_step<3, 5>(a, b, lane, 8);
  scatter_step<2, 3>(b, c, lane, 4);
  scatter_step<1, 2>(c, d, lane, 2);
  return d[0] + __shfl_xor_sync(kFull, d[0], 1);
"""
_REDUCE45 = """  const int row = reduced_row(lane);
  float out = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = g[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (r == row) out = v;
  }
  return out;
"""
_KFULL = "constexpr unsigned kFull = 0xffffffffu;\n"
_NO_SKIP = [("store_splat(st, v, warp_mask(bx, x0, x1, y0, rows_w, nwarps));",
             "(void)bx;\n  store_splat(st, v, 0xffffffffu);")]
_NO_FMA = [("fmaf(", "mad_rn("),
           (_KFULL, _KFULL + "__device__ __forceinline__ float mad_rn(float a, float b, "
                             "float c) { return __fadd_rn(__fmul_rn(a, b), c); }\n")]


def _blocks(n: int, shipped: int = 4):
    return [(f"constexpr int kMinBlocks = {shipped};", f"constexpr int kMinBlocks = {n};")]


# (old, new) edits of the shipped source, its headers inlined; each must apply
K1_VARIANTS = {
    "shipped": [],
    "no footprint skip": _NO_SKIP,
    "2 blocks an SM": _blocks(2),
    "3 blocks an SM": _blocks(3),
    "5 blocks an SM": _blocks(5),
    "8 blocks an SM": _blocks(8),
    "batches of 32": [("constexpr int kBatch = 256;", "constexpr int kBatch = 32;")],
    "batches of 64": [("constexpr int kBatch = 256;", "constexpr int kBatch = 64;")],
    "batches of 128": [("constexpr int kBatch = 256;", "constexpr int kBatch = 128;")],
}
K2_VARIANTS = {
    "shipped": [],
    "no footprint skip": _NO_SKIP,
    "45-shuffle reduction": [(_REDUCE9, _REDUCE45)],
    "no FMA": _NO_FMA,
    "2 blocks an SM": _blocks(2, 3),
    "4 blocks an SM": _blocks(4, 3),
    "5 blocks an SM": _blocks(5, 3),
    "batches of 32": [("constexpr int kBatch = 64;", "constexpr int kBatch = 32;")],
    "batches of 128": [("constexpr int kBatch = 64;", "constexpr int kBatch = 128;")],
}
K3_VARIANTS = {
    "shipped": [],
    "no footprint skip": _NO_SKIP,
    "45-shuffle reduction": [(_REDUCE9, _REDUCE45)],
    "no FMA": _NO_FMA,
    "3 blocks an SM": _blocks(3),
    "2 blocks an SM": _blocks(2),
    "5 blocks an SM": _blocks(5),
    "pass-2 batches of 32": [("constexpr int kBatch2 = 64;", "constexpr int kBatch2 = 32;")],
    "3 blocks an SM, pass-2 batches of 32": [
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;"),
        ("constexpr int kBatch2 = 64;", "constexpr int kBatch2 = 32;")],
    "row skip": [  # a warp also skips the rows of its patch outside the box's y-range
        ("float mx, my, ca, cb, cc, r, g, b, op;", "float mx, my, ca, cb, cc, r, g, b, op, ylo, yhi;"),
        ("q1.x, q1.y, q1.z, q1.w, q2.x};", "q1.x, q1.y, q1.z, q1.w, q2.x, q2.z, q2.w};"),
        ("  store_splat(st, v, warp_mask(bx, x0, x1, y0, rows_w, nwarps));\n",
         "  store_splat(st, v, warp_mask(bx, x0, x1, y0, rows_w, nwarps));\n"
         "  st[2].z = bx.ylo;\n  st[2].w = bx.yhi;\n"),
        ("        if (done & (1u << k)) continue;\n",
         "        if (done & (1u << k)) continue;\n"
         "        if (py0 + static_cast<float>(k) < s.ylo || py0 + static_cast<float>(k) > s.yhi) "
         "continue;\n")],
}
# the block's rows brought in by the copy engine (one cp.async.bulk on an
# mbarrier) in place of the staging loop; only for a 16-byte aligned table
# whose rows are 16-byte multiples, as the probe's is
_BULK_STAGE = """
__device__ __forceinline__ void bulk_stage(float* stage, const float* src, int n) {
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(4u * n) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(stage))), "l"(src), "r"(4u * n),
           "r"(b) : "memory");
  }
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {  // a copy that never lands traps
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
                 "selp.u32 %0, 1, 0, p; }" : "=r"(done) : "r"(b) : "memory");
    if (tries == (1u << 27)) __trap();
  }
}
"""
_STAGE_LOOP = """    for (int i = threadIdx.x; i < nr * cols; i += kThreads) stage[i] = src[i];
    __syncthreads();
"""
K6_VARIANTS = {
    "shipped": [],
    "512 threads": [("constexpr int kThreads = 1024;", "constexpr int kThreads = 512;")],
    "rows staged by cp.async.bulk": [
        ("constexpr int kThreads = 1024;\n", "constexpr int kThreads = 1024;\n" + _BULK_STAGE),
        ("extern __shared__ float stage[];", "extern __shared__ __align__(16) float stage[];"),
        (_STAGE_LOOP, "    bulk_stage(stage, src, nr * cols);\n")],
    "one id a thread": [("const bool vec = (", "const bool vec = false && (")],
    "write-back stores": [("__stcs(dst4", "__stwb(dst4"), ("__stcs(dst", "__stwb(dst")],
}


def _kchunk(n: int):
    return [("constexpr int kChunk = 8192;", f"constexpr int kChunk = {n};")]


_FLOAT4_LOADS = [("constexpr bool kBulkLoad = true;", "constexpr bool kBulkLoad = false;")]
_K4_PREFIX = """  if (warp == 0) {
    const Acc p = exclusive_prefix(status, c, lane);
    if (lane == 0) s_prefix = p;
  }
"""
K4_VARIANTS = {
    "shipped": [],
    "chunks of 16384": _kchunk(16384),
    "chunks of 4096": _kchunk(4096),
    "float4 loads": _FLOAT4_LOADS,
    "chunks of 16384, float4 loads": _kchunk(16384) + _FLOAT4_LOADS,
    "float totals": [("using Acc = double;", "using Acc = float;")],
    # each chunk waits on its predecessor's inclusive prefix and publishes its own
    "chained prefix": [
        ("  __shared__ Acc s_prefix;\n", "  __shared__ Acc s_prefix, s_total;\n"),
        ("    publish(status + c, total);\n", "    s_total = total;\n"),
        ("    const Acc p = exclusive_prefix(status, c, lane);\n",
         "    const Acc p = c > 0 ? wait_total(status + c - 1) : Acc(0);\n"
         "    if (lane == 0) publish(status + c, p + s_total);\n")],
    "three passes": Path(__file__).resolve().parent / "variants" / "cumsum_frames_three_pass.cu",
    "512 threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "scan steps unrolled 8": [("#pragma unroll 4\n  for (int k = 0; k < kSteps; ++k) {",
                               "#pragma unroll 8\n  for (int k = 0; k < kSteps; ++k) {")],
    "write-back stores": [("__stcs(", "__stwb(")],
    "prefix before the scan": [  # warp 0 waits on its predecessors first
        ("  // 4. each warp's segment", _K4_PREFIX + "  // 4. each warp's segment"),
        ("  // 5. the chunk's exclusive prefix from its predecessors' totals\n" + _K4_PREFIX, "")],
}


# K9: the first design, a thread a ray (FIRST_DESIGN_SOURCE, its own C entry point:
# first_design_intersect), and the shipped chunk-binned kernel with one part of its
# design changed; the group sizes are table variants (K9_GROUPS)
_K9_SIZES = ("constexpr int kSizes = 6;", "constexpr int kSizes = 1;")
_K9_BOUNDS = "__global__ void __launch_bounds__(kThreads, 3) mt_culled_kernel"
K9_VARIANTS = {
    "shipped": [],
    "slices of 256 rays": [_K9_SIZES],
    # the first chunk-binned form: slices of 256, at most 8 threads a ray
    "slices of 256 rays, at most 8 threads a ray": [
        _K9_SIZES, ("constexpr int kMinSlots = 8;", "constexpr int kMinSlots = 32;")],
    "no split slices": [("constexpr int kMinSlots = 8;", "constexpr int kMinSlots = 256;")],
    "power-of-two slots": [("  const int slots = max(n, kMinSlots), parts = kThreads / slots;",
                            "  int slots = kMinSlots;\n  while (slots < n) slots <<= 1;\n"
                            "  const int parts = kThreads / slots;")],
    "boxes from global memory": [
        ("const int stage_boxes = stage_groups && smem + box_bytes <= room;",
         "const int stage_boxes = 0;")],
    "no register bound": [(_K9_BOUNDS, _K9_BOUNDS.replace("(kThreads, 3)", "(kThreads)"))],
    # the scan without the exit test: a group passed by the ray is scanned
    "no passed-group skip": [("if (!(box_key(bg, g, r, exit) < cand_k) || exit < last_k) continue;",
                              "if (!(box_key(bg, g, r, exit) < cand_k)) continue;")],
}
K9_GROUPS = (8, 32, 0)  # chunks a group box beside CHUNK_GROUP; 0: one group (a flat scan)
FIRST_DESIGN_SOURCE = Path(__file__).resolve().parent / "variants" / "mt_culled_thread_per_ray.cu"
_FIRST_DESIGN: dict = {}


def first_design_lib() -> ctypes.CDLL:
    """The first design of K9 (variants/mt_culled_thread_per_ray.cu), built once."""
    if "lib" not in _FIRST_DESIGN:
        lib, log = build_variants("mt_culled_thread_per_ray",
                                  {"first design": FIRST_DESIGN_SOURCE})["first design"]
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mt_culled.argtypes = [p, p, i, p, i, i, p, p, p, p, p, p, p, p, p, p, p]
        lib.mt_culled.restype = ctypes.c_int
        _FIRST_DESIGN.update(lib=lib, log=log)
    return _FIRST_DESIGN["lib"]


def ray_order(o, d, tris) -> torch.Tensor:
    """The permutation that sorts the rays by their first chunk in the
    march (the smallest (key, id); NC for a ray that enters no box),
    stable; in blocks of rays that keep the (rays, NC) key plane near 2^26
    floats."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    nc = tris["bb_minx"].numel()
    step = max(1, (1 << 26) // nc)
    first = []
    for r0 in range(0, o.shape[0], step):
        key, c = tr.chunk_keys(o[r0:r0 + step], d[r0:r0 + step], tris).min(1)
        first.append(torch.where(torch.isinf(key), torch.full_like(c, nc), c))
    return torch.sort(torch.cat(first), stable=True)[1]


def first_design_intersect(o, d, tris, tc: int, order=None):
    """K9's first design on rays o, d (outputs in the rays' order), the rays
    taken in ``order`` (a permutation, design 2: rays reordered by their
    first chunk; ``True`` computes it with ray_order) where it is given.
    Uncounted: a comparison, not the path's kernel."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    if order is True:
        order = ray_order(o, d, tris)
    if order is not None:
        o, d = o[order].contiguous(), d[order].contiguous()
    out = [torch.empty((o.shape[0],), dtype=dt, device=o.device) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32)]
    err = first_design_lib().mt_culled(o.data_ptr(), d.data_ptr(), o.shape[0], tris["tri12"].data_ptr(),
                               tris["bb_minx"].numel(), tc,
                               *(tris[k].data_ptr() for k in tr.BB_KEYS),
                               *(x.data_ptr() for x in out),
                               torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"K9's first design: cudaError_t {err}")
    if order is None:
        return out
    back = [torch.empty_like(x) for x in out]
    for x, y in zip(back, out):
        x[order] = y
    return back


# the variants of each kernel source
VARIANTS = {"composite_fwd": K1_VARIANTS, "composite_bwd": K2_VARIANTS,
            "composite_train": K3_VARIANTS, "cumsum_frames": K4_VARIANTS,
            "smem_gather": K6_VARIANTS, "mt_culled": K9_VARIANTS}


def variant_source(kernel: str, edits) -> str:
    """The text of csrc/<kernel>.cu, its local headers inlined, with
    ``edits`` applied, or the text of ``edits`` where it is a source file of
    its own; raises if an edit no longer applies."""
    if isinstance(edits, Path):
        return cuda_build.source_text(edits)
    src = cuda_build.source_text(cuda_build.CSRC_DIR / f"{kernel}.cu")
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{kernel}: the variant edit {old[:40]!r} no longer applies")
        src = src.replace(old, new)
    return src


def build_variants(kernel: str, variants: dict) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas log)}, one nvcc per variant, started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = OUT_DIR / f"{kernel}_v{i}.cu"
        src.write_text(variant_source(kernel, edits))
        lib = src.with_suffix(".so")
        jobs[name] = (lib, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {kernel} variant {name!r}:\n{err}")
        out[name] = (ctypes.CDLL(str(lib)), err)
    return out


def timed(kernel: str, libs: dict, fn, clock=cuda_ms) -> dict[str, list[float]]:
    """clock(fn) with each variant's library swapped in for ``kernel``:
    ROUNDS medians, the variants in alternating orders."""
    times: dict[str, list[float]] = {name: [] for name in libs}
    for i in range(ROUNDS):
        order = list(libs) if i % 2 == 0 else list(libs)[::-1]
        for name in order:
            cuda_build._loaded[kernel] = libs[name][0]
            times[name].append(clock(fn))
    cuda_build._loaded.pop(kernel)
    return times


def k3_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.train import CameraBatch, auto_train

    smoke = _chip_smoke()
    trainer, rtx, _ = smoke.fused_cell(dev)
    auto_train(trainer, rtx, smoke.TRAIN_STEPS, rng=random.Random(0))
    group, res = smoke.TRAIN_GROUP, smoke.TRAIN_RES
    cams = CameraBatch(*(x[:group] for x in trainer.truth_cams.twice()))
    args = smoke.launch_args(trainer.model, cams, res, res, trainer.truths[:group],
                             torch.ones((group, 3), device=dev), smoke.TRAIN_TILE,
                             trainer.runtime.max_dup)
    libs = build_variants("composite_train", K3_VARIANTS)
    out = {}
    for v, (lib, log) in libs.items():
        cuda_build._loaded["composite_train"] = lib
        got = rt.composite_train(*args)
        torch.cuda.synchronize()
        finite, r_max, r_mean, _, rel_max, rel_mean = smoke.compare_train(args, got)
        ok = (finite and r_max <= smoke.MAIN_MAX_ATOL and r_mean <= smoke.MAIN_MEAN_ATOL
              and rel_max <= smoke.MAIN_MAX_ATOL and rel_mean <= smoke.MAIN_MEAN_ATOL)
        out[v] = {"gate": ok, "max_res": r_max, "max_rel_d_feat": rel_max,
                  "blocks_per_sm": rt._train_lib().composite_train_blocks_per_sm(),
                  "ptxas": smoke.ptxas_lines(log, "composite_train_kernel")}
    cuda_build._loaded.pop("composite_train")
    for v, ms in timed("composite_train", libs, lambda: rt.composite_train(*args)).items():
        out[v]["ms"] = ms
        print(f"K3 {v}: {' / '.join(f'{t:.4f}' for t in ms)} ms a launch ({group} frames, "
              f"{args[0].shape[1]} duplicates); {out[v]['blocks_per_sm']} blocks an SM; "
              f"gate {out[v]['gate']} (max|res| {out[v]['max_res']:.3e}, d_feat "
              f"{out[v]['max_rel_d_feat']:.3e}); {'; '.join(out[v]['ptxas'])}  [{name}]",
              flush=True)
    return out


def k1_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    smoke = _chip_smoke()
    cells = smoke.serve_cells(dev)
    libs = build_variants("composite_fwd", K1_VARIANTS)
    out = {}
    for (label, size), cell in cells.items():
        ref = rt.composite_fwd_reference(*cell.composite_args)
        for v, (lib, log) in libs.items():
            cuda_build._loaded["composite_fwd"] = lib
            if not torch.equal(rt.composite_fwd(*cell.composite_args), ref):
                raise SystemExit(f"K1 variant {v!r} differs from plain at {label} {size}^2")
            out.setdefault(v, {"blocks_per_sm": lib.composite_fwd_blocks_per_sm(),
                               "ptxas": smoke.ptxas_lines(log, "composite_fwd_kernel")})
        cuda_build._loaded.pop("composite_fwd")
        for v, ms in timed("composite_fwd", libs,
                           lambda: rt.composite_fwd(*cell.composite_args)).items():
            out[v][f"{label} {size}"] = ms
            print(f"K1 {v}, {label} {size}^2: {' / '.join(f'{t:.4f}' for t in ms)} ms; "
                  f"{out[v]['blocks_per_sm']} blocks an SM; equal to plain; "
                  f"{'; '.join(out[v]['ptxas'])}  [{name}]", flush=True)
    return out


def k2_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    smoke = _chip_smoke()
    args = smoke.k2_frame(dev)
    libs = build_variants("composite_bwd", K2_VARIANTS)
    out = {}
    for v, (lib, log) in libs.items():
        cuda_build._loaded["composite_bwd"] = lib
        d_k = rt.composite_bwd(*args)
        torch.cuda.synchronize()
        finite, _, rel_max, rel_mean = smoke.compare_bwd(args, d_k)
        ok = finite and rel_max <= smoke.MAIN_MAX_ATOL and rel_mean <= smoke.MAIN_MEAN_ATOL
        out[v] = {"gate": ok, "max_rel_d_feat": rel_max,
                  "blocks_per_sm": lib.composite_bwd_blocks_per_sm(),
                  "ptxas": smoke.ptxas_lines(log, "composite_bwd_kernel")}
    cuda_build._loaded.pop("composite_bwd")
    for v, ms in timed("composite_bwd", libs, lambda: rt.composite_bwd(*args)).items():
        out[v]["ms"] = ms
        print(f"K2 {v}: {' / '.join(f'{t:.4f}' for t in ms)} ms a launch (one "
              f"{smoke.NF_RES}^2 frame, {args[0].shape[1]} duplicates); "
              f"{out[v]['blocks_per_sm']} blocks an SM; gate {out[v]['gate']} (d_feat "
              f"{out[v]['max_rel_d_feat']:.3e}); {'; '.join(out[v]['ptxas'])}  [{name}]",
              flush=True)
    return out


def k6_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.scripts import gather_probe as gp
    from gaussian_splatterer_tpu_torch.scripts import smem_gather_probe as sp

    tab, ids, _ = gp.probe_inputs(dev, sp.ROWS, sp.COLS, sp.BENCH_IDS, seed=1)
    ref = sp.smem_gather_reference(tab, ids)
    libs = build_variants("smem_gather", K6_VARIANTS)
    out = {}
    for rows in (8, 4):
        for v, (lib, _) in libs.items():
            cuda_build._loaded["smem_gather"] = lib
            if not torch.equal(sp.smem_gather(tab, ids, rows), ref):
                raise SystemExit(f"K6 variant {v!r} at {rows} rows a block differs from plain")
        for v, ms in timed("smem_gather", libs, lambda: sp.smem_gather(tab, ids, rows)).items():
            out[f"{v}, {rows} rows a block"] = ms
            print(f"K6 {v}, {rows} rows a block: {' / '.join(f'{t:.4f}' for t in ms)} ms at "
                  f"D = 2^21, equal to plain  [{name}]", flush=True)
    lib_ms = cuda_ms(lambda: torch.index_select(tab, 1, ids))
    print(f"index_select: {lib_ms:.4f} ms  [{name}]")
    return dict(out, index_select=lib_ms)


def k4_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    smoke = _chip_smoke()
    x, _ = smoke.k4_input(dev)
    libs = build_variants("cumsum_frames", K4_VARIANTS)
    out = {}
    for v, (lib, log) in libs.items():  # every variant passes the gates before it is timed
        cuda_build._loaded["cumsum_frames"] = lib
        print(f"K4 {v}: chunks of {lib.cumsum_frames_chunk()}; "
              f"{'; '.join(smoke.ptxas_lines(log, '')) or 'no ptxas lines'}  [{name}]")
        smoke.k4_gate_shapes(dev)
        smoke.k4_full_size(x, f"{v}, full size")
        out[v] = {"chunk": lib.cumsum_frames_chunk(), "ptxas": smoke.ptxas_lines(log, "")}
    cuda_build._loaded.pop("cumsum_frames")
    with torch.no_grad():
        for v, ms in timed("cumsum_frames", libs, lambda: rt.cumsum_frames(x),
                           smoke.queued_ms).items():
            out[v]["ms"] = ms
            print(f"K4 {v}: {' / '.join(f'{t:.4f}' for t in ms)} ms a call on the device "
                  f"(queued) at {tuple(x.shape)}  [{name}]", flush=True)
        lib_ms = smoke.queued_ms(lambda: torch.cumsum(x, dim=2))
    print(f"torch.cumsum: {lib_ms:.4f} ms  [{name}]")
    return dict(out, **{"torch.cumsum": lib_ms})


def k9_variants(dev, name: str) -> dict:
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.rt import tracer as tr
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture

    smoke = _chip_smoke()
    cam = Camera.get_cameras(smoke.ns_project())[0]
    libs = build_variants("mt_culled", K9_VARIANTS)
    shipped = libs["shipped"][0]
    real = tr.intersect_culled
    regrouped: dict = {}

    def form(lib, group=None):
        def call(o, d, tris, tc):
            cuda_build._loaded["mt_culled"] = lib
            if group is not None:
                key = (id(tris), group)
                if key not in regrouped:
                    regrouped[key] = tr.with_groups(tris, group or tris["bb_minx"].numel())
                tris = regrouped[key]
            return real(o, d, tris, tc)
        return call

    forms = {v: form(lib) for v, (lib, _) in libs.items()}
    forms.update({f"groups of {g}" if g else "one group": form(shipped, g) for g in K9_GROUPS})
    forms["first design (a thread a ray)"] = first_design_intersect
    forms["first design, rays in first-chunk order"] = partial(first_design_intersect, order=True)
    out = {v: {"ptxas": smoke.ptxas_lines(log, "mt_culled")} for v, (_, log) in libs.items()}
    first_design_lib()
    out["first design (a thread a ray)"] = {
        "ptxas": smoke.ptxas_lines(_FIRST_DESIGN["log"], "mt_culled")}
    for mesh_res in (smoke.K9_MESH, smoke.K9_BIG_MESH):
        mesh = mushroom_mesh(*mesh_res)
        host = RtxHost(device=dev)
        host.load_model(mesh)
        host.load_texture_diffuse(mushroom_texture())
        tris, tc = host._tris, host.tri_chunk
        sizes = smoke.K5_SWEEP if mesh_res == smoke.K9_MESH else (smoke.K5_BOUNCE_RAYS,)
        rays = {f"{r} bounce rays": [x.to(dev) for x in smoke.surface_rays(mesh, r, seed=7)]
                for r in sizes}
        rays["primary batch"] = smoke.camera_rays(cam, smoke.NS_RES, dev, seed=1,
                                                  samples=host.sample_batch)
        tag = f"{mesh.num_triangles:,} triangles"
        for label, (o, d) in rays.items():
            ref = tr.intersect_culled_reference(o, d, tris, tc)
            for v, fn in forms.items():
                if not all(torch.equal(a, b) for a, b in zip(fn(o, d, tris, tc), ref)):
                    raise SystemExit(f"K9 variant {v!r} differs from plain on {label}, {tag}")
            times: dict[str, list[float]] = {v: [] for v in forms}
            for i in range(ROUNDS):
                for v in (list(forms) if i % 2 == 0 else list(forms)[::-1]):
                    # the reorder is many small operations: events around one call
                    clock = (partial(cuda_ms, warmup=1, reps=5) if "order" in v
                             else smoke.queued_ms)
                    times[v].append(clock(lambda: forms[v](o, d, tris, tc)))
            for v, ms in times.items():
                out.setdefault(v, {})[f"{label}, {tag}"] = ms
                print(f"K9 {v}, {label}, {tag}: {' / '.join(f'{t:.4f}' for t in ms)} ms a call "
                      f"on the device ({'one call' if 'order' in v else 'queued'}); equal to "
                      f"plain  [{name}]", flush=True)
            del o, d, ref
        del rays
        frames: dict[str, list[float]] = {v: [] for v in forms}
        try:
            for v in forms:  # one warm-up frame each
                tr.intersect_culled = forms[v]
                smoke.culled_frame_s(host, cam, warmup=0, reps=1)
            for i in range(2):
                for v in (list(forms) if i % 2 == 0 else list(forms)[::-1]):
                    tr.intersect_culled = forms[v]
                    frames[v].append(smoke.culled_frame_s(host, cam, warmup=0, reps=1))
        finally:
            tr.intersect_culled = real
        for v, s in frames.items():
            out.setdefault(v, {})[f"frame_s, {tag}"] = s
            print(f"K9 {v}: {' / '.join(f'{t:.4f}' for t in s)} s a {smoke.NS_SAMPLES}-sample "
                  f"{smoke.NS_RES}^2 capture frame at rig camera 0, {tag}  [{name}]", flush=True)
        del host, tris
        regrouped.clear()
        torch.cuda.empty_cache()
    cuda_build._loaded.pop("mt_culled", None)
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RUNS = {"k1": k1_variants, "k2": k2_variants, "k3": k3_variants, "k4": k4_variants,
        "k6": k6_variants, "k9": k9_variants}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append", choices=tuple(RUNS),
                    help="the kernels whose variants to run (default: all)")
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    out = {"card": name}
    for key in args.only or RUNS:
        out[key] = RUNS[key](dev, name)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
