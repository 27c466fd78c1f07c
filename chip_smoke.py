"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
gaussian_splatterer_tpu_torch/csrc/, holds each against its plain PyTorch
version, drives the serving path (``render --mode splats`` through the CLI),
the training path (``Trainer`` under ``auto_train``), the tracer path
(``new`` -> ``train`` -> ``render --mode rtx`` through the CLI), the
non-fused tiled training path (``Trainer`` and the CLI's ``train`` at a
resolution that is not a multiple of the tile), the fused step on its
cumsum reduction route (``Trainer(reduction="cumsum")``), the H100 probes,
the measuring and long-run entry points (the port's bench and
bench_scale, quality_run with a resume across processes, eval_model) and
the tracer at mesh scale (the CLI on a 65,024-triangle mesh, through the
culled intersector), the rest of the product (a JPEG texture, export
and import, doctor, the native parsers), multi-device training (two and
four ranks sharing the card, the routed 3-axis step included) and the
graft entry points at full size, times the stages with CUDA events,
and exits nonzero at the first phase that fails.  It imports nothing of
JAX.

Phases:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: one nvcc per kernel source, all started together, into
     build/torch_kernels/, with the build seconds and the ptxas lines;
  serve path (kernel composite_fwd):
  3. kernel against plain and oracle on the numerics-gate scene of the JAX
     package's bench (150 splats, 128^2, seed 7) at tile 16 and 32;
  4. main path: the CLI renders the 50k-splat bench scene at 1024^2 and
     2048^2 and a 262,144-splat scene at 2048^2 from a project directory;
  5. times: median of REPS runs after WARMUP warm-ups per scene and size;
     the kernel against its bound at all pairs visited and at those inside
     the footprint box (the summary's), its registers and spills, blocks
     an SM and the SASS instructions a pair of its loop;
  training path (kernel composite_train):
  6. gate scene of the JAX package's bench grad gate (150 splats, 128^2,
     2 frames, seed 11, uniform truths from seed 3, black background,
     tile 32): kernel against plain, the fused gradients against autograd
     through the oracle, the loss against the oracle's;
  7. main path: auto_train for TRAIN_STEPS steps of the 50k-splat bench
     scene at 1024^2 on the 16-camera rig (32 frames a step, 8 frames a
     kernel launch), truths rendered by the serve path from a perturbed
     teacher; then kernel against plain on one launch of the trained model;
  8. times: per-layer step times, steps/s, the bench's fwd+bwd ms/frame
     (scripts/bench.py's call and timing, in process; phase 18 runs the
     bench from the shell) and the device's busy share of a step; per
     group the batched front end (one frame-batched projection forward
     and backward, bin_splats_batch) beside the frame-by-frame one (a call
     a frame, bin_frames): layer times, and for one group forward and
     backward its time, device busy time, device ops, host syncs and peak
     memory; render_train_grads_batch must sync the host once a group;
     the kernel against
     its bound at all pairs visited and at those inside the footprint box
     (the summary's), its registers and spills, blocks an SM, and the SASS
     instructions a pair of both passes' loops and SHFL a duplicate;
  tracer path (kernel mt_intersect):
  9. kernel against plain on the random soup of the JAX package's tests,
     on 2^16 bounce rays leaving the north-star mushroom's surface and on
     one batch of its primary rays as a capture launches it (8 samples of
     a 1024^2 frame, 8,388,608 rays); on that batch, the split over
     triangles (the first 1024, 8192 and 65536 rays) and a second launch
     bit-equal to the first launch; a 32^2 render with the kernel against
     one with the plain intersector, same seed;
 10. main path: the CLI's new -> train -> render --mode rtx on the north
     star (the procedural mushroom, 1024^2, 8-camera rig, 32 samples,
     capacity 262,144), 6 steps that capture before iterations 0 and 3 and
     densify at 0 and 4, in subprocesses; the launches ``train`` prints
     (mt_intersect at each capture, no mt_culled);
 11. times: seconds per 32-sample 1024^2 capture frame at the north-star
     and the close-up camera with the device's busy share, and the kernel,
     its plain twin and the FP32 product alone on one batch of primary rays
     (the kernel also on one 1024^2 frame of them); the kernel alone at
     2^10, 2^13, 2^16 and 2^20 bounce rays and on the batch, per call and
     on the device, beside its bound at both counts of operations a pair;
     what the reject and the split buy, each on its own; the instructions
     a pair of its loop over triangles in the SASS (cuobjdump);
  non-fused tiled training (kernel composite_bwd, the compositor's backward):
 12. kernel against plain on the gate scene (seeded uniform gradients, tile
     16 and 32), two launches bit-equal; render_tiled gradients through the
     kernel against autograd through the oracle on the grad gate scene at
     128^2 and at 120^2 (not a multiple of the tile);
 13. main path: auto_train for TRAIN_STEPS steps of the bench scene at
     1000^2 on the 16-camera rig, which is not a multiple of the tile, so
     the Trainer renders every frame under autograd (32 K2 launches a step,
     no K3); kernel against plain on one frame of the trained model; the
     CLI's new --resolution 1000 -> train --steps 2 on the mushroom;
 14. times: per-frame layers, the step, steps/s, the device's busy share,
     and K2 against its plain twin and its bound at both counts on one
     1000^2 frame, its registers, blocks an SM, SASS a pair and SHFL a
     duplicate;
  the cumsum reduction route (kernel cumsum_frames, K4):
 15. K4 against plain at the JAX test's shapes and at D = 1000 and 100 (no
     multiple-of-128 divisor), two launches bit-equal; at full size on one
     group of the phase-7 model's duplicate gradients against a float64
     scan, no worse than twice torch.cumsum's own error;
 16. main path: auto_train for TRAIN_STEPS steps of phase 7's cell with
     Trainer(reduction="cumsum") (4 K4 launches a step); both routes'
     reduction of one group against float64, the cumsum route within its
     float32 bound (twice the scan's error plus the rounding of a prefix
     difference, per row and frame); one step's gradients and var_loc from
     both routes within the full-size gradient gate (5e-2 of the largest;
     whether the small-scene 2e-4 holds is printed); two cumsum-route
     steps bit-equal (the index_add route's printed);
     per-layer times of both routes, the whole step on each, K4 against
     its bound and torch.cumsum (K4, its plain twin and torch.cumsum also
     as the device time of one call queued behind a spin kernel, which
     leaves out the host's time between launches: the summary's K4 times);
  the probes (kernels peak_fma K8, gather_cols K7, smem_gather K6):
 17. each probe's run(), as ``python -m
     gaussian_splatterer_tpu_torch.scripts.<name>`` runs it: K8's forms at
     the reference's shape (memory-bound) and register-resident, with the
     SM clock and power, K7 at the bench scale (with the L2 sector bytes of
     random ids and the rate they imply), K6 on the (16, 4096) table with
     its rows a block;
     each kernel against its plain twin (K6 and K7 exactly); then K1-K5's
     times from this run with their shares of the bound at the published
     67 TFLOP/s and at K8's measured FP32 rate;
  the measuring and long-run entry points, in subprocesses as a user
  runs them (K1 in the forward gate and the evaluation renders, K3 in the
  gradient gate, the timed runs and training, K5 in every capture):
 18. ``python -m gaussian_splatterer_tpu_torch.scripts.bench``: its one
     JSON line, both gates within their bars and a finite value; again at
     --tile 16 with a max_dup sized from a probe of the true count; then
     scripts.bench_scale at 200k, 500k and 1M splats (ms/frame, duplicates,
     peak memory), one line each;
 19. scripts.quality_run on the north star at the ns_r5 width (1024^2, 8
     cameras, 32 samples, capacity 262,144, max_dup 786,432, recapture
     every 50, densify every 150) in two processes: 60 steps with a
     checkpoint every 30, then --resume to 120, which must resume at
     iteration 60 from a model bit-equal to the checkpoint (its SHA-256);
     then scripts.eval_model on the final model (32 samples, 2 views):
     PSNR, SSIM, steps/s and the capture's share of the run.  The summary's
     launches include these phases';
  the tracer at mesh scale (kernel mt_culled, K9, the culled intersector;
  meshes of accel_min = 1,024 triangles or more):
 20. K9 against its plain twin at phase 9's gate, and bit for bit, on the
     600-triangle soup of tests/test_torch_culled.py, on 2^16 bounce rays
     leaving the mushroom at mesh-res 256 (65,024 triangles in 127 chunks)
     and on one 1-sample 1024^2 batch of its primary rays; two launches
     bit-equal; K9 against K5 on the same rays (compare_forms: masks and
     winners at phase 9's gate, K9's t, u, v against float64 within their
     float32 condition); the main path: the CLI's new --obj (the mesh
     written as an OBJ) -> train (6 steps, captures at 0 and 3; mt_culled
     launches required at each and no mt_intersect launch) -> render
     --mode rtx, as phase 10; times:
     the 32-sample 1024^2 capture frame at rig camera 0 through K9, its
     busy share and K9's launches by size, the same frame through the brute
     force (K5, accel_min 10^9), and once through K9's first design
     (scripts/variants/mt_culled_thread_per_ray.cu, after a warm-up frame);
     the frame at mesh-res 1024 (1,046,528 triangles) through K9 with the
     brute force's primaries estimated from one K5 launch, and once
     through the first design; K9 at 2^10, 2^13, 2^16 and 2^20 bounce rays
     and on a 8-sample primary batch (the main path's), each held against
     its plain twin (phase 9's gate, and bit for bit; the first design too)
     and timed beside it, its chunks visited a ray, its steps and rays a
     bin (the launch's stats, whose rays summed over the steps must equal
     the plain twin's visits), its bound, K5 on the same rays and the first
     design (one queued round of 10 calls); at 2^20
     the first design on the rays as they come and sorted by their first
     chunk (pairs/s and triangle bytes/s at 48 B a pair); K9 against its
     plain twin on the mesh-res 1024 mushroom (2,044 chunks: boxes in the
     opt-in shared memory), on its 1-sample primary batch and 2^16 bounce
     rays, with its steps and rays a bin;
  the rest of the product (K1, K3 and K5 again):
 21. the committed JPEG fixtures (tests/data/jpeg: the 1024^2 mushroom
     texture, baseline and progressive) decoded on the host, bit-equal to
     their Pillow decodes, with the seconds; the texture fixtures
     (tests/data/textures, TEXTURE_FIXTURES, the last 19 Pillow readers'
     among them, the arithmetic-coded and lossless JPEGs, and the
     compressed YCbCr TIFFs, the CIELab TIFF, the LAB PSD, the 256^2
     and 1024^2 Zstandard TIFFs and the three JPEG 2000 files) likewise;
     the cut-out textures (the BLP2 DXT5 among them), the 1024^2
     JPEG-in-TIFF texture, an arithmetic-coded JPEG texture, the CIELab
     TIFF, the 256^2 Zstandard TIFF and the 1024^2 9/7 JPEG 2000 file on
     the north-star mesh through K5, each frame
     bit-equal to the frame under its Pillow decode; the native byte loops
     (BYTE_LOOP_FIXTURES, the 1024^2 Group 4 TIFF, the QM decoder on the
     largest arithmetic-coded fixture and the Zstandard decoder on both
     Zstandard TIFFs among them) against their Python twins, with the
     ratio of their host times; the CLI's new --obj --texture
     (the JPEG) -> train (3 steps, one capture through K5) on the north
     star; the project's texture on the card equal to the fixture's PNG;
     export to .ply, .html and .gobj and render --mode viewer (in process,
     through the CLI's main), the viewer's data equal to
     pack_viewer_arrays of the model; the .ply read into a fresh Session
     by load_splats_ply: means, SH and rotations bit-equal, opacities and
     scales within the JAX test's round-trip tolerances, its 1024^2 render
     (K1) within PLY_RENDER_ATOL of the trained model's on
     PLY_SHARE_WITHIN of the pixels and MAIN_MAX_ATOL on all, and equal to
     it with the trained opacities and scales put back; ``gsplat-torch doctor`` in a subprocess (cuda,
     gate ok, micro steps a second); the native parsers required: the
     mesh-res 1024 mushroom as an OBJ, and a 262,144-splat .gobj saved and
     loaded, native against Python, equal, with the host seconds of each.
     Its launches join the summary's.
  multi-device training (parallel/; K3, K4, K5, K9 on every rank):
 22. two ranks sharing cuda:0 over gloo, in spawned workers (NCCL refuses
     two ranks on one GPU): (a) one DP and one FSDP step (1 x 2 mesh) of
     phase 7's cell on the cumsum route against the single-process step,
     within 1e-4 of each field's largest |value| (the gap printed), the DP
     ranks bit-equal, each FSDP rank on capacity / 2 rows; per-rank step
     ms and collective ms and bytes over 3 timed steps ("2 ranks sharing
     one H100 via gloo, not a scaling figure"); (b) the sharded capture of
     the north-star rig (16 frames, 8 samples, 1024^2) on the mushroom at
     mesh-res 256 (K9), each frame bit-equal to a serial render with the
     same frame seed; (c) ``train --devices 2`` of the north star (the
     CLI's run_train on each rank) on the DP and on the FSDP mesh: 6 steps,
     the DP ranks' models bit-equal, densify grows the model, a finite
     loss; (d) one nccl rank's DP step bit-equal to make_train_step on the
     cumsum route; (e) ``gsplat-torch train --devices 2`` on the one-card
     host exits nonzero naming both numbers; the band step (tp) on a 1 x 2
     camera x tile mesh in (a) on both routes, with K3 on a band's grid
     against its plain version; (f) the FSDP shard's sharded checkpoint;
     then 4 ranks on the (1, 2, 2) camera x tile x splat mesh: (g) the
     3-axis step and (h) the routed 3-axis step (records routed to their
     compositors over an exact uneven all-to-all, no parameter gather),
     each against the single-process step within 1e-4 of each field's
     largest, the routed step's RouteStats and the bytes of its exchanges,
     and each rank's peak memory in one step of each.  Every rank's
     launches join the summary's;
  the graft entry points (K1, K3, K4):
 23. graft_entry.entry() on the card: its function once (one K1 launch),
     its duplicate budget the binning's whole count (nothing dropped), its
     image equal to K1's on that launch's binning, K1 there against its
     plain version exactly (max |diff| 0.0), and the call's time; then
     graft_entry.dryrun_multichip(4) on the card (4 gloo ranks sharing
     cuda:0): every branch's line, rank 0 on cuda:0 with K3 launched.

Bounds: the least time the card could take for a kernel's work, the larger
of its FP32 operations over 67 TFLOP/s (the data sheet's; phase 17 adds a
second share at K8's measured rate) and its bytes (each input read once,
each output written once) over 3.35 TB/s.  The operations are counted from
the (pixel, duplicate) pairs that these inputs evaluate before their pixel
terminates, which the plain version counts, times the operations per pair
of the kernel's source (an expf counts as one operation); K3's summary
counts its Gaussians, and K1's and K2's, only at the pairs inside the
duplicate's exact footprint box (``pairs_box``), the work left once a pixel
is shown to lie outside it.  The tracer
kernel's operations are every (ray, real triangle) pair of the launch
times its operations per pair, an FMA counted as two; the culled one's the
(ray, triangle) pairs its march visits on these rays (counted by the plain
twin) and one AABB test per ray and chunk.  K2's bytes are the
rows in, their gradients out, the ranges, and the forward output and its
gradient in.  K4's bytes are its input read and its output written once.

``--only bench``, ``--only quality``, ``--only k9``, ``--only export``,
``--only parallel`` and ``--only entry`` run phases 1-2 and then phase 18,
19, 20, 21, 22 or 23 (or several) and end with the full run's last line
(``k9`` after its kernels line).

``--only step`` runs phases 1-2, 7-8 and 16 (the fused step on both
reduction routes, for quick rounds on the card) and ends with the same
last line as the full run.

``--only k1|k2|k3|k4|k5|k6|k7`` runs phases 1-2 and then only phases 3-5
(without the CLI's renders; K1 timed alone), phase 12 and K2 on one 1000^2
frame of the untrained bench scene, phases 6-8, phase 15's gate shapes and
K4 alone on a synthetic (9, 8, 202,689) group (k4_input), phase 11, or
phase 17's K6 or K7 cases: copied into a second tree, it times both trees
in one call.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernel summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

GATE_ATOL_PLAIN = 1e-4  # kernel vs plain version on the gate scenes
GATE_ATOL_ORACLE = 2e-2  # kernel vs exact oracle: the forward gate of the JAX package's bench
MAIN_MAX_ATOL = 1e-2  # kernel vs plain at full size: isolated threshold flips
MAIN_MEAN_ATOL = 1e-5
GRAD_GATE_RTOL = 5e-2  # fused gradients vs the oracle's: the JAX package's bench grad gate
LOSS_GATE_RTOL = 1e-3  # fused loss vs the oracle's on the gate scene
BG_GATE = (0.2, 0.3, 0.4)
WARMUP, REPS = 3, 20
SCENES = (  # (label, splats, capacity, render sizes)
    ("bench50k", 50_000, 65_536, (1024, 2048)),
    ("large262k", 262_144, 262_144, (2048,)),
)
TRAIN_SPLATS, TRAIN_CAPACITY = 50_000, 65_536  # the bench scene, trained
TRAIN_RES, TRAIN_TILE, TRAIN_GROUP, TRAIN_STEPS = 1024, 32, 8, 6
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# operations per (pixel, duplicate) pair, counted in the kernels' sources
K1_OPS_VISITED = 16  # dx, dy, power (9), power test, expf, alpha, clamp, alpha test
K1_OPS_COMPOSITED = 10  # transmittance (2), stop test, weight, rgb (6)
K3_OPS_VISITED = 2 * K1_OPS_VISITED  # both passes evaluate the Gaussian
K3_OPS_COMPOSITED = K1_OPS_COMPOSITED + 47  # + pass 2: transmittance, d_alpha, nine sums
K3_OPS_PIXEL = 20  # residual (9), g_t (5), g_ctot (5), g_t T_final
# K5, per (ray, triangle) pair: four dot products of length 10 (4 products
# and 36 FMAs, an FMA two operations) and the epilogue (guard 3, division,
# 3 products, u + v, 5 tests, the running minimum 2): the first port's count,
# every pair through the epilogue
K5_OPS_PAIR = 76 + 15
# the FP32 work every pair still does in csrc/mt_intersect.cu: the four dot
# products (76) and the reject's arithmetic (the clamp's test, the margin's
# product, the two tests); its sign flips and the clamp's select are the
# kernel's own bookkeeping, not the function's, and are not counted.  Only
# warps with a surviving pair run the epilogue.  The bound the summary
# reports uses this count
K5_OPS_PAIR_MIN = 76 + 4
K5_SWEEP = (1 << 10, 1 << 13, 1 << 16, 1 << 20)  # phase 11's launch sizes below the batch
K5_MASK_SHARE = 0.9999  # hit masks, and winners where both hit: a guard within rounding may flip
K5_TIE_BARY_ATOL = 1e-4  # a tie's winner holds the hit point in float64, to float32 rounding
K5_T_RTOL, K5_UV_ATOL = 1e-5, 1e-5  # FMA chains vs the product's own summation order
K5_RENDER_ATOL, K5_RENDER_SHARE = 1e-3, 0.98  # tests/test_rt.py:279-281
K5_BOUNCE_RAYS = 1 << 16
# the north star (runs/README.md, ns_r5): the mushroom at mesh resolution 32
# (960 triangles), 1024^2, 8-camera rig, 32 samples, capacity 262,144,
# max_dup 786,432, location-LR decay 0.9988, densify variance 0.001 decaying
# by 0.999; the schedule is cut to 6 steps that capture at 0 and 3 and
# densify at 0 and 4
NS_MESH, NS_RES, NS_CAMS, NS_SAMPLES = (32, 16), 1024, 8, 32
NS_CAPACITY, NS_MAX_DUP = 262_144, 786_432
NS_RUNTIME = ("--runtime", "lr_location_decay=0.9988", "--runtime", "densify_variance_decay=0.999")
NS_DENSIFY_VARIANCE = 0.001
NS_STEPS, NS_INTERVAL_CAPTURE, NS_INTERVAL_DENSIFY = 6, 3, 4
NS_LIT_SHARE = 0.005  # the mushroom covers a few percent of the frame
# phase 18: the headline bench as a user runs it, at tile 32 and 16, and
# its scaling rows (scripts/bench.py, scripts/bench_scale.py)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "numerics_gate_max_err",
              "grad_gate_max_err")
SCALE_SIZES = (200_000, 500_000, 1_000_000)
# phase 19: the quality run of the north star at the ns_r5 width
# (runs/README.md: 1024^2, 8 cameras, 32 samples, capacity 262,144, max_dup
# 786,432, recapture every 50, densify every 150), cut to Q_STEPS steps in
# two processes: the first stops at Q_RESUME_AT with a checkpoint every
# Q_CHECKPOINT, the second resumes there
Q_RESUME_AT, Q_STEPS, Q_CHECKPOINT, Q_EVAL_VIEWS = 60, 120, 30, 2
NS_QUALITY = (
    "--scene", "mushroom", "--mesh-res", str(NS_MESH[0]), "--res", str(NS_RES),
    "--cams", str(NS_CAMS), "--samples", str(NS_SAMPLES), "--capacity", str(NS_CAPACITY),
    "--max-dup", str(NS_MAX_DUP), "--work-cap", "6144",
    "--densify-variance", str(NS_DENSIFY_VARIANCE), "--interval-densify", "150",
    "--interval-capture", "50", "--lr-scale", "1.0", "--lr-location-decay", "0.9988",
    "--densify-variance-decay", "0.999",
)
# phase 20: the tracer at mesh scale (K9).  The mushroom at mesh resolution
# 256 (65,024 triangles, past the JAX package's accel_min of 1,024: Morton-
# ordered into 127 chunks of 512, the culled route for every intersection)
# and at 1024 (1,046,528 triangles, 2,044 chunks); the soup of
# tests/test_torch_culled.py (600 triangles, chunks of 32)
K9_MESH, K9_BIG_MESH = (256, 128), (1024, 512)
K9_SOUP, K9_SOUP_CHUNK = 600, 32
# K9 against K5 (compare_forms): K9's t, u and v held to float64 within
# this many float32 roundings of each quantity's condition
K9_F64_ULPS = 16
# operations of a visited (ray, triangle) pair in csrc/mt_culled.cu, each
# counted once: p (6 products, 3 differences), det (3, 2), the guard's test
# and select, the reciprocal, w (3), u (4, 2), q (6, 3), v (4, 2), t (4, 2),
# the tests (valid, u, v, u + v and its test, t) 6, the running minimum 1
K9_OPS_PAIR = 9 + 5 + 2 + 1 + 3 + 6 + 9 + 6 + 6 + 6 + 1
# and of a ray's AABB test: 6 differences, 6 products, 3 min, 3 max, the
# entry's 3 max, the exit's 2 min and the key's test
K9_OPS_BOX = 6 + 6 + 3 + 3 + 3 + 2 + 1
# phase 21: the rest of the product.  The committed JPEG fixtures (the 1024^2
# mushroom texture at quality 90, 4:2:0, baseline and progressive, and their
# Pillow decodes as PNGs: tests/data/jpeg/make_fixtures.py); the north star's
# CLI cut to 3 steps that capture once; the .ply import's render tolerance
# (tests/test_torch_export.py); the .gobj size of the native parsers' check
JPEG_FIXTURES = ("mushroom1024_q90_420", "mushroom1024_q90_420_progressive")
# the texture fixtures (tests/data/textures/make_fixtures.py: the 256^2 mushroom texture
# as an alpha-keyed palette PNG, 16-bit RGBA PNG, Adam7 PNG, colour-mapped RLE TGA, CMYK
# JPEG, 32-bit bitfields BMP, LZW TIFF with predictor 2, DXT1 DDS of the keyed PNG,
# interlaced GIF with a transparent index, PPM, and WebP: lossy, lossy with alpha (the
# keyed PNG), lossless and a two-frame animation, PackBits RGBA PSD of the keyed PNG,
# QOI, verbatim and RLE SGI, RGB, grey, palette and 1-bit PCX, a PNG-entry ICO, an 8-bit
# CUR and a grey PFM, each beside its Pillow decode <stem>.pillow.png; JPEG-in-TIFF
# (RGB, YCbCr 4:2:0), Group 4 with FillOrder 2, Group 3 2-D, LZMA, BigTIFF, float,
# signed 16-bit and predictor-3 grey, raw YCbCr and BC6H UF16 and SF16 DDS; the 1024^2
# JPEG fixture's pixels as an LZW TIFF, as lossless WebP and as QOI, whose Pillow decode
# is that fixture's PNG, and as lossy WebP, JPEG-in-TIFF and Group 4 beside their Pillow
# decodes; the last 19 Pillow readers' fixtures, BLP to IPTC); the cut-out fixtures (the
# keyed palette PNG, the DXT1 DDS, the lossy WebP with alpha, the PSD, the BLP2 DXT5) on
# the north-star mesh, one frame from rig camera 0 at this size,
# sample count and seed; the files decoded by both the native byte loops and their
# Python twins
TEXTURE_FIXTURES = ("mushroom256_palette_trns.png", "mushroom256_rgba16.png",
                    "mushroom256_adam7.png", "mushroom256_map_rle.tga", "mushroom256_cmyk.jpg",
                    "mushroom256_bitfields.bmp", "mushroom256_lzw_pred2.tif",
                    "mushroom256_dxt1.dds", "mushroom256_trns.gif", "mushroom256.ppm",
                    "mushroom256_lossy.webp", "mushroom256_lossy_alpha.webp",
                    "mushroom256_lossless.webp", "mushroom256_anim.webp",
                    "mushroom256_cutout.psd", "mushroom256_rgba.qoi", "mushroom256_verbatim.sgi",
                    "mushroom256_rle.sgi", "mushroom256_rgb.pcx", "mushroom256_l.pcx",
                    "mushroom256_p.pcx", "mushroom256_1.pcx", "mushroom256_icon.ico",
                    "mushroom256_cursor.cur", "mushroom256_grey.pfm",
                    "mushroom256_jpeg_rgb.tif", "mushroom256_jpeg_ycbcr420.tif",
                    "mushroom256_g4_fill2.tif", "mushroom256_g3_2d.tif", "mushroom256_lzma.tif",
                    "mushroom256_bigtiff.tif", "mushroom256_float.tif", "mushroom256_signed16.tif",
                    "mushroom256_float_pred3.tif", "mushroom256_ycbcr_raw.tif",
                    "mushroom256_bc6h_uf16.dds", "mushroom256_bc6h_sf16.dds",
                    "mushroom1024_lzw.tif", "mushroom1024_lossless.webp", "mushroom1024_q90.webp",
                    "mushroom1024.qoi", "mushroom1024_jpeg.tif", "mushroom1024_g4.tif",
                    "mushroom256_dxt5_cutout.blp", "mushroom256_blp_palette.blp",
                    "mushroom256_ftex.ftc", "mushroom256_icns.icns", "mushroom128_icns_rle.icns",
                    "mushroom256_dcx.dcx", "mushroom256_xbm.xbm", "mushroom256_xpm.xpm",
                    "mushroom256_gbr.gbr", "mushroom256_sun_rle.ras", "mushroom256_msp.msp",
                    "mushroom256_im_lut.im", "mushroom256_fli.flc", "mushroom256_spider.spider",
                    "mushroom256_fits.fits", "mushroom256_mcidas.mcidas",
                    "mushroom256_pixar.pxr", "mushroom256_imt.imt",
                    "mushroom256_xvthumb.xvthumb", "mushroom256_iptc.iim",
                    "mushroom256_arith_420.jpg", "mushroom256_arith_progressive.jpg",
                    "mushroom256_lossless_p6.jpg", "mushroom256_lossless_grey_p7.jpg",
                    "mushroom256_arith.tif", "mushroom256_ycbcr420_lzw.tif",
                    "mushroom256_ycbcr422_tiles.tif", "mushroom256_cielab.tif",
                    "mushroom256_lab.psd", "mushroom256_zstd_pred2.tif",
                    "mushroom1024_zstd.tif", "mushroom256_53.jp2", "mushroom256_rpcl.j2k",
                    "mushroom1024_9x7.jp2")
PILLOW_DECODES = {"mushroom1024_lzw.tif": "../jpeg/mushroom1024_q90_420.png",
                  "mushroom1024_lossless.webp": "../jpeg/mushroom1024_q90_420.png",
                  "mushroom1024.qoi": "../jpeg/mushroom1024_q90_420.png"}
CUTOUT_FIXTURES = ("mushroom256_palette_trns.png", "mushroom256_dxt1.dds",
                   "mushroom256_lossy_alpha.webp", "mushroom256_cutout.psd",
                   "mushroom256_dxt5_cutout.blp")
BYTE_LOOP_FIXTURES = ("jpeg/mushroom1024_q90_420.png", "textures/mushroom1024_lzw.tif",
                      "textures/mushroom1024.qoi", "textures/mushroom256_cutout.psd",
                      "textures/mushroom256_rle.sgi", "textures/mushroom256_rgb.pcx",
                      "textures/mushroom1024_g4.tif", "textures/mushroom256_bc6h_sf16.dds",
                      "textures/mushroom256_sun_rle.ras", "textures/mushroom256_msp.msp",
                      "textures/mushroom256_fli.flc", "textures/mushroom128_icns_rle.icns",
                      "textures/mushroom256_arith_progressive.jpg",
                      "textures/mushroom256_lossless_p6.jpg",
                      "textures/mushroom256_zstd_pred2.tif", "textures/mushroom1024_zstd.tif")
# the JPEG-in-TIFF texture on the north-star mesh through K5, as the cut-out
# ones (an opaque texture: its frame against the frame of the decode flipped
# upside down, which must differ)
JPEG_TIFF_TEXTURE = "mushroom1024_jpeg.tif"
# and an arithmetic-coded JPEG texture (4:2:0, DAC, restarts) likewise, a
# CIELab TIFF (io/lab.py's littleCMS transform) and a Zstandard TIFF
# (io/zstd.py; RGBA, predictor 2)
ARITH_TEXTURE = "mushroom256_arith_420.jpg"
LAB_TEXTURE = "mushroom256_cielab.tif"
ZSTD_TEXTURE = "mushroom256_zstd_pred2.tif"
# and a JPEG 2000 texture (io/jpeg2000.py over native/src/j2k.cpp; 1024^2,
# irreversible 9/7)
J2K_TEXTURE = "mushroom1024_9x7.jp2"
P21_KEYED_RES, P21_KEYED_SAMPLES, P21_KEYED_SEED = 512, 8, 21
P21_STEPS = 3
PLY_RENDER_ATOL = 1e-4
# at full size the import's float32 round trips of opacity (a logit) and
# scale (a log) flip an alpha or transmittance test at isolated pixels:
# the render is held to PLY_RENDER_ATOL on this share of its pixels and to
# MAIN_MAX_ATOL everywhere, and with the two fields put back, exactly
PLY_SHARE_WITHIN = 0.9999
P21_GOBJ_SPLATS = 262_144
# the non-fused tiled step (phases 12-14): the bench scene trained at a
# resolution that is not a multiple of the tile, so the Trainer runs render
# tiled under autograd frame by frame (K1 forward, K2 backward)
NF_RES, NF_GATE_CROP = 1000, 120
NF_CLI_STEPS = 2
K2_OPS_VISITED = K1_OPS_VISITED  # the replay evaluates the Gaussian once
K2_OPS_COMPOSITED = 47  # transmittance, stop test, weight, d_alpha, nine sums: K3's pass 2
K2_OPS_PIXEL = 6  # g . C_total (5), g_t T_final
# the cumsum route (phases 15-16): the JAX test's scan tolerance
# (tests/test_raster_tiled.py:817-829) and its route tolerance on a 96-splat
# scene, of the largest value (tests/test_raster_tiled.py:872-884).  The
# route's error is eps x the frame's prefix, which grows with the frame's
# duplicates, so at full size its gradients are gated by GRAD_GATE_RTOL and
# its reduction by a float32 bound (route_gate); ROUTE_ATOL is printed.
K4_RTOL, K4_ATOL = 2e-5, 2e-3
K4_GATE_SHAPES = ((9, 3, 512), (9, 1, 384), (2, 2, 1024), (9, 2, 96), (9, 2, 1000), (9, 2, 100))
K4_D = 202_689  # the group's largest kept count on phase 7's cell (--only k4's input)
ROUTE_ATOL = 2e-4
# (operations, bytes) of each kernel's summary bound, for phase 17's second share
BOUND_PARTS: dict[str, tuple[float, float]] = {}


# phase 22: multi-device training on the one card.  Two ranks share cuda:0
# over gloo (NCCL refuses two ranks on one GPU): phase 7's cell on the
# cumsum route, a step held to the single-process one at P22_GATE of each
# field's largest |value| (DP, FSDP and the band step on a 1 x 2 camera x
# tile mesh, 2 bands of 16 tile rows; then the 3-axis step on P22_MESH3,
# 4 ranks); the sharded checkpoint of the FSDP shard; the sharded capture
# of the north-star rig on the mesh-res 256 mushroom at P22_CAPTURE_SAMPLES
# samples; the north star's loops through the CLI's run_train
P22_WORLD, P22_GATE, P22_TIMED_STEPS = 2, 1e-4, 3
P22_MESH3 = (1, 2, 2)  # camera x tile x splat
P22_CAPTURE_SAMPLES, P22_SEED = 8, 5
P22_FIELDS = ("means", "shs", "scales", "opacities", "rotations", "var_loc", "avg_grad_loc",
              "loss")
# the size constants the phase's workers read
P22_SIZES = ("TRAIN_SPLATS", "TRAIN_CAPACITY", "TRAIN_RES", "TRAIN_TILE", "TRAIN_GROUP",
             "NS_MESH", "NS_RES", "NS_CAMS", "NS_SAMPLES", "NS_CAPACITY", "NS_MAX_DUP", "NS_STEPS",
             "K9_MESH", "P22_CAPTURE_SAMPLES", "P22_TIMED_STEPS")


_START = time.perf_counter()


def phase(title: str) -> None:
    """A phase's heading, with the seconds since the script began (the full
    run has 1200 s)."""
    print(f"\n== {title}  [{time.perf_counter() - _START:.1f} s into the run]", flush=True)


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=120)
    return proc.stdout.strip()


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS, setup=None) -> float:
    """Median milliseconds of fn() by CUDA events, one event pair per run;
    ``setup()``, untimed, runs before each."""
    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
            torch.cuda.synchronize()
        if i < warmup:
            fn()
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float, name: str | None = None,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    if name is not None:
        BOUND_PARTS[name] = (ops, nbytes)
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(args, stats, name=None, pairs: str = "pairs_box") -> tuple[float, str]:
    """K1's bound, its Gaussians counted at stats[pairs], as k3_bound's."""
    feat, tile_start, _, tile, _ = args
    ops = K1_OPS_VISITED * stats[pairs] + K1_OPS_COMPOSITED * stats["composited"]
    nbytes = 4 * feat.numel() + 8 * tile_start.numel() + 16 * tile_start.numel() * tile * tile
    return bound_ms(ops, nbytes, name)


def k3_bound(args, stats, name=None, pairs: str = "pairs_box") -> tuple[float, str]:
    """K3's bound, its Gaussians counted at stats[pairs]: "pairs", every
    pair visited before its pixel terminated, or "pairs_box" (the summary's),
    those inside the duplicate's exact footprint box, the work that is left
    once a pixel is shown to lie outside the footprint (less work: a smaller
    share).  K1's and K2's bounds count the same way."""
    feat, tile_start, _, truth, bg, *_ = args
    pixels = truth.shape[0] * truth.shape[1]
    ops = (K3_OPS_VISITED * stats[pairs] + K3_OPS_COMPOSITED * stats["composited"]
           + K3_OPS_PIXEL * pixels)
    # feat in, d_feat out, ranges, truth in, residual out, backgrounds
    nbytes = 2 * 4 * feat.numel() + 8 * tile_start.numel() + (12 + 16) * pixels + 4 * bg.numel()
    return bound_ms(ops, nbytes, name)


def k2_bound(args, stats, name=None, pairs: str = "pairs_box") -> tuple[float, str]:
    """K2's bound, its Gaussians counted at stats[pairs], as k3_bound's."""
    feat, tile_start, _, out, *_ = args
    pixels = out.shape[0] * out.shape[1]
    ops = (K2_OPS_VISITED * stats[pairs] + K2_OPS_COMPOSITED * stats["composited"]
           + K2_OPS_PIXEL * pixels)
    # feat in, d_feat out, ranges, the forward output and its gradient in
    nbytes = 2 * 4 * feat.numel() + 8 * tile_start.numel() + 2 * 16 * pixels
    return bound_ms(ops, nbytes, name)


def bounds_line(bound, args, stats, ms: float) -> str:
    """A kernel's bound at both counts of its Gaussians (k1_bound, k2_bound
    or k3_bound) beside its time ``ms``."""
    b_all, by_all = bound(args, stats, pairs="pairs")
    b_box, by_box = bound(args, stats)
    return (f"bound at all {stats['pairs']} pairs visited {b_all:.4f} ms ({by_all}, share "
            f"{b_all / ms:.4f}); at the {stats['pairs_box']} inside the footprint box "
            f"{b_box:.4f} ms ({by_box}, share {b_box / ms:.4f}); {stats['composited']} "
            f"composited")


def compare_bwd(args, d_k, stats=None):
    """K2's d_feat against the plain version's on the same launch: (finite,
    max |d_feat|, max and mean of |d_feat| over its row's largest
    magnitude)."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    d_p = rt.composite_bwd_reference(*args, stats=stats)
    dd = (d_k - d_p).abs()
    rel = dd / d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    return bool(torch.isfinite(d_k).all()), float(dd.max()), float(rel.max()), float(rel.mean())


def compare_train(args, out_k, stats=None):
    """Kernel outputs against the plain version's on the same launch:
    (finite, max |res|, mean |res|, max |d_feat|, max and mean of |d_feat|
    over its row's largest magnitude)."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    res_p, d_p = rt.composite_train_reference(*args, stats=stats)
    res_k, d_k = out_k
    dr = (res_k - res_p).abs()
    dd = (d_k - d_p).abs()
    rel = dd / d_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-3)
    finite = bool(torch.isfinite(res_k).all() and torch.isfinite(d_k).all())
    return (finite, float(dr.max()), float(dr.mean()), float(dd.max()), float(rel.max()),
            float(rel.mean()))


def render_args(model, cam, w, h, train_fov, bg, dev):
    tx, ty = cam.tan_fov(w, h, train=train_fov)
    return (
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), cam.get_view(), cam.get_proj_view(w / h), cam.location,
        tx, ty, w, h, torch.tensor(bg, dtype=torch.float32, device=dev), model.sh_degree, 1.0,
    )


def launch_args(model, cams, width, height, truth_tiles, bgs, tile, max_dup):
    """Projection (one frame-batched call), binning (one pass) and gather
    of one fused-step group: the arguments of its composite_train
    launch."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    with torch.no_grad():
        comps, rows9 = rt.project_frames(
            model.means.expand(cams.num_frames, -1, -1), model.shs, model.scales,
            model.opacities, model.rotations, model.active_mask(), *cams,
            width, height, model.sh_degree)
        return rt.train_launch_inputs(rows9, comps, width, height, truth_tiles, bgs, tile,
                                      max_dup)[1]


class Cell:
    """One scene at one size as the main path renders it: the session's
    preview camera, runtime tile and duplicate budget, black background,
    the serve path's x-FOV.  Holds one projection and binning for the
    kernel-vs-plain comparison and times every stage."""

    def __init__(self, session, size: int):
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        self.session, self.size = session, size
        self.tile = session.runtime.tile_px
        self.max_dup = session.runtime.max_dup
        self.args = render_args(session.model, session.preview_camera(), size, size, False,
                                (0.0, 0.0, 0.0), session.device)
        with torch.no_grad():
            self.comps = self.project()
            self.bins = self.bin()
            self.feat = rt.gather_features(self.comps, self.bins)
        self.composite_args = (self.feat, self.bins.tile_start, self.bins.tile_end,
                               self.tile, -(-size // self.tile))
        self.stats: dict = {}

    def project(self):
        from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

        return project_splat_components(*self.args[:13], self.session.model.sh_degree, 1.0)

    def bin(self):
        from gaussian_splatterer_tpu_torch.ops.binning import bin_splats

        return bin_splats(self.comps, self.size, self.size, self.tile, self.max_dup)

    @torch.no_grad()
    def times(self, kernel_only: bool = False) -> dict[str, float]:
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        if kernel_only:
            return {"composite_kernel": cuda_ms(lambda: rt.composite_fwd(*self.composite_args))}
        return {
            "projection": cuda_ms(self.project),
            "binning": cuda_ms(self.bin),
            "gather": cuda_ms(lambda: rt.gather_features(self.comps, self.bins)),
            "composite_kernel": cuda_ms(lambda: rt.composite_fwd(*self.composite_args)),
            "composite_plain": cuda_ms(lambda: rt.composite_fwd_reference(*self.composite_args)),
            "render": cuda_ms(lambda: self.session.render_splats(self.size, self.size)),
        }


class TeacherRtx:
    """Truth source of the training cells: the serve path (kernel
    composite_fwd) rendering a teacher model at the training FOV."""

    def __init__(self, teacher, tile: int, max_dup: int):
        self.teacher, self.tile, self.max_dup = teacher, tile, max_dup

    @torch.no_grad()
    def render(self, camera, background, samples, width, height):
        from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

        bg = torch.tensor(background, dtype=torch.float32, device=self.teacher.device)
        return rt.render_tiled_model(self.teacher, camera, width, height, bg, train_fov=True,
                                     tile=self.tile, max_dup=self.max_dup)


def serve_projects(dev) -> tuple[Path, dict[str, str]]:
    """Phase 4's projects: each of SCENES saved by a Session at the serve
    runtime.  Returns (their directory under build/, {label: project})."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import splat_arrays
    from gaussian_splatterer_tpu_torch.app.session import Session
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE / "build"))
    projects = {}
    for label, n, cap, _ in SCENES:
        runtime = RuntimeConfig(render_resolution_x=1024, render_resolution_y=1024,
                                splats_capacity=cap, sh_degree=1, sh_coeffs=4,
                                max_dup=2**24)
        session = Session(project=Project.app_default(), runtime=runtime, device=dev)
        session.model = SplatModel.from_numpy(*splat_arrays(n, cap, seed=0), count=n,
                                              device=dev, sh_degree=1)
        session.save_project(str(work / label))
        projects[label] = str(work / label)
        print(f"{label}: wrote project with {n} splats (capacity {cap}) to {work / label}")
    return work, projects


def serve_cells(dev, projects: dict[str, str] | None = None) -> dict:
    """{(label, size): Cell} of every serve scene at each of its sizes, its
    project (serve_projects', written if not given) opened as the CLI's
    render opens it."""
    from gaussian_splatterer_tpu_torch.app import cli

    if projects is None:
        projects = serve_projects(dev)[1]
    return {(label, size): Cell(cli._make_session(
                argparse.Namespace(project=projects[label], device=dev.type), require=True),
                size)
            for label, _, _, sizes in SCENES for size in sizes}


def serve_phases(dev, card, only: bool = False) -> dict:
    """Phases 3-5.  Returns the kernel summary entry of composite_fwd.
    ``only`` (``--only k1``): phase 4 writes the projects and holds the
    kernel against plain on their cells without the CLI's renders, and
    phase 5 times the kernel alone."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import splat_arrays
    from gaussian_splatterer_tpu_torch.app import cli
    from gaussian_splatterer_tpu_torch.io.image import load_png
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    phase("3. serve kernel vs plain vs oracle (gate scene: 150 splats, 128^2, seed 7)")
    arrays = splat_arrays(150, 256, seed=7)
    gate_model = SplatModel.from_numpy(*arrays, count=150, device=dev, sh_degree=1)
    gate_cam = Camera(np.array([0.3, -0.2, -10.0], np.float32), np.zeros(3, np.float32), 60.0)
    gate_args = render_args(gate_model, gate_cam, 128, 128, True, BG_GATE, dev)
    max_err = 0.0
    for tile in (16, 32):
        with torch.no_grad():
            comps = project_splat_components(*gate_args[:13], 1, 1.0)
            bins = bin_splats(comps, 128, 128, tile, 2**13)
            feat = rt.gather_features(comps, bins)
            out_k = rt.composite_fwd(feat, bins.tile_start, bins.tile_end, tile, -(-128 // tile))
            out_p = rt.composite_fwd_reference(feat, bins.tile_start, bins.tile_end, tile,
                                               -(-128 // tile))
            torch.cuda.synchronize()
            err_plain = float((out_k - out_p).abs().max())
            img_k = rt.render_tiled(*gate_args, tile=tile, max_dup=2**13)
            img_o = render_oracle(*gate_args, row_chunk=16, tile_cull=tile)
            err_oracle = float((img_k - img_o).abs().max())
        finite = bool(torch.isfinite(img_k).all())
        print(f"tile {tile}: num_dup {bins.num_dup}  max|kernel - plain| {err_plain:.3e} "
              f"(<= {GATE_ATOL_PLAIN})  max|kernel - oracle| {err_oracle:.3e} "
              f"(<= {GATE_ATOL_ORACLE})  finite {finite}")
        if not (finite and err_plain <= GATE_ATOL_PLAIN and err_oracle <= GATE_ATOL_ORACLE):
            raise SystemExit("phase 3 failed")
        max_err = max(max_err, err_plain)

    phase("4. serve main path: gsplat-torch render --mode splats"
          + (" (--only k1: the projects and the kernel against plain on their cells)"
             if only else ""))
    work, projects = serve_projects(dev)
    runs = [(label, size) for label, _, _, sizes in SCENES for size in sizes]
    rt.composite_fwd_launches = 0
    for label, size in [] if only else runs:
        out_png = str(work / f"{label}_{size}.png")
        t0 = time.perf_counter()
        cli.main(["render", projects[label], out_png, "--mode", "splats",
                  "--size", f"{size}x{size}", "--device", "cuda"])
        print(f"  {label} {size}^2: CLI render + PNG write {time.perf_counter() - t0:.3f} s "
              "(host clock, first call)")
    launches = rt.composite_fwd_launches
    if not only:
        print(f"composite_fwd launches in the serve main path: {launches}")
        if launches < len(runs):
            raise SystemExit("phase 4 failed: the main path did not launch the kernel")

    main_max_err, cells = 0.0, serve_cells(dev, projects)
    for (label, size), cell in cells.items():
        session = cell.session
        if not only:
            img = load_png(str(work / f"{label}_{size}.png"))
            share = float((img.max(axis=2) > 0).mean())
            print(f"  {label} {size}^2: png {img.shape}, non-background share {share:.3f}, "
                  f"num_dup {cell.bins.num_dup} (max_dup {session.runtime.max_dup})")
            if img.shape != (size, size, 3) or share < 0.05:
                raise SystemExit("phase 4 failed: PNG check")
        if not 0 < cell.bins.num_dup <= session.runtime.max_dup:
            raise SystemExit("phase 4 failed: num_dup out of range")
        with torch.no_grad():
            diff = (rt.composite_fwd(*cell.composite_args)
                    - rt.composite_fwd_reference(*cell.composite_args, stats=cell.stats)).abs()
        d_max, d_mean = float(diff.max()), float(diff.mean())
        print(f"  {label} {size}^2 kernel vs plain on the same binning ({cell.feat.shape[1]} "
              f"duplicates): max {d_max:.3e} (<= {MAIN_MAX_ATOL})  mean {d_mean:.3e} "
              f"(<= {MAIN_MEAN_ATOL})  pairs visited {cell.stats['pairs']}, inside the "
              f"footprint box {cell.stats['pairs_box']}, composited {cell.stats['composited']}")
        if d_max > MAIN_MAX_ATOL or d_mean > MAIN_MEAN_ATOL:
            raise SystemExit("phase 4 failed: kernel vs plain at full size")
        main_max_err = max(main_max_err, d_max)

    phase(f"5. serve times (CUDA events, median of {REPS} after {WARMUP} warm-ups; {card})")
    times = {}
    for (label, size), cell in cells.items():
        t = cell.times(kernel_only=only)
        times[(label, size)] = t
        print(f"  {label} {size}^2 tile {cell.tile}: " + "  ".join(
            f"{k} {v:.4f} ms" for k, v in t.items()) + f"  [{card}]")
        line = bounds_line(k1_bound, cell.composite_args, cell.stats, t["composite_kernel"])
        print(f"    composite_fwd {line}  [{card}]", flush=True)
    compositor_build_facts(card, "composite_fwd")

    head_key = (SCENES[0][0], SCENES[0][3][0])  # the bench scene at 1024^2
    head = cells[head_key]
    b_ms, b_by = k1_bound(head.composite_args, head.stats, "composite_fwd")
    print("(composite_fwd ms / plain_ms / bound: the 50k-splat bench scene at 1024^2, tile 32)")
    return {
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:340",
        "launches": launches,
        "max_abs_err": max(max_err, main_max_err),
        "ms": times[head_key]["composite_kernel"],
        "plain_ms": times[head_key].get("composite_plain"),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call composites splats
    }


def train_gate(dev) -> float:
    """Phase 6.  Returns the largest kernel-vs-plain error."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import bench_cameras, splat_arrays
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.train import CameraBatch

    phase("6. train gate scene (150 splats, 128^2, 2 frames, seed 11, truths seed 3, tile 32)")
    res, tile = 128, 32
    model = SplatModel.from_numpy(*splat_arrays(150, 256, seed=11), count=150, device=dev,
                                  sh_degree=1)
    cams = CameraBatch.from_cameras(bench_cameras(2), res, res, device=dev)
    truths = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, res, res, 3))
                              .astype(np.float32)).to(dev)
    tiles = rt.image_to_tiles(truths, tile).contiguous()
    bgs = torch.zeros((2, 3), device=dev)

    args = launch_args(model, cams, res, res, tiles, bgs, tile, 2**13)
    out_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    finite, r_max, _, d_max, rel_max, _ = compare_train(args, out_k)
    print(f"kernel vs plain: max|res| {r_max:.3e} (<= {GATE_ATOL_PLAIN})  max|d_feat| "
          f"{d_max:.3e}, over the row's largest {rel_max:.3e} (<= {GATE_ATOL_PLAIN})  "
          f"finite {finite}")
    if not (finite and r_max <= GATE_ATOL_PLAIN and rel_max <= GATE_ATOL_PLAIN):
        raise SystemExit("phase 6 failed: kernel vs plain")

    params = (model.means, model.shs, model.scales, model.opacities, model.rotations)
    loss_f, g_f, var_f, res_f, num_dup, _ = rt.render_train_grads_batch(
        *params, model.active_mask(), *cams, res, res, tiles, bgs, 1, tile=tile,
        max_dup=2**13)
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    total, loss_o = 0.0, 0.0
    with torch.enable_grad():
        for i in range(2):
            img = render_oracle(*leaves, model.active_mask(), cams.view[i], cams.proj_view[i],
                                cams.cam_pos[i], float(cams.tan_fovx[i]),
                                float(cams.tan_fovy[i]), res, res, bgs[i], 1, 1.0,
                                row_chunk=16, tile_cull=tile)
            diff = img - truths[i]
            total = total - 0.5 * torch.sum(diff * diff)
            loss_o += float(torch.mean(diff.detach() * diff.detach()))
        g_o = torch.autograd.grad(total, leaves)
    worst = 0.0
    for name, a, b in zip(("means", "shs", "scales", "opacities", "rotations"), g_f, g_o):
        scale = max(1e-3, float(b.abs().max()))
        dev_rel = float((a - b).abs().max()) / scale
        ok = bool(torch.isfinite(a).all()) and dev_rel <= GRAD_GATE_RTOL
        print(f"  gradient {name}: max deviation over the oracle's largest {dev_rel:.3e} "
              f"(<= {GRAD_GATE_RTOL})  finite {bool(torch.isfinite(a).all())}")
        if not ok:
            raise SystemExit(f"phase 6 failed: {name} gradient against the oracle")
        worst = max(worst, dev_rel)
    loss_rel = abs(float(loss_f) - loss_o) / abs(loss_o)
    finite = bool(torch.isfinite(var_f).all() and torch.isfinite(res_f).all())
    print(f"  loss {float(loss_f):.6f} vs oracle {loss_o:.6f}: rel {loss_rel:.3e} "
          f"(<= {LOSS_GATE_RTOL})  num_dup {num_dup}  var_loc and residual finite {finite}")
    if not (finite and loss_rel <= LOSS_GATE_RTOL):
        raise SystemExit("phase 6 failed: loss against the oracle")
    return max(r_max, d_max)


def teacher_arrays(arrays, n: int):
    """The training cells' teacher: the scene's SH perturbed (seed 1) and its
    opacities scaled by 0.7."""
    t_arrays = [a.copy() for a in arrays]
    rng = np.random.default_rng(1)
    t_arrays[1][:n] += rng.normal(0, 0.2, t_arrays[1][:n].shape).astype(np.float32)
    t_arrays[3][:n] *= np.float32(0.7)
    return t_arrays


def fused_cell(dev, reduction: str = "index_add"):
    """The fused train cell of phases 7 and 16: the bench scene (50k splats)
    at 1024^2, tile 32, frame_group 8, on the app's 16-camera rig, truths
    rendered by the serve path from a perturbed teacher.  Returns (the
    Trainer on the route ``reduction``, its rtx, the scene's arrays)."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import splat_arrays
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.train.trainer import Trainer

    n, cap, res, tile = TRAIN_SPLATS, TRAIN_CAPACITY, TRAIN_RES, TRAIN_TILE
    arrays = splat_arrays(n, cap, seed=0)
    t_arrays = teacher_arrays(arrays, n)
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res,
                            splats_capacity=cap, sh_degree=1, sh_coeffs=4, tile_px=tile,
                            frame_group=TRAIN_GROUP)
    project = Project.app_default()
    project.intervalDensify = 3
    rtx = TeacherRtx(SplatModel.from_numpy(*t_arrays, count=n, device=dev, sh_degree=1),
                     tile, runtime.max_dup)
    trainer = Trainer(project, runtime,
                      SplatModel.from_numpy(*arrays, count=n, device=dev, sh_degree=1),
                      renderer="tiled", reduction=reduction)
    return trainer, rtx, arrays


def host_syncs(fn) -> int:
    """The calls that make the host wait for the device (a copy to or from
    the host, a synchronize) in one fn(), as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def peak_mib(fn) -> tuple[float, float]:
    """(the device memory allocated before one fn(), its peak during it), MiB."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return before / 2**20, torch.cuda.max_memory_allocated() / 2**20


def project_frames_loop(leaves, active, cams, tans, res: int, sh_degree: int):
    """The fused step's projection frame by frame, as before it was
    batched: one project_splat_components call a frame with the tangents as
    host floats (``tans``, (F, 2)), the frames' components in a list and
    their rows concatenated.  Phase 8 times it beside project_frames."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.transforms import (
        SplatComponents, project_splat_components,
    )

    comps, rows = [], []
    for i, (tx, ty) in enumerate(tans):
        c = project_splat_components(leaves[0][i], *leaves[1:], active, cams.view[i],
                                     cams.proj_view[i], cams.cam_pos[i], tx, ty, res, res,
                                     sh_degree, 1.0)
        comps.append(SplatComponents(*(x.detach() for x in c)))
        rows.append(rt._rows(c))
    return comps, torch.cat(rows, dim=1)


def group_step(leaves, active, cams, tans, truth_g, bgs, res: int, tile: int, max_dup: int,
               batched: bool):
    """One fused-step group forward and backward (index_add_ route) with the
    batched front end (project_frames, bin_splats_batch) or the frame-by-
    frame one (project_frames_loop, bin_frames); gather, K3, the reduction
    and the backward through the projection are the same."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_frames, bin_splats_batch

    with torch.enable_grad():
        if batched:
            comps, rows9 = rt.project_frames(*leaves, active, *cams, res, res, 1)
        else:
            comps, rows9 = project_frames_loop(leaves, active, cams, tans, res, 1)
    fb = (bin_splats_batch if batched else bin_frames)(comps, res, res, tile, max_dup)
    tx = -(-res // tile)
    f, tiles = len(tans), tx * tx
    _, d_feat = rt.composite_train(rt.gather_rows(rows9.detach(), fb), fb.tile_start,
                                   fb.tile_end, truth_g.reshape(f * tiles, tile * tile, 3),
                                   bgs, tile, tx, tiles)
    return torch.autograd.grad(rows9, leaves, rt.dup_grads_to_rows(d_feat, fb, rows9.shape[1]))


def train_main(dev, card):
    """Phases 7 and 8.  Returns (the kernel summary entry of
    composite_train, the duplicate gradients of one launch of the trained
    model with its FrameBins and column count)."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.scripts import bench
    from gaussian_splatterer_tpu_torch.train import (
        CameraBatch, DensifyParams, LearningRates, auto_train, densify,
    )
    from gaussian_splatterer_tpu_torch.train.trainer import _apply_sgd

    n, res, tile = TRAIN_SPLATS, TRAIN_RES, TRAIN_TILE
    phase(f"7. train main path: auto_train, {n} splats, {res}^2, tile {tile}, "
          f"frame_group {TRAIN_GROUP}, 16-camera rig")
    trainer, rtx, _ = fused_cell(dev)
    runtime, project = trainer.runtime, trainer.project
    frames = 2 * project.num_cameras
    groups = frames // TRAIN_GROUP
    log = []

    def on_step(it, m):
        log.append((it, float(m.loss), trainer.model.count, int(m.num_dup)))
        print(f"  step {it}: loss {log[-1][1]:.6f}  splats {log[-1][2]}  num_dup "
              f"{log[-1][3]} (max_dup {runtime.max_dup})", flush=True)

    rt.composite_fwd_launches = rt.composite_train_launches = 0
    stats = auto_train(trainer, rtx, TRAIN_STEPS, rng=random.Random(0), on_step=on_step)
    torch.cuda.synchronize()
    launches = rt.composite_train_launches
    print(f"auto_train: {stats}  composite_train launches {launches} (= {TRAIN_STEPS} steps "
          f"x {groups} groups of {TRAIN_GROUP} of {frames} frames)  composite_fwd launches "
          f"(truth capture) {rt.composite_fwd_launches}")
    m = trainer.model
    params = (m.means, m.shs, m.scales, m.opacities, m.rotations)
    finite = all(np.isfinite(x[1]) for x in log) and all(bool(torch.isfinite(p).all())
                                                        for p in params)
    if launches != TRAIN_STEPS * groups or not finite or len(log) != TRAIN_STEPS:
        raise SystemExit("phase 7 failed: launches, or a non-finite loss or parameter")
    if not all(0 < x[3] <= runtime.max_dup for x in log) or rt.composite_fwd_launches < frames:
        raise SystemExit("phase 7 failed: num_dup out of range, or no truth capture")

    # one launch of the trained model: the first group of the step
    cams = CameraBatch(*(x[:TRAIN_GROUP] for x in trainer.truth_cams.twice()))
    truth_g = trainer.truths[:TRAIN_GROUP]
    bgs = torch.ones((TRAIN_GROUP, 3), device=dev)
    args = launch_args(m, cams, res, res, truth_g, bgs, tile, runtime.max_dup)
    k3_stats: dict = {}
    out_k = rt.composite_train(*args)
    torch.cuda.synchronize()
    finite, r_max, r_mean, d_max, rel_max, rel_mean = compare_train(args, out_k, k3_stats)
    print(f"kernel vs plain, one launch ({TRAIN_GROUP} frames, {args[0].shape[1]} duplicates): "
          f"max|res| {r_max:.3e} (<= {MAIN_MAX_ATOL}) mean {r_mean:.3e} (<= {MAIN_MEAN_ATOL})  "
          f"max|d_feat| {d_max:.3e}, over the row's largest: max {rel_max:.3e} "
          f"(<= {MAIN_MAX_ATOL}) mean {rel_mean:.3e} (<= {MAIN_MEAN_ATOL})  finite {finite}  "
          f"pairs visited {k3_stats['pairs']}, inside the footprint box "
          f"{k3_stats.get('pairs_box')}, composited {k3_stats['composited']}")
    if not (finite and r_max <= MAIN_MAX_ATOL and r_mean <= MAIN_MEAN_ATOL
            and rel_max <= MAIN_MAX_ATOL and rel_mean <= MAIN_MEAN_ATOL):
        raise SystemExit("phase 7 failed: kernel vs plain at full size")

    phase(f"8. train times (CUDA events, median; {card})")
    from gaussian_splatterer_tpu_torch.ops.binning import bin_frames, bin_splats_batch

    reps = 10
    leaves = [m.means.detach().expand(TRAIN_GROUP, -1, -1).clone()] + [
        p.detach() for p in params[1:]]
    for x in leaves:
        x.requires_grad_(True)
    active = m.active_mask()
    tans = torch.stack([cams.tan_fovx, cams.tan_fovy], 1).tolist()

    def project_fn():
        with torch.enable_grad():
            return rt.project_frames(*leaves, active, *cams, res, res, 1)

    def project_loop():
        with torch.enable_grad():
            return project_frames_loop(leaves, active, cams, tans, res, 1)

    comps, rows9 = project_fn()
    comps_loop = project_loop()[0]
    fb, _ = rt.train_launch_inputs(rows9.detach(), comps, res, res, truth_g, bgs, tile,
                                   runtime.max_dup)
    _, d_feat = out_k
    d_rows9 = rt.dup_grads_to_rows(d_feat, fb, rows9.shape[1])

    graph = {}  # a fresh projection graph for each backward

    dp = DensifyParams.from_project(project)
    lrs = LearningRates.from_project(project)
    zero_grads = [torch.zeros_like(p) for p in params]
    var = trainer.last_metrics.var_loc
    avg = trainer.last_metrics.avg_grad_loc
    group = {  # one group of TRAIN_GROUP frames; "frame by frame": the unbatched forms
        "projection forward": cuda_ms(project_fn, reps=reps),
        "projection forward, frame by frame": cuda_ms(project_loop, reps=reps),
        "binning": cuda_ms(lambda: bin_splats_batch(comps, res, res, tile, runtime.max_dup),
                           reps=reps),
        "binning, frame by frame": cuda_ms(
            lambda: bin_frames(comps_loop, res, res, tile, runtime.max_dup), reps=reps),
        "gather": cuda_ms(lambda: rt.gather_rows(rows9.detach(), fb), reps=reps),
        "composite_train kernel": cuda_ms(lambda: rt.composite_train(*args), reps=reps),
        "reduction": cuda_ms(lambda: rt.dup_grads_to_rows(d_feat, fb, rows9.shape[1]),
                             reps=reps),
        "projection backward": cuda_ms(
            lambda: torch.autograd.grad(graph["rows"], leaves, d_rows9), reps=reps,
            setup=lambda: graph.update(rows=project_fn()[1])),
        "projection backward, frame by frame": cuda_ms(
            lambda: torch.autograd.grad(graph["rows"], leaves, d_rows9), reps=reps,
            setup=lambda: graph.update(rows=project_loop()[1])),
    }
    step = {k: v * groups for k, v in group.items() if "frame by frame" not in k}
    step["sgd"] = cuda_ms(lambda: _apply_sgd(m, zero_grads, lrs), reps=reps)
    step["densify"] = cuda_ms(lambda: densify(m, var, avg, dp), reps=reps)
    step["whole step"] = cuda_ms(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs),
        warmup=1, reps=5)
    print(f"  per group of {TRAIN_GROUP} frames: " + "  ".join(
        f"{k} {v:.3f} ms" for k, v in group.items()) + f"  [{card}]")
    print(f"  per step of {frames} frames ({groups} groups): " + "  ".join(
        f"{k} {v:.3f} ms" for k, v in step.items()) + f"  [{card}]")
    print(f"  train steps/s {1e3 / step['whole step']:.3f}  [{card}]")

    # the front end's device ops, batched against frame by frame
    def device_ops(fn) -> int:
        return sum(c for _, c in device_busy_ms(fn)[2].values())

    for label, proj, binner in (
            ("batched", project_fn,
             lambda: bin_splats_batch(comps, res, res, tile, runtime.max_dup)),
            ("frame by frame", project_loop,
             lambda: bin_frames(comps_loop, res, res, tile, runtime.max_dup))):
        fwd, binned = device_ops(proj), device_ops(binner)
        both = device_ops(lambda: torch.autograd.grad(proj()[1], leaves, d_rows9))
        print(f"  device ops of one group, {label} (torch.profiler): projection forward {fwd}  "
              f"binning {binned}  projection forward and backward {both}  [{card}]")

    # one group forward and backward, batched front end against frame by frame
    for label, batched in (("batched", True), ("frame by frame", False)):
        def one_group(batched=batched):
            return group_step(leaves, active, cams, tans, truth_g, bgs, res, tile,
                              runtime.max_dup, batched)

        g_ms = cuda_ms(one_group, reps=reps)
        busy, _, by_name = device_busy_ms(one_group)
        before, peak = peak_mib(one_group)
        print(f"  one group ({TRAIN_GROUP} frames) forward and backward, {label} front end: "
              f"{g_ms:.3f} ms  device busy {busy:.3f} ms (share {busy / g_ms:.3f})  device ops "
              f"{sum(c for _, c in by_name.values())}  host syncs {host_syncs(one_group)}  "
              f"peak memory {peak:.1f} MiB ({peak - before:.1f} above the {before:.1f} "
              f"allocated before)  [{card}]")
    group_syncs, cumsum_syncs = (host_syncs(lambda red=red: rt.render_train_grads_batch(
        *params, active, *cams, res, res, truth_g, bgs, 1, tile=tile, max_dup=runtime.max_dup,
        reduction=red)) for red in ("index_add", "cumsum"))
    step_syncs = host_syncs(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs))
    print(f"  host syncs: render_train_grads_batch on one group {group_syncs} (the F duplicate "
          f"counts; at most 1), on the cumsum route {cumsum_syncs}; the whole step "
          f"{step_syncs}  [{card}]")
    if group_syncs != 1:
        raise SystemExit("phase 8 failed: the batched front end synced other than once a group")

    plain_ms = cuda_ms(lambda: rt.composite_train_reference(*args), warmup=0, reps=2)
    k3_ms = group["composite_train kernel"]
    b_ms, b_by = k3_bound(args, k3_stats, "composite_train")
    print(f"  composite_train per launch ({TRAIN_GROUP} frames): kernel {k3_ms:.4f} ms  plain "
          f"{plain_ms:.3f} ms  {bounds_line(k3_bound, args, k3_stats, k3_ms)}  [{card}]")
    compositor_build_facts(card, "composite_train")

    # the bench's headline call (scripts/bench.py), timed as the bench times it
    headline, _ = bench.time_fwdbwd(bench.headline_inputs(dev), bench.W, bench.TILE,
                                    bench.MAX_DUP, reps)
    print(f"  fwd+bwd ms/frame (scripts/bench.py's call and timing, {reps} calls): "
          f"{headline:.4f}  [{card}]")

    busy_ms, profiled_ms, step_ops = device_busy_ms(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs))
    print(f"  device busy time of a step (torch.profiler): {busy_ms:.3f} ms, busy share "
          f"{busy_ms / step['whole step']:.3f} of the {step['whole step']:.3f} ms step "
          f"({busy_ms / profiled_ms:.3f} of the {profiled_ms:.3f} ms profiled step), device ops "
          f"{sum(c for _, c in step_ops.values())}  [{card}]")
    if busy_ms <= 0.0:
        raise SystemExit("phase 8 failed: the profiler recorded no device time")
    return {
        "name": "composite_train",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_train.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:583",
        "launches": launches,
        "max_abs_err": max(r_max, d_max),
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call composites splats
    }, (d_feat, fb, rows9.shape[1])


def write_obj(mesh, path: str) -> None:
    """The mesh as a Wavefront OBJ, one ``vt`` per triangle corner."""
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vt {u!r} {v!r}" for u, v in mesh.tri_uv.reshape(-1, 2).tolist()]
    lines += [f"f {a + 1}/{3 * i + 1} {b + 1}/{3 * i + 2} {c + 1}/{3 * i + 3}"
              for i, (a, b, c) in enumerate(mesh.triangles)]
    Path(path).write_text("\n".join(lines) + "\n")


def surface_rays(mesh, n: int, seed: int):
    """``n`` bounce rays as the tracer makes them, as CPU tensors: origins on
    random triangles of the mesh (the cancellation case of t_num),
    directions the face normal plus a unit-ball sample, not normalised."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, mesh.num_triangles, n)
    a, b, c = (mesh.vertices[mesh.triangles[tri, k]] for k in range(3))
    w = rng.dirichlet(np.ones(3), n).astype(np.float32)
    o = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    g = rng.normal(size=(n, 3))
    ball = g / np.linalg.norm(g, axis=1, keepdims=True) * rng.uniform(size=(n, 1)) ** (1 / 3)
    d = (nrm + ball).astype(np.float32)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d)


def ns_project():
    """The north star's rig: 8 cameras on sphere 1 (16 frames a capture),
    32 samples a pixel (runs/README.md, ns_r5)."""
    from gaussian_splatterer_tpu_torch.config import Project

    p = Project.app_default()
    p.sphere1.count = NS_CAMS
    p.rtSamples = NS_SAMPLES
    return p


def close_camera():
    """The close-up camera of scripts/tracer_one.py (about 13.6% coverage)."""
    from gaussian_splatterer_tpu_torch.models.camera import Camera

    return Camera(np.array([0.3, -0.2, -4.0], np.float32), np.zeros(3, np.float32), 60.0)


def camera_rays(camera, res: int, dev, seed: int, samples: int):
    """``samples`` jittered res^2 frames of primary rays from ``camera``,
    sample-major, as render_rtx_sums launches one batch of them."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    inv_pv = np.linalg.inv(camera.get_proj_view(1.0).astype(np.float64)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = samples * res * res
    jitter = torch.rand((r, 2), generator=gen, device=dev)
    d = tr.primary_rays(torch.arange(res * res, device=dev).repeat(samples), jitter, res, res,
                        inv_pv, camera.location)
    o = torch.as_tensor(camera.location, device=dev).expand(r, 3).contiguous()
    return o, d


def pair_hits64(o, d, tris, idx):
    """float64 (t, u, v) of each ray (o, d) with its triangle ``idx``, in
    the component Möller-Trumbore form."""
    o, d = o.double(), d.double()
    a, e1, e2 = (torch.stack([tris[f"{n}{c}"][idx] for c in "xyz"], 1).double()
                 for n in ("a", "e1", "e2"))
    p = torch.cross(d, e2, dim=1)
    det = (e1 * p).sum(1)
    tv = o - a
    q = torch.cross(tv, e1, dim=1)
    return (e2 * q).sum(1) / det, (tv * p).sum(1) / det, (d * q).sum(1) / det


def hit_winners(o, d, tris, k, p) -> dict:
    """The hit masks and winners of hits ``k`` against ``p`` (t, idx, u, v)
    on the same rays, as phase 9 judges them: the share of rays whose
    masks agree, the rays where both hit and found another triangle, how
    many may (1 - K5_MASK_SHARE of the rays both hit), and whether each is
    an exact tie: in float64 k's triangle lies at p's winner's distance
    (rel K5_T_RTOL) and holds the hit point (barycentrics within
    K5_TIE_BARY_ATOL).  A tie is judged in float64 because the two sides
    round their sums in different orders.  Also k's miss contract."""
    hk, hp = torch.isfinite(k[0]), torch.isfinite(p[0])
    r = hk.numel()
    both = hk & hp
    same = both & (k[1] == p[1])
    other = (both & ~same).nonzero()[:, 0]
    ties = True
    if other.numel():
        tk, uk, vk = pair_hits64(o[other], d[other], tris, k[1][other].long())
        tp, _, _ = pair_hits64(o[other], d[other], tris, p[1][other].long())
        ties = bool((((tk - tp).abs() <= K5_T_RTOL * tp.abs()) & (uk >= -K5_TIE_BARY_ATOL)
                     & (vk >= -K5_TIE_BARY_ATOL) & (uk + vk <= 1.0 + K5_TIE_BARY_ATOL)).all())
    miss_ok = not (k[1][~hk].any() or k[2][~hk].any() or k[3][~hk].any()
                   or torch.isfinite(k[0][~hk]).any())
    w = {"rays": r, "hits": int(hk.sum()), "both": both, "same": same, "ties": ties,
         "mask_share": float((hk == hp).float().mean()) if r else 1.0,
         "n_other": other.numel(), "limit": (1.0 - K5_MASK_SHARE) * int(both.sum()),
         "miss_ok": miss_ok}
    w["ok"] = (w["mask_share"] >= K5_MASK_SHARE and w["n_other"] <= w["limit"] and ties
               and miss_ok)
    w["text"] = (f"{r} rays, {w['hits']} hits; masks agree {w['mask_share']:.6f} (>= "
                 f"{K5_MASK_SHARE}); another winner on {w['n_other']} rays (<= "
                 f"{w['limit']:.1f}), all exact ties {ties}; miss contract {miss_ok}")
    return w


def compare_hits(label: str, o, d, tris, k, p, phase_no: int = 9) -> float:
    """K5's hits (t, idx, u, v) against its plain twin's on the same rays:
    the gate of phase 9.  The masks and winners as hit_winners judges
    them; where both found the same triangle, t within K5_T_RTOL and u, v
    within K5_UV_ATOL.  Returns the largest |difference| of t, u and v
    there."""
    w = hit_winners(o, d, tris, k, p)
    both, same = w["both"], w["same"]
    rel = ((k[0] - p[0]).abs() / p[0].abs().clamp(min=1e-30))[both]
    t_rel = float(rel.max()) if rel.numel() else 0.0
    uv_err = max((float((a - b).abs()[same].max()) if same.any() else 0.0)
                 for a, b in ((k[2], p[2]), (k[3], p[3])))
    t_err = float((k[0] - p[0]).abs()[same].max()) if same.any() else 0.0
    print(f"  {label}: {w['text']}; t rel {t_rel:.3e} (<= {K5_T_RTOL}); |u|,|v| {uv_err:.3e} "
          f"(<= {K5_UV_ATOL})", flush=True)
    if not (w["ok"] and t_rel <= K5_T_RTOL and uv_err <= K5_UV_ATOL):
        raise SystemExit(f"phase {phase_no} failed: {label}")
    return max(uv_err, t_err)


def compare_forms(label: str, o, d, tris, k, p, phase_no: int = 20) -> float:
    """K9's hits ``k`` against K5's ``p`` on the same rays: two forms of the
    arithmetic (K9's component Möller-Trumbore against K5's feat10 dot
    products), which round the cancellations of the numerators
    differently, so their t, u and v differ by more than phase 9's
    tolerances where a triangle is small or seen at a grazing angle (up to
    1.3e-3 in u on the mesh-res 256 primaries).  The masks and winners are
    held as phase 9 holds them (hit_winners); k's t, u and v on its hits
    are held to float64, each within K9_F64_ULPS float32 roundings of its
    own condition (its terms' magnitudes over |det|, the det's error
    carried through the division).  Returns the largest of those errors
    over their bounds."""
    w = hit_winners(o, d, tris, k, p)
    hit = torch.isfinite(k[0])
    idx = k[1][hit].long()
    o64, d64 = o[hit].double(), d[hit].double()
    a, e1, e2 = (torch.stack([tris[f"{n}{c}"][idx] for c in "xyz"], 1).double()
                 for n in ("a", "e1", "e2"))
    pv = torch.cross(d64, e2, dim=1)
    det = (e1 * pv).sum(1)
    wv = o64 - a
    q = torch.cross(wv, e1, dim=1)
    t, u, v = (e2 * q).sum(1) / det, (wv * pv).sum(1) / det, (d64 * q).sum(1) / det
    nd, n1, n2, nw = (x.norm(dim=1) for x in (d64, e1, e2, wv))
    eps = K9_F64_ULPS * 2.0 ** -24 / det.abs()
    det_err = n1 * nd * n2
    worst = 0.0
    for got, x, terms in ((k[0][hit], t, n2 * nw * n1), (k[2][hit], u, nw * nd * n2),
                          (k[3][hit], v, nd * nw * n1)):
        ratio = (got.double() - x).abs() / (eps * (terms + x.abs() * det_err))
        worst = max(worst, float(ratio.max()) if ratio.numel() else 0.0)
    print(f"  {label}: {w['text']}; K9's t, u, v against float64: the largest error "
          f"{worst:.3e} of its bound ({K9_F64_ULPS} roundings of the pair's condition; <= 1)",
          flush=True)
    if not (w["ok"] and worst <= 1.0):
        raise SystemExit(f"phase {phase_no} failed: {label}")
    return worst


def k5_slices(dev, r: int, t_real: int) -> int:
    """The slices over triangles K5's wrapper chooses for ``r`` rays."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    return tr.slice_plan(r, t_real, tr.mt_slots(dev), tr.K5_RAYS_PER_BLOCK)[0]


def tracer_gate(dev) -> float:
    """Phase 9.  Returns the largest kernel-vs-plain error."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture
    from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    phase("9. tracer kernel mt_intersect vs plain (random soup; mushroom bounce rays and "
          "a batch of primary rays; a 32^2 render)")
    worst = 0.0
    rng = np.random.default_rng(3)  # the random soup of tests/test_rt.py:377-393
    soup = RtxHost(tri_chunk=16, device=dev)
    soup.load_model(TriangleMesh(rng.uniform(-2, 2, (120, 3)).astype(np.float32),
                                 np.arange(120, dtype=np.int32).reshape(40, 3),
                                 rng.uniform(0, 1, (40, 3, 2)).astype(np.float32)))
    o = rng.uniform(-4, 4, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    pairs = [("random soup, 40 triangles", soup, o, d)]

    mesh = mushroom_mesh(NS_MESH[0], NS_MESH[1])
    host = RtxHost(device=dev)
    host.load_model(mesh)
    o, d = surface_rays(mesh, K5_BOUNCE_RAYS, seed=4)
    pairs.append((f"mushroom ({mesh.num_triangles} triangles), bounce rays from its surface",
                  host, o.to(dev), d.to(dev)))
    o, d = camera_rays(Camera.get_cameras(ns_project())[0], NS_RES, dev, seed=1,
                       samples=host.sample_batch)
    pairs.append((f"mushroom, one batch of primary rays from rig camera 0 "
                  f"({host.sample_batch} samples of {NS_RES}^2)", host, o, d))
    for label, h, o, d in pairs:
        k = tr.intersect(o, d, h._tris, h.tri_chunk)
        p = tr.intersect_reference(o, d, h._tris, h.tri_chunk)
        torch.cuda.synchronize()
        worst = max(worst, compare_hits(label, o, d, h._tris, k, p))
    # the split over triangles (a launch of a few thousand rays, as a late
    # bounce makes) against the unsplit launch, and a second launch, on the
    # primary batch: bit for bit
    tris, tc = host._tris, host.tri_chunk
    again = tr.intersect(o, d, tris, tc)
    same = all(torch.equal(a, b) for a, b in zip(k, again))
    for n in (1024, 8192, 65536):
        part = tr.intersect(o[:n], d[:n], tris, tc)
        same = same and all(torch.equal(a, b[:n]) for a, b in zip(part, k))
    splits = [k5_slices(dev, n, tris["tri40"].shape[0]) for n in (1024, 8192, 65536)]
    print(f"  split vs unsplit: intersect(o[:n]) equals intersect(o)[:n] bit for bit at n = "
          f"1024, 8192, 65536 (slices {splits}), and a second launch equals the first: {same}",
          flush=True)
    if not same:
        raise SystemExit("phase 9 failed: the split or a second launch changed a hit")
    del o, d, k, p, pairs, again, part

    # the same 32^2 render, one generator seed, through either intersector
    host.load_texture_diffuse(mushroom_texture())
    cam = close_camera()
    inv_pv = np.linalg.inv(cam.get_proj_view(1.0).astype(np.float64)).astype(np.float32)
    imgs = []
    for fn in (None, tr.intersect_reference):  # None: the tracer's route, K5 here
        gen = torch.Generator(device=dev).manual_seed(5)
        sums = tr.render_rtx_sums(host._tris, host._texture, cam.location, inv_pv, 32, 32,
                                  NS_SAMPLES, (0.0, 0.0, 0.0), gen, tri_chunk=host.tri_chunk,
                                  sample_batch=host.sample_batch, intersector=fn)
        imgs.append(tr.finish_rtx(*sums, NS_SAMPLES, 32, 32))
    diff = (imgs[0] - imgs[1]).abs().amax(dim=-1)
    share = float((diff < K5_RENDER_ATOL).float().mean())
    print(f"  32^2 render, close-up camera, {NS_SAMPLES} samples, seed 5: kernel vs plain "
          f"pixels within {K5_RENDER_ATOL}: {share:.4f} (>= {K5_RENDER_SHARE}); means "
          f"{float(imgs[0].mean()):.6f} and {float(imgs[1].mean()):.6f}", flush=True)
    if share < K5_RENDER_SHARE:
        raise SystemExit("phase 9 failed: render with the kernel vs with the plain intersector")
    return worst


def module_run(module: str, *args: str, timeout: int,
               phase_no: int) -> subprocess.CompletedProcess:
    """``python -m gaussian_splatterer_tpu_torch.<module> args`` in a
    subprocess from the checkout; a nonzero exit fails the phase."""
    proc = subprocess.run([sys.executable, "-m", f"gaussian_splatterer_tpu_torch.{module}",
                           *args], cwd=HERE, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
        raise SystemExit(f"phase {phase_no} failed: `{module} {' '.join(args[:1])}` exited "
                         f"{proc.returncode}")
    return proc


def cli(*args: str, timeout: int, phase_no: int = 10) -> tuple[str, float]:
    """One ``gsplat-torch`` command in a subprocess from the checkout:
    (its standard output, its seconds on the host clock)."""
    t0 = time.perf_counter()
    proc = module_run("app", *args, timeout=timeout, phase_no=phase_no)
    return proc.stdout, time.perf_counter() - t0


def script(name: str, *args: str, timeout: int, phase_no: int) -> tuple[list[str], dict, float]:
    """One measuring script, ``python -m
    gaussian_splatterer_tpu_torch.scripts.<name> args``, in a subprocess:
    (its standard output's lines, the kernels' launches it reports on
    standard error, its seconds on the host clock)."""
    t0 = time.perf_counter()
    proc = module_run(f"scripts.{name}", *args, timeout=timeout, phase_no=phase_no)
    secs = time.perf_counter() - t0
    reports = [json.loads(line) for line in proc.stderr.splitlines()
               if line.startswith('{"launches"')]
    if len(reports) != 1:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"phase {phase_no} failed: {name} reported no launch counts")
    return proc.stdout.strip().splitlines(), reports[0]["launches"], secs


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def bench_phase(dev, card) -> dict:
    """Phase 18: the port's bench as a user runs it (its headline and
    gates), at tile 16 with a max_dup sized from a probe, and bench_scale
    at SCALE_SIZES.  Returns the kernels' launches of these runs."""
    from gaussian_splatterer_tpu_torch.scripts import bench

    phase(f"18. bench: python -m gaussian_splatterer_tpu_torch.scripts.bench (the headline "
          f"and its gates), --tile 16, and bench_scale at "
          f"{', '.join(f'{n:,}' for n in SCALE_SIZES)} splats ({card})")
    torch.cuda.empty_cache()
    total: dict = {}
    rows = {}
    for tile in (bench.TILE, 16):
        args: tuple[str, ...] = ()
        if tile != bench.TILE:
            inputs = bench.headline_inputs(dev, tile=tile)
            num_dup = bench.probe_num_dup(inputs, bench.W, tile)
            del inputs
            torch.cuda.empty_cache()
            args = ("--tile", str(tile), "--max-dup", str(bench.sized_max_dup(num_dup)))
            print(f"  tile {tile}: the probe's num_dup {num_dup} -> {' '.join(args)}")
        lines, launches, secs = script("bench", *args, timeout=600, phase_no=18)
        head = json.loads(lines[-1])
        rows[tile] = head
        add_launches(total, launches)
        print(f"  bench{' ' + ' '.join(args) if args else ''}: {secs:.1f} s (host clock, "
              f"process included); launches {launches}")
        print(f"  {json.dumps(head)}  [{card}]", flush=True)
        ok = (len(lines) == 1 and tuple(head) == BENCH_KEYS and np.isfinite(head["value"])
              and head["value"] > 0
              and head["numerics_gate_max_err"] <= bench.NUMERICS_ATOL
              and head["grad_gate_max_err"] <= bench.GRAD_GATE_RTOL
              and launches["composite_fwd"] >= 1
              and launches["composite_train"] == bench.REPS + 2)
        if not ok:
            raise SystemExit("phase 18 failed: the bench's line, a gate, or its launches")
    print(f"  fwd+bwd ms/frame: tile 32 {rows[32]['value']}  tile 16 {rows[16]['value']}  "
          f"[{card}]")

    torch.cuda.empty_cache()
    lines, launches, secs = script("bench_scale", "--sizes", ",".join(map(str, SCALE_SIZES)),
                                   timeout=900, phase_no=18)
    add_launches(total, launches)
    print(f"  bench_scale: {secs:.1f} s (host clock, process included); launches {launches}")
    scale = [json.loads(line) for line in lines]
    for row in scale:
        print(f"  {json.dumps(row)}  [{card}]", flush=True)
    if [r["n_splats"] for r in scale] != list(SCALE_SIZES) or not all(
            np.isfinite(r["ms_per_frame"]) and r["num_dup"] <= r["max_dup"] for r in scale):
        raise SystemExit("phase 18 failed: bench_scale's rows")
    return total


def quality_phase(card) -> dict:
    """Phase 19: quality_run on the north star at the ns_r5 width in two
    processes (the second resumes the first's checkpoint), then
    eval_model on its final model.  Returns the kernels' launches of the
    three processes."""
    from gaussian_splatterer_tpu_torch.io.checkpoint import digest, load_checkpoint

    phase(f"19. quality: quality_run on the north star at the ns_r5 width ({NS_RES}^2, "
          f"{NS_CAMS} cameras, {NS_SAMPLES} samples, capacity {NS_CAPACITY:,}, recapture every "
          f"50, densify every 150): {Q_RESUME_AT} steps, a checkpoint every {Q_CHECKPOINT}; "
          f"--resume to {Q_STEPS} in a second process; eval_model ({card})")
    torch.cuda.empty_cache()
    (HERE / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_", dir=HERE / "build")) / "run"
    common = (*NS_QUALITY, "--checkpoint-every", str(Q_CHECKPOINT), "--out", str(out_dir))
    total: dict = {}
    results = []
    for steps, resume in ((Q_RESUME_AT, ()), (Q_STEPS, ("--resume",))):
        want = digest(str(out_dir / "ckpt" / "latest.npz")) if resume else None
        lines, launches, secs = script("quality_run", "--steps", str(steps), *resume, *common,
                                       timeout=900, phase_no=19)
        add_launches(total, launches)
        for line in lines:
            print(f"  {line}")
        result = json.loads(lines[-1])
        results.append(result)
        print(f"  quality_run --steps {steps}{' --resume' if resume else ''}: {secs:.1f} s "
              f"(host clock, process included); launches {launches}", flush=True)
        trained = steps - (Q_RESUME_AT if resume else 0)
        if launches["composite_train"] != trained * 2 * NS_CAMS // TRAIN_GROUP or not (
                launches["mt_intersect"] > 0 and launches["composite_fwd"] > 0):
            raise SystemExit("phase 19 failed: a step, capture or render did not launch its "
                             "kernel")
        if resume and not (f"resumed at iteration {Q_RESUME_AT};" in lines[0]
                           and lines[1].endswith(f"sha256 {want}")):
            raise SystemExit("phase 19 failed: the second process did not resume at iteration "
                             f"{Q_RESUME_AT} from a model bit-equal to the checkpoint")
    _, project = load_checkpoint(str(out_dir / "final.npz"), device="cpu")
    lines, launches, secs = script("eval_model", str(out_dir), "--samples", str(NS_SAMPLES),
                                   "--views", str(Q_EVAL_VIEWS), "--res", str(NS_RES),
                                   "--scene", "mushroom", "--mesh-res", str(NS_MESH[0]),
                                   timeout=600, phase_no=19)
    add_launches(total, launches)
    ev = json.loads(lines[-1])
    print(f"  eval_model --samples {NS_SAMPLES} --views {Q_EVAL_VIEWS}: {secs:.1f} s; {lines[-1]}"
          f"; launches {launches}")
    last = results[-1]
    print(f"  after {Q_STEPS} steps ({project.iterations} iterations in final.npz): held-out "
          f"PSNR {last['psnr_mean']} dB, SSIM {last['ssim_mean']} (4 views); eval_model PSNR "
          f"{ev['psnr_mean']} dB, SSIM {ev['ssim_mean']} ({Q_EVAL_VIEWS} views, seed 123); "
          f"steps/s {results[0]['steps_per_s']} / {last['steps_per_s']}; capture_frac "
          f"{results[0]['schedule']['capture_frac']} / {last['schedule']['capture_frac']}; "
          f"splats {last['final_splats']}  [{card}]", flush=True)
    values = [r[k] for r in (*results, ev) for k in ("psnr_mean", "ssim_mean")] + [
        r["steps_per_s"] for r in results] + [r["schedule"]["capture_frac"] for r in results]
    if project.iterations != Q_STEPS or not all(np.isfinite(v) for v in values):
        raise SystemExit("phase 19 failed: the iteration count or a non-finite value")
    return total


def tracer_main(device: str = "cuda", mesh_res: tuple[int, int] = NS_MESH, phase_no: int = 10,
                kernel: str = "mt_intersect") -> dict:
    """Phase 10: ``new`` -> ``train`` -> ``render --mode rtx`` through the
    CLI on the north star; phase 20 the same on the mushroom at mesh
    resolution ``mesh_res``.  Each capture's step must report launches of
    ``kernel`` (the intersector of the mesh's route).  Returns the
    kernels' launches of ``train``."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.io.image import load_png, save_png

    mesh = mushroom_mesh(*mesh_res)
    phase(f"{phase_no}. tracer main path: gsplat-torch new -> train -> render --mode rtx, the "
          f"mushroom {'north star' if mesh_res == NS_MESH else f'at mesh-res {mesh_res[0]}'} "
          f"({mesh.num_triangles:,} triangles; {NS_RES}^2, {NS_CAMS}-camera rig, {NS_SAMPLES} "
          f"samples, capacity {NS_CAPACITY})")
    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_rtx_", dir=HERE / "build"))
    write_obj(mesh, str(work / "mushroom.obj"))
    save_png(mushroom_texture()[..., :3], str(work / "mushroom.png"), flip_vertical=False)
    proj = str(work / "project")
    out, secs = cli("new", proj, "--obj", str(work / "mushroom.obj"), "--texture",
                    str(work / "mushroom.png"), "--init-field", "model", "--resolution",
                    str(NS_RES), "--capacity", str(NS_CAPACITY), "--max-dup", str(NS_MAX_DUP),
                    *NS_RUNTIME, "--device", device, timeout=300, phase_no=phase_no)
    print(f"  new: {secs:.3f} s (host clock): {out.strip()}")
    # the north star's rig and schedule: capture before iteration 0 and
    # again at 3, densify at 0 and 4 (train/schedule.py)
    p = Project.load(f"{proj}/settings.json")
    ns = ns_project()
    p.sphere1.count, p.rtSamples = ns.sphere1.count, ns.rtSamples
    p.intervalCapture, p.intervalDensify = NS_INTERVAL_CAPTURE, NS_INTERVAL_DENSIFY
    p.paramDensifyVariance = NS_DENSIFY_VARIANCE
    p.save(f"{proj}/settings.json")

    out, secs = cli("train", proj, "--steps", str(NS_STEPS), "--log-every", "1",
                    "--device", device, timeout=900, phase_no=phase_no)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        print(f"  {line}")
    stats = json.loads(lines[-1])
    hits, k3 = stats["launches"][kernel], stats["launches"]["composite_train"]
    # the other intersector: a mesh takes one route for every intersection
    rival = sum(stats["launches"]["mt_culled" if kernel == "mt_intersect" else "mt_intersect"])
    captures = [i for i in range(NS_STEPS) if i % NS_INTERVAL_CAPTURE == 0]
    groups = 2 * NS_CAMS // TRAIN_GROUP
    others = {k: sum(v) for k, v in stats["launches"].items() if k not in (kernel, "composite_train")}
    print(f"  train: {secs:.3f} s (host clock, process included); capture {stats['capture_s']} s "
          f"in {1 + stats['recaptures']} captures of {2 * NS_CAMS} frames; {kernel} "
          f"launches by step (the capture before it included) {hits}; composite_train {k3} "
          f"(= {NS_STEPS} steps x {groups} groups); other launches {others}; splats "
          f"{stats['splats']}")
    losses = [float(line.split()[3]) for line in lines if line.startswith("iter ")]
    launched = all(hits[i] > 0 for i in captures) and sum(k3) == NS_STEPS * groups and rival == 0
    if len(losses) != NS_STEPS or not all(np.isfinite(losses)):
        raise SystemExit(f"phase {phase_no} failed: a loss is missing or not finite")
    if device != "cpu" and not launched:  # the CPU runs the plain versions
        raise SystemExit(f"phase {phase_no} failed: a capture or a step did not launch its "
                         f"kernel, or a capture launched the other intersector")
    from gaussian_splatterer_tpu_torch.io.gobj import load_gobj

    host_model = load_gobj(f"{proj}/splats.gobj", capacity=NS_CAPACITY)
    n = host_model.count
    finite = all(np.isfinite(getattr(host_model, k)[:n]).all()
                 for k in ("means", "shs", "scales", "opacities", "rotations"))
    if not finite or n == 0:
        raise SystemExit(f"phase {phase_no} failed: the trained parameters are not finite")

    png = str(work / "rtx.png")
    out, secs = cli("render", proj, png, "--mode", "rtx", "--size", f"{NS_RES}x{NS_RES}",
                    "--samples", str(NS_SAMPLES), "--device", device, timeout=300,
                    phase_no=phase_no)
    img = load_png(png)
    lit = float((img.max(axis=2) > 0).mean())
    print(f"  render --mode rtx: {secs:.3f} s (host clock, process included); png "
          f"{img.shape}, {lit:.4f} of the pixels not black (>= {NS_LIT_SHARE}), "
          f"{len(np.unique(img.reshape(-1, 3), axis=0))} colours", flush=True)
    if img.shape != (NS_RES, NS_RES, 3) or lit < NS_LIT_SHARE or img.min() == img.max():
        raise SystemExit(f"phase {phase_no} failed: PNG check")
    return {name: sum(v) for name, v in stats["launches"].items()}


def tracer_times(dev, card, launches: int, gate_err: float) -> dict:
    """Phase 11.  Returns the kernel summary entry of mt_intersect."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    phase(f"11. tracer times (CUDA events; {card})")
    mesh = mushroom_mesh(NS_MESH[0], NS_MESH[1])
    host = RtxHost(device=dev)
    host.load_model(mesh)
    host.load_texture_diffuse(mushroom_texture())
    cams = (("north-star camera (rig camera 0)", Camera.get_cameras(ns_project())[0]),
            ("close-up camera", close_camera()))
    for label, cam in cams:
        s = cuda_ms(lambda: host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES),
                    warmup=1, reps=2) / 1e3
        img = host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES, seed=1)
        cover = float((img.amax(dim=-1) > 0).float().mean())
        before = tr.mt_intersect_launches
        busy_ms, wall_ms, by_name = device_busy_ms(
            lambda: host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES))
        per_frame = (tr.mt_intersect_launches - before) // 2  # warm-up and profiled frame
        print(f"  {label}: {s:.4f} s per {NS_SAMPLES}-sample {NS_RES}^2 capture frame "
              f"(median of 2 after 1 warm-up); coverage {cover:.4f}; device busy "
              f"{busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled frame, share "
              f"{busy_ms / wall_ms:.3f}; {per_frame} mt_intersect launches and "
              f"{sum(n for _, n in by_name.values())} device kernels and copies a frame  "
              f"[{card}]", flush=True)
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"    device {ms:.3f} ms in {n} runs: {name[:90]}")
        if busy_ms <= 0.0:
            raise SystemExit("phase 11 failed: the profiler recorded no device time")

    # one batch of primary rays, the launch shape of a capture's primary
    # step (sample_batch samples of the frame); its first frame alone too
    o, d = camera_rays(cams[0][1], NS_RES, dev, seed=1, samples=host.sample_batch)
    tris, tc = host._tris, host.tri_chunk
    r, n_pix, t_pad = o.shape[0], NS_RES * NS_RES, int(tris["valid"].numel())
    t_real = int(tris["valid"].sum())
    k5_ms = cuda_ms(lambda: tr.intersect(o, d, tris, tc))
    k5_frame_ms = cuda_ms(lambda: tr.intersect(o[:n_pix], d[:n_pix], tris, tc))
    plain_ms = cuda_ms(lambda: tr.intersect_reference(o, d, tris, tc), warmup=1, reps=3)
    # the (R, 10) x (10, 4T) product alone, one frame of rays a call into
    # one reused output: the whole batch's would not fit on the card
    r10 = tr._ray_features(o, d)
    prod = torch.empty((n_pix, 4 * t_pad), dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: [torch.matmul(r10[s:s + n_pix], tris["feat10"], out=prod)
                              for s in range(0, r, n_pix)], warmup=1, reps=3)
    del prod, r10
    b_ms, b_by = k5_bound(r, t_real, K5_OPS_PAIR_MIN, "mt_intersect")
    b_old, _ = k5_bound(r, t_real, K5_OPS_PAIR)
    print(f"  mt_intersect per launch on a batch of primary rays ({host.sample_batch} samples "
          f"of {NS_RES}^2 = {r} rays x {t_pad} triangles, {t_real} real): kernel {k5_ms:.3f} "
          f"ms  plain {plain_ms:.3f} ms  torch.matmul of the (R, 10) x (10, {4 * t_pad}) "
          f"product alone, {r // n_pix} calls of {n_pix} rays, {lib_ms:.3f} ms  bound "
          f"{b_ms:.4f} ms ({b_by}, {K5_OPS_PAIR_MIN} operations a pair), share "
          f"{b_ms / k5_ms:.3f}; at the first port's {K5_OPS_PAIR} a pair {b_old:.4f} ms, share "
          f"{b_old / k5_ms:.3f}; the kernel on one frame ({n_pix} rays) {k5_frame_ms:.3f} ms  "
          f"[{card}]", flush=True)
    k5_sweep(dev, card, host, o, d)
    k5_forms(card, host, o, d)
    del o, d
    k5_sass(card)
    return {
        "name": "mt_intersect",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/mt_intersect.cu",
        "replaces": "gaussian_splatterer_tpu/rt/tracer.py:444",
        "launches": launches,
        "max_abs_err": gate_err,
        "ms": k5_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,  # the product alone: no PyTorch call finds a first hit
    }


def k5_bound(r: int, t_real: int, ops_pair: int, name: str | None = None):
    """K5's bound: every (ray, real triangle) pair at ``ops_pair``
    operations; rays in (24 B) and out (16 B), the triangle table (160 B and
    its index or valid flag) once."""
    return bound_ms(ops_pair * r * t_real, 40 * r + 164 * t_real, name)


def k5_sweep(dev, card, host, o, d) -> None:
    """K5 alone at each launch size of K5_SWEEP (bounce rays leaving the
    mushroom's surface, as the capture's bounces launch it: without the
    reject) and on the primary batch (o, d): the time of one call by CUDA
    events, which holds the wrapper's host work, beside the device time of
    the kernels and the profiler's reading of it, and the bound under both
    counts of operations."""
    import inspect

    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    tris, tc = host._tris, host.tri_chunk
    t_real = int(tris["valid"].sum())
    split = "reject" in inspect.signature(tr.intersect).parameters
    print(f"  mt_intersect by launch size (call: CUDA events around one call, median of "
          f"{REPS}; device: CUDA events around 10 calls queued behind a spin kernel, so no "
          f"host time between them, median of 5; bound at {K5_OPS_PAIR_MIN} / {K5_OPS_PAIR} "
          f"operations a pair):")
    for r in (*K5_SWEEP, o.shape[0]):
        if r == o.shape[0]:
            ro, rd, label, kw = o, d, "primary batch", {}
        else:
            ro, rd = (x.to(dev) for x in surface_rays(host.mesh, r, seed=7))
            label, kw = "bounce rays", ({"reject": False} if split else {})
        call_ms = cuda_ms(lambda: tr.intersect(ro, rd, tris, tc, **kw))
        dev_ms = queued_ms(lambda: tr.intersect(ro, rd, tris, tc, **kw))
        _, wall_ms, by_name = device_busy_ms(
            lambda: [tr.intersect(ro, rd, tris, tc, **kw) for _ in range(10)])
        prof_ms = sum(ms for name, (ms, _) in by_name.items()
                      if "mt_intersect" in name or "merge_slices" in name) / 10 or float("nan")
        b_min, _ = k5_bound(r, t_real, K5_OPS_PAIR_MIN)
        b_old, _ = k5_bound(r, t_real, K5_OPS_PAIR)
        slices = k5_slices(dev, r, t_real) if split else 1
        print(f"    R = {r} ({label}), {slices} slices: call {call_ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (the profiler's kernel time {prof_ms:.4f} ms, host clock "
              f"{wall_ms / 10:.4f} ms a launch under it); bound {b_min:.5f} / {b_old:.5f} ms; "
              f"device share {b_min / dev_ms:.3f} / {b_old / dev_ms:.3f}  [{card}]", flush=True)
    # the clock beside a window of primary batches back to back
    from gaussian_splatterer_tpu_torch.scripts.peak_probe import sample_clocks

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window():
        start.record()
        for _ in range(40):
            tr.intersect(o, d, tris, tc)
        end.record()
        torch.cuda.synchronize()

    clocks = sample_clocks(window)
    print(f"    40 primary batches back to back: {start.elapsed_time(end) / 40:.4f} ms a launch; "
          f"nvidia-smi ({clocks['samples']} samples): SM clock {clocks['sm_clock_mhz']} MHz "
          f"(min {clocks.get('sm_clock_min_mhz', 'not measured')}), {clocks['power_w']} W of "
          f"{clocks['power_limit_w']} W  [{card}]", flush=True)


def queued_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Device milliseconds of one fn(): n calls enqueued behind a spin kernel
    of ~10 ms, so that the host has queued them all before the device starts
    the first, with CUDA events around the n calls; median of ``reps``."""
    times = []
    for i in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def k5_one_slice(o, d, tris):
    """One launch of K5 over all triangles in one slice, whatever the
    launch's size: the kernel's C entry point called as the wrapper calls
    it for a launch that slice_plan does not split.  Counted nowhere."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    r, t_real = o.shape[0], tris["tri40"].shape[0]
    out = [torch.empty((r,), dtype=dt, device=o.device) for dt in (
        torch.float32, torch.int32, torch.float32, torch.float32)]
    err = tr._mt_lib().mt_intersect(
        o.data_ptr(), d.data_ptr(), r, tris["tri40"].data_ptr(), tris["tri_ids"].data_ptr(),
        t_real, 0, 1, t_real, *(x.data_ptr() for x in out), None, None, None, None,
        torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"phase 11 failed: mt_intersect in one slice: cudaError_t {err}")
    return out


def k5_forms(card, host, o, d) -> None:
    """What the reject and the split buy, each on its own: the reject on
    and off on the primary batch and on 2^20 bounce rays; the split (as
    slice_plan chooses it) against one slice on 2^13 bounce rays, where
    the hits must be bit-equal.  Every form gives the same hits (the
    tests)."""
    import inspect

    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    if "reject" not in inspect.signature(tr.intersect).parameters:
        return
    tris, tc = host._tris, host.tri_chunk
    on, off = (cuda_ms(lambda: tr.intersect(o, d, tris, tc, reject=rej)) for rej in (True, False))
    print(f"  mt_intersect on the primary batch: reject on {on:.3f} ms, off {off:.3f} ms  "
          f"[{card}]")
    ro, rd = (x.to(o.device) for x in surface_rays(host.mesh, 1 << 20, seed=7))
    on, off = (queued_ms(lambda: tr.intersect(ro, rd, tris, tc, reject=rej))
               for rej in (True, False))
    print(f"  mt_intersect on 2^20 bounce rays (device): reject on {on:.4f} ms, off {off:.4f} "
          f"ms (the capture's bounces run with it off)  [{card}]", flush=True)
    ro, rd = ro[:1 << 13], rd[:1 << 13]
    if not all(torch.equal(a, b) for a, b in zip(tr.intersect(ro, rd, tris, tc, reject=False),
                                                 k5_one_slice(ro, rd, tris))):
        raise SystemExit("phase 11 failed: the split changed a hit")
    auto = queued_ms(lambda: tr.intersect(ro, rd, tris, tc, reject=False))
    one = queued_ms(lambda: k5_one_slice(ro, rd, tris))
    print(f"  mt_intersect on 2^13 bounce rays (device, reject off): split into "
          f"{k5_slices(o.device, 1 << 13, tris['tri40'].shape[0])} slices {auto:.4f} ms, one "
          f"slice {one:.4f} ms, hits bit-equal  [{card}]", flush=True)


def sass_functions(sass: str) -> list[tuple[str, list]]:
    """(name, [(address, opcode, operands)]) of each function in
    ``cuobjdump -sass`` output."""
    import re

    out: list = []
    for line in sass.splitlines():
        if "Function :" in line:
            out.append((line.split("Function :")[1].strip(), []))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*);",
                     line)
        if m and out:
            out[-1][1].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def sass_inner_loops(ins: list, holds) -> list[list]:
    """Bodies of the innermost loops (a backward branch's span) among the
    loops of ``ins`` whose body satisfies ``holds``, in address order."""
    import re

    spans = []
    for addr, op, text in ins:
        tgt = re.search(r"0x([0-9a-f]+)", text) if op.startswith("BRA") else None
        if tgt is None or int(tgt.group(1), 16) > addr:
            continue
        lo = int(tgt.group(1), 16)
        body = [x for x in ins if lo <= x[0] <= addr]
        if holds(body):
            spans.append((lo, addr, body))
    return [s[2] for s in sorted(spans) if not any(
        o is not s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]


def sass_kinds(body: list) -> dict[str, int]:
    kinds: dict[str, int] = {}
    for _, op, _ in body:
        key = op.split(".")[0]
        kinds[key] = kinds.get(key, 0) + 1
    return kinds


def sass_loop_counts(sass: str) -> list[dict]:
    """The innermost loop over triangles of each intersector kernel in
    ``cuobjdump -sass`` output: its instructions by kind and per (ray,
    triangle) pair.  A triangle is read as ten 16-byte shared-memory loads
    (LDS.128) in both ports of K5, so the loop's pairs are its LDS.128 / 10
    times the rays a thread holds (K5_RAYS_PER_THREAD for the kernel
    templated on the reject, 1 for the first port)."""
    import re

    out = []
    for name, ins in sass_functions(sass):
        if "mt_intersect_kernel" not in name:
            continue
        m = re.search(r"mt_intersect_kernelILb(\d)E", name)
        rt, reject = 1, False
        if m:
            from gaussian_splatterer_tpu_torch.rt.tracer import K5_RAYS_PER_THREAD

            rt, reject = K5_RAYS_PER_THREAD, bool(int(m.group(1)))

        def lds(body):
            return sum(x[1] == "LDS.128" for x in body)

        # the innermost loops that read a triangle (a compiler's unrolled
        # body and its remainder), of which the one that reads the most
        inner = sass_inner_loops(ins, lambda body: lds(body) >= 10)
        if not inner:
            continue
        best = max(inner, key=lds)
        pairs = lds(best) // 10 * rt
        out.append({"rt": rt, "reject": reject, "instructions": len(best), "pairs": pairs,
                    "per_pair": len(best) / pairs, "kinds": sass_kinds(best)})
    return out


def compositor_sass_counts(sass: str, name: str) -> list[dict]:
    """The loops over duplicates of compositor ``name``'s kernels (K1
    composite_fwd, K2 composite_bwd, K3 composite_train; PPT pixels a
    thread: <name>_kernel<PPT>, 1 for an untemplated kernel) in ``cuobjdump
    -sass`` output: the innermost loops that evaluate a Gaussian (an expf is
    one MUFU.EX2), K3's pass 1 and K1's loop without shuffles, K3's pass 2
    and K2's loop with the warp reduction's SHFL.  For each: its
    instructions, the pairs one trip evaluates (its MUFU.EX2), instructions
    a pair, and SHFL a duplicate (SHFL x PPT / pairs).  Static counts: every
    branch's instructions."""
    import re

    out = []
    for fname, ins in sass_functions(sass):
        m = re.search(rf"{name}_kernel(?:ILi(\d+)E)?", fname)
        if not m:
            continue
        ppt = int(m.group(1) or 1)
        for body in sass_inner_loops(ins, lambda b: any(x[1] == "MUFU.EX2" for x in b)):
            pairs = sum(x[1] == "MUFU.EX2" for x in body)
            shfl = sum(x[1].startswith("SHFL") for x in body)
            out.append({"ppt": ppt, "pass": 2 if shfl else 1, "instructions": len(body),
                        "pairs": pairs, "per_pair": len(body) / pairs,
                        "shfl_per_dup": shfl * ppt / pairs, "kinds": sass_kinds(body)})
    return out


def cuobjdump_sass(name: str) -> str | None:
    """``cuobjdump -sass`` of the built library of kernel source ``name``
    (cuobjdump from the CUDA toolkit beside nvcc), or None if it failed."""
    from gaussian_splatterer_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    lib = cuda_build.build_info[name]["path"]
    proc = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        print(f"  SASS: cuobjdump failed: {proc.stderr.strip()[:200]}")
        return None
    return proc.stdout


def k5_sass(card) -> None:
    """Instructions per (ray, triangle) pair in the SASS of the built
    intersector."""
    sass = cuobjdump_sass("mt_intersect")
    for c in sass_loop_counts(sass) if sass is not None else []:
        kinds = " ".join(f"{k} {n}" for k, n in sorted(c["kinds"].items(), key=lambda kv: -kv[1]))
        print(f"  SASS of the loop over triangles, RT {c['rt']}, reject {c['reject']}: "
              f"{c['instructions']} instructions for {c['pairs']} pairs, {c['per_pair']:.2f} a "
              f"pair (static; the reject's skipped epilogue included): {kinds}  [{card}]",
              flush=True)


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """'<entry>: N registers, spill stores/loads' for each entry function
    of ``log`` (nvcc -Xptxas -v) whose name holds ``kernel``."""
    import re

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name and kernel in name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
    return out


def compositor_build_facts(card, name: str) -> None:
    """Phases 5, 8 and 14: compositor ``name``'s registers and spills (phase
    2's ptxas lines), the blocks of its tile-32 kernel an SM holds (its
    exported <name>_blocks_per_sm), and the SASS of its loops over
    duplicates (compositor_sass_counts)."""
    from gaussian_splatterer_tpu_torch.ops import cuda_build

    for line in ptxas_lines(cuda_build.build_info[name]["ptxas"], f"{name}_kernel"):
        print(f"  ptxas: {line}")
    try:
        per_sm = getattr(cuda_build.load_library(name), f"{name}_blocks_per_sm")()
    except AttributeError:  # a tree whose kernel does not export it
        per_sm = "not exported"
    print(f"  {name}: the tile-32 kernel holds {per_sm} blocks an SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)  [{card}]")
    sass = cuobjdump_sass(name)
    for c in compositor_sass_counts(sass, name) if sass is not None else []:
        kinds = " ".join(f"{k} {n}" for k, n in sorted(c["kinds"].items(), key=lambda kv: -kv[1]))
        what = "with the warp reduction" if c["shfl_per_dup"] else "without shuffles"
        print(f"  SASS of {name}'s loop over duplicates {what}, {c['ppt']} pixels a thread: "
              f"{c['instructions']} instructions for {c['pairs']} pairs, {c['per_pair']:.2f} a "
              f"pair, {c['shfl_per_dup']:.2f} SHFL a duplicate (static, every branch): {kinds}",
              flush=True)


def frame_bwd_args(model, cams, i, width, height, truth, bg, tile, max_dup):
    """Frame ``i`` as the non-fused step renders it (projection, binning,
    gather, K1) and the gradient its backward hands the compositor, the
    residual ``truth - image`` in tile order, zero past W and H, with its
    background dot product as the T_final channel: the arguments of one
    composite_bwd launch."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    tx, ty = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        comps = project_splat_components(
            model.means, model.shs, model.scales, model.opacities, model.rotations,
            model.active_mask(), cams.view[i], cams.proj_view[i], cams.cam_pos[i],
            float(cams.tan_fovx[i]), float(cams.tan_fovy[i]), width, height, model.sh_degree,
            1.0)
        bins = bin_splats(comps, width, height, tile, max_dup)
        feat = rt.gather_features(comps, bins)
        out = rt.composite_fwd(feat, bins.tile_start, bins.tile_end, tile, tx)
        img = rt.tiles_to_image(out[..., 0:3] + out[..., 3:4] * bg, width, height, tile)
        resid = torch.zeros((ty * tile, tx * tile, 3), device=feat.device)
        resid[:height, :width] = truth - img
        g = rt.image_to_tiles(resid, tile)
        gin = torch.cat([g, (g * bg).sum(-1, keepdim=True)], dim=-1).contiguous()
    return feat, bins.tile_start, bins.tile_end, out, gin, tile, tx


def bwd_gate(dev) -> float:
    """Phase 12.  Returns the largest kernel-vs-plain |d_feat| difference."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import bench_cameras, splat_arrays
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.raster_reference import render_oracle
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components
    from gaussian_splatterer_tpu_torch.train import CameraBatch

    phase("12. serve backward kernel composite_bwd vs plain (gate scene: 150 splats, 128^2, "
          f"seed 7); render_tiled gradients vs the oracle's (grad gate scene, 128^2 and "
          f"{NF_GATE_CROP}^2, tile {TRAIN_TILE})")
    model = SplatModel.from_numpy(*splat_arrays(150, 256, seed=7), count=150, device=dev,
                                  sh_degree=1)
    cam = Camera(np.array([0.3, -0.2, -10.0], np.float32), np.zeros(3, np.float32), 60.0)
    gate_args = render_args(model, cam, 128, 128, True, BG_GATE, dev)
    worst = 0.0
    for tile in (16, 32):
        tx = -(-128 // tile)
        with torch.no_grad():
            comps = project_splat_components(*gate_args[:13], 1, 1.0)
            bins = bin_splats(comps, 128, 128, tile, 2**13)
            feat = rt.gather_features(comps, bins)
            out = rt.composite_fwd(feat, bins.tile_start, bins.tile_end, tile, tx)
            gin = torch.from_numpy(np.random.default_rng(7).uniform(
                -1, 1, tuple(out.shape)).astype(np.float32)).to(dev)
            args = (feat, bins.tile_start, bins.tile_end, out, gin, tile, tx)
            d_k = rt.composite_bwd(*args)
            d_k2 = rt.composite_bwd(*args)
            torch.cuda.synchronize()
            finite, d_max, rel_max, _ = compare_bwd(args, d_k)
        same = bool(torch.equal(d_k, d_k2))
        print(f"tile {tile}: {feat.shape[1]} duplicates; max|d_feat kernel - plain| {d_max:.3e}, "
              f"over the row's largest {rel_max:.3e} (<= {GATE_ATOL_PLAIN})  two launches "
              f"bit-equal {same}  finite {finite}")
        if not (finite and same and rel_max <= GATE_ATOL_PLAIN):
            raise SystemExit("phase 12 failed: kernel vs plain")
        worst = max(worst, d_max)

    model = SplatModel.from_numpy(*splat_arrays(150, 256, seed=11), count=150, device=dev,
                                  sh_degree=1)
    params = (model.means, model.shs, model.scales, model.opacities, model.rotations)
    for res in (128, NF_GATE_CROP):
        cams = CameraBatch.from_cameras(bench_cameras(2), res, res, device=dev)
        truths = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, res, res, 3))
                                  .astype(np.float32)).to(dev)
        bgs = torch.zeros((2, 3), device=dev)
        before = rt.composite_bwd_launches
        grads = []
        for render in (partial(rt.render_tiled, tile=TRAIN_TILE, max_dup=2**13),
                       partial(render_oracle, row_chunk=8, tile_cull=TRAIN_TILE)):
            leaves = [p.detach().clone().requires_grad_(True) for p in params]
            total = 0.0
            with torch.enable_grad():
                for i in range(2):
                    img = render(*leaves, model.active_mask(), cams.view[i], cams.proj_view[i],
                                 cams.cam_pos[i], float(cams.tan_fovx[i]),
                                 float(cams.tan_fovy[i]), res, res, bgs[i], 1, 1.0)
                    diff = img - truths[i]
                    total = total - 0.5 * torch.sum(diff * diff)
                grads.append(torch.autograd.grad(total, leaves))
        launched = rt.composite_bwd_launches - before
        print(f"  {res}^2: composite_bwd launches {launched} (= 2 frames)")
        if launched != 2:
            raise SystemExit("phase 12 failed: the gradients did not go through the kernel")
        for name, a, b in zip(("means", "shs", "scales", "opacities", "rotations"), *grads):
            finite = bool(torch.isfinite(a).all())
            dev_rel = float((a - b).abs().max()) / max(1e-3, float(b.abs().max()))
            print(f"    gradient {name}: max deviation over the oracle's largest {dev_rel:.3e} "
                  f"(<= {GRAD_GATE_RTOL})  finite {finite}")
            if not (finite and dev_rel <= GRAD_GATE_RTOL):
                raise SystemExit(f"phase 12 failed: {name} gradient against the oracle at {res}^2")
    return worst


def nonfused_cli(device: str) -> None:
    """The CLI drive of phase 13: ``new`` at --resolution NF_RES, which is
    not a multiple of the runtime's tile 32, then ``train --steps
    NF_CLI_STEPS``; every step must launch composite_bwd and not
    composite_train."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.io.image import save_png

    print(f"  CLI: gsplat-torch new --obj <mushroom> --texture ... --init-field model "
          f"--resolution {NF_RES}, then train --steps {NF_CLI_STEPS} ({NS_CAMS}-camera rig, "
          f"{NS_SAMPLES} samples)", flush=True)
    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_nf_", dir=HERE / "build"))
    write_obj(mushroom_mesh(NS_MESH[0], NS_MESH[1]), str(work / "mushroom.obj"))
    save_png(mushroom_texture()[..., :3], str(work / "mushroom.png"), flip_vertical=False)
    proj = str(work / "project")
    out, secs = cli("new", proj, "--obj", str(work / "mushroom.obj"), "--texture",
                    str(work / "mushroom.png"), "--init-field", "model", "--resolution",
                    str(NF_RES), "--capacity", str(NS_CAPACITY), "--device", device,
                    timeout=300, phase_no=13)
    print(f"  new: {secs:.3f} s (host clock): {out.strip()}")
    p = Project.load(f"{proj}/settings.json")
    p.sphere1.count, p.rtSamples = NS_CAMS, NS_SAMPLES
    p.save(f"{proj}/settings.json")
    out, secs = cli("train", proj, "--steps", str(NF_CLI_STEPS), "--log-every", "1",
                    "--device", device, timeout=600, phase_no=13)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        print(f"  {line}")
    stats = json.loads(lines[-1])
    launches = stats["launches"]
    k2, k3 = launches["composite_bwd"], launches["composite_train"]
    print(f"  train: {secs:.3f} s (host clock, process included); launches by step: "
          f"composite_bwd {k2}, composite_fwd {launches['composite_fwd']}, composite_train "
          f"{k3}, mt_intersect {launches['mt_intersect']}")
    losses = [float(line.split()[3]) for line in lines if line.startswith("iter ")]
    if len(losses) != NF_CLI_STEPS or not all(np.isfinite(losses)) or len(k2) != NF_CLI_STEPS:
        raise SystemExit("phase 13 failed: the CLI's steps or losses")
    if any(k3) or (device != "cpu" and not all(x > 0 for x in k2)):
        raise SystemExit("phase 13 failed: a CLI step did not take the non-fused step")


def nonfused_main(dev, card) -> dict:
    """Phases 13 and 14.  Returns the kernel summary entry of composite_bwd."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import splat_arrays
    from gaussian_splatterer_tpu_torch.config import Project, RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.transforms import (
        SplatComponents, project_splat_components,
    )
    from gaussian_splatterer_tpu_torch.train import LearningRates, Trainer, auto_train

    n, cap, res, tile = TRAIN_SPLATS, TRAIN_CAPACITY, NF_RES, TRAIN_TILE
    phase(f"13. non-fused train main path: Trainer(renderer='tiled') + auto_train, {n} splats, "
          f"{res}^2 (not a multiple of tile {tile}), 16-camera rig")
    arrays = splat_arrays(n, cap, seed=0)
    t_arrays = teacher_arrays(arrays, n)
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res,
                            splats_capacity=cap, sh_degree=1, sh_coeffs=4, tile_px=tile)
    project = Project.app_default()
    project.intervalDensify = 3
    rtx = TeacherRtx(SplatModel.from_numpy(*t_arrays, count=n, device=dev, sh_degree=1),
                     tile, runtime.max_dup)
    trainer = Trainer(project, runtime,
                      SplatModel.from_numpy(*arrays, count=n, device=dev, sh_degree=1),
                      renderer="tiled")
    if trainer._fused is not False:
        raise SystemExit("phase 13 failed: the trainer took the fused step")
    frames = 2 * project.num_cameras

    def counts():
        return rt.composite_fwd_launches, rt.composite_bwd_launches, rt.composite_train_launches

    log = []

    def on_step(it, m):
        now = counts()
        k1, k2, k3 = (a - b for a, b in zip(now, seen[-1]))
        seen.append(now)
        log.append((it, float(m.loss), trainer.model.count, k1, k2, k3))
        print(f"  step {it}: loss {log[-1][1]:.6f}  splats {log[-1][2]}  launches: "
              f"composite_fwd {k1} (truth capture included)  composite_bwd {k2}  "
              f"composite_train {k3}", flush=True)

    rt.composite_fwd_launches = rt.composite_bwd_launches = rt.composite_train_launches = 0
    seen = [counts()]
    stats = auto_train(trainer, rtx, TRAIN_STEPS, rng=random.Random(0), on_step=on_step)
    torch.cuda.synchronize()
    launches = rt.composite_bwd_launches
    print(f"auto_train: {stats}  composite_bwd launches {launches} (= {TRAIN_STEPS} steps x "
          f"{frames} frames)  composite_train launches {rt.composite_train_launches}")
    m = trainer.model
    params = (m.means, m.shs, m.scales, m.opacities, m.rotations)
    finite = all(np.isfinite(x[1]) for x in log) and all(bool(torch.isfinite(p).all())
                                                        for p in params)
    per_step = all(k1 >= frames and k2 == frames and k3 == 0 for *_, k1, k2, k3 in log)
    if not (finite and per_step and len(log) == TRAIN_STEPS):
        raise SystemExit("phase 13 failed: launches per step, or a non-finite loss or parameter")

    # one frame of the trained model, the step's first (white background)
    cams2 = trainer.truth_cams.twice()
    bg = torch.ones(3, device=dev)
    args = frame_bwd_args(m, cams2, 0, res, res, trainer.truths[0], bg, tile, runtime.max_dup)
    k2_stats: dict = {}
    d_k = rt.composite_bwd(*args)
    torch.cuda.synchronize()
    finite, d_max, rel_max, rel_mean = compare_bwd(args, d_k, k2_stats)
    print(f"kernel vs plain, one frame ({args[0].shape[1]} duplicates): max|d_feat| {d_max:.3e}, "
          f"over the row's largest: max {rel_max:.3e} (<= {MAIN_MAX_ATOL}) mean {rel_mean:.3e} "
          f"(<= {MAIN_MEAN_ATOL})  finite {finite}  pairs visited {k2_stats['pairs']}, inside "
          f"the footprint box {k2_stats['pairs_box']}, composited {k2_stats['composited']}")
    if not (finite and rel_max <= MAIN_MAX_ATOL and rel_mean <= MAIN_MEAN_ATOL):
        raise SystemExit("phase 13 failed: kernel vs plain at full size")
    nonfused_cli(dev.type)

    phase(f"14. non-fused train times (CUDA events, median; {card})")
    reps = 10
    active = m.active_mask()
    cam = (cams2.view[0], cams2.proj_view[0], cams2.cam_pos[0], float(cams2.tan_fovx[0]),
           float(cams2.tan_fovy[0]))
    leaves = [p.detach().clone().requires_grad_(True) for p in params]

    def project_fn():
        with torch.enable_grad():
            return project_splat_components(*leaves, active, *cam, res, res, m.sh_degree, 1.0)

    comps = project_fn()
    detached = SplatComponents(*(x.detach() for x in comps))
    bins = bin_splats(detached, res, res, tile, runtime.max_dup)
    graph = {}  # a fresh autograd graph of the frame for each backward

    def build_graph():
        with torch.enable_grad():
            img = trainer._render_fn(*leaves, active, *cam, res, res, bg, m.sh_degree, 1.0)
        graph.update(img=img, resid=(trainer.truths[0] - img).detach())

    def backward():
        return torch.autograd.grad(graph["img"], leaves, graph["resid"])

    feat, tile_start, tile_end, *_, tx = args
    frame = {
        "projection forward": cuda_ms(project_fn, reps=reps),
        "binning": cuda_ms(lambda: bin_splats(detached, res, res, tile, runtime.max_dup),
                           reps=reps),
        "gather": cuda_ms(lambda: rt.gather_features(comps, bins), reps=reps),
        "composite_fwd kernel": cuda_ms(
            lambda: rt.composite_fwd(feat, tile_start, tile_end, tile, tx), reps=reps),
        "composite_bwd kernel": cuda_ms(lambda: rt.composite_bwd(*args), reps=reps),
        "autograd backward (composite_bwd, gather and projection backward)": cuda_ms(
            backward, reps=reps, setup=build_graph),
        "render + backward": cuda_ms(lambda: (build_graph(), backward()), reps=reps),
    }
    print(f"  per frame: " + "  ".join(f"{k} {v:.3f} ms" for k, v in frame.items())
          + f"  [{card}]")
    lrs = LearningRates.from_project(project)
    step_ms = cuda_ms(lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams,
                                            lrs), warmup=1, reps=3)
    print(f"  per step of {frames} frames: " + "  ".join(
        f"{k} {v * frames:.3f} ms" for k, v in frame.items()) + f"  whole step {step_ms:.3f} ms"
        f"  [{card}]")
    print(f"  non-fused train steps/s {1e3 / step_ms:.3f}  [{card}]")
    busy_ms, profiled_ms, _ = device_busy_ms(
        lambda: trainer._step(trainer.model, trainer.truths, trainer.truth_cams, lrs))
    print(f"  device busy time of a step (torch.profiler): {busy_ms:.3f} ms, busy share "
          f"{busy_ms / step_ms:.3f} of the {step_ms:.3f} ms step ({busy_ms / profiled_ms:.3f} "
          f"of the {profiled_ms:.3f} ms profiled step)  [{card}]")
    if busy_ms <= 0.0:
        raise SystemExit("phase 14 failed: the profiler recorded no device time")

    plain_ms = cuda_ms(lambda: rt.composite_bwd_reference(*args), warmup=0, reps=2)
    b_ms, b_by = k2_bound(args, k2_stats, "composite_bwd")
    k2_ms = frame["composite_bwd kernel"]
    print(f"  composite_bwd per launch (one {res}^2 frame): kernel {k2_ms:.4f} ms  plain "
          f"{plain_ms:.3f} ms  {bounds_line(k2_bound, args, k2_stats, k2_ms)}  [{card}]")
    compositor_build_facts(card, "composite_bwd")
    return {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:407",
        "launches": launches,
        "max_abs_err": d_max,
        "ms": k2_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no PyTorch call computes the compositor's VJP
    }

def k2_frame(dev):
    """One NF_RES^2 frame of the bench scene as the non-fused step renders
    it, for K2 alone (``--only k2`` and the design variants): the untrained
    bench model at bench camera 0, its truth rendered from phase 13's
    teacher, a white background.  Returns frame_bwd_args of it."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import bench_cameras, splat_arrays
    from gaussian_splatterer_tpu_torch.config import RuntimeConfig
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel
    from gaussian_splatterer_tpu_torch.train import CameraBatch

    n, cap, res, tile = TRAIN_SPLATS, TRAIN_CAPACITY, NF_RES, TRAIN_TILE
    arrays = splat_arrays(n, cap, seed=0)
    runtime = RuntimeConfig(render_resolution_x=res, render_resolution_y=res,
                            splats_capacity=cap, sh_degree=1, sh_coeffs=4, tile_px=tile)
    teacher = TeacherRtx(SplatModel.from_numpy(*teacher_arrays(arrays, n), count=n, device=dev,
                                               sh_degree=1), tile, runtime.max_dup)
    cam = bench_cameras(1)[0]
    truth = teacher.render(cam, (1.0, 1.0, 1.0), 1, res, res)
    model = SplatModel.from_numpy(*arrays, count=n, device=dev, sh_degree=1)
    cams = CameraBatch.from_cameras([cam], res, res, device=dev)
    return frame_bwd_args(model, cams, 0, res, res, truth, torch.ones(3, device=dev), tile,
                          runtime.max_dup)


def k2_alone(dev, card) -> None:
    """``--only k2``: K2 on k2_frame against plain at phase 13's full-size
    gate, two launches bit-equal, its time, its bound at both counts and its
    build facts."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    phase(f"14. composite_bwd on one {NF_RES}^2 frame of the bench scene (--only k2; CUDA "
          f"events, median of {REPS} after {WARMUP} warm-ups; {card})")
    args = k2_frame(dev)
    stats: dict = {}
    d_k, d_k2 = rt.composite_bwd(*args), rt.composite_bwd(*args)
    torch.cuda.synchronize()
    finite, d_max, rel_max, rel_mean = compare_bwd(args, d_k, stats)
    same = bool(torch.equal(d_k, d_k2))
    print(f"kernel vs plain ({args[0].shape[1]} duplicates): max|d_feat| {d_max:.3e}, over the "
          f"row's largest: max {rel_max:.3e} (<= {MAIN_MAX_ATOL}) mean {rel_mean:.3e} "
          f"(<= {MAIN_MEAN_ATOL})  two launches bit-equal {same}  finite {finite}")
    if not (finite and same and rel_max <= MAIN_MAX_ATOL and rel_mean <= MAIN_MEAN_ATOL):
        raise SystemExit("composite_bwd failed against plain at full size")
    k2_ms = cuda_ms(lambda: rt.composite_bwd(*args))
    print(f"  composite_bwd per launch: kernel {k2_ms:.4f} ms  "
          f"{bounds_line(k2_bound, args, stats, k2_ms)}  [{card}]")
    compositor_build_facts(card, "composite_bwd")


def k4_gate_shapes(dev) -> float:
    """Phase 15's first part: K4 against plain at the JAX test's shapes and
    D = 1000, 100 (no multiple-of-128 divisor), two launches bit-equal.
    Returns the largest |kernel - plain| difference."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    rng = np.random.default_rng(7)  # the JAX test's inputs: normal x 100
    worst = 0.0
    for shape in K4_GATE_SHAPES:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 100).to(dev)
        y, y2 = rt.cumsum_frames(x), rt.cumsum_frames(x)
        ref = rt.cumsum_frames_reference(x)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        ok = bool(torch.allclose(y, ref, rtol=K4_RTOL, atol=K4_ATOL)) and torch.equal(y, y2)
        print(f"  {shape}: max|kernel - plain| {err:.3e} (rtol {K4_RTOL}, atol {K4_ATOL})  "
              f"two launches bit-equal {torch.equal(y, y2)}")
        if not ok:
            raise SystemExit(f"phase 15 failed: K4 at {shape}")
        worst = max(worst, err)
    return worst


def k4_full_size(x, label: str) -> float:
    """Phase 15's full-size rule on the scan input ``x``: K4 against a
    float64 scan no worse than max(twice torch.cumsum's error, one ulp of the
    largest prefix), two launches bit-equal, finite.  Returns
    max|kernel - torch.cumsum|."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    y, y2 = rt.cumsum_frames(x), rt.cumsum_frames(x)
    lib = torch.cumsum(x, dim=2)
    ref64 = torch.cumsum(x.double(), dim=2)
    torch.cuda.synchronize()
    err_k = float((y.double() - ref64).abs().max())
    err_lib = float((lib.double() - ref64).abs().max())
    floor = float(torch.finfo(torch.float32).eps * ref64.abs().max())  # one ulp of the largest
    same = torch.equal(y, y2)
    finite = bool(torch.isfinite(y).all())
    lib_diff = float((y - lib).abs().max())
    print(f"  {label} {tuple(x.shape)} ({x.numel() * 4 / 1e6:.1f} MB, D % 128 = "
          f"{x.shape[2] % 128}): max|kernel - float64| {err_k:.3e} ({err_k / floor:.3f} ulp of "
          f"the largest prefix), max|torch.cumsum - float64| {err_lib:.3e} (kernel <= max(2 x "
          f"that, {floor:.3e}))  max|kernel - torch.cumsum| {lib_diff:.3e}  two launches "
          f"bit-equal {same}  finite {finite}")
    if not (finite and same and err_k <= max(2 * err_lib, floor)):
        raise SystemExit(f"phase 15 failed: K4 at {label}")
    return lib_diff


def cumsum_gate(dev, group) -> float:
    """Phase 15.  ``group``: (d_feat, FrameBins, columns) of one launch of
    the phase-7 model.  Returns the largest |kernel - plain| difference."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    phase("15. per-frame scan cumsum_frames (K4) vs plain; full size on one group of the "
          "trained bench model's duplicate gradients vs float64")
    worst = k4_gate_shapes(dev)
    d_feat, fb, _ = group
    x = rt.dups_to_depth_order(d_feat, fb)
    return max(worst, k4_full_size(x, "full size"))


def k4_input(dev, seed: int = 0):
    """A (9, 8, K4_D) scan input shaped like the route's on phase 7's cell:
    each frame's kept count drawn from ``seed`` (one frame at D, the group's
    largest), normal x 1e-3 below it and a zero tail."""
    rng = np.random.default_rng(seed)
    k, f, d = 9, TRAIN_GROUP, K4_D
    counts = rng.integers(d // 2, d + 1, size=f)
    counts[int(np.argmax(counts))] = d
    x = (rng.standard_normal((k, f, d), dtype=np.float32) * np.float32(1e-3))
    x[:, np.arange(d)[None, :] >= counts[:, None]] = 0.0
    return torch.from_numpy(x).to(dev), counts


def k4_times(x, card, label: str) -> dict:
    """K4's, its plain twin's and torch.cumsum's times on ``x``: CUDA events
    around one call (host time between launches included, as phase 16's
    layers are timed) and the device time of one call queued behind a spin
    kernel (queued_ms), beside the bound; printed, and returned as
    {"ms", "event_ms", "plain_ms", "library_ms", "copy_ms", "bound_ms",
    "bound_by"}: x.clone() moves the same bytes, a floor the card reaches."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    with torch.no_grad():
        out = {
            "event_ms": cuda_ms(lambda: rt.cumsum_frames(x)),
            "ms": queued_ms(lambda: rt.cumsum_frames(x)),
            "plain_ms": queued_ms(lambda: rt.cumsum_frames_reference(x)),
            "library_ms": queued_ms(lambda: torch.cumsum(x, dim=2)),
            "copy_ms": queued_ms(lambda: x.clone()),
        }
    b_ms, b_by = bound_ms(x.numel(), 2 * 4 * x.numel(), "cumsum_frames")  # one add an element
    out.update(bound_ms=b_ms, bound_by=b_by)
    blocks = getattr(rt._cumsum_lib(), "cumsum_frames_blocks_per_sm", None)
    if blocks is not None:
        blocks.argtypes, blocks.restype = [], ctypes.c_int
    print(f"  cumsum_frames per launch {tuple(x.shape)} ({label}): kernel {out['ms']:.4f} ms on "
          f"the device (queued; {out['event_ms']:.4f} ms by events around one call)  plain "
          f"{out['plain_ms']:.4f} ms  torch.cumsum {out['library_ms']:.4f} ms  a copy of x "
          f"(x.clone(), the same bytes) {out['copy_ms']:.4f} ms  bound "
          f"{b_ms:.4f} ms ({b_by})  kernel at {b_ms / out['ms']:.3f} of the bound; "
          f"{blocks() if blocks else 'not exported'} blocks an SM  [{card}]")
    return out


def k4_alone(dev, card) -> None:
    """``--only k4``: phase 15's gate shapes, then K4 alone at full size on
    k4_input against the full-size rule, two launches bit-equal, its times
    beside the bound and torch.cumsum, and its registers."""
    from gaussian_splatterer_tpu_torch.ops import cuda_build

    phase(f"15. per-frame scan cumsum_frames (K4) vs plain; full size on a synthetic group "
          f"(--only k4; {card})")
    k4_gate_shapes(dev)
    x, counts = k4_input(dev)
    print(f"  synthetic input: kept counts {counts.tolist()} of D = {K4_D}, normal x 1e-3")
    k4_full_size(x, "full size")
    k4_times(x, card, "synthetic")
    for line in ptxas_lines(cuda_build.build_info["cumsum_frames"]["ptxas"], ""):
        print(f"  {line}")


def step_grads(trainer, reduction: str):
    """One fused step's summed gradients (five), var_loc and loss on the
    trainer's model and truths, by the route ``reduction``, without the
    SGD update: the work of make_train_step's fused branch."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.train.trainer import fused_kw_from_runtime

    m, cams2, rtm = trainer.model, trainer.truth_cams.twice(), trainer.runtime
    f, dev = trainer.truth_cams.num_frames, m.device
    bgs = torch.cat([torch.ones((f, 3)), torch.zeros((f, 3))]).to(dev)
    params = (m.means, m.shs, m.scales, m.opacities, m.rotations)
    grads = [torch.zeros_like(p) for p in params]
    var = torch.zeros((m.capacity,), dtype=torch.float32, device=dev)
    for g0 in range(0, 2 * f, TRAIN_GROUP):
        sl = slice(g0, g0 + TRAIN_GROUP)
        _, g, v, *_ = rt.render_train_grads_batch(
            *params, m.active_mask(), *(x[sl] for x in cams2), rtm.render_resolution_x,
            rtm.render_resolution_y, trainer.truths[sl], bgs[sl], m.sh_degree,
            **fused_kw_from_runtime(rtm), reduction=reduction)
        for acc, gi in zip(grads, g):
            acc += gi
        var += v
    return grads + [var]


def route_gate(d_feat, fb, columns: int, x, cs) -> None:
    """Phase 16: both routes' (9, F*N) output on one group against the
    same reduction in float64.  Each segment sum of the cumsum route is a
    difference of two float32 prefixes of its frame, so its error is at
    most twice the scan's error in that (row, frame) plus the rounding of
    the difference, eps x the largest prefix: a bound of absolute size,
    which a splat with small gradients in a long frame feels most.  ``x``
    and ``cs``: the scan's input and output on the card."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt

    f = x.shape[1]
    ref = torch.zeros((rt.F_ROWS, columns), dtype=torch.float64, device=x.device)
    ref.index_add_(1, fb.gather_idx, d_feat.double())
    cs64 = torch.cumsum(x.double(), dim=2)
    scan_err = (cs.double() - cs64).abs().amax(dim=2)  # (9, F)
    eps = torch.finfo(torch.float32).eps
    bound = 2 * scan_err + 2 * eps * cs64.abs().amax(dim=2)
    per_frame = {}
    for route in rt.REDUCTIONS:
        got = rt.reduce_dup_grads(d_feat, fb, columns, route).double()
        per_frame[route] = (got - ref).abs().view(rt.F_ROWS, f, -1).amax(dim=2)  # (9, F)
    share = float((per_frame["cumsum"] / bound.clamp(min=1e-30)).max())
    largest = ref.abs().view(rt.F_ROWS, f, -1).amax(dim=2).clamp(min=1e-30)
    err = {k: (float(v.max()), float((v / largest).max())) for k, v in per_frame.items()}
    print(f"  reduction of one group vs float64: cumsum route max err {err['cumsum'][0]:.3e} "
          f"(at {share:.3f} of its (row, frame) bound, 2 x scan error + 2 eps x largest prefix; "
          f"largest prefix {float(cs64.abs().max()):.3e}), over the (row, frame)'s largest sum "
          f"{err['cumsum'][1]:.3e}; index_add route max err {err['index_add'][0]:.3e}, over the "
          f"largest {err['index_add'][1]:.3e}")
    if not share <= 1.0:
        raise SystemExit("phase 16 failed: the cumsum route's reduction past its float32 bound")


def cumsum_cell(dev, card, gate_err: float | None = None) -> dict:
    """Phase 16.  Returns the kernel summary entry of cumsum_frames, with
    phase 15's ``gate_err`` as its error."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.train import (
        CameraBatch, LearningRates, auto_train, make_train_step,
    )
    from gaussian_splatterer_tpu_torch.train.trainer import fused_kw_from_runtime

    res, tile = TRAIN_RES, TRAIN_TILE
    phase(f"16. fused train cell on the cumsum route: Trainer(reduction='cumsum') + auto_train, "
          f"{TRAIN_SPLATS} splats, {res}^2, tile {tile}, frame_group {TRAIN_GROUP}")
    trainer, rtx, _ = fused_cell(dev, reduction="cumsum")
    groups = 2 * trainer.project.num_cameras // TRAIN_GROUP
    log = []

    def on_step(it, m):
        log.append((it, float(m.loss), trainer.model.count, rt.cumsum_frames_launches))
        print(f"  step {it}: loss {log[-1][1]:.6f}  splats {log[-1][2]}  cumsum_frames "
              f"launches so far {log[-1][3]}", flush=True)

    rt.cumsum_frames_launches = rt.composite_train_launches = 0
    stats = auto_train(trainer, rtx, TRAIN_STEPS, rng=random.Random(0), on_step=on_step)
    torch.cuda.synchronize()
    launches = rt.cumsum_frames_launches
    print(f"auto_train: {stats}  cumsum_frames launches {launches} (= {TRAIN_STEPS} steps x "
          f"{groups} groups)  composite_train launches {rt.composite_train_launches}")
    per_step = [b[3] - a[3] for a, b in zip([(0, 0, 0, 0)] + log, log)]
    finite = all(np.isfinite(x[1]) for x in log)
    if not (finite and len(log) == TRAIN_STEPS and all(k == groups for k in per_step)
            and rt.composite_train_launches == TRAIN_STEPS * groups):
        raise SystemExit("phase 16 failed: launches per step, or a non-finite loss")

    # one group of the trained model (the step's first): the reduction's
    # output against a float64 reduction, then the layer times below
    m = trainer.model
    cams = CameraBatch(*(x[:TRAIN_GROUP] for x in trainer.truth_cams.twice()))
    with torch.no_grad():
        comps, rows9 = rt.project_frames(
            m.means.expand(TRAIN_GROUP, -1, -1), m.shs, m.scales, m.opacities, m.rotations,
            m.active_mask(), *cams, res, res, m.sh_degree)
        fb, args = rt.train_launch_inputs(rows9, comps, res, res, trainer.truths[:TRAIN_GROUP],
                                          torch.ones((TRAIN_GROUP, 3), device=dev), tile,
                                          trainer.runtime.max_dup)
        _, d_feat = rt.composite_train(*args)
        columns = rows9.shape[1]
        x = rt.dups_to_depth_order(d_feat, fb)
        cs = rt.cumsum_frames(x)
        seg = rt.segment_sums(cs, fb, columns)
        route_gate(d_feat, fb, columns, x, cs)

    names = ("means", "shs", "scales", "opacities", "rotations", "var_loc")
    with torch.no_grad():
        c1, c2 = step_grads(trainer, "cumsum"), step_grads(trainer, "cumsum")
        i1, i2 = step_grads(trainer, "index_add"), step_grads(trainer, "index_add")
    torch.cuda.synchronize()
    bit_c = all(torch.equal(a, b) for a, b in zip(c1, c2))
    bit_i = all(torch.equal(a, b) for a, b in zip(i1, i2))
    for name, a, b in zip(names, c1, i1):
        diff, largest = float((a - b).abs().max()), float(b.abs().max())
        rel = diff / max(1e-30, largest)
        finite = bool(torch.isfinite(a).all())
        print(f"  one step ({2 * trainer.project.num_cameras} frames) of the trained model, "
              f"{name}: max|cumsum - index_add| {diff:.3e}, largest {largest:.3e}, over the "
              f"largest {rel:.3e} (<= {GRAD_GATE_RTOL}; within the small-scene {ROUTE_ATOL}: "
              f"{rel <= ROUTE_ATOL})  finite {finite}")
        if not (finite and rel <= GRAD_GATE_RTOL):
            raise SystemExit(f"phase 16 failed: {name}, the cumsum route against index_add")
    print(f"  two cumsum-route steps bit-equal: {bit_c}  two index_add-route steps bit-equal: "
          f"{bit_i} (printed, not gated: index_add_ adds with atomics)")
    if not bit_c:
        raise SystemExit("phase 16 failed: two cumsum-route steps differ")

    with torch.no_grad():
        layers = {
            "permute to depth order": cuda_ms(lambda: rt.dups_to_depth_order(d_feat, fb)),
            "K4 cumsum_frames": cuda_ms(lambda: rt.cumsum_frames(x)),
            "boundaries": cuda_ms(lambda: rt.segment_sums(cs, fb, columns)),
            "gather to rows": cuda_ms(lambda: rt.rows_from_depth(seg, fb)),
            "cumsum route": cuda_ms(lambda: rt.dup_grads_to_rows_cumsum(d_feat, fb, columns)),
            "index_add_ route": cuda_ms(lambda: rt.dup_grads_to_rows(d_feat, fb, columns)),
        }
    print(f"  reduction of one group ({TRAIN_GROUP} frames, {d_feat.shape[1]} duplicates, scan "
          f"{tuple(x.shape)}): " + "  ".join(f"{k} {v:.4f} ms" for k, v in layers.items())
          + f"  [{card}]")
    lrs = LearningRates.from_project(trainer.project)
    whole = {}
    for reduction in ("index_add", "cumsum", "cumsum", "index_add"):
        step = make_train_step(res, res, m.sh_degree, renderer="tiled", fused=True,
                               fused_opts=dict(fused_kw_from_runtime(trainer.runtime),
                                               reduction=reduction), frame_group=TRAIN_GROUP)
        whole.setdefault(reduction, []).append(cuda_ms(
            lambda: step(trainer.model, trainer.truths, trainer.truth_cams, lrs),
            warmup=1, reps=5))
    print("  whole step (32 frames, median of 5 after 1; in turns index_add, cumsum, cumsum, "
          "index_add): " + "  ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)} ms"
                                     for k, v in whole.items()) + f"  [{card}]")
    t = k4_times(x, card, "one group of the trained model")
    return {
        "name": "cumsum_frames",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/cumsum_frames.cu",
        "replaces": "gaussian_splatterer_tpu/ops/raster_tiled.py:1077",
        "launches": launches,
        "max_abs_err": gate_err,
        "ms": t["ms"],  # device time of one call (queued_ms)
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],  # torch.cumsum(x, dim=2)
    }


def probe_phase(dev, card, earlier: list) -> list:
    """Phase 17.  ``earlier``: the summary entries of K1-K5.  Returns the
    summary entries of peak_fma, gather_cols and smem_gather."""
    from gaussian_splatterer_tpu_torch.scripts import gather_probe as gp
    from gaussian_splatterer_tpu_torch.scripts import peak_probe as pp
    from gaussian_splatterer_tpu_torch.scripts import smem_gather_probe as sp

    phase(f"17. H100 probes: peak (K8), gather at the bench scale (K7), gather from shared "
          f"memory (K6) ({card})")
    pp.peak_launches = 0
    peak = pp.run(dev)
    k8_launches = pp.peak_launches
    pp.report(peak, card)
    gp.gather_cols_launches = 0
    gather = gp.run(dev)
    k7_launches = gp.gather_cols_launches
    gp.report(gather, card)
    smem, k6_launches, tab6, ids6 = k6_phase(dev, card)
    print(f"  launches in the probes' runs: peak_fma {k8_launches}, gather_cols {k7_launches}, "
          f"smem_gather {k6_launches}")

    k8_err = 0.0
    for key, shape, runs, seed in (("reference", pp.REFERENCE_SHAPE, pp.REFERENCE_RUNS, 0),
                                   ("resident", (pp.RESIDENT_N,), pp.RESIDENT_RUNS, 1)):
        x32 = pp.probe_input(shape, "fma", dev, seed)
        for form, kk in runs:
            x = x32 if not form.endswith("bf16") else x32.bfloat16()
            k, p = pp.peak(x, form, kk).float(), pp.peak_reference(x, form, kk).float()
            err = float((k - p).abs().max())
            atol = 2e-2 if form.endswith("bf16") else 1e-5
            print(f"  peak_fma {key} {form} x {kk}: max|kernel - plain| {err:.3e} (<= {atol})")
            if not (bool(torch.isfinite(k).all()) and err <= atol):
                raise SystemExit(f"phase 17 failed: peak_fma {form} against plain")
            k8_err = max(k8_err, err)
        del x32
    tab16, ids, ids_sorted = gp.probe_inputs(dev, gp.PADDED_ROWS, gp.COLS, gp.IDS)
    for rows in (gp.ROWS, gp.PADDED_ROWS):
        tab = tab16[:rows].contiguous()
        for idx in (ids, ids_sorted):
            if not torch.equal(gp.gather_cols(tab, idx), gp.gather_cols_reference(tab, idx)):
                raise SystemExit(f"phase 17 failed: gather_cols at {rows} rows")
    print("  gather_cols (9 and 16 rows, random and sorted ids) equals its plain twin")

    rate = pp.fp32_rate(peak)
    w = peak["window"]
    r8 = next(r for r in peak["resident"] if (r["form"], r["kk"]) == pp.PEAK_FORM)
    print(f"  measured FP32 rate (register-resident {pp.PEAK_FORM[0]} x {pp.PEAK_FORM[1]}, "
          f"{w['launches']} launches back to back): {rate / 1e12:.3f} TFLOP/s = "
          f"{rate / FP32_OPS_PER_S:.3f} of the published {FP32_OPS_PER_S / 1e12:.0f}, at SM clock "
          f"{w['sm_clock_mhz']} MHz, {w['power_w']} W of {w['power_limit_w']} W; one launch "
          f"(median) {r8['rate_per_s'] / 1e12:.3f} TFLOP/s")
    print("  K1-K5 against both FP32 lines (this run):")
    for e in earlier:
        ops, nbytes = BOUND_PARTS[e["name"]]
        b2, by2 = bound_ms(ops, nbytes, ops_per_s=rate)
        print(f"    {e['name']}: {e['ms']:.4f} ms; bound {e['bound_ms']:.4f} ms ({e['bound_by']}) "
              f"at 67 TFLOP/s, share {e['bound_ms'] / e['ms']:.4f}; bound {b2:.4f} ms ({by2}) "
              f"at the measured {rate / 1e12:.3f} TFLOP/s, share {b2 / e['ms']:.4f}  [{card}]")

    # the summary entries: K8 register-resident, K7 at the bench scale, K6 at D = 2^21
    form, kk = pp.PEAK_FORM
    x8 = pp.probe_input((pp.RESIDENT_N,), form, dev, 1)
    k8_plain = cuda_ms(lambda: pp.peak_reference(x8, form, kk), warmup=1, reps=2)
    c7 = next(c for c in gather["cases"] if c["rows"] == gp.ROWS and c["order"] == "random")
    tab9 = tab16[:gp.ROWS].contiguous()
    k7_plain = cuda_ms(lambda: gp.gather_cols_reference(tab9, ids))
    c6 = next(c for c in smem["cases"] if c["ids"] == sp.BENCH_IDS)
    k6_plain = cuda_ms(lambda: sp.smem_gather_reference(tab6, ids6))
    return [{
        "name": "peak_fma", "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/peak_fma.cu",
        "replaces": "scripts/peak_probe.py:60",
        "launches": k8_launches, "max_abs_err": k8_err,
        "ms": r8["ms"], "plain_ms": k8_plain, "bound_ms": r8["bound_ms"],
        "bound_by": r8["bound_by"],
        "library_ms": None,  # no PyTorch call runs a chain of FMAs
    }, {
        "name": "gather_cols", "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/gather_cols.cu",
        "replaces": "scripts/gather_probe.py:96",
        "launches": k7_launches, "max_abs_err": 0.0,
        "ms": c7["kernel_ms"], "plain_ms": k7_plain, "bound_ms": c7["bound_ms"],
        "bound_by": c7["bound_by"],
        "library_ms": c7["index_select_ms"],  # torch.index_select(tab, 1, ids)
    }, {
        "name": "smem_gather", "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/smem_gather.cu",
        "replaces": "scripts/vmem_gather_probe.py:50",
        "launches": k6_launches, "max_abs_err": 0.0,
        "ms": c6["kernel_ms"], "plain_ms": k6_plain, "bound_ms": c6["bound_ms"],
        "bound_by": c6["bound_by"],
        "library_ms": c6["index_select_ms"],  # torch.index_select(tab, 1, ids)
    }]


def k6_phase(dev, card):
    """Phase 17's K6 cases: the probe's run() (times at D = 8192 and 2^21
    beside gather_cols, index_select and the bound), the rows a block, and
    the kernel against its plain twin at both D in both index layouts.
    Returns (run()'s result, the launches in it, the table, the ids)."""
    from gaussian_splatterer_tpu_torch.scripts import gather_probe as gp
    from gaussian_splatterer_tpu_torch.scripts import smem_gather_probe as sp

    sp.smem_gather_launches = 0
    smem = sp.run(dev)
    launches = sp.smem_gather_launches
    sp.report(smem, card)
    rows = sp.split_rows(sp.ROWS, sp.COLS, sp._lib().smem_gather_max_bytes(dev.index or 0))
    tab6, ids6, _ = gp.probe_inputs(dev, sp.ROWS, sp.COLS, sp.BENCH_IDS, seed=1)
    for d in (sp.PROBE_IDS, sp.BENCH_IDS):
        flat = ids6[:d].contiguous()
        for idx in (flat, flat.view(-1, 128)):
            if not torch.equal(sp.smem_gather(tab6, idx), sp.smem_gather_reference(tab6, idx)):
                raise SystemExit(f"phase 17 failed: smem_gather at D = {d}")
    print(f"  smem_gather: {rows} rows a block ({sp.ROWS} rows of {sp.COLS} in "
          f"{-(-sp.ROWS // rows)} row groups); equals its plain twin at D = {sp.PROBE_IDS} and "
          f"2^21, both index layouts  [{card}]")
    return smem, launches, tab6, ids6


def k9_bound(r: int, pairs: float, visits: float, nc: int, ng: int, t_pad: int,
             name: str | None = None):
    """K9's bound for ``r`` rays: the (ray, triangle) pairs its march
    visits on these rays (counted by the plain twin) at K9_OPS_PAIR; at
    K9_OPS_BOX each ray's test of the ``ng`` group boxes and one test of
    each of the ``visits`` chunks the rays visit (the least box work that
    finds the visited chunks, fewer than the two-level scan's member tests);
    rays in (24 B) and out (16 B), geo10 (40 B a triangle) and the chunk
    and group boxes (24 B each) once."""
    return bound_ms(K9_OPS_PAIR * pairs + K9_OPS_BOX * (r * ng + visits),
                    40 * r + 40 * t_pad + 24 * (nc + ng), name)


def k9_hosts(dev):
    """(soup host, its rays, the mesh-res 256 mushroom, its host): both
    Morton-ordered, the mushroom at the default accel_min and chunk."""
    from gaussian_splatterer_tpu_torch.io.obj import TriangleMesh
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh

    rng = np.random.default_rng(5)  # tests/test_torch_culled.py's soup
    soup = RtxHost(tri_chunk=K9_SOUP_CHUNK, device=dev)
    soup.load_model(TriangleMesh(rng.uniform(-2, 2, (3 * K9_SOUP, 3)).astype(np.float32),
                                 np.arange(3 * K9_SOUP, dtype=np.int32).reshape(K9_SOUP, 3),
                                 rng.uniform(0, 1, (K9_SOUP, 3, 2)).astype(np.float32)),
                    accel_min=1)
    o = torch.from_numpy(rng.uniform(-4, 4, (1 << 14, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(1 << 14, 3)).astype(np.float32)), dim=1).to(dev)
    mesh = mushroom_mesh(*K9_MESH)
    host = RtxHost(device=dev)
    host.load_model(mesh)
    if "bb_minx" not in host._tris or "bb_minx" not in soup._tris:
        raise SystemExit("phase 20 failed: a scene past accel_min has no Morton chunks")
    return soup, (o, d), mesh, host


def culled_gate(dev) -> tuple[float, object]:
    """Phase 20, part 1 and 2: K9 against its plain twin and against K5 at
    phase 9's gate, on the soup, on 2^16 bounce rays leaving the mesh-res
    256 mushroom and on one 1-sample 1024^2 batch of its primary rays; two
    launches bit-equal.  Returns the largest kernel-vs-plain error and the
    mushroom's host."""
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    soup, (so, sd), mesh, host = k9_hosts(dev)
    nc = host._tris["bb_minx"].shape[0]
    phase(f"20. the tracer at mesh scale: mt_culled (K9) vs plain and vs mt_intersect (K5) "
          f"(the soup, {K9_SOUP} triangles; the mushroom at mesh-res {K9_MESH[0]}, "
          f"{mesh.num_triangles:,} triangles in {nc} chunks of {host.tri_chunk})")
    o, d = surface_rays(mesh, K5_BOUNCE_RAYS, seed=4)
    po, pd = camera_rays(Camera.get_cameras(ns_project())[0], NS_RES, dev, seed=1, samples=1)
    sets = [(f"random soup, {K9_SOUP} triangles, chunks of {K9_SOUP_CHUNK}", soup, so, sd),
            (f"mushroom mesh-res {K9_MESH[0]}, {K5_BOUNCE_RAYS} bounce rays from its surface",
             host, o.to(dev), d.to(dev)),
            (f"mushroom mesh-res {K9_MESH[0]}, one 1-sample {NS_RES}^2 batch of primary rays "
             f"from rig camera 0", host, po, pd)]
    worst = 0.0
    for label, h, o, d in sets:
        tris, tc = h._tris, h.tri_chunk
        before = tr.mt_culled_launches
        k = tr.intersect_culled(o, d, tris, tc)
        again = tr.intersect_culled(o, d, tris, tc)
        torch.cuda.synchronize()
        p = tr.intersect_culled_reference(o, d, tris, tc)
        worst = max(worst, culled_check(label, o, d, tris, tc, k, p))
        same = all(torch.equal(a, b) for a, b in zip(k, again))
        print(f"    a second launch equals the first: {same}; launches counted "
              f"{tr.mt_culled_launches - before}", flush=True)
        if not same or tr.mt_culled_launches - before != 2:
            raise SystemExit(f"phase 20 failed: {label}: a second launch or the count")
        k5 = tr.intersect(o, d, tris, tc)
        compare_forms(f"{label}: K9 vs K5", o, d, tris, k, k5)
    return worst, host


def culled_check(label: str, o, d, tris, tc: int, k, p) -> float:
    """K9's hits ``k`` against its plain twin's ``p`` on the same rays:
    phase 9's gate (compare_hits) and bit for bit, as the kernel rounds
    every step as its twin does.  Returns compare_hits' error."""
    err = compare_hits(f"{label}: K9 vs plain", o, d, tris, k, p, phase_no=20)
    bits = all(torch.equal(a, b) for a, b in zip(k, p))
    print(f"    K9 equals its plain twin bit for bit: {bits}", flush=True)
    if not bits:
        raise SystemExit(f"phase 20 failed: {label}: K9 differs from its plain twin")
    return err


def culled_launch_sizes(host, cam) -> list[tuple[str, int, int]]:
    """K9's launches in one capture frame from ``cam``, by rays a launch:
    (bucket, launches, rays)."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    real, sizes = tr.intersect_culled, []

    def recorded(o, *args, **kwargs):
        sizes.append(o.shape[0])
        return real(o, *args, **kwargs)

    tr.intersect_culled = recorded
    try:
        host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES)
    finally:
        tr.intersect_culled = real
    edges = (1 << 10, 1 << 13, 1 << 16, 1 << 20, 1 << 24)
    out, lo = [], 0
    for hi in edges:
        part = [n for n in sizes if lo < n <= hi]
        out.append((f"{lo + 1}-{hi}", len(part), sum(part)))
        lo = hi
    return out


def culled_frame_s(host, cam, warmup: int = 1, reps: int = 2) -> float:
    """Seconds of one NS_SAMPLES-sample NS_RES^2 capture frame, median of
    ``reps`` after ``warmup`` (CUDA events)."""
    return cuda_ms(lambda: host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES),
                   warmup=warmup, reps=reps) / 1e3


def culled_first_design_frame(host, cam, warm: bool) -> float:
    """Seconds of one capture frame from ``cam`` through K9's first design
    (scripts/variants/mt_culled_thread_per_ray.cu), after a warm-up frame
    where ``warm`` (its first use builds it)."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr
    from gaussian_splatterer_tpu_torch.scripts.redesign_variants import first_design_intersect

    real = tr.intersect_culled
    try:
        tr.intersect_culled = first_design_intersect
        return culled_frame_s(host, cam, warmup=int(warm), reps=1)
    finally:
        tr.intersect_culled = real


def culled_stats(o, d, tris, tc: int, visits) -> str:
    """One K9 launch's stats on o, d: its steps, rays a bin and a slice, and
    the milliseconds of its phases (init, offsets, scatter, tests, each to
    the end of its grid barrier); its rays summed over the steps must equal
    the plain twin's ``visits``."""
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    stats = torch.zeros((8,), dtype=torch.int64, device=o.device)
    tr.intersect_culled(o, d, tris, tc, stats=stats)
    steps, bins, rays, slices, *ns = stats.tolist()
    if rays != int(visits.long().sum()):
        raise SystemExit(f"phase 20 failed: K9 tested {rays} (ray, chunk) pairs, its plain twin "
                         f"{int(visits.long().sum())}")
    return (f"{steps} steps, {rays / max(bins, 1):.1f} rays a bin, {rays / max(slices, 1):.1f} "
            f"a slice; phases init / offsets / scatter / tests "
            f"{' / '.join(f'{t / 1e6:.4f}' for t in ns)} ms")


def culled_times(dev, card, host, launches: int, gate_err: float) -> dict:
    """Phase 20, part 4: capture frames on the mesh-res 256 mushroom with K9
    and with the brute force (K5, accel_min 10^9), on the mesh-res 1024
    mushroom with K9 (its brute force estimated from one K5 launch); K9 by
    launch size beside K5, its mean chunks visited and its bound.  Each
    launch size, the main path's primary batch included, and the mesh-res
    1024 mushroom's primary and bounce rays are held against the plain twin
    (culled_check).  Returns the kernel summary entry of mt_culled."""
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.rt import tracer as tr
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture

    phase(f"20. the tracer at mesh scale: times (CUDA events; {card})")
    cam = Camera.get_cameras(ns_project())[0]
    tex = mushroom_texture()
    host.load_texture_diffuse(tex)
    t_mesh = host.mesh.num_triangles
    s9 = culled_frame_s(host, cam)
    before = (tr.mt_culled_launches, tr.mt_intersect_launches)
    busy_ms, wall_ms, by_name = device_busy_ms(
        lambda: host.render(cam, (0.0, 0.0, 0.0), NS_SAMPLES, NS_RES, NS_RES))
    per_frame = [(tr.mt_culled_launches - before[0]) // 2, (tr.mt_intersect_launches - before[1]) // 2]
    k9_dev = sum(ms for name, (ms, _) in by_name.items() if "mt_culled" in name)
    print(f"  K9 route, {t_mesh:,} triangles: {s9:.4f} s per {NS_SAMPLES}-sample {NS_RES}^2 "
          f"capture frame at rig camera 0 (median of 2 after 1 warm-up); device busy "
          f"{busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled frame, share {busy_ms / wall_ms:.3f}; "
          f"mt_culled {k9_dev:.3f} ms of it (the profiler's reading); {per_frame[0]} mt_culled "
          f"and {per_frame[1]} mt_intersect launches a frame  [{card}]", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"    device {ms:.3f} ms in {n} runs: {name[:90]}")
    if per_frame[0] == 0 or per_frame[1] != 0:
        raise SystemExit("phase 20 failed: a capture frame past accel_min did not take K9 alone")
    sizes = culled_launch_sizes(host, cam)
    print(f"    K9's launches in one frame by rays a launch (primaries and bounces): "
          + "; ".join(f"{label} {n} launches, {rays:,} rays" for label, n, rays in sizes),
          flush=True)
    brute = RtxHost(device=dev)
    brute.load_model(host.mesh, accel_min=10**9)
    brute.load_texture_diffuse(tex)
    s5 = culled_frame_s(brute, cam, warmup=0, reps=1)
    print(f"  brute-force route (accel_min 10^9, K5), {t_mesh:,} triangles: {s5:.4f} s per "
          f"frame (one frame); K9's route {s5 / s9:.2f}x faster  [{card}]", flush=True)
    del brute
    first = culled_first_design_frame(host, cam, warm=True)
    print(f"  K9's first design (thread a ray), {t_mesh:,} triangles: {first:.4f} s a frame "
          f"(one frame after a warm-up), the shipped kernel (chunk-binned) {s9:.4f} s (above)"
          f"  [{card}]", flush=True)

    # K9 by launch size on the mesh-res 256 mushroom, and on a primary batch
    tris, tc = host._tris, host.tri_chunk
    nc, ng = int(tris["bb_minx"].numel()), int(tris["bg_minx"].numel())
    t_pad = int(tris["valid"].numel())
    po, pd = camera_rays(cam, NS_RES, dev, seed=1, samples=host.sample_batch)
    print(f"  mt_culled by launch size on {t_mesh:,} triangles ({nc} chunks of {tc}) (call: CUDA "
          f"events around one call, median of {REPS}; device: 10 calls queued behind a spin "
          f"kernel, median of 5; visits and pairs from the plain twin; bound at {K9_OPS_PAIR} "
          f"operations a visited pair and {K9_OPS_BOX} a box test, each ray's {ng} group boxes and "
          f"each visited chunk's box once):")
    from gaussian_splatterer_tpu_torch.scripts import redesign_variants as rv

    entry = {}
    for r in (*K5_SWEEP, po.shape[0]):
        if r == po.shape[0]:
            ro, rd, label = po, pd, f"primary batch, {host.sample_batch} samples of {NS_RES}^2"
        else:
            ro, rd = (x.to(dev) for x in surface_rays(host.mesh, r, seed=7))
            label = "bounce rays"
        call_ms = cuda_ms(lambda: tr.intersect_culled(ro, rd, tris, tc))
        dev_ms = queued_ms(lambda: tr.intersect_culled(ro, rd, tris, tc))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        *plain, visits = tr.culled_march(ro, rd, tris, tc)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        gate_err = max(gate_err, culled_check(f"R = {r} ({label})", ro, rd, tris, tc,
                                              tr.intersect_culled(ro, rd, tris, tc), plain))
        pairs = float(visits.double().sum()) * tc
        b_ms, b_by = k9_bound(r, pairs, float(visits.double().sum()), nc, ng, t_pad,
                              "mt_culled" if r == po.shape[0] else None)
        k5_ms = cuda_ms(lambda: tr.intersect(ro, rd, tris, tc, reject=r == po.shape[0]),
                        warmup=1, reps=3)
        if not all(torch.equal(a, b) for a, b in zip(rv.first_design_intersect(ro, rd, tris, tc), plain)):
            raise SystemExit(f"phase 20 failed: R = {r}: K9's first design differs from plain")
        first_ms = queued_ms(lambda: rv.first_design_intersect(ro, rd, tris, tc), reps=1)
        launch = culled_stats(ro, rd, tris, tc, visits)
        print(f"    R = {r} ({label}): call {call_ms:.4f} ms, device {dev_ms:.4f} ms; plain "
              f"{plain_ms:.1f} ms (one call); chunks visited a ray {float(visits.float().mean()):.3f}"
              f" (max {int(visits.max())}), pairs {pairs:.4e}; bound {b_ms:.5f} ms ({b_by}), "
              f"device share {b_ms / dev_ms:.4f}; K5 on the same rays {k5_ms:.4f} ms (call); "
              f"{launch}; device first design {first_ms:.4f} ms (one round of 10), shipped "
              f"{dev_ms:.4f} ms"
              f"  [{card}]", flush=True)
        if r == 1 << 20:  # step 1's split: the first design on the rays reordered
            order = rv.ray_order(ro, rd, tris)
            so, sd = ro[order].contiguous(), rd[order].contiguous()
            split = [first_ms,
                     queued_ms(lambda: rv.first_design_intersect(so, sd, tris, tc), reps=1),
                     dev_ms]
            order_ms = cuda_ms(lambda: rv.ray_order(ro, rd, tris), warmup=1, reps=5)
            print(f"    the first design on R = {r} as they come / sorted by first chunk, and "
                  f"the shipped kernel: " + "; ".join(
                      f"{name} {ms:.4f} ms, {pairs / ms * 1e3:.4e} pairs/s, "
                      f"{48 * pairs / ms * 1e3 / 1e12:.3f} TB/s of triangles at 48 B a pair"
                      for name, ms in zip(("as they come", "sorted", "shipped"), split))
                  + f"; the sort itself {order_ms:.4f} ms (call)  [{card}]", flush=True)
            del order, so, sd
        if r == po.shape[0]:
            entry = {"ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    del po, pd, ro, rd

    # the mesh-res 1024 mushroom: K9's frame, and the brute force's primaries
    # estimated from one K5 launch on one 1-sample frame of them
    t0 = time.perf_counter()
    big = RtxHost(device=dev)
    big.load_model(big_mushroom())
    big.load_texture_diffuse(tex)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t_big = big.mesh.num_triangles
    s9_big = culled_frame_s(big, cam)
    fo, fd = camera_rays(cam, NS_RES, dev, seed=1, samples=1)
    k5_frame_ms = cuda_ms(lambda: tr.intersect(fo, fd, big._tris, big.tri_chunk), warmup=0,
                          reps=1)
    k9_frame_ms = cuda_ms(lambda: tr.intersect_culled(fo, fd, big._tris, big.tri_chunk))
    # the boxes of 2,044 chunks (49 KB) take the launch's opt-in shared memory
    bo, bd = (x.to(dev) for x in surface_rays(big.mesh, K5_BOUNCE_RAYS, seed=8))
    for label, ro, rd in ((f"mesh-res {K9_BIG_MESH[0]}, one 1-sample {NS_RES}^2 batch of "
                           f"primary rays", fo, fd),
                          (f"mesh-res {K9_BIG_MESH[0]}, {K5_BOUNCE_RAYS} bounce rays from its "
                           f"surface", bo, bd)):
        *plain, visits = tr.culled_march(ro, rd, big._tris, big.tri_chunk)
        gate_err = max(gate_err, culled_check(
            label, ro, rd, big._tris, big.tri_chunk,
            tr.intersect_culled(ro, rd, big._tris, big.tri_chunk), plain))
        print(f"    {culled_stats(ro, rd, big._tris, big.tri_chunk, visits)}, chunks visited "
              f"a ray {float(visits.float().mean()):.3f}", flush=True)
    print(f"  mesh-res {K9_BIG_MESH[0]}, {t_big:,} triangles ({big._tris['bb_minx'].numel()} "
          f"chunks; mesh and tables built and loaded in {load_s:.2f} s): K9 route {s9_big:.4f} s "
          f"per {NS_SAMPLES}-sample {NS_RES}^2 frame (median of 2 after 1 warm-up); one 1-sample "
          f"{NS_RES}^2 batch of primary rays: K9 {k9_frame_ms:.3f} ms, K5 {k5_frame_ms:.3f} ms "
          f"(one launch), so the brute force's primaries of a {NS_SAMPLES}-sample frame alone "
          f"would take about {k5_frame_ms * NS_SAMPLES / 1e3:.1f} s (estimated, bounces left out)"
          f"  [{card}]", flush=True)
    first_big = culled_first_design_frame(big, cam, warm=False)
    print(f"  K9's first design, {t_big:,} triangles: {first_big:.4f} s a frame (one frame), "
          f"the shipped kernel {s9_big:.4f} s (above)  [{card}]", flush=True)
    del big, fo, fd, bo, bd, ro, rd
    torch.cuda.empty_cache()
    if not all(np.isfinite(x) and x > 0 for x in (s9, s5, s9_big, k5_frame_ms)):
        raise SystemExit("phase 20 failed: a time is not finite")
    return {
        "name": "mt_culled",
        "route": "cuda",
        "source": "gaussian_splatterer_tpu_torch/csrc/mt_culled.cu",
        "replaces": "gaussian_splatterer_tpu/rt/tracer.py:145",
        "launches": launches,
        "max_abs_err": gate_err,
        **entry,
        "library_ms": None,  # no PyTorch call marches AABBs
    }


def culled_phase(dev, card) -> dict:
    """Phase 20: the gates, the main path (``new --obj`` -> ``train`` ->
    ``render --mode rtx`` on the mesh-res 256 mushroom, K9 launches
    required) and the times.  Returns the summary entry of mt_culled."""
    gate_err, host = culled_gate(dev)
    launches = tracer_main(dev.type, mesh_res=K9_MESH, phase_no=20, kernel="mt_culled")
    return culled_times(dev, card, host, launches["mt_culled"], gate_err)


@lru_cache(maxsize=1)
def big_mushroom():
    """The mushroom at mesh-res 1024 (1,046,528 triangles), made once for
    phases 20 and 21."""
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh

    return mushroom_mesh(*K9_BIG_MESH)


def write_obj_indexed(mesh, path: str) -> None:
    """The mesh as a Wavefront OBJ with one ``vt`` a vertex, as exporters
    write a mesh whose corners share their vertex's UV (the mushroom's do)."""
    uv = np.zeros((mesh.vertices.shape[0], 2), np.float32)
    uv[mesh.triangles.ravel()] = mesh.tri_uv.reshape(-1, 2)
    if not np.array_equal(uv[mesh.triangles], mesh.tri_uv):
        raise ValueError("write_obj_indexed: corners of a vertex differ in UV")
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vt {u!r} {v!r}" for u, v in uv.tolist()]
    lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in (mesh.triangles + 1).tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def timed(fn):
    """(fn(), its seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def pillow_decode(path: Path) -> Path:
    """A texture fixture's committed Pillow decode, an 8-bit RGBA PNG."""
    if path.name in PILLOW_DECODES:
        return (path.parent / PILLOW_DECODES[path.name]).resolve()
    return path.with_name(f"{path.name.rsplit('.', 1)[0]}.pillow.png")


def keyed_texture_frames(dev, card, path: Path, fail, cutout: bool = True) -> int:
    """Phase 21's alpha path: the north-star mesh under a cut-out texture
    fixture, one frame from rig camera 0 with the same seed three times:
    the texture loaded by path, given as its committed Pillow decode, and
    that decode with alpha forced to 1 (for an opaque texture, ``cutout``
    False: flipped upside down).  The first two must be bit-equal and the
    third must differ.  Returns K5's launches."""
    from gaussian_splatterer_tpu_torch.io.image import load_texture_rgba
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.rt import tracer as tr
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh

    decoded = load_texture_rgba(str(pillow_decode(path)))
    opaque = decoded.copy() if cutout else np.ascontiguousarray(decoded[::-1])
    if cutout:
        opaque[..., 3] = 1.0
    host = RtxHost(device=dev)
    host.load_model(mushroom_mesh(*NS_MESH))
    cam = Camera.get_cameras(ns_project())[0]
    before = tr.mt_intersect_launches
    frames = []
    t0 = time.perf_counter()
    for tex in (str(path), decoded, opaque):
        host.load_texture_diffuse(tex)
        frames.append(host.render(cam, (0.0, 0.0, 0.0), P21_KEYED_SAMPLES, P21_KEYED_RES,
                                  P21_KEYED_RES, seed=P21_KEYED_SEED))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k5 = tr.mt_intersect_launches - before
    from_file, from_decode, from_opaque = frames
    equal = torch.equal(from_file, from_decode)
    lit = int((from_file.amax(dim=-1) > 0).sum())
    differ = int((from_file != from_opaque).any(dim=-1).sum())
    other = "with alpha forced to 1" if cutout else "of the decode flipped upside down"
    print(f"  {path.name} ({float((decoded[..., 3] == 0).mean()):.4f} of its texels keyed "
          f"out) on the mushroom ({host.mesh.num_triangles} triangles), rig camera 0, "
          f"{P21_KEYED_SAMPLES} samples at {P21_KEYED_RES}^2, seed {P21_KEYED_SEED}: the frame "
          f"from the file bit-equal to the frame from its Pillow decode {equal}; {differ:,} of "
          f"{P21_KEYED_RES ** 2:,} pixels ({lit:,} lit) differ from the frame {other}; "
          f"mt_intersect launches {k5}; three frames {secs:.3f} s (host clock)  [{card}]")
    if (not equal or differ == 0 or (dev.type == "cuda" and k5 == 0)
            or not all(bool(torch.isfinite(f).all()) for f in frames)):
        fail(f"{path.name}'s frame is not the frame of its Pillow decode, does not differ "
             "from the opaque one, or K5 did not run")
    return k5


def byte_loops(card, fixtures: Path, fail) -> None:
    """Phase 21's native byte loops (native/src/codecs.cpp: PNG's unfilter,
    TIFF's LZW, QOI's ops, PSD's PackBits, SGI's and PCX's run lengths,
    TIFF's CCITT fax decoder, DDS's BC6H blocks, SUN's, MSP's and ICNS's
    run lengths, FLI's frame chunks; native/src/jpeg.cpp: the arithmetic
    (QM) decoder and lossless JPEG's difference and predictor loops;
    native/src/zstd.cpp: the Zstandard frame decoder): each file decoded
    with the native library and with it hidden (the Python twins), the two
    results equal and both host times printed."""
    from unittest import mock

    from gaussian_splatterer_tpu_torch import native
    from gaussian_splatterer_tpu_torch.io.image import decode_texture

    if native.lib() is None:
        fail("the native library (parsers and byte loops) did not build or load")
    for name in BYTE_LOOP_FIXTURES:
        blob = (fixtures / name).read_bytes()
        got, n_secs = timed(lambda: decode_texture(blob))
        with mock.patch.object(native, "lib", lambda: None):
            ref, p_secs = timed(lambda: decode_texture(blob))
        same = np.array_equal(got, ref)
        print(f"  {name} ({len(blob):,} B, {got.shape[1]}x{got.shape[0]}): native loops "
              f"{n_secs:.4f} s, Python twins {p_secs:.4f} s (host clock), "
              f"{p_secs / n_secs:.1f}x; equal {same}  [{card}]")
        if not same:
            fail(f"{name}: the native byte loops and their Python twins disagree")


def product_phase(dev, card) -> dict:
    """Phase 21: the rest of the product.  The JPEG and texture fixtures
    against their Pillow decodes, the cut-out textures' frames through K5
    (``keyed_texture_frames``: the keyed palette PNG, the DXT1 DDS, the
    lossy WebP with alpha, the PackBits PSD and the BLP2 DXT5) and those of
    the opaque JPEG-in-TIFF, arithmetic-coded JPEG, CIELab, Zstandard and
    JPEG 2000 textures, the 1024^2 PNG, LZW TIFF and QOI, the 256^2 PSD, RLE SGI and
    PCX, the arithmetic-coded and lossless JPEGs and the Zstandard TIFFs
    through the native byte loops and their Python twins (``byte_loops``), a
    JPEG-textured north star through the CLI
    (new -> train), its export to .ply, .html and .gobj and
    render --mode viewer, the .ply imported into a fresh session and
    rendered by K1 against the trained model's render, ``doctor`` in a
    subprocess, and the native parsers against the Python ones at size.
    Returns the kernels' launches of the phase.  On a CPU device (a
    rehearsal at small sizes) the CLI runs with ``--device cpu`` and no
    launch is required."""
    import argparse

    from gaussian_splatterer_tpu_torch import native
    from gaussian_splatterer_tpu_torch.app import cli as tcli
    from gaussian_splatterer_tpu_torch.app.session import Session
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.io import gobj as tgobj
    from gaussian_splatterer_tpu_torch.io import obj as tobj
    from gaussian_splatterer_tpu_torch.io.image import decode_png_rgba, load_texture_rgba
    from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg
    from gaussian_splatterer_tpu_torch.io.ply import load_ply
    from gaussian_splatterer_tpu_torch.io.viewer import pack_viewer_arrays
    from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh

    def fail(why: str):
        raise SystemExit(f"phase 21 failed: {why}")

    phase(f"21. the rest of the product: the texture fixtures, five cut-out textures, a "
          f"JPEG-in-TIFF, an arithmetic-coded JPEG, a CIELab, a Zstandard and a JPEG 2000 "
          f"texture on the card, the decoders' native byte loops, a JPEG texture, export (.ply, .html, .gobj, "
          f"render --mode viewer), the .ply imported and rendered, doctor, the native parsers "
          f"({card})")
    launches: dict[str, int] = {}
    on_card = dev.type == "cuda"
    flag = ("--device", dev.type)
    fixtures = HERE / "tests" / "data" / "jpeg"
    for name in JPEG_FIXTURES:
        blob = (fixtures / f"{name}.jpg").read_bytes()
        rgba, secs = timed(lambda: decode_jpeg(blob))
        same = np.array_equal(rgba, decode_png_rgba((fixtures / f"{name}.png").read_bytes()))
        print(f"  decode_jpeg {name}.jpg ({len(blob):,} B, {rgba.shape[1]}x{rgba.shape[0]}): "
              f"{secs:.4f} s (host clock); equal to its Pillow decode (the PNG) {same}")
        if not same:
            fail(f"{name}.jpg does not decode to its PNG")
    textures = HERE / "tests" / "data" / "textures"
    for name in TEXTURE_FIXTURES:
        path = textures / name
        rgba, secs = timed(lambda: load_texture_rgba(str(path)))
        same = np.array_equal(rgba, load_texture_rgba(str(pillow_decode(path))))
        note = " (JPEG entropy decoding in Python)" if "jpeg" in name else ""
        print(f"  load_texture_rgba {name} ({path.stat().st_size:,} B, {rgba.shape[1]}x"
              f"{rgba.shape[0]}): {secs:.4f} s (host clock){note}; equal to its Pillow decode "
              f"({pillow_decode(path).name}) {same}  [{card}]")
        if not same:
            fail(f"{name} does not decode to its Pillow decode")
    for name in CUTOUT_FIXTURES:
        add_launches(launches, {"mt_intersect": keyed_texture_frames(
            dev, card, textures / name, fail)})
    for name in (JPEG_TIFF_TEXTURE, ARITH_TEXTURE, LAB_TEXTURE, ZSTD_TEXTURE, J2K_TEXTURE):
        add_launches(launches, {"mt_intersect": keyed_texture_frames(
            dev, card, textures / name, fail, cutout=False)})
    byte_loops(card, HERE / "tests" / "data", fail)

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_product_", dir=HERE / "build"))
    write_obj(mushroom_mesh(*NS_MESH), str(work / "mushroom.obj"))
    jpg = str(fixtures / f"{JPEG_FIXTURES[0]}.jpg")
    proj = str(work / "project")
    out, secs = cli("new", proj, "--obj", str(work / "mushroom.obj"), "--texture", jpg,
                    "--init-field", "model", "--resolution", str(NS_RES), "--capacity",
                    str(NS_CAPACITY), "--max-dup", str(NS_MAX_DUP), *NS_RUNTIME, *flag,
                    timeout=300, phase_no=21)
    print(f"  new --texture {Path(jpg).name}: {secs:.3f} s (host clock): {out.strip()}")
    p = Project.load(f"{proj}/settings.json")
    p.sphere1.count, p.rtSamples = NS_CAMS, NS_SAMPLES
    p.intervalCapture, p.intervalDensify = NS_INTERVAL_CAPTURE, NS_INTERVAL_DENSIFY
    p.paramDensifyVariance = NS_DENSIFY_VARIANCE
    p.save(f"{proj}/settings.json")
    out, secs = cli("train", proj, "--steps", str(P21_STEPS), "--log-every", "1", *flag,
                    timeout=600, phase_no=21)
    stats = json.loads(out.strip().splitlines()[-1])
    steps = {name: sum(v) for name, v in stats["launches"].items()}
    add_launches(launches, steps)
    groups = 2 * NS_CAMS // TRAIN_GROUP
    print(f"  train --steps {P21_STEPS}: {secs:.3f} s (host clock, process included); capture "
          f"{stats['capture_s']} s; launches {stats['launches']}; splats {stats['splats']}")
    if on_card and (stats["launches"]["mt_intersect"][0] == 0 or steps["mt_culled"]
                    or steps["composite_train"] != P21_STEPS * groups):
        fail("the capture did not run K5, or a step did not run K3")

    # export and import, in this process: the CLI's entry point, counts from 0
    rt.composite_fwd_launches = rt.composite_train_launches = 0
    session = tcli._make_session(argparse.Namespace(project=proj, device=dev.type),
                                 require=True)
    png_tex = load_texture_rgba(str(fixtures / f"{JPEG_FIXTURES[0]}.png"))
    if not np.array_equal(session.rtx._texture.cpu().numpy(), png_tex):
        fail("the project's texture differs from the fixture's Pillow decode")
    print(f"  the project's texture on the card equals {JPEG_FIXTURES[0]}.png's decode bit for "
          f"bit; OBJ read by the {tobj.last_path} parser, splats.gobj by the "
          f"{tgobj.last_path} one")
    host = session.model.to_host()
    outs = {ext: str(work / f"model.{ext}") for ext in ("ply", "html", "gobj")}
    for ext, path in outs.items():
        _, secs = timed(lambda: tcli.main(["export", proj, path, *flag]))
        print(f"  export {Path(path).name}: {secs:.3f} s (host clock), "
              f"{Path(path).stat().st_size:,} B")
    viewer = str(work / "viewer.html")
    _, secs = timed(lambda: tcli.main(["render", proj, viewer, "--mode", "viewer", *flag]))
    html = Path(viewer).read_text()
    b64 = html.split('const B64 = "', 1)[1].split('"', 1)[0]
    import base64

    embedded = np.frombuffer(base64.b64decode(b64), np.float32).reshape(host.count, 23)
    viewer_ok = (np.array_equal(embedded, pack_viewer_arrays(host))
                 and html == Path(outs["html"]).read_text())
    gobj_back = tgobj.load_gobj(outs["gobj"], capacity=NS_CAPACITY)
    ply_back = load_ply(outs["ply"])
    print(f"  render --mode viewer: {secs:.3f} s (host clock); embedded data equal to "
          f"pack_viewer_arrays of the model ({host.count:,} splats) and to export's .html "
          f"{viewer_ok}; .gobj {gobj_back.count:,} splats, .ply {ply_back.count:,}")
    if (not viewer_ok or gobj_back.count != host.count or ply_back.count != host.count
            or not np.array_equal(gobj_back.means[:host.count], host.means[:host.count])):
        fail("an export does not hold the model")
    fresh = Session(runtime=session.runtime, device=dev)
    fresh.load_splats_ply(outs["ply"])
    imported, n_i = fresh.model.to_host(), fresh.model.count
    exact = n_i == host.count and all(
        np.array_equal(getattr(imported, k)[:n_i], getattr(host, k)[:n_i])
        for k in ("means", "shs", "rotations"))
    # the INRIA layout stores opacity as a logit (clipped to [1e-5, 1 - 1e-5]
    # first) and scales as logs: float32 round trips, held to
    # tests/test_splats_io.py's tolerances
    clipped = np.clip(host.opacities[:n_i], 1e-5, 1 - 1e-5)
    d_opac = float(np.abs(imported.opacities[:n_i] - clipped).max())
    d_scale = float((np.abs(imported.scales[:n_i] - host.scales[:n_i])
                     / host.scales[:n_i]).max())
    cam, scale = session.preview_camera(), session.project.previewSplatScale
    with torch.no_grad():
        a = session.render_splats(NS_RES, NS_RES, camera=cam, splat_scale=scale)
        b = fresh.render_splats(NS_RES, NS_RES, camera=cam, splat_scale=scale)
        for k in ("opacities", "scales"):  # the trained values back: the same model
            getattr(fresh.model, k).copy_(getattr(session.model, k))
        c = fresh.render_splats(NS_RES, NS_RES, camera=cam, splat_scale=scale)
    if on_card:
        torch.cuda.synchronize()
    diff = torch.abs(a - b).amax(dim=2)
    err, off = float(diff.max()), int((diff > PLY_RENDER_ATOL).sum())
    restored = float(torch.max(torch.abs(a - c)))
    k1 = rt.composite_fwd_launches
    add_launches(launches, {"composite_fwd": k1})
    print(f"  .ply imported into a fresh session ({n_i:,} splats, capacity "
          f"{fresh.model.capacity:,}): means, SH and rotations bit-equal to the trained "
          f"model's {exact}; opacity max |diff| from the clipped trained one {d_opac:.3e} (<= 1e-5), scales max rel "
          f"{d_scale:.3e} (<= 1e-5)")
    print(f"  its {NS_RES}^2 K1 render against the trained model's: max |diff| {err:.3e}, "
          f"mean {float(diff.mean()):.3e}, {off} of {diff.numel():,} pixels beyond "
          f"{PLY_RENDER_ATOL} (share within {1 - off / diff.numel():.6f} >= "
          f"{PLY_SHARE_WITHIN}; max <= {MAIN_MAX_ATOL}); with the trained opacities and "
          f"scales put back, max |diff| {restored:.3e} (== 0); composite_fwd launches {k1}")
    if (not exact or d_opac > 1e-5 or d_scale > 1e-5 or restored != 0.0
            or 1 - off / diff.numel() < PLY_SHARE_WITHIN or err > MAIN_MAX_ATOL
            or (on_card and k1 < 3) or not bool(torch.isfinite(b).all())):
        fail("the imported model differs from the trained one, or K1 did not run")
    del session, fresh, a, b, c

    proc = module_run("app", "doctor", *flag, timeout=300, phase_no=21)
    report = json.loads(proc.stdout)
    doc = [json.loads(ln)["launches"] for ln in proc.stderr.splitlines()
           if ln.startswith('{"launches"')]
    print(f"  gsplat-torch doctor: platform {report['platform']}, numerics_gate "
          f"{report['numerics_gate']}, tiled_vs_oracle_max_err "
          f"{report['tiled_vs_oracle_max_err']}, micro_step_per_s {report['micro_step_per_s']} "
          f"({report['config']}); launches {doc}  [{card}]")
    if report["platform"] != dev.type or report["numerics_gate"] != "ok" or len(doc) != 1:
        fail("doctor did not pass on the card")
    add_launches(launches, doc[0])

    mesh = big_mushroom()
    big = str(work / "mushroom1024.obj")
    _, secs = timed(lambda: write_obj_indexed(mesh, big))
    got, n_secs = timed(lambda: tobj.load_obj(big))
    path_n = tobj.last_path
    ref, p_secs = timed(lambda: tobj.load_obj_python(big))
    same = all(np.array_equal(getattr(got, k), getattr(ref, k))
               for k in ("vertices", "triangles", "tri_uv"))
    print(f"  OBJ at mesh-res {K9_BIG_MESH[0]} ({got.num_triangles:,} triangles, "
          f"{Path(big).stat().st_size:,} B, written in {secs:.2f} s): native {n_secs:.3f} s, "
          f"Python {p_secs:.3f} s (host clock), {p_secs / n_secs:.1f}x; equal arrays {same}, "
          f"equal to the mesh {np.array_equal(got.tri_uv, mesh.tri_uv)}")
    if path_n != "native" or not same or got.num_triangles != mesh.num_triangles:
        fail("the native OBJ parser did not run or disagrees with the Python one")
    rng = np.random.default_rng(21)
    n = P21_GOBJ_SPLATS
    model = SplatModelHost.from_arrays(
        rng.normal(0, 1, (n, 3)), rng.normal(0, 0.5, (n, 4, 3)), rng.uniform(0.01, 0.3, (n, 3)),
        rng.uniform(0.05, 1, n), rng.normal(0, 1, (n, 4)), capacity=n)
    files = {k: str(work / f"splats_{k}.gobj") for k in ("native", "python")}
    _, sn = timed(lambda: tgobj.save_gobj(model, files["native"]))
    wrote_n = tgobj.last_path
    _, sp = timed(lambda: tgobj.save_gobj_python(model, files["python"]))
    text_same = Path(files["native"]).read_bytes() == Path(files["python"]).read_bytes()
    back_n, ln = timed(lambda: tgobj.load_gobj(files["native"], capacity=n))
    read_n = tgobj.last_path
    back_p, lp = timed(lambda: tgobj.load_gobj_python(files["native"], capacity=n))
    same = all(np.array_equal(getattr(back_n, k), getattr(back_p, k))
               for k in ("means", "shs", "scales", "opacities", "rotations"))
    print(f"  .gobj of {n:,} splats (SH degree 1, {Path(files['native']).stat().st_size:,} B): "
          f"save native {sn:.3f} s, Python {sp:.3f} s, equal text {text_same}; load native "
          f"{ln:.3f} s, Python {lp:.3f} s, equal arrays {same} (host clock)")
    if wrote_n != "native" or read_n != "native" or not text_same or not same:
        fail("the native .gobj parser did not run or disagrees with the Python one")
    print(f"  launches of phase 21: {launches}", flush=True)
    return launches


def p22_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p22_counts() -> dict[str, int]:
    """The launch counts of the kernels on phase 22's path."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    return {"composite_train": rt.composite_train_launches,
            "cumsum_frames": rt.cumsum_frames_launches,
            "composite_fwd": rt.composite_fwd_launches,
            "mt_intersect": tr.mt_intersect_launches, "mt_culled": tr.mt_culled_launches}


def p22_zero_counts() -> None:
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.rt import tracer as tr

    rt.composite_train_launches = rt.cumsum_frames_launches = rt.composite_fwd_launches = 0
    tr.mt_intersect_launches = tr.mt_culled_launches = 0


def p22_fields(model, met) -> dict:
    """A step's model and metrics as numpy arrays."""
    out = {name: getattr(model, name).detach().cpu().numpy() for name in P22_FIELDS[:5]}
    out.update(var_loc=met.var_loc.cpu().numpy(), avg_grad_loc=met.avg_grad_loc.cpu().numpy(),
               loss=np.float64(float(met.loss)))
    return out


def p22_digest(arrays: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def p22_cell(dev):
    """Phase 7's cell on the cumsum route with its truths captured: (the
    trainer, the scene's arrays, the step's learning rates)."""
    from gaussian_splatterer_tpu_torch.train import LearningRates

    trainer, rtx, arrays = fused_cell(dev, "cumsum")
    trainer.capture_truths(rtx)
    return trainer, arrays, LearningRates.from_project(trainer.project)


def p22_model(arrays, dev):
    from gaussian_splatterer_tpu_torch.models.splats import SplatModel

    return SplatModel.from_numpy(*arrays, count=TRAIN_SPLATS, device=dev, sh_degree=1)


def p22_run_step(rank: int, kind: str, step, mesh, model, truths, cams, lrs, dev,
                 out: Path):
    """One step of a sharded ``kind`` with the launch counts zeroed just
    before it and read just after, its outputs written for the parent
    (rank 0: the whole model), then P22_TIMED_STEPS timed steps with the
    collectives timed.  Returns (its summary, the model after the first
    step)."""
    from gaussian_splatterer_tpu_torch import parallel
    from gaussian_splatterer_tpu_torch.parallel.collectives import all_gather_rows

    p22_sync(dev)
    p22_zero_counts()
    model, met = step(model, truths, cams, lrs)
    p22_sync(dev)
    launches = p22_counts()
    if isinstance(model, parallel.SplatShard):
        group = mesh.get_group(parallel.SPLAT_AXIS)
        fields = p22_fields(parallel.gather_model(mesh, model), met._replace(
            var_loc=all_gather_rows(met.var_loc, group),
            avg_grad_loc=all_gather_rows(met.avg_grad_loc, group)))
    else:
        fields = p22_fields(model, met)
    if rank == 0:
        np.savez(out / f"{kind}.npz", **fields)
    summary = {"frames": truths.shape[0], "tiles": truths.shape[1],
               "rows": model.means.shape[0], "launches": launches,
               "digest": p22_digest(fields)}
    return summary, model


def p22_time_steps(step, model, truths, cams, lrs, dev) -> dict:
    """P22_TIMED_STEPS more steps: the median step and the collectives'
    time, bytes and calls a step (CommStats, timed)."""
    step.comm.reset()
    step.comm.timed = True
    times = []
    for _ in range(P22_TIMED_STEPS):
        p22_sync(dev)
        t0 = time.perf_counter()
        step(model, truths, cams, lrs)
        p22_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": statistics.median(times),
            "comm_ms": step.comm.seconds * 1e3 / P22_TIMED_STEPS,
            "comm_bytes": step.comm.bytes // P22_TIMED_STEPS,
            "comm_calls": step.comm.calls // P22_TIMED_STEPS}


def p22_checkpoint(mesh, shard, arrays, dev, out: Path) -> dict:
    """Part (f) on one rank: the FSDP shard saved sharded into
    OUT/ckpt_fsdp, then loaded into a shard of the unstepped model's rows;
    whether its rows came back bit for bit, and the seconds of each."""
    from gaussian_splatterer_tpu_torch import parallel
    from gaussian_splatterer_tpu_torch.io.checkpoint import (
        load_checkpoint_sharded, save_checkpoint_sharded,
    )

    like = parallel.shard_model(mesh, p22_model(arrays, dev))
    saves = []
    for _ in range(2):  # the first call also imports and sets up the checkpointer
        p22_sync(dev)
        t0 = time.perf_counter()
        save_checkpoint_sharded(str(out / "ckpt_fsdp"), shard)
        saves.append(time.perf_counter() - t0)
    t1 = time.perf_counter()
    back, _ = load_checkpoint_sharded(str(out / "ckpt_fsdp"), like=like)
    p22_sync(dev)
    t2 = time.perf_counter()
    equal = (back.count == shard.count and back.offset == shard.offset
             and all(torch.equal(getattr(back, k), getattr(shard, k)) for k in P22_FIELDS[:5]))
    return {"equal": bool(equal), "save_s": saves, "load_s": t2 - t1,
            "device": str(back.device)}


def p22_steps(rank: int, dev, out: Path) -> dict:
    """Parts (a) and (f) on one rank: one DP, one FSDP and one band (tp)
    step of phase 7's cell on the cumsum route and a band step on the
    index_add route, each timed after, and the FSDP shard's sharded
    checkpoint."""
    from gaussian_splatterer_tpu_torch import parallel

    trainer, arrays, lrs = p22_cell(dev)
    runtime, res = trainer.runtime, TRAIN_RES
    result = {}
    for kind in ("dp", "fsdp", "tp", "tp_index_add"):
        reduction = "index_add" if kind.endswith("index_add") else "cumsum"
        if kind == "dp":
            mesh = parallel.make_camera_mesh(dev.type)
            step = parallel.make_dp_train_step(mesh, res, res, 1, runtime=runtime,
                                               reduction="cumsum")
            model = p22_model(arrays, dev)
            truths = parallel.shard_truths(mesh, trainer.truths)
        elif kind == "fsdp":
            mesh = parallel.make_2d_mesh(dev.type, 1, P22_WORLD)
            step = parallel.make_fsdp_train_step(mesh, res, res, 1, runtime=runtime,
                                                 reduction="cumsum")
            model = parallel.shard_model(mesh, p22_model(arrays, dev))
            truths = parallel.shard_truths(mesh, trainer.truths)
        else:
            mesh = parallel.make_tile_mesh(dev.type, 1, P22_WORLD)
            step = parallel.make_tp_train_step(mesh, res, res, 1, runtime=runtime,
                                               reduction=reduction)
            model = p22_model(arrays, dev)
            truths = parallel.shard_truths_tp(mesh, trainer.truths)
        result[kind], model = p22_run_step(rank, kind, step, mesh, model, truths,
                                           trainer.truth_cams, lrs, dev, out)
        if kind == "fsdp":
            result["ckpt"] = p22_checkpoint(mesh, model, arrays, dev, out)
        result[kind].update(p22_time_steps(step, model, truths, trainer.truth_cams, lrs, dev))
    return result


def p22_mesh3(rank: int, dev, out: Path) -> dict:
    """Parts (g) and (h) on one rank of P22_MESH3's: one 3-axis step and one
    routed 3-axis step of phase 7's cell (cumsum route), each followed by
    timed steps; the routed step's RouteStats and the collectives of its
    first step."""
    from gaussian_splatterer_tpu_torch import parallel

    trainer, arrays, lrs = p22_cell(dev)
    res = TRAIN_RES
    mesh = parallel.make_3d_mesh(dev.type, *P22_MESH3)
    truths = parallel.shard_truths_3d(mesh, trainer.truths)
    mesh3 = parallel.make_3d_train_step(mesh, res, res, 1, runtime=trainer.runtime,
                                        reduction="cumsum")
    routed = parallel.make_routed3_train_step(mesh, res, res, 1, runtime=trainer.runtime,
                                              frame_group=TRAIN_GROUP, reduction="cumsum")
    stats = []

    def routed_step(shard, truths, cams, lrs):
        shard, met, route_stats = routed(shard, truths, cams, lrs)
        stats.append(route_stats)
        return shard, met

    routed_step.comm = routed.comm
    result = {}
    for kind, step in (("mesh3", mesh3), ("routed", routed_step)):
        summary, shard = p22_run_step(rank, kind, step, mesh,
                                      parallel.shard_model_3d(mesh, p22_model(arrays, dev)),
                                      truths, trainer.truth_cams, lrs, dev, out)
        summary["offset"] = shard.offset
        summary["first_comm"] = [step.comm.calls, step.comm.bytes]
        if kind == "routed":
            summary["route_stats"] = stats[0]._asdict()
        summary.update(p22_time_steps(step, shard, truths, trainer.truth_cams, lrs, dev))
        summary["memory_mib"] = p22_step_memory(step, shard, truths, trainer.truth_cams, lrs,
                                                dev)
        result[kind] = summary
    return result


def p22_step_memory(step, model, truths, cams, lrs, dev):
    """[MiB allocated before one more step, MiB of its peak above that]
    in this process (each rank is one), or None on the CPU."""
    if dev.type != "cuda":
        return None
    p22_sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    step(model, truths, cams, lrs)
    p22_sync(dev)
    return [base / 2**20, (torch.cuda.max_memory_allocated(dev) - base) / 2**20]


def p22_mesh3_worker(rank: int, init_method: str, out: str, device: str, sizes: dict) -> None:
    """Rank ``rank`` of the 3-axis and routed 3-axis steps on ``device``: a
    gloo group of the P22_MESH3 ranks, its results in
    OUT/mesh3_rank<r>.json."""
    import torch.distributed as dist

    from gaussian_splatterer_tpu_torch import parallel

    globals().update(sizes)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    parallel.init_distributed(rank=rank, world_size=int(np.prod(P22_MESH3)),
                              init_method=init_method, backend="gloo")
    try:
        result = p22_mesh3(rank, dev, Path(out))
    finally:
        dist.destroy_process_group()
    Path(out, f"mesh3_rank{rank}.json").write_text(json.dumps(result))


def p22_band_launch(trainer, band: int, n_band: int):
    """The composite_train arguments of band ``band`` of ``n_band`` of the
    cell's first frame group, as the band step launches them: the
    projection shifted up by the band's offset, binned on the band's
    grid, against the band's truth tiles."""
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.train.trainer import CameraBatch, backgrounds

    res, tile, g = TRAIN_RES, TRAIN_TILE, TRAIN_GROUP
    band_h = res // n_band
    model = trainer.model
    cams = CameraBatch(*(x[:g] for x in trainer.truth_cams.twice()))
    bgs = backgrounds(trainer.truth_cams.num_frames, model.device)[:g]
    t = trainer.truths.shape[1] // n_band
    tiles = trainer.truths[:g, band * t:(band + 1) * t].contiguous()
    with torch.no_grad():
        comps, rows9 = rt.project_frames(
            model.means.expand(g, -1, -1), model.shs, model.scales, model.opacities,
            model.rotations, model.active_mask(), *cams, res, res, model.sh_degree)
        comps, rows9 = rt.shift_to_band(comps, rows9, band * band_h)
        return rt.train_launch_inputs(rows9, comps, res, band_h, tiles, bgs, tile,
                                      trainer.runtime.max_dup)[1]


def p22_capture_host(dev):
    from gaussian_splatterer_tpu_torch.rt import RtxHost
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture

    host = RtxHost(device=dev)
    host.load_model(mushroom_mesh(*K9_MESH))
    host.load_texture_diffuse(mushroom_texture())
    return host


def p22_frame_digest(img) -> str:
    import hashlib

    return hashlib.sha256(img.detach().cpu().numpy().tobytes()).hexdigest()


def p22_capture(rank: int, dev) -> dict:
    """Part (b) on one rank: its block of the sharded capture of the
    north-star rig on the mesh-res 256 mushroom (K9), each frame's
    SHA-256."""
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.parallel import capture_images_sharded

    host = p22_capture_host(dev)
    cameras = Camera.get_cameras(ns_project())
    p22_sync(dev)
    p22_zero_counts()
    t0 = time.perf_counter()
    frames = capture_images_sharded(host, cameras, P22_CAPTURE_SAMPLES, NS_RES, NS_RES,
                                    seed=P22_SEED)
    p22_sync(dev)
    return {"seconds": time.perf_counter() - t0, "launches": p22_counts(),
            "first": rank * frames.shape[0], "digests": [p22_frame_digest(f) for f in frames]}


def p22_loops(rank: int, dev, projects: dict) -> dict:
    """Part (c) on one rank: ``train --devices 2`` of each project through
    the CLI's run_train (the body every worker of ``spawn_train`` runs)."""
    from gaussian_splatterer_tpu_torch.app import cli as tcli
    from gaussian_splatterer_tpu_torch.io.checkpoint import digest

    result = {}
    for kind, proj in projects.items():
        args = tcli.build_parser().parse_args(
            ["train", proj, "--steps", str(NS_STEPS), "--devices", str(P22_WORLD),
             "--log-every", "1", "--device", str(dev), "--runtime", f"train_mesh={kind}"])
        p22_sync(dev)
        p22_zero_counts()
        t0 = time.perf_counter()
        session = tcli.run_train(args)
        p22_sync(dev)
        secs = time.perf_counter() - t0
        launches = p22_counts()
        model = session.model  # gathered under fsdp, on every rank
        result[kind] = {"seconds": secs, "launches": launches, "digest": digest(model),
                        "count": model.count, "devices": session.devices,
                        "rows": session.trainer.model.means.shape[0],
                        "loss": float(session.trainer.last_metrics.loss),
                        "iterations": session.project.iterations}
    return result


def p22_worker(rank: int, init_method: str, out: str, projects: dict, device: str,
               sizes: dict) -> None:
    """Rank ``rank`` of phase 22 on ``device`` (cuda:0 for every rank): a
    gloo group of P22_WORLD ranks (NCCL refuses two ranks on one GPU),
    parts (a)-(c), its results in OUT/rank<r>.json.  ``sizes`` are the
    parent's size constants (a rehearsal on the CPU sets them small)."""
    import torch.distributed as dist

    from gaussian_splatterer_tpu_torch import parallel

    globals().update(sizes)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the device is set up before the meshes
    parallel.init_distributed(rank=rank, world_size=P22_WORLD, init_method=init_method,
                              backend="gloo")
    try:
        result = {"steps": p22_steps(rank, dev, Path(out)), "capture": p22_capture(rank, dev),
                  "loops": p22_loops(rank, dev, projects)}
    finally:
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(result))


def p22_projects(work: Path, dev) -> dict:
    """The north star as ``new`` makes it (phase 10's mesh, rig and
    schedule), once for each mesh kind."""
    import shutil

    from gaussian_splatterer_tpu_torch.app import cli as tcli
    from gaussian_splatterer_tpu_torch.config import Project
    from gaussian_splatterer_tpu_torch.io.image import save_png
    from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_mesh, mushroom_texture

    write_obj(mushroom_mesh(*NS_MESH), str(work / "mushroom.obj"))
    save_png(mushroom_texture()[..., :3], str(work / "mushroom.png"), flip_vertical=False)
    dp = str(work / "dp")
    if tcli.main(["new", dp, "--obj", str(work / "mushroom.obj"), "--texture",
                  str(work / "mushroom.png"), "--init-field", "model", "--resolution",
                  str(NS_RES), "--capacity", str(NS_CAPACITY), "--max-dup", str(NS_MAX_DUP),
                  *NS_RUNTIME, "--device", dev.type]) != 0:
        raise SystemExit("phase 22 failed: new")
    p = Project.load(f"{dp}/settings.json")
    ns = ns_project()
    p.sphere1.count, p.rtSamples = ns.sphere1.count, ns.rtSamples
    p.intervalCapture, p.intervalDensify = NS_INTERVAL_CAPTURE, NS_INTERVAL_DENSIFY
    p.paramDensifyVariance = NS_DENSIFY_VARIANCE
    p.save(f"{dp}/settings.json")
    fsdp = str(work / "fsdp")
    shutil.copytree(dp, fsdp)
    return {"dp": dp, "fsdp": fsdp}


def p22_step_check(work: Path, kind: str, per: list, want: dict, dev, fail) -> dict:
    """Print each rank's step and collectives and the gap of the sharded
    ``kind`` to the single-process step; fail past P22_GATE, without K3
    and K4 launches on the card, or when the ranks' whole models differ.
    Returns the launches summed over the ranks."""
    with np.load(work / f"{kind}.npz") as z:
        got = {k: z[k] for k in z.files}
    gap = p22_gap(got, want)
    part = {"mesh3": "(g)", "routed": "(h)"}.get(kind, "(a)")
    for r, x in enumerate(per):
        print(f"  {part} {kind} rank {r}: {x['frames']} frames, {x['tiles']} tiles a frame, "
              f"{x['rows']} rows; step {x['step_ms']:.3f} ms, collectives {x['comm_ms']:.3f} ms "
              f"in {x['comm_calls']} calls of {x['comm_bytes']:,} B a step (median of "
              f"{P22_TIMED_STEPS}, collectives timed with the device synchronised, "
              f"{len(per)} ranks sharing one H100 via gloo, not a scaling figure); launches "
              f"{x['launches']}")
    print(f"  {part} {kind} against the single-process step, max |diff| over the field's "
          f"largest (<= {P22_GATE}): " + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()),
          flush=True)
    if max(gap.values()) > P22_GATE or not all(np.isfinite(v) for v in gap.values()):
        fail(f"{part} the {kind} step against the single-process step")
    cumsum = not kind.endswith("index_add")
    if dev.type == "cuda" and any(x["launches"]["composite_train"] == 0
                                  or (cumsum and x["launches"]["cumsum_frames"] == 0)
                                  for x in per):
        fail(f"{part} a rank's {kind} step did not launch K3" + (" and K4" if cumsum else ""))
    if len({x["digest"] for x in per}) != 1:  # the whole model, gathered under fsdp
        fail(f"{part} the {kind} ranks' models differ")
    if kind == "fsdp" and [x["rows"] for x in per] != [TRAIN_CAPACITY // P22_WORLD] * 2:
        fail("(a) an FSDP rank does not hold capacity / 2 rows")
    return {k: sum(x["launches"][k] for x in per) for k in per[0]["launches"]}


def p22_gap(got: dict, want: dict) -> dict[str, float]:
    """Each field's max |got - want| over want's largest |value|."""
    return {k: float(np.max(np.abs(got[k] - want[k]))) / max(float(np.max(np.abs(want[k]))),
                                                            1e-30) for k in P22_FIELDS}


def parallel_phase(dev, card) -> dict:
    """Phase 22: multi-device training on the one card, 2 gloo ranks on
    cuda:0 in spawned workers: (a) a DP, an FSDP and a band (tp, 1 x 2
    camera x tile) step of phase 7's cell (cumsum route; the band step on
    the index_add route too) against the single-process step on the same
    route, K3 on a band's grid against its plain version first; (f) the
    FSDP shard's sharded checkpoint, restored bit for bit on each rank and,
    in one process, equal to the gathered model; (g) the 3-axis step and
    (h) the routed 3-axis step (records routed to their compositors, no
    parameter gather) on P22_MESH3 (4 gloo ranks) against the
    single-process step, the routed step's RouteStats; (b) the sharded capture
    of the north-star rig on the mesh-res 256 mushroom (K9) bit-equal to
    serial renders; (c) ``train --devices 2`` of the north star on each
    mesh (DP copies bit-equal, densify grows it, a finite loss); (d) one
    nccl rank's DP step bit-equal to make_train_step; (e) the CLI's
    ``train --devices 2`` refused on the one-card host.  Returns the
    kernels' launches of the workers' main paths, both ranks summed."""
    import shutil
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gaussian_splatterer_tpu_torch import parallel
    from gaussian_splatterer_tpu_torch.io.checkpoint import load_checkpoint_sharded
    from gaussian_splatterer_tpu_torch.io.gobj import load_gobj
    from gaussian_splatterer_tpu_torch.models.camera import Camera
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.raster_tiled import REDUCTIONS
    from gaussian_splatterer_tpu_torch.parallel import frame_seed
    from gaussian_splatterer_tpu_torch.train import fused_kw_from_runtime, make_train_step

    def fail(why: str):
        raise SystemExit(f"phase 22 failed: {why}")

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    phase(f"22. multi-device training: {P22_WORLD} ranks sharing one H100 via gloo, not a "
          f"scaling figure ({card})")
    t_phase = time.perf_counter()
    # the single-process step of phase 7's cell on the cumsum route, and (d)
    trainer, arrays, lrs = p22_cell(dev)
    runtime, res = trainer.runtime, TRAIN_RES
    wants = {}
    for reduction in REDUCTIONS:
        single = make_train_step(res, res, 1, renderer="tiled", fused=True,
                                 fused_opts=dict(fused_kw_from_runtime(runtime),
                                                 reduction=reduction),
                                 frame_group=runtime.frame_group)
        wants[reduction] = p22_fields(*single(p22_model(arrays, dev), trainer.truths,
                                              trainer.truth_cams, lrs))
    want = wants["cumsum"]
    parallel.init_distributed(rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{free_port()}",
                              backend=parallel.backend_for(dev))
    try:
        mesh = parallel.make_camera_mesh(dev.type)
        step = parallel.make_dp_train_step(mesh, res, res, 1, runtime=runtime,
                                           reduction="cumsum")
        p22_zero_counts()
        one = p22_fields(*step(p22_model(arrays, dev), trainer.truths, trainer.truth_cams, lrs))
        p22_sync(dev)
        nccl_launches = p22_counts()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    equal = all(np.array_equal(one[k], want[k]) for k in P22_FIELDS)
    print(f"  (d) one {backend} rank's DP step against make_train_step, cumsum route: "
          f"bit-equal {equal}; launches {nccl_launches}", flush=True)
    if not equal or backend != parallel.backend_for(dev) or (
            dev.type == "cuda" and nccl_launches["composite_train"] == 0):
        fail("(d) the 1-rank nccl DP step is not bit-equal to the single-process step")
    # K3 on the second band's grid, as the band step launches it
    args = p22_band_launch(trainer, 1, P22_WORLD)
    out_k = rt.composite_train(*args)
    p22_sync(dev)
    finite, r_max, r_mean, d_max, rel_max, rel_mean = compare_train(args, out_k)
    print(f"  (a) K3 on band 1 of {P22_WORLD} ({TRAIN_GROUP} frames, {args[-1]} tiles a frame, "
          f"{args[0].shape[1]} duplicates) vs plain: max|res| {r_max:.3e} (<= {MAIN_MAX_ATOL}) "
          f"mean {r_mean:.3e} (<= {MAIN_MEAN_ATOL})  max|d_feat| {d_max:.3e}, over the row's "
          f"largest: max {rel_max:.3e} (<= {MAIN_MAX_ATOL}) mean {rel_mean:.3e} "
          f"(<= {MAIN_MEAN_ATOL})  finite {finite}", flush=True)
    if not (finite and r_max <= MAIN_MAX_ATOL and r_mean <= MAIN_MEAN_ATOL
            and rel_max <= MAIN_MAX_ATOL and rel_mean <= MAIN_MEAN_ATOL):
        fail("(a) K3 on a band's grid against its plain version")
    del trainer, args, out_k

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=HERE / "build"))
    projects = p22_projects(work, dev)
    start = load_gobj(f"{projects['dp']}/splats.gobj", capacity=NS_CAPACITY).count
    t0 = time.perf_counter()
    sizes = {k: globals()[k] for k in P22_SIZES}
    mp.start_processes(p22_worker, args=(f"tcp://127.0.0.1:{free_port()}", str(work), projects,
                                         "cuda:0" if dev.type == "cuda" else "cpu", sizes),
                       nprocs=P22_WORLD, join=True, start_method="spawn")
    workers_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(P22_WORLD)]
    print(f"  workers: {workers_s:.3f} s (host clock, the processes' start included)")

    # (a) the steps against the single-process step
    launches: dict[str, int] = {}
    for kind in ("dp", "fsdp", "tp", "tp_index_add"):
        add_launches(launches, p22_step_check(
            work, kind, [r["steps"][kind] for r in ranks],
            wants["index_add" if kind.endswith("index_add") else "cumsum"], dev, fail))
    if [x["steps"]["tp"]["tiles"] for x in ranks] != [ranks[0]["steps"]["dp"]["tiles"] // 2] * 2:
        fail("(a) a tp rank does not hold half the tiles")

    # (f) the FSDP shard's sharded checkpoint
    for r, x in enumerate(ranks):
        ck = x["steps"]["ckpt"]
        print(f"  (f) fsdp rank {r}: saved sharded in {ck['save_s'][0]:.3f} s, again (over "
              f"it) in {ck['save_s'][1]:.3f} s, loaded into its rows on {ck['device']} in "
              f"{ck['load_s']:.3f} s (host clock): bit-equal {ck['equal']}")
    whole, _ = load_checkpoint_sharded(str(work / "ckpt_fsdp"), device=dev)
    with np.load(work / "fsdp.npz") as z:
        same = all(np.array_equal(getattr(whole, k).cpu().numpy(), z[k]) for k in P22_FIELDS[:5])
    print(f"  (f) the checkpoint loaded in one process, no group: equal to the gathered FSDP "
          f"model bit for bit {same}", flush=True)
    if not (same and all(x["steps"]["ckpt"]["equal"] for x in ranks)):
        fail("(f) the sharded checkpoint did not restore the rows bit for bit")
    del whole

    # (g) the 3-axis step and (h) the routed 3-axis step on P22_MESH3's 4 ranks
    n3 = int(np.prod(P22_MESH3))
    t0 = time.perf_counter()
    mp.start_processes(p22_mesh3_worker, args=(f"tcp://127.0.0.1:{free_port()}", str(work),
                                               "cuda:0" if dev.type == "cuda" else "cpu", sizes),
                       nprocs=n3, join=True, start_method="spawn")
    print(f"  (g)-(h) {n3} workers: {time.perf_counter() - t0:.3f} s (host clock, the processes' "
          f"start included)")
    ranks3 = [json.loads((work / f"mesh3_rank{r}.json").read_text()) for r in range(n3)]
    half = TRAIN_CAPACITY // P22_MESH3[2]
    for kind in ("mesh3", "routed"):
        per3 = [x[kind] for x in ranks3]
        add_launches(launches, p22_step_check(work, kind, per3, want, dev, fail))
        if ([x["offset"] for x in per3] != [0, half] * (n3 // 2)
                or len({x["digest"] for x in per3}) != 1):
            fail(f"the {kind} ranks' rows or models")
    # (h) the routed step's true route maxima and its first step's exchanges
    routed = [x["routed"] for x in ranks3]
    for r, x in enumerate(routed):
        print(f"  (h) routed rank {r}: RouteStats {x['route_stats']}; first step's collectives "
              f"{x['first_comm'][0]} calls of {x['first_comm'][1]:,} B (against the 3-axis "
              f"step's {ranks3[r]['mesh3']['first_comm'][1]:,} B)")
        mem = {k: ranks3[r][k]["memory_mib"] for k in ("mesh3", "routed")}
        if mem["routed"] is not None:
            print(f"  (g)-(h) rank {r} memory (torch.cuda allocator of the rank's process): "
                  + "; ".join(f"{k} {v[0]:.3f} MiB held before a step, its peak {v[1]:.3f} "
                              f"MiB above that" for k, v in mem.items()))
    if len({json.dumps(x["route_stats"], sort_keys=True) for x in routed}) != 1:
        fail("(h) the ranks' RouteStats differ")

    # (b) the sharded capture against serial renders, frame seeds alike
    host = p22_capture_host(dev)
    cameras = Camera.get_cameras(ns_project())
    c = len(cameras)
    p22_sync(dev)
    t0 = time.perf_counter()
    serial = [p22_frame_digest(host.render(cameras[i % c], (1.0,) * 3 if i < c else (0.0,) * 3,
                                           P22_CAPTURE_SAMPLES, NS_RES, NS_RES,
                                           seed=frame_seed(P22_SEED, i)))
              for i in range(2 * c)]
    p22_sync(dev)
    serial_s = time.perf_counter() - t0
    sharded = [d for r in ranks for d in r["capture"]["digests"]]
    for r, x in enumerate(ranks):
        cap = x["capture"]
        print(f"  (b) rank {r}: frames {cap['first']}-{cap['first'] + len(cap['digests']) - 1} "
              f"in {cap['seconds']:.3f} s (host clock); launches {cap['launches']}")
    print(f"  (b) {2 * c} frames of {P22_CAPTURE_SAMPLES} samples at {NS_RES}^2, the mushroom "
          f"at mesh-res {K9_MESH[0]}: serial {serial_s:.3f} s; sharded bit-equal to serial "
          f"{sharded == serial}", flush=True)
    if sharded != serial or len(set(serial)) != 2 * c:
        fail("(b) the sharded capture is not bit-equal to the serial renders")
    if dev.type == "cuda" and any(x["capture"]["launches"]["mt_culled"] == 0 for x in ranks):
        fail("(b) a rank's capture did not launch K9")
    add_launches(launches, {k: sum(x["capture"]["launches"][k] for x in ranks)
                            for k in ranks[0]["capture"]["launches"]})

    # (c) the product loops
    for kind in ("dp", "fsdp"):
        per = [r["loops"][kind] for r in ranks]
        for r, x in enumerate(per):
            print(f"  (c) {kind} rank {r}: train --devices {P22_WORLD}, {x['iterations']} "
                  f"steps in {x['seconds']:.3f} s (host clock); splats {start} -> {x['count']}; "
                  f"loss {x['loss']:.6f}; rows {x['rows']}; launches {x['launches']}")
        ok = (all(x["iterations"] == NS_STEPS and x["devices"] == P22_WORLD
                  and x["count"] > start and np.isfinite(x["loss"])
                  and (dev.type != "cuda" or (x["launches"]["composite_train"] > 0
                                              and x["launches"]["mt_intersect"] > 0))
                  for x in per) and per[0]["digest"] == per[1]["digest"])
        if not ok:
            fail(f"(c) the {kind} loop: steps, growth, a finite loss, launches or the ranks' "
                 "models")
        add_launches(launches, {k: sum(x["launches"][k] for x in per) for k in per[0]["launches"]})

    # (e) the CLI refuses more ranks than cards
    rt_before = Path(projects["dp"], "runtime.json").read_text()
    proc = subprocess.run([sys.executable, "-m", "gaussian_splatterer_tpu_torch.app", "train",
                           projects["dp"], "--steps", "1", "--devices", str(P22_WORLD)],
                          cwd=HERE, capture_output=True, text=True, timeout=300)
    want_msg = f"train_devices={P22_WORLD} but only {torch.cuda.device_count()} devices"
    print(f"  (e) train --devices {P22_WORLD} with {torch.cuda.device_count()} card(s): exit "
          f"{proc.returncode}; {proc.stderr.strip().splitlines()[-1] if proc.stderr else ''}")
    if dev.type == "cuda" and torch.cuda.device_count() < P22_WORLD and (
            proc.returncode == 0 or want_msg not in proc.stderr
            or Path(projects["dp"], "runtime.json").read_text() != rt_before):
        fail("(e) train --devices was not refused on the one-card host")
    shutil.rmtree(work, ignore_errors=True)
    print(f"  phase 22: {time.perf_counter() - t_phase:.3f} s; launches {launches}", flush=True)
    return launches


def entry_phase(dev, card) -> dict:
    """Phase 23: the graft entry points on the card.  graft_entry.entry():
    its function called once (one K1 launch, counted), no duplicate
    dropped, its image equal to K1's on that launch's binning, and K1 there
    against its plain version exactly; then the call's time.  Then
    dryrun_multichip(4): every branch, K3 launched on rank 0.  Returns the
    launches."""
    from gaussian_splatterer_tpu_torch import graft_entry
    from gaussian_splatterer_tpu_torch.ops import raster_tiled as rt
    from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
    from gaussian_splatterer_tpu_torch.ops.transforms import project_splat_components

    phase(f"23. the graft entry points: graft_entry.entry() and dryrun_multichip(4) on the "
          f"card ({card})")
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(dev.type)
    p22_sync(dev)
    made_s = time.perf_counter() - t0
    rt.composite_fwd_launches = 0
    t0 = time.perf_counter()
    img = fn(*args)
    p22_sync(dev)
    first_s = time.perf_counter() - t0
    launches = {"composite_fwd": rt.composite_fwd_launches}
    size, tile = img.shape[0], graft_entry.ENTRY_TILE
    with torch.no_grad():
        comps = project_splat_components(*args[:11], size, size, 1, 1.0)
        bins = bin_splats(comps, size, size, tile, fn.max_dup)
        cargs = (rt.gather_features(comps, bins), bins.tile_start, bins.tile_end, tile,
                 -(-size // tile))
        out_k = rt.composite_fwd(*cargs)
        out_p = rt.composite_fwd_reference(*cargs)
        img_k = rt.tiles_to_image(out_k[..., 0:3] + out_k[..., 3:4] * args[11], size, size, tile)
    p22_sync(dev)
    err = float((out_k - out_p).abs().max())
    same = bool(torch.equal(img, img_k))
    lit = float((img.max(dim=2).values > 0).float().mean())
    print(f"  entry(): {int(args[5].sum())} splats in {args[0].shape[0]} slots, image "
          f"{tuple(img.shape)}, lit share {lit:.4f}, finite {bool(torch.isfinite(img).all())}; "
          f"scene made in {made_s:.3f} s, first call {first_s:.3f} s (host clock); launches "
          f"{launches}")
    print(f"  K1 on the entry's launch ({cargs[0].shape[1]} duplicates, num_dup {bins.num_dup}, "
          f"max_dup {fn.max_dup}): max|kernel - plain| {err:.3e} (== 0); the "
          f"entry's image equal to K1's {same}")
    if dev.type == "cuda" and launches["composite_fwd"] != 1:
        raise SystemExit("phase 23 failed: entry() did not launch K1 once")
    if not bins.num_dup == fn.num_dup <= fn.max_dup == cargs[0].shape[1]:
        raise SystemExit("phase 23 failed: entry()'s render dropped duplicates")
    if err != 0.0 or not same or not torch.isfinite(img).all() or lit < 0.05:
        raise SystemExit("phase 23 failed: entry()'s render against K1's plain version")
    ms = cuda_ms(lambda: fn(*args))
    print(f"  entry()'s call: {ms:.4f} ms (CUDA events, median of {REPS} after {WARMUP} "
          f"warm-ups; {card})", flush=True)
    del fn, args, img, comps, bins, cargs, out_k, out_p, img_k

    # the dry run on the card: 4 gloo ranks sharing it; rank 0 prints its lines
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(4, dev.type)
    print(f"  dryrun_multichip(4): {time.perf_counter() - t0:.3f} s (host clock, the 4 "
          f"processes' start included); rank 0 on {dry['device']} over {dry['backend']}, its "
          f"launches {dry['launches']}; losses " + ", ".join(
              f"{k} {dry[k]:.6f}" for k in ("dp", "fsdp", "bands", "mesh3", "routed")) +
          f"; RouteStats {dry['route_stats']}; densify {dry['densify']}; product "
          f"{dry['product']}", flush=True)
    if dev.type == "cuda" and (dry["device"] != "cuda:0"
                               or dry["launches"]["composite_train"] == 0):
        raise SystemExit("phase 23 failed: the dry run did not run K3 on the card")
    if set(dry["product"]) != {"dp", "fsdp"} or dry["densify"][1] <= dry["densify"][0]:
        raise SystemExit("phase 23 failed: the dry run missed a branch")
    launches["composite_train"] = dry["launches"]["composite_train"]
    return launches


def device_busy_ms(fn) -> tuple[float, float, dict]:
    """(milliseconds in which the device ran a kernel or a copy, wall
    milliseconds, {name: [device ms, count]} of the kernels and copies) of
    one fn() under torch.profiler's CUDA activity, after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3
        entry[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:  # the union of the device's busy intervals
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy_us / 1e3, wall_ms, by_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append",
                    choices=("step", "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k9", "bench",
                             "quality", "export", "parallel", "entry"),
                    help="run phases 1-2 and then only phases 7-8 and 16 (step: the fused "
                         "step's cell on both reduction routes, its layers and the batched "
                         "front end against the frame-by-frame one), phases 3-5 (k1: the "
                         "serve gate, the "
                         "kernel against plain on the three serve cells, its times, bounds, "
                         "registers and SASS), phase 12 and K2 on one 1000^2 frame (k2), "
                         "phases 6-8 (k3: the train gate, the fused train cell, the "
                         "compositor's times, bounds, registers and SASS), phase 15's gate "
                         "shapes and K4 alone on a synthetic full-size group (k4), phase 11 (k5: "
                         "capture frames, the intersector's times, launch sizes and SASS) or "
                         "phase 17's gather probes (k6: from shared memory, k7: at the bench "
                         "scale; for timing two trees of the repository in one call, this "
                         "script copied into each), or phase 18 (bench: the port's bench, "
                         "--tile 16 and bench_scale) or phase 19 (quality: quality_run, "
                         "resumed, and eval_model) or phase 20 (k9: the tracer at mesh scale) "
                         "or phase 21 (export: the JPEG texture, export and import, doctor, "
                         "the native parsers) or phase 22 (parallel: multi-device training, "
                         "2 and 4 ranks sharing the card) or phase 23 (entry: the graft "
                         "entry points), which end with the full run's last line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import gaussian_splatterer_tpu_torch as port
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script: {exc}",
              file=sys.stderr)
        return 2
    if Path(port.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported the port from {port.__file__}, not from {HERE}",
              file=sys.stderr)
        return 2
    from gaussian_splatterer_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("1. environment")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0].strip()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print("nvcc:", run([cuda_build.find_nvcc(), "--version"]).splitlines()[-1])
    print(f"device: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {card}")
    try:
        import lzma  # noqa: F401  (the LZMA TIFF textures need it)
        print("lzma imports (LZMA TIFF textures read)")
    except ImportError as exc:
        print(f"lzma does not import ({exc}): LZMA TIFF textures are refused")

    phase("2. build")
    t0 = time.perf_counter()
    kernels = cuda_build.KERNELS
    cuda_build.build(kernels)
    print(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s (wall)")
    for name in kernels:
        info = cuda_build.build_info[name]
        print(f"{name}: {info['seconds']:.2f} s -> {info['path']}")
        print(info["ptxas"])

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.only == ["step"]:
        train_main(dev, card)
        cumsum_cell(dev, card)
        print(card)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if args.only and set(args.only) <= {"bench", "quality", "k9", "export", "parallel",
                                        "entry"}:
        if "bench" in args.only:
            bench_phase(dev, card)
        if "quality" in args.only:
            quality_phase(card)
        if "k9" in args.only:
            k9 = culled_phase(dev, card)
            print(json.dumps({"kernels": [k9]}))
        if "export" in args.only:
            product_phase(dev, card)
        if "parallel" in args.only:
            parallel_phase(dev, card)
        if "entry" in args.only:
            entry_phase(dev, card)
        print(card)
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if args.only:
        if not set(args.only).isdisjoint({"step", "bench", "quality", "k9", "export",
                                          "parallel", "entry"}):
            raise SystemExit("chip_smoke: --only step, and --only bench, quality, k9, export, "
                             "parallel and entry, run without the other --only options")
        if "k1" in args.only:
            serve_phases(dev, card, only=True)
        if "k2" in args.only:
            bwd_gate(dev)
            k2_alone(dev, card)
        if "k3" in args.only:
            train_gate(dev)
            train_main(dev, card)
        if "k4" in args.only:
            k4_alone(dev, card)
        if "k5" in args.only:
            tracer_times(dev, card, 0, 0.0)
        if "k6" in args.only:
            phase(f"17. gather from shared memory (K6) ({card})")
            k6_phase(dev, card)
        if "k7" in args.only:
            from gaussian_splatterer_tpu_torch.scripts import gather_probe as gp

            phase(f"17. gather at the bench scale (K7) ({card})")
            gp.report(gp.run(dev), card)
        print(card)
        return 0

    fwd = serve_phases(dev, card)
    gate_err = train_gate(dev)
    train, group = train_main(dev, card)
    train["max_abs_err"] = max(train["max_abs_err"], gate_err)
    k5_err = tracer_gate(dev)
    launches = tracer_main()
    k5 = tracer_times(dev, card, launches["mt_intersect"], k5_err)
    k2_err = bwd_gate(dev)
    bwd = nonfused_main(dev, card)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], k2_err)
    k4 = cumsum_cell(dev, card, cumsum_gate(dev, group))
    del group
    probes = probe_phase(dev, card, [fwd, bwd, train, k4, k5])
    measured = bench_phase(dev, card)
    add_launches(measured, quality_phase(card))
    k9 = culled_phase(dev, card)
    add_launches(measured, product_phase(dev, card))
    add_launches(measured, parallel_phase(dev, card))
    add_launches(measured, entry_phase(dev, card))
    for entry in (fwd, train, k5, bwd, k4, k9):
        entry["launches"] += measured.get(entry["name"], 0)
    print(f"launches of phases 18-19 and 21-23 added to the summary: {measured}")
    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: jax was imported")

    print(json.dumps({"kernels": [fwd, train, k5, bwd, k4, *probes, k9]}))
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
