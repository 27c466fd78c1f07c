"""Tiled rasterizer (counterpart of gaussian_splatterer_tpu.ops.raster_tiled).

Serving half, differentiable with respect to the splat parameters and the
background (render_tiled, render_tiled_model):

  project_splat_components (transforms.py)
    -> bin_splats (depth sort + stable tile sort + per-tile ranges, binning.py)
    -> gather of the nine feature rows per duplicate into a (9, D) array
    -> composite: front-to-back compositing of each tile's duplicates, a
       torch.autograd.Function (the JAX package's custom VJP) whose
       forward is composite_fwd (the CUDA kernel csrc/composite_fwd.cu on
       a CUDA tensor, its plain PyTorch version composite_fwd_reference on
       a CPU tensor) and whose backward is composite_bwd
       (csrc/composite_bwd.cu, or composite_bwd_reference), from the saved
       rows and forward output
    -> C + T_final * background.

Compositing rules (identical to the oracle, raster_reference.py): skip a
duplicate where power > 0 or alpha < 1/255, clamp alpha at 0.99, and stop a
pixel, without that duplicate, once T would fall below 1e-4.

Training half (counterpart of render_train_grads_rows / _batch / and
render_train_grads):

  project_frames: one frame-batched projection of F frames, the nine
    feature rows (9, F*N) under autograd
    -> bin_splats_batch (binning.py: the F frames binned in one pass, one
       host sync for their duplicate counts)
    -> gather of the rows per duplicate
    -> composite_train: per (frame, tile), forward composite, signed
       residual truth - (C + T_final * bg) and backward replay into
       per-duplicate gradients of the nine rows; the CUDA kernel
       csrc/composite_train.cu on a CUDA tensor, composite_train_reference
       on a CPU tensor
    -> the reduction of the duplicate gradients onto the frame-stacked rows
       (each frame's duplicates land in its own columns, so the rows stay
       per frame), by one of two routes, the ``reduction`` argument:
         "index_add" (the default), dup_grads_to_rows: one index_add_;
         "cumsum", dup_grads_to_rows_cumsum: the JAX package's route, the
         duplicates carried back to depth order, a per-frame inclusive
         scan (cumsum_frames: the CUDA kernel csrc/cumsum_frames.cu on a
         CUDA tensor, torch.cumsum on a CPU tensor) and per-splat segment
         differences; its sums run in a fixed order, so it is
         deterministic on the card, where index_add_'s atomics are not
    -> torch.autograd.grad through the projection.

Truth and residual tiles are pixel-major, (F, T, P, 3) and (F, T, P, 4);
the JAX package's channel-major (8, P) layout is a TPU memory-layout
workaround.  Everything is float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.ops.binning import FrameBins, bin_splats, bin_splats_batch
from gaussian_splatterer_tpu_torch.ops.transforms import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    SplatComponents,
    project_splat_components,
)

# feature row layout of the (9, D) duplicate array
F_MX, F_MY, F_CA, F_CB, F_CC, F_CR, F_CG, F_CB2, F_OP = range(9)
F_ROWS = 9
TILE_SIZES = (8, 16, 32)  # composite_fwd: one CUDA thread per pixel, 64 to 1024

# Launches of the CUDA compositor in this process.  Only the CUDA branch of
# composite_fwd adds to it; a run can read it to show that its path went
# through the kernel.
composite_fwd_launches = 0
# Launches of the CUDA train kernel, counted the same way by composite_train.
composite_train_launches = 0
# Launches of the CUDA backward compositor, counted the same way by composite_bwd.
composite_bwd_launches = 0
# Launches of the CUDA per-frame scan, counted the same way by cumsum_frames.
cumsum_frames_launches = 0
REDUCTIONS = ("index_add", "cumsum")  # routes of the duplicate-gradient reduction


def _check_composite_args(feat, tile_start, tile_end, tile):
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not supported (one of {TILE_SIZES})")
    if feat.dtype != torch.float32 or feat.dim() != 2 or feat.shape[0] != F_ROWS:
        raise ValueError(f"feat must be ({F_ROWS}, D) float32, got {tuple(feat.shape)} {feat.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_end", tile_end)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != feat.device:
            raise ValueError(f"{name} must be (T,) int32 on {feat.device}")
    if tile_start.shape != tile_end.shape:
        raise ValueError("tile_start and tile_end differ in shape")
    if feat.shape[1] >= 2**31:
        raise ValueError("more than 2^31 - 1 duplicates")


class _Steps(NamedTuple):
    """Tiles ordered by duplicate count, so that the tiles still running at
    step k of a plain replay are a prefix."""

    order: torch.Tensor  # (n,) tile ids, most duplicates first
    start: torch.Tensor  # (n,) int64 first duplicate of each ordered tile
    running: list  # running[k] = number of tiles with more than k duplicates
    px: torch.Tensor  # (n, P) float32 pixel coordinates of the ordered tiles
    py: torch.Tensor


def _steps(tile_start, tile_end, tile: int, tx_tiles: int, tiles_frame: int) -> _Steps:
    dev = tile_start.device
    num_tiles = tile_start.shape[0]
    count = (tile_end.to(torch.int64) - tile_start.to(torch.int64)).clamp(min=0)
    count_sorted, order = torch.sort(count, descending=True, stable=True)
    steps = int(count_sorted[0]) if num_tiles else 0
    running = (num_tiles - torch.searchsorted(
        count_sorted.flip(0), torch.arange(steps, device=dev), side="right"
    )).tolist()
    t_img = order % tiles_frame
    pix = torch.arange(tile * tile, device=dev)
    px = ((t_img % tx_tiles) * tile)[:, None].to(torch.float32) + (pix % tile).to(torch.float32)
    py = ((t_img // tx_tiles) * tile)[:, None].to(torch.float32) + (pix // tile).to(torch.float32)
    return _Steps(order, tile_start.to(torch.int64)[order], running, px, py)


def _gauss(f, px, py):
    """Per-(tile, pixel) Gaussian of step k's duplicates ``f`` (9, m, 1), in
    the kernels' order of operations: (dx, dy, power, exp(power), alpha_raw,
    alpha clamped at 0.99)."""
    dx = px - f[F_MX]
    dy = py - f[F_MY]
    power = -0.5 * (f[F_CA] * dx * dx + f[F_CC] * dy * dy) - f[F_CB] * dx * dy
    expp = torch.exp(power)
    alpha_raw = f[F_OP] * expp
    return dx, dy, power, expp, alpha_raw, torch.clamp(alpha_raw, max=ALPHA_MAX)


def _forward_replay(feat, s: _Steps, stats):
    """Plain forward composite over the ordered tiles: (rgb (n, P, 3), T (n, P))."""
    n, p_count = s.px.shape
    trans = torch.ones((n, p_count), dtype=torch.float32, device=feat.device)
    rgb = torch.zeros((n, p_count, 3), dtype=torch.float32, device=feat.device)
    alive = torch.ones((n, p_count), dtype=torch.bool, device=feat.device)
    pairs = torch.zeros((), dtype=torch.int64, device=feat.device)
    pairs_box = torch.zeros((), dtype=torch.int64, device=feat.device)
    kept = torch.zeros((), dtype=torch.int64, device=feat.device)
    for k, m in enumerate(s.running):
        f = feat[:, s.start[:m] + k][:, :, None]  # (9, m, 1)
        _, _, power, _, _, alpha = _gauss(f, s.px[:m], s.py[:m])
        t_m = trans[:m]
        if stats is not None:
            pairs += alive[:m].sum()
            pairs_box += (alive[:m] & in_footprint(f, s.px[:m], s.py[:m])).sum()
        contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & alive[:m]
        test_t = t_m * (1.0 - alpha)
        stop = contrib & (test_t < T_EPS)
        use = contrib & ~stop
        if stats is not None:
            kept += use.sum()
        w = torch.where(use, alpha * t_m, torch.zeros_like(alpha))
        rgb[:m] += w[..., None] * f[F_CR : F_CB2 + 1].permute(1, 2, 0)
        trans[:m] = torch.where(use, test_t, t_m)
        alive[:m] &= ~stop
    if stats is not None:
        stats.update(pairs=int(pairs), pairs_box=int(pairs_box), composited=int(kept))
    return rgb, trans


def _backward_replay(feat, s: _Steps, g, g_ctot, gtn, stats):
    """Plain backward replay over the ordered tiles: d_feat (9, D), the
    per-duplicate sums over their tile's pixels of g-weighted gradients of
    the nine rows.  g (n, P, 3) is the pixel gradient of C, g_ctot (n, P)
    g . C_total and gtn (n, P) g_t T_final, with g_t the pixel gradient of
    T_final.  The forward is replayed front to back with _forward_replay's
    decisions; for a kept duplicate with t_k = T before it and w = alpha t_k,
    d_alpha = g.c t_k - (g . S_k + g_t T_final) / (1 - alpha), where S_k =
    C_total - sum_{j<=k} w_j c_j, zero where alpha_raw >= 0.99 (the clamp).
    ``stats`` receives ``pairs``, ``pairs_box`` and ``composited`` as from
    _forward_replay."""
    rr, rg, rb = g.unbind(-1)
    d_feat = torch.zeros_like(feat)
    trans = torch.ones_like(gtn)
    acc = torch.zeros_like(gtn)  # running sum of w * gc over kept duplicates
    alive = torch.ones(gtn.shape, dtype=torch.bool, device=feat.device)
    zero = torch.zeros((), dtype=torch.float32, device=feat.device)
    pairs = torch.zeros((), dtype=torch.int64, device=feat.device)
    pairs_box = torch.zeros((), dtype=torch.int64, device=feat.device)
    kept = torch.zeros((), dtype=torch.int64, device=feat.device)
    for k, m in enumerate(s.running):
        cols = s.start[:m] + k
        f = feat[:, cols][:, :, None]  # (9, m, 1)
        dx, dy, power, expp, alpha_raw, alpha = _gauss(f, s.px[:m], s.py[:m])
        t_m = trans[:m]
        if stats is not None:
            pairs += alive[:m].sum()
            pairs_box += (alive[:m] & in_footprint(f, s.px[:m], s.py[:m])).sum()
        contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & alive[:m]
        test_t = t_m * (1.0 - alpha)
        stop = contrib & (test_t < T_EPS)
        use = contrib & ~stop
        if stats is not None:
            kept += use.sum()
        w = torch.where(use, alpha * t_m, zero)
        r_m, g_m, b_m = rr[:m], rg[:m], rb[:m]
        gc = r_m * f[F_CR] + g_m * f[F_CG] + b_m * f[F_CB2]
        acc[:m] = torch.where(use, acc[:m] + w * gc, acc[:m])
        g_s = g_ctot[:m] - acc[:m]
        inv = 1.0 / (1.0 - alpha)
        d_alpha = gc * t_m - (g_s + gtn[:m]) * inv
        d_alpha = torch.where(use & (alpha_raw < ALPHA_MAX), d_alpha, zero)
        d_power = d_alpha * alpha_raw
        d_feat[:, cols] = torch.stack([
            (d_power * (f[F_CA] * dx + f[F_CB] * dy)).sum(1),
            (d_power * (f[F_CC] * dy + f[F_CB] * dx)).sum(1),
            -0.5 * (d_power * dx * dx).sum(1),
            -(d_power * dx * dy).sum(1),
            -0.5 * (d_power * dy * dy).sum(1),
            (r_m * w).sum(1),
            (g_m * w).sum(1),
            (b_m * w).sum(1),
            (d_alpha * expp).sum(1),
        ])
        trans[:m] = torch.where(use, test_t, t_m)
        alive[:m] &= ~stop
    if stats is not None:
        stats.update(pairs=int(pairs), pairs_box=int(pairs_box), composited=int(kept))
    return d_feat


def composite_fwd_reference(feat: torch.Tensor, tile_start: torch.Tensor,
                            tile_end: torch.Tensor, tile: int, tx_tiles: int,
                            stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch compositor with composite_fwd's contract.

    feat (9, D) float32 rows [mx, my, conic a, b, c, r, g, b, opacity] of the
    tile-sorted duplicates; tile t composites feat[:, tile_start[t]:
    tile_end[t]] front to back.  Returns (T, tile*tile, 4) float32
    (r, g, b, T_final), pixels row-major within the tile.

    It steps through duplicate position k of all tiles at once, in the
    kernel's order of operations, one rounding per operation.  A ``stats``
    dict receives the work the kernel does: ``pairs``, the (pixel,
    duplicate) pairs visited before their pixel terminated, ``pairs_box``,
    those of them whose pixel lies inside the duplicate's exact footprint
    box (in_footprint), and ``composited``, those that were composited."""
    _check_composite_args(feat, tile_start, tile_end, tile)
    num_tiles, p_count = tile_start.shape[0], tile * tile
    s = _steps(tile_start, tile_end, tile, tx_tiles, max(num_tiles, 1))
    rgb, trans = _forward_replay(feat, s, stats)
    out = torch.empty((num_tiles, p_count, 4), dtype=torch.float32, device=feat.device)
    out[s.order, :, 0:3] = rgb
    out[s.order, :, 3] = trans
    return out


def composite_fwd(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                  tile: int, tx_tiles: int) -> torch.Tensor:
    """Forward tile compositor: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as composite_fwd_reference)."""
    global composite_fwd_launches
    if feat.device.type == "cpu":
        return composite_fwd_reference(feat, tile_start, tile_end, tile, tx_tiles)
    if feat.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {feat.device}")
    _check_composite_args(feat, tile_start, tile_end, tile)
    if not (feat.is_contiguous() and tile_start.is_contiguous() and tile_end.is_contiguous()):
        raise ValueError("composite_fwd: inputs must be contiguous")
    lib = _composite_lib()
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, tile * tile, 4), dtype=torch.float32, device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.composite_fwd(
            feat.data_ptr(), feat.shape[1], tile_start.data_ptr(), tile_end.data_ptr(),
            out.data_ptr(), num_tiles, tile, tx_tiles, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: cudaError_t {err}")
    composite_fwd_launches += 1
    return out


def _composite_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("composite_fwd")
    fn = lib.composite_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_bwd_args(feat, tile_start, tile_end, out, gin, tile):
    _check_composite_args(feat, tile_start, tile_end, tile)
    shape = (tile_start.shape[0], tile * tile, 4)
    for name, x in (("out", out), ("gin", gin)):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != feat.device:
            raise ValueError(f"{name} must be {shape} float32 on {feat.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def composite_bwd_reference(feat: torch.Tensor, tile_start: torch.Tensor,
                            tile_end: torch.Tensor, out: torch.Tensor, gin: torch.Tensor,
                            tile: int, tx_tiles: int,
                            stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch backward compositor with composite_bwd's contract: the
    vector-Jacobian product of composite_fwd.

    feat, tile_start, tile_end, tile and tx_tiles as composite_fwd took
    them; out (T, P, 4) its output (r, g, b, T_final) and gin (T, P, 4) the
    gradient with respect to it.  Returns d_feat (9, D): per duplicate, the
    sums over its tile's pixels of gin-weighted gradients of the nine rows.
    The forward is replayed in the kernel's order of operations, so every
    skip and stop decision is the forward's; C_total and T_final come from
    ``out``.  ``stats`` receives ``pairs``, ``pairs_box`` and ``composited``
    as from composite_fwd_reference."""
    _check_bwd_args(feat, tile_start, tile_end, out, gin, tile)
    s = _steps(tile_start, tile_end, tile, tx_tiles, max(tile_start.shape[0], 1))
    g, fwd = gin[s.order], out[s.order]
    rr, rg, rb, g_t = g.unbind(-1)
    g_ctot = rr * fwd[..., 0] + rg * fwd[..., 1] + rb * fwd[..., 2]
    return _backward_replay(feat, s, g[..., 0:3], g_ctot, g_t * fwd[..., 3], stats)


def composite_bwd(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
                  out: torch.Tensor, gin: torch.Tensor, tile: int,
                  tx_tiles: int) -> torch.Tensor:
    """Backward tile compositor: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as composite_bwd_reference)."""
    global composite_bwd_launches
    if feat.device.type == "cpu":
        return composite_bwd_reference(feat, tile_start, tile_end, out, gin, tile, tx_tiles)
    if feat.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {feat.device}")
    _check_bwd_args(feat, tile_start, tile_end, out, gin, tile)
    if not all(x.is_contiguous() for x in (feat, tile_start, tile_end, out, gin)):
        raise ValueError("composite_bwd: inputs must be contiguous")
    lib = _bwd_lib()
    d_feat = torch.zeros_like(feat)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.composite_bwd(
            feat.data_ptr(), feat.shape[1], tile_start.data_ptr(), tile_end.data_ptr(),
            out.data_ptr(), gin.data_ptr(), d_feat.data_ptr(), tile_start.shape[0], tile,
            tx_tiles, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: cudaError_t {err}")
    composite_bwd_launches += 1
    return d_feat


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("composite_bwd")
    fn = lib.composite_bwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


class _Composite(torch.autograd.Function):
    """composite_fwd with composite_bwd as its backward (the JAX package's
    custom VJP of the compositor).  It saves the gathered rows, the tile
    ranges and the forward output; the ranges get no gradient."""

    @staticmethod
    def forward(ctx, feat, tile_start, tile_end, tile: int, tx_tiles: int):
        out = composite_fwd(feat, tile_start, tile_end, tile, tx_tiles)
        ctx.save_for_backward(feat, tile_start, tile_end, out)
        ctx.tile, ctx.tx_tiles = tile, tx_tiles
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gin):
        feat, tile_start, tile_end, out = ctx.saved_tensors
        d_feat = composite_bwd(feat, tile_start, tile_end, out, gin.contiguous(), ctx.tile,
                               ctx.tx_tiles)
        return d_feat, None, None, None, None


def composite(feat: torch.Tensor, tile_start: torch.Tensor, tile_end: torch.Tensor,
              tile: int, tx_tiles: int) -> torch.Tensor:
    """composite_fwd, differentiable with respect to ``feat``."""
    return _Composite.apply(feat, tile_start, tile_end, tile, tx_tiles)


def image_to_tiles(img: torch.Tensor, tile: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., T, tile*tile, C) in the compositor's
    tile-major pixel order.  Requires tile | H and tile | W; the training
    path's truth tiles are this of the (F, H, W, 3) truth images."""
    *lead, h, w, c = img.shape
    ty, txx = h // tile, w // tile
    return img.reshape(*lead, ty, tile, txx, tile, c).transpose(-4, -3).reshape(
        *lead, ty * txx, tile * tile, c)


def tiles_to_image(img_tiles: torch.Tensor, width: int, height: int, tile: int) -> torch.Tensor:
    """(T, tile*tile, C) -> (H, W, C), cropping the padding tiles past W, H."""
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    c = img_tiles.shape[-1]
    img = img_tiles.reshape(ty_tiles, tx_tiles, tile, tile, c).permute(0, 2, 1, 3, 4).reshape(
        ty_tiles * tile, tx_tiles * tile, c)
    return img[:height, :width, :]


def _rows(c: SplatComponents) -> torch.Tensor:
    """(9, N) feature rows [mx, my, conic a, b, c, r, g, b, opacity]; (9, F,
    N) for (F, N) components."""
    return torch.stack([c.mx, c.my, c.ca, c.cb, c.cc, c.cr, c.cg, c.cb2, c.opacity])


def gather_features(comps, bins) -> torch.Tensor:
    """(9, D) feature rows of the tile-sorted duplicates."""
    return _rows(comps)[:, bins.gather_idx].contiguous()


def render_tiled_tiles(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, background, sh_degree: int, scale_mod=1.0,
    *, tile: int = 16, max_dup: int = 2**19, aa: bool = False,
) -> torch.Tensor:
    """Tile-space render: (T, tile*tile, 3) image tiles, background applied.
    Binning reads the projection without its gradient, as the JAX package's
    stop_gradient does; the gathered rows carry it into the compositor."""
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not supported (one of {TILE_SIZES})")
    tx_tiles = -(-width // tile)
    comps = project_splat_components(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    )
    bins = bin_splats(SplatComponents(*(x.detach() for x in comps)), width, height, tile,
                      max_dup)
    out = composite(gather_features(comps, bins), bins.tile_start, bins.tile_end, tile,
                    tx_tiles)
    bg = torch.as_tensor(background, dtype=torch.float32, device=out.device)
    return out[..., 0:3] + out[..., 3:4] * bg


def render_tiled(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, background, sh_degree: int, scale_mod=1.0,
    *, tile: int = 16, max_dup: int = 2**19, aa: bool = False,
) -> torch.Tensor:
    """Render (H, W, 3) float32 with the tiled path; matches
    render_oracle(tile_cull=tile).  Differentiable with respect to the
    five splat parameters and the background; pixels cropped past W and H
    carry no gradient."""
    img_tiles = render_tiled_tiles(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, background, sh_degree, scale_mod,
        tile=tile, max_dup=max_dup, aa=aa,
    )
    return tiles_to_image(img_tiles, width, height, tile)


def render_tiled_model(model, camera, width, height, background, scale_mod=1.0,
                       train_fov: bool = True, **kw) -> torch.Tensor:
    """Convenience wrapper taking a SplatModel + Camera."""
    tan_fovx, tan_fovy = camera.tan_fov(width, height, train=train_fov)
    return render_tiled(
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), camera.get_view(), camera.get_proj_view(width / height),
        camera.location, tan_fovx, tan_fovy, width, height, background,
        model.sh_degree, scale_mod, **kw,
    )


# -- training half -------------------------------------------------------------


def _check_train_args(feat, tile_start, tile_end, truth, bg, tile, tiles_frame):
    _check_composite_args(feat, tile_start, tile_end, tile)
    blocks = tile_start.shape[0]
    if truth.dtype != torch.float32 or tuple(truth.shape) != (blocks, tile * tile, 3):
        raise ValueError(f"truth must be ({blocks}, {tile * tile}, 3) float32, "
                         f"got {tuple(truth.shape)} {truth.dtype}")
    if bg.dtype != torch.float32 or bg.dim() != 2 or bg.shape[1] != 3:
        raise ValueError(f"bg must be (F, 3) float32, got {tuple(bg.shape)} {bg.dtype}")
    if bg.shape[0] * tiles_frame != blocks:
        raise ValueError(f"{bg.shape[0]} frames x {tiles_frame} tiles != {blocks} blocks")
    if truth.device != feat.device or bg.device != feat.device:
        raise ValueError("truth and bg must be on the features' device")


# Margins of the footprint box (csrc/composite_train.cu's header proves them)
FOOT_SHRINK = 2.0**-18  # the conic's shrink and the threshold's widening
FOOT_WIDEN = 2.0**-16  # relative widening of the half-extents
FOOT_ABS = 2.0**-40  # absolute widening, a share of |centre|
FOOT_DET_MIN = 2.0**-30  # a determinant below this share of a c never skips
FOOT_L_MIN = 2.0**-40  # floor of the threshold
_ALPHA_MIN_F32 = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))  # the kernels' kAlphaMin


def _round_f32(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> float32 rounded toward -inf (down) or +inf."""
    y = x.float()
    off = y.double() > x if down else y.double() < x
    return torch.where(off, torch.nextafter(y, torch.full_like(y, -math.inf if down else math.inf)),
                       y)


def footprint_box(feat: torch.Tensor):
    """Plain twin of composite_train's footprint box, in the kernel's float64
    operations: (xlo, xhi, ylo, yhi), (D,) float32 each, outside which no
    pixel of the duplicate reaches alpha >= 1/255 by the kernels' float32
    arithmetic (the margins cover its rounding).  Empty (xlo = +inf) when
    no pixel does (op <= 0, or op below the threshold); the whole plane when
    a value is not finite or the conic is not positive definite."""
    rows = (F_MX, F_MY, F_CA, F_CB, F_CC, F_OP)
    finite = torch.isfinite(feat[list(rows)]).all(0)
    mx, my, a, b, c, op = feat[list(rows)].double().unbind(0)
    lm = (torch.log(op) - math.log(_ALPHA_MIN_F32) + FOOT_SHRINK) * (1.0 + FOOT_SHRINK)
    empty = ~(op > 0) | (lm < 0)
    lm = lm.clamp(min=FOOT_L_MIN)
    a1, c1 = a * (1.0 - FOOT_SHRINK), c * (1.0 - FOOT_SHRINK)
    ac = a1 * c1
    det = ac - b * b
    pd = (a1 > 0) & (det > ac * FOOT_DET_MIN)
    t = 2.0 * lm
    exw = torch.sqrt(t * c1 / det) * (1.0 + FOOT_WIDEN) + mx.abs() * FOOT_ABS
    eyw = torch.sqrt(t * a1 / det) * (1.0 + FOOT_WIDEN) + my.abs() * FOOT_ABS
    box = [_round_f32(mx - exw, True), _round_f32(mx + exw, False),
           _round_f32(my - eyw, True), _round_f32(my + eyw, False)]
    inf = torch.full_like(box[0], math.inf)
    out = []
    for i, edge in enumerate(box):
        lo = i % 2 == 0
        edge = torch.where(finite & empty, inf if lo else -inf, edge)
        out.append(torch.where(~finite | (~empty & ~pd), -inf if lo else inf, edge))
    return tuple(out)


def footprint_skips(box, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The footprint predicate: True where pixel (px, py) lies outside the
    box (footprint_box's, broadcast against the pixels), so that the pair
    may be skipped.  A NaN edge compares false and never skips.
    composite_train skips a duplicate for a warp whose whole patch of rows
    lies outside it."""
    xlo, xhi, ylo, yhi = box
    return (px < xlo) | (px > xhi) | (py < ylo) | (py > yhi)


def in_footprint(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(pixel, duplicate) pairs inside the duplicate's exact footprint box,
    no margin, in float64: |dx| <= sqrt(2 L c / (a c - b^2)) and likewise
    dy, L = ln(op / (1/255)); none where op <= 0 or L < 0, else all where
    a value is not finite or the conic is not positive definite.  ``f`` (9,
    m, 1) rows of m duplicates, px, py (m, P) their pixels.  The work count
    ``pairs_box`` of the replays' ``stats``."""
    rows = (F_MX, F_MY, F_CA, F_CB, F_CC, F_OP)
    finite = torch.isfinite(f[list(rows)]).all(0)
    mx, my, a, b, c, op = f[list(rows)].double().unbind(0)
    lsq = 2.0 * (torch.log(op) - math.log(_ALPHA_MIN_F32))
    det = a * c - b * b
    empty = finite & ((op <= 0) | (lsq < 0))
    whole = ~finite | ~((a > 0) & (det > 0))
    inside = ((px.double() - mx).abs() <= torch.sqrt(lsq * c / det)) & (
        (py.double() - my).abs() <= torch.sqrt(lsq * a / det))
    return ~empty & (whole | inside)


def composite_train_reference(feat, tile_start, tile_end, truth, bg, tile: int,
                              tx_tiles: int, tiles_frame: int,
                              stats: Optional[dict] = None):
    """Plain PyTorch fused training compositor with composite_train's
    contract.

    feat (9, D) rows of the tile-sorted duplicates of F frames; block b =
    f * tiles_frame + t composites feat[:, tile_start[b]:tile_end[b]] for
    tile t of frame f against truth[b] (P, 3) and background bg[f].
    Returns (res (F*T, P, 4) = (truth - (C + T_final bg), T_final),
    d_feat (9, D)): per duplicate, the sums over its tile's pixels of the
    gradient of the nine rows, J^T residual (see csrc/composite_train.cu).

    Like composite_fwd_reference it steps through duplicate position k of
    all blocks at once, in the kernel's order of operations; only the sums
    over pixels are taken in another order.  ``stats`` receives ``pairs``,
    ``pairs_box`` and ``composited`` as from composite_fwd_reference; each
    of the kernel's two passes visits those pairs once, and evaluates the
    Gaussian for the pairs of warps whose patch meets the footprint box
    (footprint_box), at least ``pairs_box``."""
    _check_train_args(feat, tile_start, tile_end, truth, bg, tile, tiles_frame)
    num_blocks, p_count = tile_start.shape[0], tile * tile
    s = _steps(tile_start, tile_end, tile, tx_tiles, tiles_frame)
    rgb, t_n = _forward_replay(feat, s, stats)

    bgo = bg[s.order // tiles_frame][:, None, :]  # (n, 1, 3)
    resid = truth[s.order] - (rgb + t_n[..., None] * bgo)
    rr, rg, rb = resid.unbind(-1)
    g_t = rr * bgo[..., 0] + rg * bgo[..., 1] + rb * bgo[..., 2]
    g_ctot = rr * rgb[..., 0] + rg * rgb[..., 1] + rb * rgb[..., 2]
    d_feat = _backward_replay(feat, s, resid, g_ctot, g_t * t_n, None)

    res = torch.empty((num_blocks, p_count, 4), dtype=torch.float32, device=feat.device)
    res[s.order, :, 0:3] = resid
    res[s.order, :, 3] = t_n
    return res, d_feat


def composite_train(feat, tile_start, tile_end, truth, bg, tile: int, tx_tiles: int,
                    tiles_frame: int):
    """Fused training compositor: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as composite_train_reference)."""
    global composite_train_launches
    if feat.device.type == "cpu":
        return composite_train_reference(feat, tile_start, tile_end, truth, bg, tile,
                                         tx_tiles, tiles_frame)
    if feat.device.type != "cuda":
        raise ValueError(f"composite_train: unsupported device {feat.device}")
    _check_train_args(feat, tile_start, tile_end, truth, bg, tile, tiles_frame)
    args = (feat, tile_start, tile_end, truth, bg)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("composite_train: inputs must be contiguous")
    lib = _train_lib()
    num_blocks = tile_start.shape[0]
    res = torch.empty((num_blocks, tile * tile, 4), dtype=torch.float32, device=feat.device)
    d_feat = torch.zeros_like(feat)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.composite_train(
            feat.data_ptr(), feat.shape[1], tile_start.data_ptr(), tile_end.data_ptr(),
            truth.data_ptr(), bg.data_ptr(), res.data_ptr(), d_feat.data_ptr(),
            num_blocks, tile, tx_tiles, tiles_frame, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_train kernel launch failed: cudaError_t {err}")
    composite_train_launches += 1
    return res, d_feat


def _train_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("composite_train")
    fn = lib.composite_train
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.composite_train_blocks_per_sm.argtypes = []
    lib.composite_train_blocks_per_sm.restype = ctypes.c_int
    return lib


def project_frames(means_b, shs, scales, opacities, rotations, active,
                   views, proj_views, cam_posns, tan_fovxs, tan_fovys,
                   width: int, height: int, sh_degree: int, aa: bool = False):
    """Project F frames in one frame-batched call (the JAX package's vmapped
    projection).  ``means_b`` is (F, N, 3), one copy of the means per frame,
    so that a backward through the rows gives per-frame location gradients;
    the camera arrays are (F, ...) stacks, tensors or numpy arrays.
    Returns (the SplatComponents, every field (F, N), detached, for
    binning; rows (9, F*N), column f * N + i, in the autograd graph of the
    inputs)."""
    c = project_splat_components(
        means_b, shs, scales, opacities, rotations, active,
        views, proj_views, cam_posns, tan_fovxs, tan_fovys,
        width, height, sh_degree, 1.0, aa=aa,
    )
    return SplatComponents(*(x.detach() for x in c)), _rows(c).reshape(F_ROWS, -1)


def gather_rows(rows9: torch.Tensor, fb: FrameBins) -> torch.Tensor:
    """(9, D) feature rows of the frame group's duplicates."""
    return rows9[:, fb.gather_idx].contiguous()


def dup_grads_to_rows(d_feat: torch.Tensor, fb: FrameBins, columns: int) -> torch.Tensor:
    """(9, D) per-duplicate gradients -> (9, F*N) per-row gradients.  Each
    frame's duplicates index only its own N columns, so no sum crosses
    frames; duplicates dropped past max_dup have no column and add
    nothing."""
    out = torch.zeros((F_ROWS, columns), dtype=torch.float32, device=d_feat.device)
    return out.index_add_(1, fb.gather_idx, d_feat)


def _check_cumsum_args(x):
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be (K, F, D) float32, got {tuple(x.shape)} {x.dtype}")


def cumsum_frames_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of cumsum_frames: torch.cumsum along D."""
    _check_cumsum_args(x)
    return torch.cumsum(x, dim=2)


def cumsum_frames(x: torch.Tensor) -> torch.Tensor:
    """Per-frame inclusive scan of a (K, F, D) float32 array along D (the
    JAX package's cumsum_frames): the CUDA kernel for CUDA tensors (one
    pass, each element read once, in an order fixed by the shapes), any D,
    bit-equal from launch to launch; the plain version for CPU tensors."""
    global cumsum_frames_launches
    if x.device.type == "cpu":
        return cumsum_frames_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum_frames: unsupported device {x.device}")
    _check_cumsum_args(x)
    if not x.is_contiguous():
        raise ValueError("cumsum_frames: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _cumsum_lib()
    k, f, d = x.shape
    # the ticket counter, then one status word per (row, chunk); zeroed by
    # the C entry on the launch's stream
    scratch = torch.empty((k * f * math.ceil(d / lib.cumsum_frames_chunk()) + 1,),
                          dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cumsum_frames(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), k * f, d,
                                stream)
    if err != 0:
        raise RuntimeError(f"cumsum_frames kernel launch failed: cudaError_t {err}")
    cumsum_frames_launches += 1
    return y


def _cumsum_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("cumsum_frames")
    fn = lib.cumsum_frames
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.cumsum_frames_chunk.argtypes = []
    lib.cumsum_frames_chunk.restype = ctypes.c_int
    return lib


def _frame_firsts(fb: FrameBins, device) -> torch.Tensor:
    """(F,) int64 first duplicate of each frame in the concatenation."""
    counts = torch.tensor(fb.frame_dups, dtype=torch.int64, device=device)
    return torch.cumsum(counts, 0) - counts


def dups_to_depth_order(d_feat: torch.Tensor, fb: FrameBins) -> torch.Tensor:
    """(9, D) tile-sorted duplicate gradients -> (9, F, Dmax) in each
    frame's depth order, Dmax the group's largest kept count, each frame's
    tail zero.  The move is a permutation, so the store is exact."""
    f, dmax = len(fb.frame_dups), max(fb.frame_dups, default=0)
    dev = d_feat.device
    out = torch.zeros((F_ROWS, f * dmax), dtype=torch.float32, device=dev)
    counts = torch.tensor(fb.frame_dups, dtype=torch.int64, device=dev)
    frame_of = torch.repeat_interleave(torch.arange(f, device=dev), counts,
                                       output_size=d_feat.shape[1])
    col = fb.presort_pos - _frame_firsts(fb, dev)[frame_of] + frame_of * dmax
    out[:, col] = d_feat
    return out.view(F_ROWS, f, dmax)


def segment_sums(cs: torch.Tensor, fb: FrameBins, columns: int) -> torch.Tensor:
    """(9, F, Dmax) per-frame inclusive scans -> (9, F*N) per depth slot:
    the sum over the slot's duplicates [a, b) of its frame is cs[b - 1] -
    cs[a - 1], with 0 for a prefix that starts at the frame's own first
    duplicate (told from the slot's frame, not from a modulo).  A frame's
    last slot ends at its kept count, where its scan holds the frame total;
    an empty segment gives exactly 0."""
    f, dmax = cs.shape[1], cs.shape[2]
    dev = cs.device
    if columns % max(f, 1):
        raise ValueError(f"{columns} columns are not {f} frames of N")
    out = torch.zeros((F_ROWS, columns), dtype=torch.float32, device=dev)
    if dmax == 0:
        return out
    slot_frame = torch.arange(columns, device=dev) // (columns // f)
    first = _frame_firsts(fb, dev)[slot_frame]
    base = slot_frame * dmax - 1
    flat = cs.reshape(F_ROWS, f * dmax)

    def prefix(ends):  # the scan just before local position ``ends``
        local = ends - first
        return torch.where(local > 0, flat[:, (base + local).clamp(min=0)], out)

    return prefix(fb.seg_end) - prefix(fb.seg_start)


def rows_from_depth(seg: torch.Tensor, fb: FrameBins) -> torch.Tensor:
    """(9, F*N) per depth slot -> per row column: a permutation store."""
    out = torch.empty_like(seg)
    out[:, fb.depth_order] = seg
    return out


def dup_grads_to_rows_cumsum(d_feat: torch.Tensor, fb: FrameBins, columns: int) -> torch.Tensor:
    """The cumsum route of dup_grads_to_rows, with its output (9, F*N): the
    counterpart of the JAX package's _dup_grads_to_rows.  Depth order
    (dups_to_depth_order), a per-frame scan (cumsum_frames: kernel K4 on
    the card), segment differences (segment_sums), back to row order
    (rows_from_depth).  Every sum is in a fixed order: bit-equal from call
    to call on the card."""
    cs = cumsum_frames(dups_to_depth_order(d_feat, fb))
    return rows_from_depth(segment_sums(cs, fb, columns), fb)


def reduce_dup_grads(d_feat: torch.Tensor, fb: FrameBins, columns: int,
                     reduction: str = "index_add") -> torch.Tensor:
    """(9, D) duplicate gradients -> (9, F*N) by the route ``reduction``."""
    if reduction == "index_add":
        return dup_grads_to_rows(d_feat, fb, columns)
    if reduction == "cumsum":
        return dup_grads_to_rows_cumsum(d_feat, fb, columns)
    raise ValueError(f"reduction {reduction!r} is not one of {REDUCTIONS}")


def train_launch_inputs(rows9, comps: SplatComponents, width: int, height: int, truth_tiles,
                        backgrounds, tile: int, max_dup: int):
    """Bin F frames (``comps``: every field (F, N)) whose rows (9, F*N) are
    given, in one pass, and gather their duplicates.  Returns (the
    FrameBins, the arguments of one composite_train launch over all F x T
    (frame, tile) blocks)."""
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not supported (one of {TILE_SIZES})")
    f = comps.mx.shape[0]
    tx_tiles = -(-width // tile)
    num_tiles = tx_tiles * -(-height // tile)
    dev = rows9.device
    truth = torch.as_tensor(truth_tiles, dtype=torch.float32, device=dev)
    if tuple(truth.shape) != (f, num_tiles, tile * tile, 3):
        raise ValueError(f"truth_tiles must be ({f}, {num_tiles}, {tile * tile}, 3), "
                         f"got {tuple(truth.shape)}")
    bg = torch.as_tensor(backgrounds, dtype=torch.float32, device=dev).reshape(f, 3)
    fb = bin_splats_batch(comps, width, height, tile, max_dup)
    return fb, (gather_rows(rows9, fb), fb.tile_start, fb.tile_end,
                truth.reshape(f * num_tiles, tile * tile, 3).contiguous(), bg.contiguous(),
                tile, tx_tiles, num_tiles)


def _train_core(rows9, comps, width, height, truth_tiles, backgrounds,
                tile: int, max_dup: int, reduction: str = "index_add"):
    """Bin, gather, composite and reduce (by the route ``reduction``) F
    frames (``comps``: every field (F, N)) whose rows (9, F*N) are given.
    Returns (loss_sum, d_rows9 (9, F*N), res (F, T, P, 4), num_dup)."""
    fb, args = train_launch_inputs(rows9, comps, width, height, truth_tiles,
                                   backgrounds, tile, max_dup)
    res, d_feat = composite_train(*args)
    d_rows9 = reduce_dup_grads(d_feat, fb, rows9.shape[1], reduction)
    res = res.reshape(comps.mx.shape[0], args[-1], tile * tile, 4)
    loss_sum = torch.square(res[..., 0:3]).mean(dim=(1, 2, 3)).sum()
    return loss_sum, d_rows9, res, fb.num_dup


def render_train_grads_rows(comps: SplatComponents, width: int, height: int,
                            truth_tiles, backgrounds, *, tile: int = 32,
                            max_dup: int = 2**18, reduction: str = "index_add"):
    """Fused training core from pre-projected splats: every field of
    ``comps`` is (F, M).  Returns (loss_sum, d_rows (F, 9, M), res
    (F, T, P, 4), num_dup, num_work): loss_sum is the sum over frames of the
    mean squared residual, d_rows the gradients of the rows [mx, my, ca,
    cb, cc, cr, cg, cb2, opacity], num_dup the most duplicates any frame
    generated (> max_dup: the deepest were dropped), and num_work -1 (there
    is no work list).  ``reduction`` picks the route of the duplicate
    gradients' reduction, "index_add" or "cumsum"."""
    f, m = comps.mx.shape
    comps = SplatComponents(*(x.detach() for x in comps))
    loss_sum, d_rows9, res, num_dup = _train_core(
        _rows(comps).reshape(F_ROWS, f * m), comps, width, height, truth_tiles, backgrounds,
        tile, max_dup, reduction)
    return loss_sum, d_rows9.reshape(F_ROWS, f, m).transpose(0, 1), res, num_dup, -1


def render_train_grads_batch(
    means, shs, scales, opacities, rotations, active,
    views, proj_views, cam_posns, tan_fovxs, tan_fovys,  # (F, ...) stacks
    width: int, height: int,
    truth_tiles,  # (F, T, P, 3) pixel-major truth tiles
    backgrounds,  # (F, 3)
    sh_degree: int,
    *, tile: int = 32, max_dup: int = 2**18, aa: bool = False,
    reduction: str = "index_add", band: Optional[tuple] = None,
    frame_loc_grads: bool = False,
):
    """Fused training core for F frames: one frame-batched projection
    (forward and backward), one binning pass with one host sync (the F
    duplicate counts), one compositor launch and one reduction.
    ``reduction`` picks the route of the duplicate gradients' reduction:
    "index_add" (one index_add_) or "cumsum" (the JAX package's per-frame
    scan route, deterministic on the card).

    ``band=(y_off_px, band_h)`` rasterizes only the horizontal band
    [y_off_px, y_off_px + band_h) of the image: the projection stays
    full-image, the centres are shifted by -y_off_px (in float32, in the
    binning's detached copy and in row 1 of the rows, so the gradient of
    ``my`` passes through unchanged), and binning and compositing run on
    the band's ``band_h``-tall tile grid.  ``band_h`` must be a multiple of
    the tile, and ``truth_tiles`` holds the band's tiles alone,
    (F, T_band, P, 3).  Band-parallel training (parallel/tp.py) builds on
    it.  ``frame_loc_grads=True`` returns the raw per-frame location
    gradients (F, N, 3) in place of ``var_loc``, for a caller that sums
    them over bands before the nonlinear norm.

    Returns (loss_sum, grads, var_loc, res, num_dup, num_work):
      loss_sum = sum over frames of the per-frame mean squared residual;
      grads    = (means, shs, scales, opacities, rotations) gradients,
                 summed over frames, J^T residual: the negative L2
                 gradient that the SGD step adds;
      var_loc  = (N,) sum over frames of the per-frame norms of the
                 location gradient, the densify signal;
      res      = (F, T, P, 4) residual rgb and T_final per pixel;
      num_dup  = the most duplicates any frame generated; num_work = -1."""
    f = len(views)
    bin_height = height
    if band is not None:
        y_off, bin_height = float(band[0]), int(band[1])
        if bin_height % tile:
            raise ValueError(f"band height {bin_height} is not a multiple of the tile {tile}")
    leaves = [means.detach().expand(f, -1, -1).clone()] + [
        x.detach() for x in (shs, scales, opacities, rotations)]
    for x in leaves:
        x.requires_grad_(True)
    with torch.enable_grad():
        comps, rows9 = project_frames(*leaves, active, views, proj_views, cam_posns,
                                      tan_fovxs, tan_fovys, width, height, sh_degree, aa)
        if band is not None:
            comps, rows9 = shift_to_band(comps, rows9, y_off)
    loss_sum, d_rows9, res, num_dup = _train_core(
        rows9.detach(), comps, width, bin_height, truth_tiles, backgrounds, tile, max_dup,
        reduction)
    d_means_b, *grads = torch.autograd.grad(rows9, leaves, d_rows9)
    var_loc = d_means_b if frame_loc_grads else loc_norm_sum(d_means_b)
    return loss_sum, (d_means_b.sum(0), *grads), var_loc, res, num_dup, -1


def shift_to_band(comps: SplatComponents, rows9: torch.Tensor, y_off: float):
    """Projected splats moved into the band that starts ``y_off`` pixels
    down: ``my`` less y_off in float32, in the detached components that
    binning reads and in row 1 of the rows (inside the autograd graph,
    where the gradient of ``my`` passes through unchanged)."""
    shift = torch.zeros((F_ROWS, 1), dtype=torch.float32, device=rows9.device)
    shift[F_MY] = y_off
    return comps._replace(my=comps.my - y_off), rows9 - shift


def loc_norm_sum(d_means_b: torch.Tensor) -> torch.Tensor:
    """(F, N, 3) per-frame location gradients -> (N,) the sum over frames
    of their norms: the densify signal."""
    return torch.sqrt(torch.sum(torch.square(d_means_b), dim=-1)).sum(0)


def render_train_grads(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, truth_tiles, background, sh_degree: int,
    *, tile: int = 32, max_dup: int = 2**18, aa: bool = False,
    reduction: str = "index_add",
):
    """Fused training core for one frame: (loss_mean, grads, res (T, P, 4)),
    truth_tiles (T, P, 3).  render_train_grads_batch with F = 1."""
    loss, grads, _var, res, _nd, _nw = render_train_grads_batch(
        means, shs, scales, opacities, rotations, active,
        *(torch.as_tensor(x, dtype=torch.float32)[None]
          for x in (view, proj_view, cam_pos, tan_fovx, tan_fovy)), width, height,
        torch.as_tensor(truth_tiles)[None], torch.as_tensor(background)[None], sh_degree,
        tile=tile, max_dup=max_dup, aa=aa, reduction=reduction,
    )
    return loss, grads, res[0]
