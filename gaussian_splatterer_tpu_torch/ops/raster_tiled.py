"""Tiled rasterizer, serving half (counterpart of the forward path of
gaussian_splatterer_tpu.ops.raster_tiled).

Pipeline:

  project_splat_components (transforms.py)
    -> bin_splats (depth sort + stable tile sort + per-tile ranges, binning.py)
    -> gather of the nine feature rows per duplicate into a (9, D) array
    -> composite_fwd: front-to-back compositing of each tile's duplicates,
       the CUDA kernel csrc/composite_fwd.cu on a CUDA tensor and its plain
       PyTorch version composite_fwd_reference on a CPU tensor
    -> C + T_final * background.

Compositing rules (identical to the oracle, raster_reference.py): skip a
duplicate where power > 0 or alpha < 1/255, clamp alpha at 0.99, and stop a
pixel, without that duplicate, once T would fall below 1e-4.  The training
half (fused forward + backward kernels) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatterer_tpu_torch.ops import cuda_build
from gaussian_splatterer_tpu_torch.ops.binning import bin_splats
from gaussian_splatterer_tpu_torch.ops.transforms import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    project_splat_components,
)

# feature row layout of the (9, D) duplicate array
F_MX, F_MY, F_CA, F_CB, F_CC, F_CR, F_CG, F_CB2, F_OP = range(9)
F_ROWS = 9
TILE_SIZES = (8, 16, 32)  # one CUDA thread per pixel: 64, 256, 1024 threads

# Launches of the CUDA compositor in this process.  Only the CUDA branch of
# composite_fwd adds to it; a run can read it to show that its path went
# through the kernel.
composite_fwd_launches = 0


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


def composite_fwd_reference(feat: torch.Tensor, tile_start: torch.Tensor,
                            tile_end: torch.Tensor, tile: int, tx_tiles: int) -> torch.Tensor:
    """Plain PyTorch compositor with composite_fwd's contract.

    feat (9, D) float32 rows [mx, my, conic a, b, c, r, g, b, opacity] of the
    tile-sorted duplicates; tile t composites feat[:, tile_start[t]:
    tile_end[t]] front to back.  Returns (T, tile*tile, 4) float32
    (r, g, b, T_final), pixels row-major within the tile.

    It steps through duplicate position k of all tiles at once, in the
    kernel's order of operations, one rounding per operation; tiles are
    ordered by duplicate count so that the tiles still running at step k
    are a prefix."""
    _check_composite_args(feat, tile_start, tile_end, tile)
    dev = feat.device
    num_tiles, p_count = tile_start.shape[0], tile * tile
    count = (tile_end.to(torch.int64) - tile_start.to(torch.int64)).clamp(min=0)
    count_sorted, order = torch.sort(count, descending=True, stable=True)
    steps = int(count_sorted[0]) if num_tiles else 0
    # running[k] = number of tiles with more than k duplicates
    running = (num_tiles - torch.searchsorted(
        count_sorted.flip(0), torch.arange(steps, device=dev), side="right"
    )).tolist()

    pix = torch.arange(p_count, device=dev)
    px = ((order % tx_tiles) * tile)[:, None].to(torch.float32) + (pix % tile).to(torch.float32)
    py = ((order // tx_tiles) * tile)[:, None].to(torch.float32) + (pix // tile).to(torch.float32)
    start = tile_start.to(torch.int64)[order]
    trans = torch.ones((num_tiles, p_count), dtype=torch.float32, device=dev)
    rgb = torch.zeros((num_tiles, p_count, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((num_tiles, p_count), dtype=torch.bool, device=dev)
    for k in range(steps):
        m = running[k]
        f = feat[:, start[:m] + k][:, :, None]  # (9, m, 1)
        dx = px[:m] - f[F_MX]
        dy = py[:m] - f[F_MY]
        power = -0.5 * (f[F_CA] * dx * dx + f[F_CC] * dy * dy) - f[F_CB] * dx * dy
        alpha = torch.clamp(f[F_OP] * torch.exp(power), max=ALPHA_MAX)
        t_m = trans[:m]
        contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & alive[:m]
        test_t = t_m * (1.0 - alpha)
        stop = contrib & (test_t < T_EPS)
        use = contrib & ~stop
        w = torch.where(use, alpha * t_m, torch.zeros_like(alpha))
        rgb[:m] += w[..., None] * f[F_CR : F_CB2 + 1].permute(1, 2, 0)
        trans[:m] = torch.where(use, test_t, t_m)
        alive[:m] &= ~stop

    out = torch.empty((num_tiles, p_count, 4), dtype=torch.float32, device=dev)
    out[order, :, 0:3] = rgb
    out[order, :, 3] = trans
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


def image_to_tiles(img: torch.Tensor, tile: int) -> torch.Tensor:
    """(H, W, C) -> (T, tile*tile, C) in the compositor's tile-major pixel
    order.  Requires tile | H and tile | W."""
    h, w, c = img.shape
    ty, txx = h // tile, w // tile
    return img.reshape(ty, tile, txx, tile, c).permute(0, 2, 1, 3, 4).reshape(
        ty * txx, tile * tile, c)


def tiles_to_image(img_tiles: torch.Tensor, width: int, height: int, tile: int) -> torch.Tensor:
    """(T, tile*tile, C) -> (H, W, C), cropping the padding tiles past W, H."""
    tx_tiles = -(-width // tile)
    ty_tiles = -(-height // tile)
    c = img_tiles.shape[-1]
    img = img_tiles.reshape(ty_tiles, tx_tiles, tile, tile, c).permute(0, 2, 1, 3, 4).reshape(
        ty_tiles * tile, tx_tiles * tile, c)
    return img[:height, :width, :]


def gather_features(comps, bins) -> torch.Tensor:
    """(9, D) feature rows of the tile-sorted duplicates."""
    rows = torch.stack([comps.mx, comps.my, comps.ca, comps.cb, comps.cc,
                        comps.cr, comps.cg, comps.cb2, comps.opacity])  # (9, N)
    return rows[:, bins.gather_idx].contiguous()


def render_tiled_tiles(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, background, sh_degree: int, scale_mod=1.0,
    *, tile: int = 16, max_dup: int = 2**19, aa: bool = False,
) -> torch.Tensor:
    """Tile-space render: (T, tile*tile, 3) image tiles, background applied."""
    if tile not in TILE_SIZES:
        raise ValueError(f"tile {tile} not supported (one of {TILE_SIZES})")
    tx_tiles = -(-width // tile)
    comps = project_splat_components(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    )
    bins = bin_splats(comps, width, height, tile, max_dup)
    out = composite_fwd(gather_features(comps, bins), bins.tile_start, bins.tile_end,
                        tile, tx_tiles)
    bg = torch.as_tensor(background, dtype=torch.float32, device=out.device)
    return out[..., 0:3] + out[..., 3:4] * bg


def render_tiled(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, background, sh_degree: int, scale_mod=1.0,
    *, tile: int = 16, max_dup: int = 2**19, aa: bool = False,
) -> torch.Tensor:
    """Render (H, W, 3) float32 with the tiled path; matches
    render_oracle(tile_cull=tile)."""
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
