"""Oracle rasterizer: slow, exact, per-pixel (counterpart of
gaussian_splatterer_tpu.ops.raster_reference).

Every pixel evaluates every splat in depth order; it is the ground truth
the tiled path is held against (the forward gate).  Compositing is the
scan-free form of the JAX oracle:

    T_k = prod_{j<k} (1 - a_j) == exp(cumsum(log1p(-a)))
    out = sum_k c_k a_k T_k + bg * T_final

with the INRIA masking rules (skip when power > 0 or alpha < 1/255, clamp
alpha at 0.99, and stop a pixel, without that splat, once T would fall
below 1e-4).  Plain PyTorch; runs on any device.
"""

from __future__ import annotations

import torch

from gaussian_splatterer_tpu_torch.ops.binning import tile_aabb
from gaussian_splatterer_tpu_torch.ops.transforms import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    ProjectedSplats,
    project_splats,
)


def composite_pixels(pix_xy: torch.Tensor, splats: ProjectedSplats,
                     background: torch.Tensor, tile_cull: int = 0) -> torch.Tensor:
    """Alpha-composite all splats into P pixels.  Splats MUST be sorted
    front to back with invalid entries last.

    ``tile_cull > 0`` applies the binned path's tile-granular cutoff: a
    splat only touches pixels whose tile lies in its tile AABB."""
    d = pix_xy[:, None, :] - splats.mean2d[None, :, :]  # (P, N, 2)
    dx, dy = d[..., 0], d[..., 1]
    conic = splats.conic
    power = (
        -0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
        - conic[None, :, 1] * dx * dy
    )
    alpha = torch.clamp(splats.opacity[None, :] * torch.exp(power), max=ALPHA_MAX)
    contrib = (power <= 0.0) & (alpha >= ALPHA_MIN) & splats.valid[None, :]
    if tile_cull:
        big = 1 << 20  # unclipped tile grid; clipping happens via pixel coords
        x0, y0, x1, y1 = tile_aabb(
            splats.mean2d[:, 0], splats.mean2d[:, 1], splats.rx, splats.ry,
            tile_cull, big, big,
        )
        ptx = torch.floor(pix_xy[:, 0:1] / tile_cull).to(torch.int64)  # (P, 1)
        pty = torch.floor(pix_xy[:, 1:2] / tile_cull).to(torch.int64)
        contrib = contrib & (
            (ptx >= x0[None, :]) & (ptx < x1[None, :])
            & (pty >= y0[None, :]) & (pty < y1[None, :])
        )
    a = torch.where(contrib, alpha, torch.zeros_like(alpha))

    logs = torch.log1p(-a)
    t_excl = torch.exp(torch.cumsum(logs, dim=1) - logs)  # exclusive cumprod
    trigger = t_excl * (1.0 - a) < T_EPS
    keep = torch.cummax(trigger.to(torch.int32), dim=1).values == 0
    a_eff = a * keep

    logs_eff = torch.log1p(-a_eff)
    cum = torch.cumsum(logs_eff, dim=1)
    w = a_eff * torch.exp(cum - logs_eff)  # (P, N)
    color = w @ splats.color  # (P, 3)
    t_final = torch.exp(cum[:, -1])
    return color + t_final[:, None] * background[None, :]


def sort_splats_front_to_back(splats: ProjectedSplats) -> ProjectedSplats:
    key = torch.where(splats.valid, splats.depth, torch.full_like(splats.depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    return ProjectedSplats(*(x[order] for x in splats))


def render_oracle(
    means, shs, scales, opacities, rotations, active,
    view, proj_view, cam_pos, tan_fovx, tan_fovy,
    width: int, height: int, background, sh_degree: int, scale_mod=1.0,
    row_chunk: int = 32, tile_cull: int = 0, aa: bool = False,
) -> torch.Tensor:
    """Render (H, W, 3) float32.  ``row_chunk`` rows of pixels are composited
    at a time, which bounds the (P, N) intermediates to row_chunk*W*N
    floats; it must divide the height."""
    if height % row_chunk:
        raise ValueError(f"row_chunk {row_chunk} must divide the image height {height}")
    dev = means.device
    splats = sort_splats_front_to_back(project_splats(
        means, shs, scales, opacities, rotations, active,
        view, proj_view, cam_pos, tan_fovx, tan_fovy,
        width, height, sh_degree, scale_mod, aa=aa,
    ))
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    rows = []
    for y0 in range(0, height, row_chunk):
        ys = torch.arange(y0, y0 + row_chunk, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        rows.append(composite_pixels(pix, splats, background, tile_cull).reshape(
            row_chunk, width, 3))
    return torch.cat(rows, 0)


def render_oracle_model(model, camera, width: int, height: int, background,
                        scale_mod=1.0, train_fov: bool = True,
                        row_chunk: int = 32) -> torch.Tensor:
    """render_oracle of a SplatModel from a Camera (host-side matrices), on
    the model's device."""
    tan_fovx, tan_fovy = camera.tan_fov(width, height, train=train_fov)
    return render_oracle(
        model.means, model.shs, model.scales, model.opacities, model.rotations,
        model.active_mask(), camera.get_view(), camera.get_proj_view(width / height),
        camera.location, tan_fovx, tan_fovy, width, height, background, model.sh_degree,
        scale_mod, row_chunk=row_chunk,
    )
