"""Per-splat rasterization math: SH color, covariance, EWA projection
(counterpart of gaussian_splatterer_tpu.ops.transforms).

Semantics follow the INRIA diff-gaussian-rasterization pipeline the
reference links (call sites src/Trainer.cu:334-412): EWA projection with a
0.3-pixel dilation, SH -> RGB with a +0.5 offset and a zero clamp, a near
cull at view-space depth 0.2.  The arithmetic is written in the same order
as the JAX package, operation for operation, so the two agree to float32
rounding.

Plain PyTorch on (N,) component vectors, or (F, N) for F cameras at once
(project_splat_components with a leading frame axis: the counterpart of
the JAX package's ``jax.vmap(project_splat_components)``); runs on any
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Real spherical-harmonics basis constants (bands 0-3).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

NEAR_CULL_Z = 0.2  # view-space near cull
DILATION = 0.3  # screen-space covariance dilation (anti-aliasing floor)
ALPHA_MIN = 1.0 / 255.0  # contribution threshold
ALPHA_MAX = 0.99  # per-splat alpha clamp
T_EPS = 1e-4  # transmittance early-termination threshold


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) scalar-first quaternion -> (..., 3, 3) rotation matrix.

    Quaternions are normalised here; the reference never renormalises
    after SGD (src/Trainer.cu:97-99) and relies on the rasterizer doing it."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor, scale_mod=1.0) -> torch.Tensor:
    """(N, 3) scales + (N, 4) quats -> (N, 3, 3) world covariance R S^2 R^T."""
    R = quat_to_rotmat(rotations)
    s2 = torch.square(scales * scale_mod)
    return torch.einsum("nij,nj,nkj->nik", R, s2, R)


class ProjectedSplats(NamedTuple):
    """Screen-space splats in (N, k) layout, padded to N with ``valid``."""

    mean2d: torch.Tensor  # (N, 2) pixel coordinates
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c): ax^2+2bxy+cy^2
    color: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,) view-space z (positive in front)
    radius: torch.Tensor  # (N,) 3-sigma pixel radius (0 when culled)
    rx: torch.Tensor  # (N,) opacity-aware per-axis half-extents
    ry: torch.Tensor
    valid: torch.Tensor  # (N,) bool


class SplatComponents(NamedTuple):
    """Screen-space splats as flat (N,) component vectors, or (F, N) for a
    frame-batched projection."""

    mx: torch.Tensor  # pixel x
    my: torch.Tensor  # pixel y
    ca: torch.Tensor  # conic a
    cb: torch.Tensor  # conic b
    cc: torch.Tensor  # conic c
    cr: torch.Tensor  # color r
    cg: torch.Tensor  # color g
    cb2: torch.Tensor  # color b
    opacity: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor  # 3-sigma_max circle (diagnostics); binning uses rx/ry
    rx: torch.Tensor
    ry: torch.Tensor
    valid: torch.Tensor  # bool


def _sh_to_rgb_channels(shs, dx, dy, dz, sh_degree: int):
    """Component-wise SH evaluation; shs (N, K, 3), unit view dirs as (N,)
    or (F, N) vectors (the (N,) coefficients broadcast over the frames).
    Returns (r, g, b), each of the directions' shape, clamped at zero
    after +0.5."""
    out = []
    for ch in range(3):
        c = SH_C0 * shs[:, 0, ch]
        if sh_degree >= 1:
            c = (
                c
                - SH_C1 * dy * shs[:, 1, ch]
                + SH_C1 * dz * shs[:, 2, ch]
                - SH_C1 * dx * shs[:, 3, ch]
            )
        if sh_degree >= 2:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            c = (
                c
                + SH_C2[0] * dx * dy * shs[:, 4, ch]
                + SH_C2[1] * dy * dz * shs[:, 5, ch]
                + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6, ch]
                + SH_C2[3] * dx * dz * shs[:, 7, ch]
                + SH_C2[4] * (xx - yy) * shs[:, 8, ch]
            )
        if sh_degree >= 3:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            c = (
                c
                + SH_C3[0] * dy * (3.0 * xx - yy) * shs[:, 9, ch]
                + SH_C3[1] * dx * dy * dz * shs[:, 10, ch]
                + SH_C3[2] * dy * (4.0 * zz - xx - yy) * shs[:, 11, ch]
                + SH_C3[3] * dz * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12, ch]
                + SH_C3[4] * dx * (4.0 * zz - xx - yy) * shs[:, 13, ch]
                + SH_C3[5] * dz * (xx - yy) * shs[:, 14, ch]
                + SH_C3[6] * dx * (xx - yy) * shs[:, 15, ch]
            )
        out.append(torch.clamp(c + 0.5, min=0.0))
    return tuple(out)


def sh_to_rgb(shs: torch.Tensor, dirs: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """SH colour, (N, K, 3) coefficients and (N, 3) unit view directions ->
    (N, 3): the band sum + 0.5, clamped at zero (INRIA's
    computeColorFromSH; the clamp stops the gradient, as under autograd)."""
    return torch.clamp(sh_eval_linear(shs, dirs, sh_degree) + 0.5, min=0.0)


def sh_eval_linear(shs, dirs, sh_degree: int):
    """Raw SH band sum, (N, K, 3) coefficients and (N, 3) unit view
    directions -> (N, 3): no +0.5 offset and no clamp.  The linear part
    that partial evaluations use (the HTML viewer bakes bands >= 2 at a
    nominal direction).  Works on numpy arrays and on tensors."""
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    c = SH_C0 * shs[:, 0]
    if sh_degree >= 1:
        c = c - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] - SH_C1 * x * shs[:, 3]
    if sh_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c = (
            c
            + SH_C2[0] * xy * shs[:, 4]
            + SH_C2[1] * yz * shs[:, 5]
            + SH_C2[2] * (2.0 * zz - xx - yy) * shs[:, 6]
            + SH_C2[3] * xz * shs[:, 7]
            + SH_C2[4] * (xx - yy) * shs[:, 8]
        )
    if sh_degree >= 3:
        c = (
            c
            + SH_C3[0] * y * (3.0 * xx - yy) * shs[:, 9]
            + SH_C3[1] * xy * z * shs[:, 10]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[:, 11]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[:, 12]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[:, 13]
            + SH_C3[5] * z * (xx - yy) * shs[:, 14]
            + SH_C3[6] * x * (xx - yy) * shs[:, 15]
        )
    return c


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x >= 0 whose gradient at x = 0 is 0, not inf: the
    clamp after it zeroes the cotangent there, and inf * 0 would put NaN
    into autograd (a zero quaternion, a splat at the camera centre)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def project_splat_components(
    means: torch.Tensor,
    shs: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    rotations: torch.Tensor,
    active: torch.Tensor,
    view,
    proj_view,
    cam_pos,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    sh_degree: int,
    scale_mod=1.0,
    aa: bool = False,
) -> SplatComponents:
    """The per-splat 'preprocess' stage: 3D gaussians -> 2D screen splats.

    One camera: ``view``, ``proj_view`` (4, 4) and ``cam_pos`` (3,), numpy
    arrays or tensors, moved to the splats' device, and scalar tangents;
    every field is (N,).  F cameras (the frame-batched form): ``view`` and
    ``proj_view`` (F, 4, 4), ``cam_pos`` (F, 3), ``tan_fovx`` and
    ``tan_fovy`` (F,); ``means`` is (N, 3) or (F, N, 3) (one copy a frame,
    for per-frame location gradients), the other splat arrays stay (N, ...)
    and broadcast; every field is (F, N).  ``aa=True`` scales opacity by
    sqrt(det(cov2d) / det(cov2d + dilation)) (mip-splatting), so sub-pixel
    splats fade instead of aliasing."""
    dev = means.device
    f32 = torch.float32
    x = means[..., 0].to(f32)
    y = means[..., 1].to(f32)
    z = means[..., 2].to(f32)
    v = _as_f32(view, dev)
    pvm = _as_f32(proj_view, dev)
    cam = _as_f32(cam_pos, dev)
    if v.dim() == 3:
        # F cameras: every matrix entry v[..., i, j] and camera coordinate
        # becomes an (F, 1) column that broadcasts against the (N,) or
        # (F, N) splat vectors.  The tangents become (F, 1) float32
        # tensors, so the focal lengths and the clamp limits below are
        # float32 products, as in JAX's vmapped call, where they are traced
        # float32 values.  (One camera keeps its scalar tangents: a Python
        # float is multiplied in double and rounded once, as JAX does with
        # a Python float.)
        v, pvm, cam = v[:, None], pvm[:, None], cam[:, None]
        tan_fovx = _as_f32(tan_fovx, dev).reshape(-1, 1)
        tan_fovy = _as_f32(tan_fovy, dev).reshape(-1, 1)

    # view transform (rows of the 4x4 applied to [x, y, z, 1])
    pv_x = v[..., 0, 0] * x + v[..., 0, 1] * y + v[..., 0, 2] * z + v[..., 0, 3]
    pv_y = v[..., 1, 0] * x + v[..., 1, 1] * y + v[..., 1, 2] * z + v[..., 1, 3]
    depth = v[..., 2, 0] * x + v[..., 2, 1] * y + v[..., 2, 2] * z + v[..., 2, 3]
    in_front = depth > NEAR_CULL_Z

    ph_x = pvm[..., 0, 0] * x + pvm[..., 0, 1] * y + pvm[..., 0, 2] * z + pvm[..., 0, 3]
    ph_y = pvm[..., 1, 0] * x + pvm[..., 1, 1] * y + pvm[..., 1, 2] * z + pvm[..., 1, 3]
    ph_w = pvm[..., 3, 0] * x + pvm[..., 3, 1] * y + pvm[..., 3, 2] * z + pvm[..., 3, 3]
    p_w = 1.0 / (ph_w + 1e-7)

    # quaternion -> rotation matrix components (normalised, see quat_to_rotmat)
    q = rotations.to(f32)
    qn = _safe_sqrt(q[:, 0] ** 2 + q[:, 1] ** 2 + q[:, 2] ** 2 + q[:, 3] ** 2)
    qi = 1.0 / torch.clamp(qn, min=1e-12)
    qr, qx, qy, qz = q[:, 0] * qi, q[:, 1] * qi, q[:, 2] * qi, q[:, 3] * qi
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qr * qz)
    r02 = 2 * (qx * qz + qr * qy)
    r10 = 2 * (qx * qy + qr * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qr * qx)
    r20 = 2 * (qx * qz - qr * qy)
    r21 = 2 * (qy * qz + qr * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    s2x = torch.square(scales[:, 0].to(f32) * scale_mod)
    s2y = torch.square(scales[:, 1].to(f32) * scale_mod)
    s2z = torch.square(scales[:, 2].to(f32) * scale_mod)

    # Sigma = R S^2 R^T (6 unique entries)
    c00 = r00 * r00 * s2x + r01 * r01 * s2y + r02 * r02 * s2z
    c01 = r00 * r10 * s2x + r01 * r11 * s2y + r02 * r12 * s2z
    c02 = r00 * r20 * s2x + r01 * r21 * s2y + r02 * r22 * s2z
    c11 = r10 * r10 * s2x + r11 * r11 * s2y + r12 * r12 * s2z
    c12 = r10 * r20 * s2x + r11 * r21 * s2y + r12 * r22 * s2z
    c22 = r20 * r20 * s2x + r21 * r21 * s2y + r22 * r22 * s2z

    # EWA Jacobian (rows [fx/tz, 0, -fx tx/tz^2], [0, fy/tz, -fy ty/tz^2])
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tzs = torch.where(torch.abs(depth) < 1e-12, torch.full_like(depth, 1e-12), depth)
    tx = torch.clamp(pv_x / tzs, -lim_x, lim_x) * depth
    ty = torch.clamp(pv_y / tzs, -lim_y, lim_y) * depth
    j00 = focal_x / tzs
    j02 = -focal_x * tx / (tzs * tzs)
    j11 = focal_y / tzs
    j12 = -focal_y * ty / (tzs * tzs)

    # A = J @ W with W = view[:3, :3] (the -lookAt sign squares away)
    a00 = j00 * v[..., 0, 0] + j02 * v[..., 2, 0]
    a01 = j00 * v[..., 0, 1] + j02 * v[..., 2, 1]
    a02 = j00 * v[..., 0, 2] + j02 * v[..., 2, 2]
    a10 = j11 * v[..., 1, 0] + j12 * v[..., 2, 0]
    a11 = j11 * v[..., 1, 1] + j12 * v[..., 2, 1]
    a12 = j11 * v[..., 1, 2] + j12 * v[..., 2, 2]

    # cov2d = A Sigma A^T
    t0 = c00 * a00 + c01 * a01 + c02 * a02
    t1 = c01 * a00 + c11 * a01 + c12 * a02
    t2 = c02 * a00 + c12 * a01 + c22 * a02
    u0 = c00 * a10 + c01 * a11 + c02 * a12
    u1 = c01 * a10 + c11 * a11 + c12 * a12
    u2 = c02 * a10 + c12 * a11 + c22 * a12
    cxx = a00 * t0 + a01 * t1 + a02 * t2 + DILATION
    cxy = a10 * t0 + a11 * t1 + a12 * t2
    cyy = a10 * u0 + a11 * u1 + a12 * u2 + DILATION

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    ca = cyy / det_safe
    cb = -cxy / det_safe
    cc = cxx / det_safe

    opacities = opacities.to(f32)
    if aa:
        # mip-splat compensation: raw over dilated 2D covariance determinant;
        # a fully collapsed splat fades out (the double where keeps sqrt's
        # infinite slope at 0 out of any gradient)
        det_raw = (cxx - DILATION) * (cyy - DILATION) - cxy * cxy
        ratio = torch.clamp(det_raw / det_safe, 0.0, 1.0)
        nondegen = ratio > 1e-12
        opacities = opacities * torch.where(
            nondegen, torch.sqrt(torch.where(nondegen, ratio, torch.ones_like(ratio))),
            torch.zeros_like(ratio),
        )

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(mid + disc, min=1e-12)))

    # Tight per-axis, opacity-aware extents: a pixel with
    # alpha = op * exp(power) < 1/255 is skipped, so the visible support is
    # the ellipse q <= k^2 with k^2 = 2 ln(op * 255), capped at the 3-sigma
    # truncation (k <= 3); its axis-aligned box is k*sigma_x by k*sigma_y.
    k2 = torch.clamp(2.0 * torch.log(torch.clamp(opacities, min=1e-12) * 255.0), 0.0, 9.0)
    k = torch.sqrt(k2)
    rx = torch.ceil(k * torch.sqrt(torch.clamp(cxx, min=1e-12)))
    ry = torch.ceil(k * torch.sqrt(torch.clamp(cyy, min=1e-12)))

    # NDC -> pixel centers: ((v + 1) * S - 1) / 2
    px = ((ph_x * p_w + 1.0) * width - 1.0) * 0.5
    py = ((ph_y * p_w + 1.0) * height - 1.0) * 0.5

    on_screen = (px + rx >= 0) & (px - rx < width) & (py + ry >= 0) & (py - ry < height)
    valid = active.to(dev) & in_front & det_ok & on_screen & (rx > 0) & (ry > 0)

    dx = x - cam[..., 0]
    dy = y - cam[..., 1]
    dz = z - cam[..., 2]
    dn = 1.0 / torch.clamp(_safe_sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
    cr, cg, cb2 = _sh_to_rgb_channels(shs.to(f32), dx * dn, dy * dn, dz * dn, sh_degree)

    zero = torch.zeros_like(radius)
    # colours at SH degree 0 and opacities without aa are (N,): broadcast
    # them to the frames' (F, N)
    cr, cg, cb2, opacities = (c.expand_as(depth) for c in (cr, cg, cb2, opacities))
    return SplatComponents(
        mx=px, my=py, ca=ca, cb=cb, cc=cc, cr=cr, cg=cg, cb2=cb2,
        opacity=opacities, depth=depth,
        radius=torch.where(valid, radius, zero),
        rx=torch.where(valid, rx, zero),
        ry=torch.where(valid, ry, zero),
        valid=valid,
    )


def project_splats(*args, **kwargs) -> ProjectedSplats:
    """(N, k)-layout projection over project_splat_components (same
    arguments); the oracle consumes this form."""
    c = project_splat_components(*args, **kwargs)
    return ProjectedSplats(
        mean2d=torch.stack([c.mx, c.my], -1),
        conic=torch.stack([c.ca, c.cb, c.cc], -1),
        color=torch.stack([c.cr, c.cg, c.cb2], -1),
        opacity=c.opacity,
        depth=c.depth,
        radius=c.radius,
        rx=c.rx,
        ry=c.ry,
        valid=c.valid,
    )
