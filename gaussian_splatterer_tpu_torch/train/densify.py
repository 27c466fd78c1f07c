"""Densification: split / clone / cull (counterpart of
gaussian_splatterer_tpu.train.densify).

The reference does this on the CPU with dynamic arrays and per-insert
capacity checks (src/Trainer.cu:437-542).  Here it works on the
fixed-capacity padded model with boolean masks: appends go to the slots
past ``count`` and culling is a stable compaction.

Semantics, as in the JAX package:
  * classification on the *pre-split* model (src/Trainer.cu:448-456):
      - cull when opacity <= paramCullOpacity or |scale| < paramCullSize
      - else volatile when var(|grad_loc|) - |mean grad_loc| > paramDensifyVariance
        -> split when |scale| > paramSplitSize else clone
  * split (src/Trainer.cu:459-496): offset along the splat's largest scale
    axis rotated by its quaternion; both halves scaled by paramSplitScale;
    original moved +offset/2, the appended copy -offset/2
  * clone (src/Trainer.cu:499-521): appended copy offset by
    (R(q) @ scale) * normalize(grad_loc) * paramCloneDistance (componentwise)
  * splits append before clones, each in index order; appends stop at
    capacity (src/Trainer.cu:460,500)
  * cull is a stable compaction (src/Trainer.cu:524-534); the freed tail
    slots are zeroed with identity rotations.

The masks read the live count, so densify syncs the host once; it runs
every ``intervalDensify`` steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splatterer_tpu_torch.models.splats import SplatModel
from gaussian_splatterer_tpu_torch.ops.transforms import quat_to_rotmat


class DensifyParams(NamedTuple):
    cull_opacity: float
    cull_size: float
    densify_variance: float
    split_size: float
    split_distance: float
    split_scale: float
    clone_distance: float

    @classmethod
    def from_project(cls, project) -> "DensifyParams":
        return cls(
            cull_opacity=project.paramCullOpacity,
            cull_size=project.paramCullSize,
            densify_variance=project.paramDensifyVariance,
            split_size=project.paramSplitSize,
            split_distance=project.paramSplitDistance,
            split_scale=project.paramSplitScale,
            clone_distance=project.paramCloneDistance,
        )


@torch.no_grad()
def densify(model: SplatModel, var_loc: torch.Tensor, avg_grad_loc: torch.Tensor,
            params: DensifyParams) -> SplatModel:
    """A new model: ``var_loc`` (C,) is the mean per-frame |location grad|,
    ``avg_grad_loc`` (C, 3) the mean location gradient of the last step."""
    cap, count = model.capacity, model.count
    means, shs, scales = model.means, model.shs, model.scales
    opac, rots = model.opacities, model.rotations
    active = torch.arange(cap, device=model.device) < count

    size_mag = torch.linalg.vector_norm(scales, dim=-1)
    grad_mag = torch.linalg.vector_norm(avg_grad_loc, dim=-1)
    remove = active & ((opac <= params.cull_opacity) | (size_mag < params.cull_size))
    volatile = active & ~remove & ((var_loc - grad_mag) > params.densify_variance)
    split = volatile & (size_mag > params.split_size)
    clone = volatile & ~split

    free = cap - count
    split_src = torch.nonzero(split).squeeze(1)[:free]
    clone_src = torch.nonzero(clone).squeeze(1)[:free - split_src.shape[0]]

    rot = quat_to_rotmat(rots)
    # split offset: largest scale axis, rotated (src/Trainer.cu:466-479)
    sx, sy, sz = scales[:, 0], scales[:, 1], scales[:, 2]
    is_x = (sx > sy) & (sx > sz)
    is_y = ~is_x & (sy > sz)
    zero = torch.zeros_like(sx)
    axis_scale = torch.stack([torch.where(is_x, sx, zero), torch.where(is_y, sy, zero),
                              torch.where(~(is_x | is_y), sz, zero)], -1)
    split_offset = torch.einsum("nij,nj->ni", rot, axis_scale) * (params.split_distance * 0.5)
    split_scales = scales * params.split_scale
    # clone offset: (R @ scale) * dir(grad) * cloneDistance, componentwise
    dir_grad = avg_grad_loc / torch.clamp(grad_mag, min=1e-12)[:, None]
    clone_offset = torch.einsum("nij,nj->ni", rot, scales) * dir_grad * params.clone_distance

    split_ok = torch.zeros_like(split)
    split_ok[split_src] = True
    new_means = torch.where(split_ok[:, None], means + split_offset, means)
    new_scales = torch.where(split_ok[:, None], split_scales, scales)
    src = torch.cat([split_src, clone_src])
    app_means = torch.cat([means[split_src] - split_offset[split_src],
                           means[clone_src] + clone_offset[clone_src]])
    app_scales = torch.cat([split_scales[split_src], scales[clone_src]])

    # originals that survive the cull, in order, then every append
    keep = active & ~remove
    fields = (
        torch.cat([new_means[keep], app_means]),
        torch.cat([shs[keep], shs[src]]),
        torch.cat([new_scales[keep], app_scales]),
        torch.cat([opac[keep], opac[src]]),
        torch.cat([rots[keep], rots[src]]),
    )
    new_count = fields[0].shape[0]
    out = SplatModel.empty(cap, model.sh_degree, model.sh_coeffs, device=model.device)
    for name, value in zip(("means", "shs", "scales", "opacities", "rotations"), fields):
        getattr(out, name)[:new_count] = value
    out.count = new_count
    return out
