"""Binary checkpoints (counterpart of the npz half of
gaussian_splatterer_tpu.io.checkpoint).

One ``.npz`` holds the exact float32 arrays of the capacity-padded model
plus the Project settings, for a bit-exact resume.  The layout is the JAX
package's, key for key, dtype for dtype and shape for shape, so either
package resumes the other's run: ``format_version`` (int32), ``means``,
``shs``, ``scales``, ``opacities``, ``rotations``, ``count`` (0-d int32),
``sh_degree`` (int32) and, with a project, ``project_json`` (its JSON as
uint8 bytes).  The file is written beside its path and moved over it, so a
crash mid-write leaves the previous checkpoint whole.  The JAX package's
sharded (orbax) checkpoints are not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from gaussian_splatterer_tpu_torch.config import Project
from gaussian_splatterer_tpu_torch.models.splats import SplatModel

FORMAT_VERSION = 1


_ARRAYS = ("means", "shs", "scales", "opacities", "rotations", "count", "sh_degree")


def _model_arrays(model: SplatModel) -> dict:
    arrays = {name: getattr(model, name).detach().cpu().numpy() for name in _ARRAYS[:5]}
    arrays["count"] = np.asarray(model.count, np.int32)
    arrays["sh_degree"] = np.int32(model.sh_degree)
    return arrays


def digest(source) -> str:
    """SHA-256 of a model's checkpoint arrays (``source``: a SplatModel or
    a checkpoint's path), so that a model can be shown bit-equal to a
    file."""
    if isinstance(source, SplatModel):
        arrays = _model_arrays(source)
    else:
        with np.load(source) as z:
            arrays = {name: z[name] for name in _ARRAYS}
    h = hashlib.sha256()
    for name in _ARRAYS:
        a = np.asarray(arrays[name])
        h.update(f"{name}{a.dtype.str}{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, model: SplatModel, project: Optional[Project] = None) -> None:
    payload = {"format_version": np.int32(FORMAT_VERSION), **_model_arrays(model)}
    if project is not None:
        payload["project_json"] = np.frombuffer(
            json.dumps(project.to_json()).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda") -> Tuple[SplatModel, Optional[Project]]:
    """(the model on ``device``, the project or None)."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than supported")
        model = SplatModel.from_numpy(
            z["means"], z["shs"], z["scales"], z["opacities"], z["rotations"],
            count=int(z["count"]), device=device, sh_degree=int(z["sh_degree"]))
        project = None
        if "project_json" in z:
            project = Project.from_json(json.loads(bytes(z["project_json"]).decode()))
    return model, project
