"""Binary checkpoints (counterpart of the npz half of
gaussian_splatterer_tpu.io.checkpoint).

One ``.npz`` holds the exact float32 arrays of the capacity-padded model
plus the Project settings, for a bit-exact resume.  The layout is the JAX
package's, key for key, dtype for dtype and shape for shape, so either
package resumes the other's run: ``format_version`` (int32), ``means``,
``shs``, ``scales``, ``opacities``, ``rotations``, ``count`` (0-d int32),
``sh_degree`` (int32) and, with a project, ``project_json`` (its JSON as
uint8 bytes).  The file is written beside its path and moved over it, so a
crash mid-write leaves the previous checkpoint whole.

Sharded checkpoints (``save_checkpoint_sharded``, the counterpart of the
JAX package's orbax ones) write a directory: ``arrays/``, written with
``torch.distributed.checkpoint`` (torch's on-disk format, not orbax's:
neither package reads the other's), each rank writing its own rows, and
``meta.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# Sharded checkpoints: torch.distributed.checkpoint
# ---------------------------------------------------------------------------
# The .npz path gathers every row into one process.  A splat-sharded model
# (parallel.SplatShard) is saved here from the ranks that own its rows, as a
# DTensor sharded over the mesh's ``splat`` axis (replicas on its other
# axes are written once), and restored straight into each rank's rows.


def _sharded_state(source) -> dict:
    """The arrays of a SplatModel (plain tensors) or a SplatShard (DTensors
    over its mesh), with ``count`` as a 0-d int32 tensor, as JAX's tree."""
    from gaussian_splatterer_tpu_torch.parallel.fsdp import SPLAT_AXIS, SplatShard

    state = {"count": torch.tensor(source.count, dtype=torch.int32)}
    if not isinstance(source, SplatShard):
        state.update({name: getattr(source, name).detach() for name in _ARRAYS[:5]})
        return state
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = source.mesh
    if mesh is None:
        raise ValueError("a SplatShard without its mesh cannot be saved sharded")
    placements = [Shard(0) if name == SPLAT_AXIS else Replicate()
                  for name in mesh.mesh_dim_names]
    for name in _ARRAYS[:5]:
        state[name] = DTensor.from_local(getattr(source, name), mesh, placements,
                                         run_check=False)
    return state


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint_sharded(directory: str, model_or_shard,
                            project: Optional[Project] = None) -> None:
    """Save a SplatModel, or a splat-sharded model's rows (a SplatShard),
    into ``directory`` without gathering them.  Under a process group
    every rank calls it; rank 0 replaces an earlier ``arrays/`` (kept as
    ``arrays.old``) and writes ``meta.json`` (format_version, sh_degree,
    the project), with barriers around both."""
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    arrays_dir = os.path.join(directory, "arrays")
    if _rank0():
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(arrays_dir):
            shutil.rmtree(arrays_dir + ".old", ignore_errors=True)
            os.replace(arrays_dir, arrays_dir + ".old")
    _barrier()
    dcp.save(_sharded_state(model_or_shard), checkpoint_id=arrays_dir,
             no_dist=not dist.is_initialized())
    if _rank0():
        meta = {"format_version": FORMAT_VERSION, "sh_degree": int(model_or_shard.sh_degree),
                "project": project.to_json() if project is not None else None}
        tmp = os.path.join(directory, "meta.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, os.path.join(directory, "meta.json"))
    _barrier()


def load_checkpoint_sharded(directory: str, like=None, device="cuda"):
    """(the model, the project or None) from a sharded checkpoint.

    ``like`` a SplatShard: this rank's rows of the saved model, on its
    device and mesh (every rank calls it).  ``like`` a SplatModel: the
    whole model shaped and placed like it.  No ``like``: the whole model on
    ``device``, read in one process when there is no group."""
    import torch.distributed.checkpoint as dcp

    from gaussian_splatterer_tpu_torch.parallel.fsdp import SplatShard

    with open(os.path.join(directory, "meta.json")) as fh:
        meta = json.load(fh)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['format_version']} is newer than supported")
    arrays_dir = os.path.join(os.path.abspath(directory), "arrays")
    if like is None:
        stored = dcp.FileSystemReader(arrays_dir).read_metadata().state_dict_metadata
        state = {name: torch.empty(tuple(stored[name].size), dtype=torch.float32)
                 for name in _ARRAYS[:5]}
        state["count"] = torch.zeros((), dtype=torch.int32)
    else:
        state = {k: torch.empty_like(v) for k, v in _sharded_state(like).items()}
    with warnings.catch_warnings():  # one process without a group is what we ask for
        warnings.filterwarnings("ignore", "torch.distributed is disabled", UserWarning)
        dcp.load(state, checkpoint_id=arrays_dir, no_dist=not dist.is_initialized())
    count = int(state["count"])
    project = Project.from_json(meta["project"]) if meta.get("project") else None
    fields = [state[name] for name in _ARRAYS[:5]]
    if isinstance(like, SplatShard):
        return SplatShard(*(x.to_local() for x in fields), count=count, capacity=like.capacity,
                          sh_degree=meta["sh_degree"], offset=like.offset, mesh=like.mesh), project
    dev = like.device if like is not None else device
    return SplatModel(*(x.to(dev) for x in fields), count=count,
                      sh_degree=meta["sh_degree"]), project
