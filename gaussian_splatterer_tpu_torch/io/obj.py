"""Wavefront OBJ loading with the reference's semantics (counterpart of
gaussian_splatterer_tpu.io.obj).  The C++ parser of ``native/`` reads the
file when it builds and no ``progress`` callback is given; the pure-Python
parser here is its plain twin and the fallback.  ``last_path`` says which
one read the last file: "native" or "python".

The reference parser (src/rtx/RtxHost.cpp:107-186) reads:
  * ``v x y z`` vertices and ``vt u v`` texture coordinates;
  * ``f`` faces with 3 or 4 ``v/vt/vn`` corners (quads split 0-1-2 / 0-2-3),
    negative (relative) indices included.

Each triangle stores its own three (u, v) pairs, (0, 0) for all three when
any corner lacks a ``vt`` index (src/rtx/RtxHost.cpp:171-183).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from gaussian_splatterer_tpu_torch import native

last_path = None  # "native" or "python": the parser that read the last file

@dataclass
class TriangleMesh:
    """Host triangle mesh: vertices (V, 3) float32, triangles (T, 3) int32
    vertex indices, tri_uv (T, 3, 2) float32 per-corner texture coordinates."""

    vertices: np.ndarray
    triangles: np.ndarray
    tri_uv: np.ndarray

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]


def _corner(tok: str, n_vertices: int, n_uvs: int) -> tuple[int, int]:
    """1-based (vertex, vt) indices of one face corner; vt 0 when missing."""
    sub = tok.split("/")
    if not sub[0]:
        raise ValueError(f"face corner without vertex index: {tok!r}")
    vi = int(sub[0])
    if vi < 0:  # relative index: -1 is the latest vertex defined
        vi = n_vertices + vi + 1
    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
    if ti < 0:
        ti = n_uvs + ti + 1
    if not 1 <= vi <= n_vertices:
        raise ValueError(
            f"face vertex index {tok!r} out of range ({n_vertices} vertices defined so far)")
    return vi, ti


def load_obj(path: str, progress: Optional[Callable[[], None]] = None) -> TriangleMesh:
    """The mesh of ``path``: the native parser's when it builds and no
    ``progress`` callback is given, else load_obj_python's."""
    global last_path
    if progress is None:
        arrays = native.load_obj(path)
        if arrays is not None:
            last_path = "native"
            return TriangleMesh(*arrays)
    return load_obj_python(path, progress)


def load_obj_python(path: str, progress: Optional[Callable[[], None]] = None) -> TriangleMesh:
    """The pure-Python parser; ``progress()`` is called once a line."""
    global last_path
    last_path = "python"
    vertices: list[tuple[float, float, float]] = []
    uvs: list[tuple[float, float]] = []
    triangles: list[tuple[int, int, int]] = []
    tri_uv_idx: list[tuple[int, int, int]] = []  # 1-based vt indices, 0 = missing

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            tag = parts[0] if parts else ""
            if tag == "v":
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                uvs.append((float(parts[1]), float(parts[2])))
            elif tag == "f":
                corners = [_corner(tok, len(vertices), len(uvs)) for tok in parts[1:]]
                if len(corners) == 4:
                    splits = ((0, 1, 2), (0, 2, 3))
                elif len(corners) == 3:
                    splits = ((0, 1, 2),)
                else:
                    raise ValueError(f"Unexpected vertex count in face list! {len(corners)}")
                for tri in splits:
                    triangles.append(tuple(corners[i][0] - 1 for i in tri))
                    tri_uv_idx.append(tuple(corners[i][1] for i in tri))
            if progress:
                progress()

    verts = np.asarray(vertices, np.float32).reshape(-1, 3)
    tris = np.asarray(triangles, np.int32).reshape(-1, 3)
    uv_ref = np.asarray(uvs, np.float32).reshape(-1, 2)
    tri_uv = np.zeros((tris.shape[0], 3, 2), np.float32)
    for i, idx3 in enumerate(tri_uv_idx):
        if all(j > 0 for j in idx3):
            tri_uv[i] = uv_ref[[j - 1 for j in idx3]]
    return TriangleMesh(verts, tris, tri_uv)
