"""Gaussian-OBJ (.gobj) text format, interoperable with the reference and the
JAX package (counterpart of gaussian_splatterer_tpu.io.gobj; numpy only).

Per splat, five lines (reference writer src/ui/UiFrame.cpp:333-358, reader
src/ui/UiFrame.cpp:373-450):

    v  x y z
    sh c0 ... c{3K-1}          (K = SH coefficient count; row-major (K, 3))
    s  sx sy sz
    a  opacity
    r  q0 q1 q2 q3

The SH coefficient count is taken from the first ``sh`` line and must be the
same on every line (reference src/ui/UiFrame.cpp:419-420).

A file given by its path is read and written by the C++ parser of
``native/`` when it builds; the pure-Python code here is its plain twin
and the fallback.  ``last_path`` says which one handled the last call:
"native" or "python".
"""

from __future__ import annotations

import io as _io
from typing import TextIO, Union

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost

last_path = None  # "native" or "python": the code that handled the last call


def save_gobj(model: SplatModelHost, path_or_file: Union[str, TextIO]) -> None:
    """The native writer when given a path and the library builds, else
    save_gobj_python."""
    global last_path
    n = model.count
    if isinstance(path_or_file, str) and native.save_gobj(
            path_or_file, model.means[:n], model.shs[:n], model.scales[:n],
            model.opacities[:n], model.rotations[:n]):
        last_path = "native"
        return
    save_gobj_python(model, path_or_file)


def save_gobj_python(model: SplatModelHost, path_or_file: Union[str, TextIO]) -> None:
    global last_path
    last_path = "python"
    n, k = model.count, model.sh_coeffs
    buf = _io.StringIO()
    for i in range(n):
        loc = model.means[i]
        buf.write(f"v {loc[0]:g} {loc[1]:g} {loc[2]:g}\n")
        buf.write("sh " + " ".join(f"{x:g}" for x in model.shs[i].reshape(3 * k)) + "\n")
        s = model.scales[i]
        buf.write(f"s {s[0]:g} {s[1]:g} {s[2]:g}\n")
        buf.write(f"a {model.opacities[i]:g}\n")
        r = model.rotations[i]
        buf.write(f"r {r[0]:g} {r[1]:g} {r[2]:g} {r[3]:g}\n")
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as fh:
            fh.write(buf.getvalue())
    else:
        path_or_file.write(buf.getvalue())


def _parse(fh: TextIO) -> dict[str, list]:
    rows: dict[str, list] = {"v": [], "sh": [], "s": [], "a": [], "r": []}
    widths = {"v": 3, "s": 3, "r": 4}
    sh_coeffs = None
    for line in fh:
        parts = line.split()
        if not parts or parts[0] not in rows:
            continue
        tag = parts[0]
        if tag == "sh":
            vals = [float(x) for x in parts[1:]]
            if sh_coeffs is None:
                sh_coeffs = len(vals)
            elif sh_coeffs != len(vals):
                raise ValueError("Inconsistent SH degree!")
            rows["sh"].append(vals)
        elif tag == "a":
            rows["a"].append(float(parts[1]))
        else:
            rows[tag].append([float(x) for x in parts[1 : 1 + widths[tag]]])
    return rows


def load_gobj(path_or_file: Union[str, TextIO], capacity: int | None = None) -> SplatModelHost:
    """The native reader when given a path and the library builds (and
    reads the file), else load_gobj_python."""
    global last_path
    if isinstance(path_or_file, str):
        arrays = native.load_gobj(path_or_file)
        if arrays is not None:
            last_path = "native"
            return SplatModelHost.from_arrays(*arrays, capacity=capacity)
    return load_gobj_python(path_or_file, capacity)


def load_gobj_python(path_or_file: Union[str, TextIO],
                     capacity: int | None = None) -> SplatModelHost:
    global last_path
    last_path = "python"
    if isinstance(path_or_file, str):
        with open(path_or_file) as fh:
            rows = _parse(fh)
    else:
        rows = _parse(path_or_file)
    return SplatModelHost.from_arrays(
        np.asarray(rows["v"], np.float32),
        np.asarray(rows["sh"], np.float32),
        np.asarray(rows["s"], np.float32),
        np.asarray(rows["a"], np.float32),
        np.asarray(rows["r"], np.float32),
        capacity=capacity,
    )
