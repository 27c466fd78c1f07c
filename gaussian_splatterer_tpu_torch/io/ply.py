"""Standard 3DGS binary ``.ply`` splat import and export (counterpart of
gaussian_splatterer_tpu.io.ply; numpy only).

The Gaussian-splatting ecosystem (the INRIA trainer, supersplat,
antimatter15/splat, most web viewers) exchanges binary little-endian PLY
with the INRIA field layout:

    x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity scale_{0..2}
    rot_{0..3}

with INRIA's activations baked into the stored values: opacity is the
pre-sigmoid logit, scales are logs, f_rest is channel-major (3, K-1) per
splat, and rotations are unnormalised wxyz quaternions.  The splat models
here (like the reference's) hold post-activation opacity and scales and
(K, 3) row-major SH, so the conversion happens here, in numpy, at the IO
boundary.  Files are byte-equal to the JAX package's for the same model.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost

_OPACITY_EPS = 1e-5  # logit() needs opacity away from exactly 0 and 1
_SCALE_FLOOR = 1e-9  # log() needs strictly positive scales


def _header(n: int, sh_coeffs: int) -> bytes:
    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(3 * (sh_coeffs - 1))]
    props += ["opacity"]
    props += [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    lines += [f"property float {p}" for p in props]
    lines += ["end_header"]
    return ("\n".join(lines) + "\n").encode("ascii")


def _logit(p: np.ndarray) -> np.ndarray:
    return np.log(p) - np.log1p(-p)


def save_ply(model: SplatModelHost, path: str) -> None:
    """Write the INRIA-layout binary PLY (one float32 record per splat)."""
    n, k = model.count, model.sh_coeffs
    cols = [
        model.means[:n].astype(np.float32),
        np.zeros((n, 3), np.float32),  # normals: unused, the layout wants them
        model.shs[:n, 0].astype(np.float32),  # f_dc: the SH DC term as it is
        # f_rest channel-major: (n, K-1, 3) -> (n, 3, K-1) flattened
        np.ascontiguousarray(model.shs[:n, 1:].transpose(0, 2, 1))
        .reshape(n, 3 * (k - 1)).astype(np.float32),
        # logit: the inverse of the sigmoid INRIA applies on load
        _logit(np.clip(model.opacities[:n], _OPACITY_EPS, 1.0 - _OPACITY_EPS))[:, None]
        .astype(np.float32),
        np.log(np.maximum(model.scales[:n], _SCALE_FLOOR)).astype(np.float32),
        model.rotations[:n].astype(np.float32),  # wxyz; viewers normalise
    ]
    rec = np.concatenate([c.reshape(n, -1) for c in cols], axis=1)
    with open(path, "wb") as fh:
        fh.write(_header(n, k))
        fh.write(np.ascontiguousarray(rec, np.float32).tobytes())


def _read_header(fh, path: str) -> tuple[int, list[str]]:
    """(vertex count, vertex property names) of a PLY header.  Comment and
    ``obj_info`` lines are skipped; property lines are read and checked
    only for the vertex element (ecosystem writers add comments and
    sometimes an empty face element)."""
    header = b""
    while not header.endswith((b"end_header\n", b"end_header\r\n")):
        ch = fh.read(1)
        if not ch:
            raise ValueError(f"{path}: truncated PLY header")
        header += ch
    lines = header.decode("ascii", "replace").splitlines()
    if not any(ln.strip() == "format binary_little_endian 1.0" for ln in lines):
        raise ValueError(f"{path}: only binary little-endian PLY supported")
    n, props, current = None, [], None
    for ln in lines:
        ln = ln.strip()
        if ln.startswith(("comment", "obj_info")) or not ln:
            continue
        if ln.startswith("element "):
            parts = ln.split()
            current = parts[1]
            if current == "vertex":
                if n is not None:
                    raise ValueError(f"{path}: multiple vertex elements")
                n = int(parts[2])
            elif n is None:
                raise ValueError(f"{path}: element {current!r} precedes vertex data")
        elif ln.startswith("property ") and current == "vertex":
            parts = ln.split()
            if parts[1] != "float":
                raise ValueError(f"{path}: non-float vertex property {ln!r}")
            props.append(parts[-1])
    if n is None:
        raise ValueError(f"{path}: no vertex element")
    return n, props


def load_ply(path: str, capacity: int | None = None) -> SplatModelHost:
    """Read an INRIA-layout binary PLY into a SplatModelHost of at least
    ``capacity`` slots.  The SH degree comes from the f_rest count (as
    the .gobj reader takes it from the first ``sh`` line)."""
    with open(path, "rb") as fh:
        n, props = _read_header(fh, path)
        data = np.frombuffer(fh.read(4 * n * len(props)), "<f4").reshape(n, len(props))

    col = {p: i for i, p in enumerate(props)}
    n_rest = sum(1 for p in props if p.startswith("f_rest_"))
    if n_rest % 3:
        raise ValueError(f"{path}: f_rest count {n_rest} not divisible by 3")
    k = 1 + n_rest // 3
    degree = int(round(np.sqrt(k))) - 1
    if (degree + 1) ** 2 != k:
        raise ValueError(f"{path}: SH coefficient count {k} is not square")

    def cols(*names):
        return data[:, [col[p] for p in names]]

    m = SplatModelHost(max(capacity or 0, n), degree, k)
    m.means[:n] = cols("x", "y", "z")
    m.shs[:n, 0] = cols("f_dc_0", "f_dc_1", "f_dc_2")
    if k > 1:
        rest = cols(*(f"f_rest_{i}" for i in range(3 * (k - 1))))
        m.shs[:n, 1:] = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    m.opacities[:n] = 1.0 / (1.0 + np.exp(-data[:, col["opacity"]]))
    m.scales[:n] = np.exp(cols("scale_0", "scale_1", "scale_2"))
    m.rotations[:n] = cols("rot_0", "rot_1", "rot_2", "rot_3")
    m.count = n
    return m
