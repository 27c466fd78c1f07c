"""CIE L*a*b* -> sRGB as Pillow converts a LAB image, in numpy.

Pillow's ``Image.convert("RGBA")`` of a LAB image builds a littleCMS 2
transform from ``ImageCms.createProfile("LAB")`` (a version-2 Lab identity
profile, D50) to ``createProfile("sRGB")`` (a matrix-shaper: the Rec. 709
primaries and D65 white adapted to D50 by Bradford, the IEC 61966-2.1
curve), perceptual intent, 8 bits in and out.  littleCMS 2.17 optimises
that pipeline (Lab -> XYZ, the inverse colorant matrix, the inverse curves)
by resampling it into a 16-bit table of 33 x 33 x 33 nodes, each node
evaluated in single precision as its stages compute it, and looks the
table up with its 16-bit tetrahedral interpolation; the 8-bit input
reaches it as ``v * 257`` and the output leaves it as littleCMS's
``FROM_16_TO_8``.  No white fix-up applies: Lab white (0xFFFF, 0x8080,
0x8080) falls between the table's nodes.  Alpha is 255.

``lab_to_rgb`` takes the bytes littleCMS is handed (L* as 0-255, a* and b*
offset by 128); what each reader hands it is the reader's business
(io/tiff.py flips the sign bit of a TIFF's a* and b*, io/psd.py passes the
stored channels).  The table is built from the profiles' definitions at
first use (``lab_table``), never read from a file.  It equals Pillow on all
2^24 triples.
"""

from __future__ import annotations

import functools
import math

import numpy as np

D50 = (0.9642, 1.0, 0.8249)
GRID = 33
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # littleCMS's MAX_ENCODEABLE_XYZ
_MAGIC = 68719476736.0 * 1.5  # _cmsQuickFloor's 2^36 * 1.5


def _inverse(a):
    """_cmsMAT3inverse, its sums in littleCMS's order."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _bradford(source, dest):
    """_cmsAdaptationMatrix with the Bradford cone matrix."""
    cone = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    s, d = _apply(cone, source), _apply(cone, dest)
    scale = [[d[0] / s[0], 0.0, 0.0], [0.0, d[1] / s[1], 0.0], [0.0, 0.0, d[2] / s[2]]]
    return _product(_inverse(cone), _product(scale, cone))


def srgb_to_xyz() -> list:
    """cmsCreate_sRGBProfile's colorant matrix (_cmsBuildRGB2XYZtransferMatrix,
    adapted to D50)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb],
                            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    white = ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0)
    return _product(_bradford(white, D50), m)


def _inverse_curve(r: float) -> float:
    """The sRGB curve's inverse, parametric type -4 (littleCMS's
    DefaultEvalParametricFn) in double."""
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    if r >= math.pow(a * d + b, g):
        return (math.pow(r, 1.0 / g) - b) / a
    return r / c


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 clamped to [0, 65535], floored as
    _cmsQuickFloor floors (at 16 fractional bits)."""
    d = d + 0.5
    t = d - 32767.0
    v = np.floor((t + _MAGIC) - _MAGIC) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, v)).astype(np.int64)


@functools.lru_cache(maxsize=1)
def lab_table() -> np.ndarray:
    """The optimised transform's (33, 33, 33, 3) table of 16-bit RGB:
    node (i, j, k) is the pipeline at L, a, b = _cmsQuantizeVal(i, 33) ...
    / 65535 as float, through Lab -> XYZ (D50, over MAX_ENCODEABLE_XYZ, as
    float), the inverse colorant matrix (times MAX_ENCODEABLE_XYZ, double
    sums of float inputs, as float) and the inverse curves (double, as
    float), saturated to 16 bits."""
    f32 = np.float32
    node = _saturate_word(np.arange(GRID) * 65535.0 / (GRID - 1)).astype(np.float64)
    inp = (node / 65535.0).astype(f32).astype(np.float64)
    lv, av, bv = np.meshgrid(inp * 100.0, inp * 255.0 - 128.0, inp * 255.0 - 128.0,
                             indexing="ij")
    fy = (lv + 16.0) / 116.0

    def f_inv(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [(f_inv(fy + 0.002 * av) * D50[0] / _MAX_XYZ).astype(f32).astype(np.float64),
           (f_inv(fy) * D50[1] / _MAX_XYZ).astype(f32).astype(np.float64),
           (f_inv(fy - 0.005 * bv) * D50[2] / _MAX_XYZ).astype(f32).astype(np.float64)]
    inv = [[v * _MAX_XYZ for v in row] for row in _inverse(srgb_to_xyz())]
    out = np.empty((GRID, GRID, GRID, 3), np.int64)
    for i in range(3):
        lin = (((0.0 + xyz[0] * inv[i][0]) + xyz[1] * inv[i][1]) + xyz[2] * inv[i][2])
        lin = lin.astype(f32).astype(np.float64).ravel()
        curved = np.array([_inverse_curve(v) for v in lin.tolist()], np.float64)
        out[..., i] = _saturate_word(curved.astype(f32).astype(np.float64) * 65535.0).reshape(
            GRID, GRID, GRID)
    return out


# TetrahedralInterp16's six tetrahedra: the test on the rests (rx, ry, rz),
# the corners c1, c2, c3 as (x, y, z) steps from c0, and the differences of
# corners (c0 .. c3) that weigh rx, ry and rz
_TETRAHEDRA = (
    (lambda x, y, z: (x >= y) & (y >= z), ((1, 0, 0), (1, 1, 0), (1, 1, 1)),
     ((1, 0), (2, 1), (3, 2))),
    (lambda x, y, z: (x >= y) & (y < z) & (z >= x), ((1, 0, 1), (1, 1, 1), (0, 0, 1)),
     ((1, 3), (2, 1), (3, 0))),
    (lambda x, y, z: (x >= y) & (y < z) & (z < x), ((1, 0, 0), (1, 1, 1), (1, 0, 1)),
     ((1, 0), (2, 3), (3, 1))),
    (lambda x, y, z: (x < y) & (x >= z), ((1, 1, 0), (0, 1, 0), (1, 1, 1)),
     ((1, 2), (2, 0), (3, 1))),
    (lambda x, y, z: (x < y) & (x < z) & (y >= z), ((1, 1, 1), (0, 1, 0), (0, 1, 1)),
     ((1, 3), (2, 0), (3, 2))),
    (lambda x, y, z: (x < y) & (x < z) & (y < z), ((1, 1, 1), (0, 1, 1), (0, 0, 1)),
     ((1, 2), (2, 3), (3, 0))),
)


def _tetrahedral(table: np.ndarray, lab: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of (N, 3) 8-bit inputs, each v * 257 -> (N, 3)
    16-bit.  A byte's grid cell and rest are the same wherever it comes,
    so they are looked up per byte value; the table is read flat."""
    grid = table.shape[0]
    v = np.arange(256, dtype=np.int64) * 257
    fixed = v * (grid - 1)
    fixed = fixed + (fixed + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    lo_b, rest_b = fixed >> 16, fixed & 0xFFFF
    step_b = np.where(v == 0xFFFF, 0, 1)  # the next node, or none at the top
    flat = table.reshape(-1, 3)
    stride = (grid * grid, grid, 1)
    lab = lab.astype(np.intp)
    base = sum(lo_b[lab[:, k]] * stride[k] for k in range(3))
    rest = np.stack([rest_b[lab[:, k]] for k in range(3)], axis=1)
    rx, ry, rz = rest.T
    which = np.zeros(lab.shape[0], np.int8)
    for k, (test, _, _) in enumerate(_TETRAHEDRA):
        which[test(rx, ry, rz)] = k
    out = np.empty(lab.shape, np.int64)
    for k, (_, corners, weights) in enumerate(_TETRAHEDRA):
        at = np.nonzero(which == k)[0]
        if not at.size:
            continue
        b, r, sel = base[at], rest[at], lab[at]
        c = [flat[b]] + [flat[b + sum(step_b[sel[:, j]] * stride[j] for j in range(3) if step[j])]
                         for step in corners]
        acc = sum((c[a] - c[z]) * r[:, j:j + 1] for j, (a, z) in enumerate(weights)) + 0x8001
        out[at] = (c[0] + ((acc + (acc >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 L*, a* + 128, b* + 128 as littleCMS is handed them ->
    (..., 3) uint8 sRGB, Pillow's bytes.  Each distinct triple is
    transformed once."""
    flat = lab.reshape(-1, 3)
    key = (flat[:, 0].astype(np.uint32) << 16) | (flat[:, 1].astype(np.uint32) << 8) | flat[:, 2]
    keys, back = np.unique(key, return_inverse=True)
    rgb = np.empty((keys.size, 3), np.uint8)
    table = lab_table()
    for at in range(0, keys.size, 1 << 18):  # bounded memory on large images
        k = keys[at:at + (1 << 18)]
        w = _tetrahedral(table, np.stack([k >> 16, (k >> 8) & 0xFF, k & 0xFF], axis=1))
        rgb[at:at + (1 << 18)] = ((w * 65281 + 8388608) >> 24) & 0xFF  # FROM_16_TO_8
    return rgb[back.reshape(-1)].reshape(lab.shape)
