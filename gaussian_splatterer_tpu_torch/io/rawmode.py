"""Pillow's raw decoder, its unpackers and its conversions to RGBA, in
numpy, for the readers of the formats whose pixels Pillow reads through a
``raw`` tile (io/blp.py, io/im.py, io/sun.py, io/fits.py and the others).

``raw_rows`` cuts the rows a raw tile reads: ``h`` rows of ``row`` bytes
from ``offset``, ``stride`` bytes apart (0: ``row``), bottom-up when the
tile's ystep is negative.  Pillow's decoder needs ``(h - 1) * stride +
row`` bytes (the last row's padding may be missing); less refuses the
file ("image file is truncated"), and so does a stride shorter than a row
or an offset below 0.

``unpack(rawmode, rows, w)`` gives the pixels in the image mode's form:
(H, W) uint8 for ``1``, ``L`` and ``P`` (``1`` as 0 or 255), (H, W, C)
uint8 for the modes of several bands, int64 for ``I`` and the ``I;16``
modes, float32 for ``F``.  ``to_rgba(mode, pixels, palette)`` is Pillow's
``convert("RGBA")`` of them: ``I`` and ``I;16`` clipped to [0, 255], ``F``
truncated toward zero and clipped (NaN 0), ``P`` and ``PA`` through a
palette of 256 entries, ``CMYK`` as Pillow converts it (io/jpeg.py's
``cmyk_to_rgb`` of the inverted planes), ``YCbCr`` through Pillow's own
fixed-point tables (``ycbcr_to_rgb``).
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch.io.jpeg import cmyk_to_rgb

# raw mode -> bits a pixel, of the unpackers the readers use
BITS = {
    "1": 1, "1;I": 1, "L": 8, "P": 8, "L;4": 4, "P;4": 4, "P;2": 2, "RGB": 24, "BGR": 24,
    "RGBX": 32, "BGRX": 32, "RGB;L": 24, "RGBX;L": 32, "RGBA;L": 32, "LA;L": 16, "PA;L": 16,
    "CMYK;L": 32, "YCbCr;L": 24, "I": 32, "I;32": 32, "I;32S": 32, "I;32B": 32, "I;16": 16,
    "I;16L": 16, "I;16B": 16, "F": 32, "F;8": 8, "F;8S": 8, "F;16": 16, "F;16S": 16,
    "F;32": 32, "F;32F": 32, "F;32BF": 32,
}
# image mode -> the raw modes of BITS Pillow unpacks into it
PAIRS = {
    "1": ("1", "1;I"), "L": ("L", "L;4"), "P": ("P", "P;4", "P;2", "L"),
    "RGB": ("RGB", "BGR", "RGBX", "BGRX", "RGB;L", "RGBX;L"),
    "RGBA": ("RGBA;L",), "LA": ("LA;L",), "PA": ("PA;L",), "CMYK": ("CMYK;L",),
    "YCbCr": ("YCbCr;L",), "I": ("I", "I;32", "I;32S", "I;32B", "I;16", "I;16B"),
    "I;16": ("I;16",), "I;16L": ("I;16L",), "I;16B": ("I;16B",),
    "F": ("F", "F;8", "F;8S", "F;16", "F;16S", "F;32", "F;32F", "F;32BF"),
}


def row_bytes(rawmode: str, w: int) -> int:
    return (w * BITS[rawmode] + 7) // 8


def raw_rows(blob: bytes, offset: int, h: int, row: int, stride: int = 0,
             bottom_up: bool = False, fmt: str = "raw") -> np.ndarray:
    """The (h, row) uint8 rows of a raw tile, row 0 the top of the image."""
    stride = stride or row
    if offset < 0:
        raise ValueError(f"{fmt} image data at a negative offset")
    if stride < row:
        raise ValueError(f"{fmt} row stride {stride} below its {row} bytes (decoder config)")
    need = (h - 1) * stride + row if h else 0
    if len(blob) - offset < need:
        raise ValueError(f"{fmt} image data is too short (image file is truncated)")
    buf = np.frombuffer(blob, np.uint8, need, offset)
    if stride == row:
        out = buf.reshape(h, row)
    else:
        out = np.lib.stride_tricks.as_strided(buf, (h, row), (stride, 1))
    return np.array(out[::-1] if bottom_up else out)  # a writable copy


def _bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    v = np.unpackbits(rows, axis=1)
    v = v.reshape(rows.shape[0], -1, bits)
    weights = 1 << np.arange(bits - 1, -1, -1)
    return (v * weights).sum(axis=2)[:, :w].astype(np.uint8)


def unpack(rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """Rows of at least ``row_bytes(rawmode, w)`` bytes -> the pixels."""
    h = rows.shape[0]
    n = row_bytes(rawmode, w)
    r = rows[:, :n]
    if rawmode in ("1", "1;I"):
        v = _bits(r, w, 1)
        return ((1 - v) if rawmode == "1;I" else v) * 255
    if rawmode in ("L", "P"):
        return r.copy()
    if rawmode in ("L;4", "P;4", "P;2"):
        v = _bits(r, w, 2 if rawmode == "P;2" else 4)
        return v * 17 if rawmode == "L;4" else v
    if rawmode in ("RGB", "BGR", "RGBX", "BGRX"):
        c = r.reshape(h, w, len(rawmode))[..., :3]
        return np.ascontiguousarray(c[..., ::-1] if rawmode[0] == "B" else c)
    if rawmode.endswith(";L"):  # line interleaved: each band's w bytes in turn
        bands = len(rawmode[:-2]) if rawmode != "YCbCr;L" else 3
        v = r.reshape(h, bands, w).transpose(0, 2, 1)
        return np.ascontiguousarray(v[..., :3] if rawmode == "RGBX;L" else v)
    if rawmode.startswith("I"):
        dt = {"I": "<i4", "I;32": "<u4", "I;32S": "<i4", "I;32B": ">u4", "I;16": "<u2",
              "I;16L": "<u2", "I;16B": ">u2"}[rawmode]
        v = r.view(dt).astype(np.int64)
        return (v + (1 << 31)) % (1 << 32) - (1 << 31) if dt[1:] == "u4" else v
    dt = {"F": "<f4", "F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4",
          "F;32F": "<f4", "F;32BF": ">f4"}[rawmode]
    with np.errstate(invalid="ignore", over="ignore"):
        return r.view(dt).astype(np.float32)


def step_table(first: int, low: int, steps: str) -> np.ndarray:
    """A table of 256 int64 from its first entry and its steps (``low``
    plus each character's code less 48)."""
    return np.concatenate([[first], first + np.cumsum([ord(c) - 48 + low for c in steps])])


# Pillow's YCbCr -> RGB as it converts (ConvertYCbCr.c, fixed point at 6
# bits), measured over every (Y, Cb, Cr): R = Y + _R[Cr], B = Y + _B[Cb],
# G = Y + ((_G_CB[Cb] + _G_CR[Cr]) >> 6), each clipped to [0, 255].
_R = step_table(-180, 1, (
    '01010010100101001010100101001010010100101001010010100101001010010100101001010010'
    '10010100101001010010100101001010010101001010010100101001010010100101001010010100'
    '10100101001010010100101001010010100101001010010100101001010010101001010010100101'
    '001010010100101'
))
_B = step_table(-227, 1, (
    '01111011101111011101110111101110111011110111011110111011101111011101111011101110'
    '11110111011110111011101111011101110111101110111101110111011110111011101111011101'
    '11101110111011110111011110111011101111011101110111101110111101110111011110111011'
    '110111011101111'
))
_G_CB = step_table(-2963, -47, (
    'U1W1UU3US5SU4RW2TV1VT3UT4SV1UV0WT2V2UT4TT5RV3SW1UU2VS4TU3SW1UV0WT2V2US5SU4RW2TV1'
    'VT3UT4SV2TW0VU1W1UU3US5SU4RW1UU2VS4TU3SW1UV0WT2V2UU3US5SU4RW2TV1VT3UT3SW1UV0WT2V'
    '2UT4TT5RV3SW1UU2VS4TU3SW1UV0W1UU3US5SU4RW2TV1VT3UT4SV2TW0VU1W1UU3US5RV3SW1UU2VS4'
    'TU3SW1UV0WT2V2U'
))
_G_CR = step_table(11649, -56, (
    '200S10R200S10R200T00R200T00R200T00S100T00S101S00S101S00S101S01R101S01R101S01R110'
    'S01R110S01R110S10R110S10R200S10R200S10R200T00R201T00R200T00S100T00S100T00S101S00'
    'S101S01R101S01R101S01R110S01R110S01R110S10R110S10R110S10R200S10R200T00R200T00R20'
    '0T00S100T00S10R'
))


def ycbcr_to_rgb(v: np.ndarray) -> np.ndarray:
    """Pillow's YCbCr -> RGB of (..., 3) uint8."""
    y, cb, cr = (v[..., i].astype(np.int64) for i in range(3))
    rgb = np.stack([y + _R[cr], y + ((_G_CB[cb] + _G_CR[cr]) >> 6), y + _B[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def to_rgba(mode: str, v: np.ndarray, palette: np.ndarray | None = None) -> np.ndarray:
    """Pillow's ``convert("RGBA")`` of pixels in ``mode``; ``palette`` is
    (256, 3) or (256, 4) uint8 for ``P`` and ``PA`` (alpha from the palette
    for ``P`` when it has four columns)."""
    h, w = v.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if mode in ("1", "L"):
        rgba[..., :3] = v[..., None]
    elif mode == "P":
        pal = np.asarray(palette, np.uint8)
        rgba[..., :pal.shape[1]] = pal[v]
    elif mode == "LA":
        rgba[..., :3] = v[..., :1]
        rgba[..., 3] = v[..., 1]
    elif mode == "PA":
        rgba[..., :3] = np.asarray(palette, np.uint8)[v[..., 0], :3]
        rgba[..., 3] = v[..., 1]
    elif mode == "RGB":
        rgba[..., :3] = v
    elif mode == "RGBA":
        rgba[...] = v
    elif mode == "CMYK":
        rgba[..., :3] = cmyk_to_rgb([255 - v[..., c].astype(np.int64) for c in range(4)],
                                    ycck=False)
    elif mode == "YCbCr":
        rgba[..., :3] = ycbcr_to_rgb(v)
    elif mode == "F":
        with np.errstate(invalid="ignore"):  # signalling NaNs
            f = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        rgba[..., :3] = np.clip(np.trunc(f), 0, 255).astype(np.uint8)[..., None]
    else:  # I and the I;16 modes
        rgba[..., :3] = np.clip(v, 0, 255).astype(np.uint8)[..., None]
    return rgba
