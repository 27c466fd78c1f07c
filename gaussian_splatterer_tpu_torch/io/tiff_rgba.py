"""libtiff's RGBA interface for YCbCr, in numpy: how Pillow reads a YCbCr TIFF
under LZW, Deflate, PackBits, LZMA or Zstandard.

Pillow hands such a file to libtiff's ``TIFFRGBAImageGet``
(tif_getimage.c), which reads each strip or tile of 8-bit samples laid out
in libtiff's blocks (the ``h x v`` Y samples of a block, then one Cb and one
Cr; ``YCbCrSubsampling`` 1x1, 1x2, 2x1, 2x2, 4x1, 4x2 or 4x4, the
``putcontig8bitYCbCr*tile`` routines) and converts every pixel with
``TIFFYCbCrtoRGB``: integer tables that ``TIFFYCbCrToRGBInit`` (tif_color.c)
builds in single-precision floating point from ``YCbCrCoefficients`` and
``ReferenceBlackWhite`` (libtiff's defaults 0.299, 0.587, 0.114 and 0, 255,
128, 255, 128, 255 where a tag is absent).  A pixel of a block that the
image's edge cuts takes the Y sample at its own place in the block and the
block's Cb and Cr; chroma is never interpolated.

``ycbcr_tables`` builds the tables; ``blocks_to_rgb`` turns one strip's or
tile's blocks into RGB.  io/tiff.py reads the strips and tiles into
libtiff's buffer and calls these.
"""

from __future__ import annotations

import numpy as np

# libtiff's defaults where YCbCrCoefficients or ReferenceBlackWhite is absent
DEFAULT_COEFFICIENTS = (0.299, 0.587, 0.114)
DEFAULT_REFERENCE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
# the subsamplings TIFFRGBAImage has a routine for (PickContigCase)
SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))

_F = np.float32
_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)


def _fix(x) -> int:
    """FIX(x): (int32)(x * 65536 + 0.5), the product in float, the sum in
    double."""
    return int(np.trunc(float(_F(x) * _F(65536)) + 0.5))


def _clamp(f, lo, hi):
    """CLAMP(f, min, max), where NaN reads as ``min``."""
    return lo if not f >= lo else hi if f > hi else f


def _clampw(f, lo, hi):
    return lo if f < lo else hi if f > hi else f


def _code2v(c: int, rb, rw, cr):
    """Code2V(c, RB, RW, CR) in float: (c - (int32)RB) * CR / (RW - RB, or 1)."""
    rb, rw = _F(rb), _F(rw)
    den = _F(rw - rb) if _F(rw - rb) != 0 else _F(1)
    return _F(_F(_F(c - int(np.trunc(rb))) * _F(cr)) / den)


def ycbcr_tables(coefficients=DEFAULT_COEFFICIENTS, reference=DEFAULT_REFERENCE) -> tuple:
    """TIFFYCbCrToRGBInit -> (Y, Cr->R, Cb->B, Cr->G, Cb->G) int64 tables of
    256 entries, indexed by the stored sample.  ValueError where
    initYCbCrConversion refuses the tags (a NaN or zero green coefficient,
    a reference value out of range)."""
    red, green, blue = (_F(v) for v in coefficients)
    ref = [_F(v) for v in reference]
    if np.isnan(red) or np.isnan(green) or green == 0 or np.isnan(blue):
        raise ValueError("TIFF with YCbCrCoefficients libtiff refuses")
    lim_lo, lim_hi = _F(-0x7FFFFFFF + 128), _F(0x7FFFFFFF)
    if not all(lim_lo < v < lim_hi for v in ref):
        raise ValueError("TIFF with ReferenceBlackWhite libtiff refuses")
    f1 = _F(_F(2) - _F(2) * red)
    d1 = _fix(_clamp(f1, _F(0), _F(2)))
    f2 = _F(_F(red * f1) / green)
    d2 = -_fix(_clamp(f2, _F(0), _F(2)))
    f3 = _F(_F(2) - _F(2) * blue)
    d3 = _fix(_clamp(f3, _F(0), _F(2)))
    f4 = _F(_F(blue * f3) / green)
    d4 = -_fix(_clamp(f4, _F(0), _F(2)))
    lo, hi = _F(-128.0 * 32), _F(128.0 * 32)
    y_tab, cr_r, cb_b, cr_g, cb_g = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = int(np.trunc(_clampw(_code2v(x, ref[4] - _F(128), ref[5] - _F(128), 127), lo, hi)))
        cb = int(np.trunc(_clampw(_code2v(x, ref[2] - _F(128), ref[3] - _F(128), 127), lo, hi)))
        cr_r[i] = (d1 * cr + _ONE_HALF) >> _SHIFT
        cb_b[i] = (d3 * cb + _ONE_HALF) >> _SHIFT
        cr_g[i] = _i32(d2 * cr)
        cb_g[i] = _i32(d4 * cb + _ONE_HALF)
        y_tab[i] = int(np.trunc(_clampw(_code2v(i, ref[0], ref[1], 255), lo, hi)))
    return y_tab, cr_r, cb_b, cr_g, cb_g


def _i32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """TIFFYCbCrtoRGB of uint8 samples -> (..., 3) uint8."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[y]
    g_sum = (cb_g[cb] + cr_g[cr] + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 sum
    rgb = np.stack([yv + cr_r[cr], yv + (g_sum >> _SHIFT), yv + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def row_bytes(width: int, tile_width: int, sub: tuple) -> int:
    """The bytes a put routine steps from one block row to the next when it
    shows ``width`` of a row of ``tile_width`` pixels: its blocks, then
    ``fromskew``, the pixels it skips, as (fromskew / h) blocks; the 4x4
    routine counts a skipped block as 10 bytes, the 4x2 routine's size,
    where a 4x4 block has 18."""
    hs, vs = sub
    size = hs * vs + 2
    skipped = (tile_width - width) // hs * (10 if sub == (4, 4) else size)
    return -(-width // hs) * size + skipped


def blocks_to_rgb(buf: np.ndarray, rows: int, width: int, stride: int, sub: tuple,
                  tables) -> np.ndarray:
    """The ``rows`` x ``width`` pixels a put routine makes of a strip's or
    tile's bytes ``buf``, its block rows ``stride`` bytes apart
    (``row_bytes``) -> (rows, width, 3) uint8."""
    hs, vs = sub
    size = hs * vs + 2
    bh, bv = -(-width // hs), -(-rows // vs)
    at = np.arange(bv)[:, None] * stride + np.arange(bh)[None, :] * size
    blocks = buf[at[..., None] + np.arange(size)]  # (bv, bh, size)
    y = blocks[..., :hs * vs].reshape(bv, bh, vs, hs).transpose(0, 2, 1, 3).reshape(
        bv * vs, bh * hs)[:rows, :width]
    cb = np.repeat(np.repeat(blocks[..., -2], vs, axis=0), hs, axis=1)[:rows, :width]
    cr = np.repeat(np.repeat(blocks[..., -1], vs, axis=0), hs, axis=1)[:rows, :width]
    return ycbcr_to_rgb(y, cb, cr, tables)
