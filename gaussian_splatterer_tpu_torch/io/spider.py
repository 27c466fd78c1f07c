"""SPIDER 2D image decoding with numpy, for textures on hosts without
Pillow.

``decode_spider(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: a 2D image (``iform`` 1) of 32-bit floats, big- or
little-endian (the header tried big-endian first), alone or the first of
a stack; converted to RGBA as Pillow converts mode ``F``: each float
truncated toward zero and clipped to [0, 255], NaN 0 (io/rawmode.py).

Where Pillow refuses a file this module raises ValueError naming SPIDER:
a stack header that points at an image by number (Pillow's missing
``stkoffset``), data that ends early, a file above Pillow's pixel limit.
A header that is not SPIDER's, a 3D or Fourier image, inconsistent stack
fields or a side of 0 or below turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header(t: tuple) -> int:
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _open(blob: bytes) -> tuple[bool, int, int, int]:
    """SpiderImageFile._open with Pillow's exceptions -> (big-endian,
    width, height, where the pixels start)."""
    f = blob[:108]
    big = True
    t = struct.unpack(">27f", f)
    hdrlen = _header(t)
    if hdrlen == 0:
        big = False
        t = struct.unpack("<27f", f)
        hdrlen = _header(t)
    if hdrlen == 0:
        raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    w, rows = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise AttributeError("'SpiderImageFile' object has no attribute 'stkoffset'")
    else:
        raise SyntaxError("inconsistent stack header values")
    if w <= 0 or rows <= 0:
        raise SyntaxError("not identified by this driver")
    return big, w, rows, offset


def opens(blob: bytes) -> tuple[bool, int, int, int]:
    return falls_through(_open, blob)


def decode_spider(blob: bytes) -> np.ndarray:
    """SPIDER bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    big, w, h, offset = opens(blob)
    check_size("SPIDER", w, h)
    raw = "F;32BF" if big else "F;32F"
    rows = rawmode.raw_rows(blob, offset, h, 4 * w, fmt="SPIDER")
    return rawmode.to_rgba("F", rawmode.unpack(raw, rows, w))
