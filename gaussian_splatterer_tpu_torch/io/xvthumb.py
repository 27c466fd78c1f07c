"""XV thumbnail (``P7 332``) decoding with numpy, for textures on hosts
without Pillow.

``decode_xvthumb(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the ``P7 332`` header, its comment lines and the size line,
then one byte a pixel through XV's fixed 3-3-2 palette (red and green
``v * 255 // 7``, blue ``v * 255 // 3``).

Pillow's reading is kept with its quirks: the rest of the first line is
skipped, then every line that starts with ``#``; the first other line
gives the size (its first two words); the pixels start past it.

Where Pillow refuses a file this module raises ValueError naming
XVThumb: a size Pillow cannot read as integers, data that ends early, a
file above Pillow's pixel limit.  A file that ends in its comments, a
size line of fewer than two words or a side of 0 or below turns the file
away (``NotThisFormat``).
"""

from __future__ import annotations

import io

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

MAGIC = b"P7 332"
PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                    for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def _open(blob: bytes) -> tuple[int, int, int]:
    fp = io.BytesIO(blob)
    fp.read(6)
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    w, h = int(w), int(h)
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return w, h, fp.tell()


def opens(blob: bytes) -> tuple[int, int, int]:
    """(width, height, where the pixels start)."""
    return falls_through(_open, blob)


def decode_xvthumb(blob: bytes) -> np.ndarray:
    """XV thumbnail bytes -> (H, W, 4) uint8 RGBA, row 0 the top."""
    w, h, start = opens(blob)
    check_size("XVThumb", w, h)
    rows = rawmode.raw_rows(blob, start, h, w, fmt="XVThumb")
    return rawmode.to_rgba("P", rows, PALETTE)
