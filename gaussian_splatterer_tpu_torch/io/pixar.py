"""PIXAR raster decoding with numpy, for textures on hosts without Pillow.

``decode_pixar(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: what Pillow reads of the format: the size at bytes 416-419 and
raw 8-bit RGB from byte 1024 when the header's mode (bytes 424-427) is
(14, 2); every other mode leaves Pillow's image without a mode.

Where Pillow refuses a file this module raises ValueError naming PIXAR:
data that ends early, a file above Pillow's pixel limit.  A header that
ends early, another mode or a side of 0 turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

MAGIC = b"\200\350\000\000"


def _open(blob: bytes) -> tuple[int, int]:
    s = blob[:512]
    h, w = struct.unpack_from("<HH", s, 416)
    mode = struct.unpack_from("<HH", s, 424)
    if mode != (14, 2) or w == 0 or h == 0:
        raise SyntaxError("not identified by this driver")
    return w, h


def opens(blob: bytes) -> tuple[int, int]:
    """(width, height)."""
    return falls_through(_open, blob)


def decode_pixar(blob: bytes) -> np.ndarray:
    """PIXAR bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    w, h = opens(blob)
    check_size("PIXAR", w, h)
    rows = rawmode.raw_rows(blob, 1024, h, 3 * w, fmt="PIXAR")
    return rawmode.to_rgba("RGB", rawmode.unpack("RGB", rows, w))
