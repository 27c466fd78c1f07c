"""Firaxis texture (FTEX, ``.ftc`` / ``.ftu``) decoding with numpy, for
textures on hosts without Pillow.

``decode_ftex(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: format 0, DXT1 blocks through Pillow's C ``bcn`` decoder, as
io/dds.py reads BC1 (bit replication, the three-colour mode and its
transparent black), and format 1, raw RGB; the first mipmap.

Pillow's reading is kept with its quirks:

  * the mipmap's data is what follows its 4-byte size at the format's
    offset, at most that size (a size of -1 reads to the end of the file,
    a size below -1 refuses it);
  * bytes past those the image needs are ignored.

Where Pillow refuses a file this module raises ValueError naming FTEX: a
format other than 0 and 1 ("Invalid texture compression format"), a
``format_count`` other than 1 (Pillow's ``assert``), a negative offset,
data that ends early, a file above Pillow's pixel limit.  A header or
mipmap size that ends early, or a side of 0 or below, turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.dds import _bcn
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

MAGIC = b"FTEX"


def _open(blob: bytes) -> tuple[int, int, int, bytes]:
    """FtexImageFile._open with Pillow's exceptions -> (format, w, h, data)."""
    struct.unpack("<i", blob[4:8])
    w, h = struct.unpack("<2i", blob[8:16])
    _, format_count = struct.unpack("<2i", blob[16:24])
    if format_count != 1:
        raise AssertionError(f"FTEX format count {format_count}")
    fmt, where = struct.unpack("<2i", blob[24:32])
    if where < 0:
        raise OSError("FTEX mipmap at a negative offset")
    (size,) = struct.unpack("<i", blob[where:where + 4])
    if size < -1:
        raise ValueError("read length must be non-negative or -1")
    data = blob[where + 4:] if size == -1 else blob[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt}")
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return fmt, w, h, data


def opens(blob: bytes) -> tuple[int, int, int, bytes]:
    return falls_through(_open, blob)


def decode_ftex(blob: bytes) -> np.ndarray:
    """FTEX bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    fmt, w, h, data = opens(blob)
    check_size("FTEX", w, h)
    if fmt == 0:
        try:
            return _bcn(data, 0, w, h, 1).astype(np.uint8)
        except ValueError:
            raise ValueError("FTEX DXT1 data is too short (image file is truncated)") from None
    if len(data) < w * h * 3:
        raise ValueError("FTEX RGB data is too short (image file is truncated)")
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = np.frombuffer(data, np.uint8, w * h * 3).reshape(h, w, 3)
    return rgba
