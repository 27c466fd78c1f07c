"""Windows cursor (CUR) decoding with numpy, for textures on hosts without
Pillow.

``decode_cur(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the cursor's bitmap as io/bmp.py reads a DIB (every header, bit
depth and compression it reads), the top half of its rows.

Pillow's reading is kept with its quirks:

  * the cursor read is the first entry of the directory, unless a later
    one is strictly wider and strictly taller than the one kept so far
    (by the directory's width and height bytes, where 0 means 256 to
    Windows but is the smallest here);
  * the bitmap's height counts the colour rows and the AND mask's: the
    first half of the rows is read, and the mask is ignored, so the
    cursor is opaque;
  * a 32-bit BI_RGB bitmap keeps its fourth byte as alpha only when it
    starts at byte 22 (the bitmap of a one-entry directory); elsewhere it
    is opaque;
  * an entry whose bitmap offset is 0 reads the bitmap from the end of the
    directory.

Where Pillow refuses a file this module raises ValueError naming the
bitmap's fault (io/bmp.py): an unsupported header, depth, compression or
palette, data that ends early, a PNG cursor.  A directory of no entries,
one that ends early, or a bitmap of one row turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import decode_bitmap
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size, falls_through

SIGNATURE = b"\0\0\2\0"


def _open(blob: bytes) -> tuple[int, int]:
    """CurImageFile._open's directory walk, with Pillow's exceptions ->
    (the entry's bitmap offset, where Pillow reads the bitmap from)."""
    if not blob.startswith(SIGNATURE):
        raise SyntaxError("not a CUR file")
    pos, kept = 6, b""
    for _ in range(struct.unpack_from("<H", blob[:6], 4)[0]):
        entry = blob[pos:pos + 16]
        pos += len(entry)
        if not kept:
            kept = entry
        elif entry[0] > kept[0] and entry[1] > kept[1]:
            kept = entry
    if not kept:
        raise TypeError("No cursors were found")
    header = struct.unpack_from("<I", kept, 12)[0]
    at = header or pos
    struct.unpack_from("<I", blob[at:at + 4])  # the bitmap's header size
    return header, at


def opens(blob: bytes) -> tuple[int, int]:
    """The directory as Pillow walks it; ``NotThisFormat`` where Pillow
    tries its next plugin."""
    return falls_through(_open, blob)


def decode_cur(blob: bytes) -> np.ndarray:
    """CUR bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    header, at = opens(blob)
    rgba, _ = decode_bitmap(blob, at, 0, halve=True, bgra=header == 22)
    if rgba.shape[0] == 0:
        raise NotThisFormat("CUR bitmap of one row")
    check_size("CUR", rgba.shape[1], rgba.shape[0])
    return rgba
