"""Windows icon (ICO) decoding with numpy, for textures on hosts without
Pillow.

``decode_ico(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the entry Pillow picks, as a PNG (io/png.py) or as a bitmap
(io/bmp.py reads it as a DIB) with its AND mask.

Pillow's reading is kept with its quirks:

  * the entry read is the largest (width times height, a size byte of 0
    meaning 256), and of the largest the one of the least colour depth
    (the entry's bits a pixel, else the log2 of its colour count, else
    256), the first of those in the directory;
  * a PNG entry keeps its pixels and its alpha samples, but not its
    ``tRNS`` chunk: a palette, grey or RGB PNG entry is opaque;
  * a bitmap entry reads the top half of its bitmap's rows (the colour
    rows); below 32 bits a pixel (by the directory's count, not the
    bitmap's) the AND mask that ends the entry (the entry's offset plus
    its size, less the mask's bytes: rows padded to 32 bits, bottom-up)
    sets alpha 0 where its bit is 1 and 255 elsewhere; at 32 bits the
    fourth byte of each pixel is its alpha;
  * the picture's size is the entry's image's, whatever the directory
    says.

Where Pillow refuses a file this module raises ValueError naming the
fault: a bitmap or PNG that io/bmp.py or io/png.py refuses, a mask or
alpha plane that the file does not hold, a bitmap of one row, a file
above Pillow's pixel limit.  A directory of no entries or one that ends
early turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import decode_bitmap
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through
from gaussian_splatterer_tpu_torch.io.png import SIGNATURE as PNG_SIGNATURE
from gaussian_splatterer_tpu_torch.io.png import decode_png_rgba

SIGNATURE = b"\0\0\1\0"


def _open(blob: bytes) -> tuple[int, int, int]:
    """IcoFile's directory and choice of entry, with Pillow's exceptions ->
    (the entry's bits a pixel, byte size, offset)."""
    if not blob.startswith(SIGNATURE):
        raise SyntaxError("not an ICO file")
    entries = []
    for i in range(struct.unpack_from("<H", blob[:6], 4)[0]):
        s = blob[6 + 16 * i:22 + 16 * i]
        w, h, colours = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    return entries[0][2:]


def opens(blob: bytes) -> tuple[int, int, int]:
    """The entry Pillow picks; ``NotThisFormat`` where Pillow tries its
    next plugin."""
    return falls_through(_open, blob)


def decode_ico(blob: bytes) -> np.ndarray:
    """ICO bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    bpp, size, offset = opens(blob)
    if blob[offset:offset + 8] == PNG_SIGNATURE:
        rgba = decode_png_rgba(blob[offset:], trns=False)
    else:
        falls_through(lambda b: struct.unpack_from("<I", b[offset:offset + 4]), blob)
        rgba, start = decode_bitmap(blob, offset, 0, halve=True)
        h, w = rgba.shape[:2]
        if h == 0:
            raise ValueError("ICO bitmap of one row")
        if bpp == 32:
            alpha = np.frombuffer(blob[start:start + 4 * w * h], np.uint8)[3::4]
            if alpha.size < w * h:
                raise ValueError("ICO alpha plane is too short (buffer is not large enough)")
        else:
            stride = (w + 31) // 32 * 4
            at = offset + size - stride * h
            if at < 0:
                raise ValueError("ICO AND mask before the start of the file (negative seek)")
            mask = blob[at:at + stride * h]
            if len(mask) < (h - 1) * stride + (w + 7) // 8:
                raise ValueError("ICO AND mask is too short (not enough image data)")
            rows = np.frombuffer(mask + bytes(stride * h - len(mask)), np.uint8)
            bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
            alpha = np.where(bits, 0, 255).astype(np.uint8)
        rgba[..., 3] = alpha.reshape(h, w)[::-1]
    check_size("ICO", rgba.shape[1], rgba.shape[0])
    return rgba
