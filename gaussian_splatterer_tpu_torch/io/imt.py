"""IM Tools (IMT) decoding with numpy, for textures on hosts without
Pillow.

``decode_imt(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the text header (``width n``, ``height n``, ``pixel n8``,
``*`` comments) up to its form feed (0x0C), then raw 8-bit grey.

Pillow's reading is kept with its quirks: the header is read in chunks of
100 bytes, a line of one character or of more than 100, or one that is
not ``key value``, ends it; the pixels start just past the form feed.

Where Pillow refuses a file this module raises ValueError naming IMT: a
header that ends without its form feed (Pillow's image has no data),
pixels that end early, a number Pillow cannot read, a file above
Pillow's pixel limit.  A first 100 bytes without a line feed, no
``pixel n8`` or a side of 0 or below turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _open(blob: bytes) -> tuple[int, int, int | None]:
    """ImtImageFile._open with Pillow's exceptions -> (width, height, where
    the pixels start or None)."""
    buffer, pos = blob[:100], min(100, len(blob))
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode, start = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = blob[pos:pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            start = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += blob[pos:pos + 100]
            pos = min(pos + 100, len(blob))
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return size[0], size[1], start


def opens(blob: bytes) -> tuple[int, int, int | None]:
    return falls_through(_open, blob)


def decode_imt(blob: bytes) -> np.ndarray:
    """IMT bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    w, h, start = opens(blob)
    check_size("IMT", w, h)
    if start is None:
        raise ValueError("IMT header without its form feed (the image has no data)")
    rows = rawmode.raw_rows(blob, start, h, w, fmt="IMT")
    return rawmode.to_rgba("L", rows)
