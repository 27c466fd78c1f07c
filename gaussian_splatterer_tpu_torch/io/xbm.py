"""X11 bitmap (XBM) decoding with numpy, for textures on hosts without
Pillow.

``decode_xbm(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the ``#define`` header (width, height, an optional hot spot) and
the C array of hexadecimal bytes, each a row's 8 pixels, the lowest bit
first, a set bit white.

Pillow's reading is kept with its quirks:

  * the header is matched in the first 512 bytes, and the data start past
    the last ``_bits[]`` there;
  * Pillow's C decoder takes each ``x`` and the two characters after it
    as a byte, whatever they are (a character that is not a hexadecimal
    digit counts 0, so ``0x3,`` is 0x30), and skips everything else;
  * rows are ``ceil(W / 8)`` bytes.

Where Pillow refuses a file this module raises ValueError naming XBM:
data that ends before the last row ("image file is truncated"), a file
above Pillow's pixel limit.  A header that does not match, or a side of
0, turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - 48
for _c in b"abcdef":
    _HEX[_c] = _c - 87
    _HEX[_c - 32] = _c - 87


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def opens(blob: bytes) -> tuple[int, int, int]:
    """(width, height, where the data start)."""
    m = HEAD.match(blob[:512])
    if not m:
        raise NotThisFormat("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NotThisFormat("XBM image of no pixels")
    return w, h, m.end()


def decode_xbm(blob: bytes) -> np.ndarray:
    """XBM bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    w, h, start = opens(blob)
    check_size("XBM", w, h)
    line = (w + 7) // 8
    need = line * h
    data = np.frombuffer(blob, np.uint8)[start:]
    xs = np.flatnonzero(data == ord("x"))
    values = []
    pos = -1
    for x in xs:  # the decoder's SKIP state: the next 'x' past the last byte
        if x <= pos:
            continue
        if x + 2 >= len(data):
            break
        values.append(x)
        pos = x + 2
        if len(values) == need:
            break
    if len(values) < need:
        raise ValueError("XBM data ends before the last row (image file is truncated)")
    at = np.asarray(values)
    b = (_HEX[data[at + 1]] << 4) + _HEX[data[at + 2]]
    bits = np.unpackbits(b.astype(np.uint8).reshape(h, line), axis=1, bitorder="little")[:, :w]
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = (bits * 255)[..., None]
    return rgba
