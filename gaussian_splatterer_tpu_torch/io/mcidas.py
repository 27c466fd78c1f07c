"""McIdas area file decoding with numpy, for textures on hosts without
Pillow.

``decode_mcidas(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the 256-byte area directory (64 big-endian words) and one band
of 1, 2 or 4 bytes a pixel (grey, big-endian 16-bit grey, big-endian
32-bit integers), rows at the directory's offset and stride (a prefix of
``w[15]`` bytes, then ``w[10] * w[11] * w[14]`` bytes of pixels);
converted to RGBA as Pillow converts ``L``, ``I;16B`` and ``I`` (clipped
to [0, 255]).

Pillow's reading is kept with its quirks: the pixels of a row are read
from just past the row's prefix, the first row from ``w[34] + w[15]``;
Pillow maps the file of a 1- or 2-byte image whose rows it holds, so a
stride of 0 or below reads rows back to back and a stride shorter than a
row reads them overlapped, where its decoder (the 4-byte image's, or a
file too short to map) refuses a stride shorter than a row.

Where Pillow refuses a file this module raises ValueError naming McIdas:
a negative offset, data that ends early, a file above Pillow's pixel
limit.  A directory that ends early, a pixel size other than 1, 2 and 4,
or a side of 0 or below turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
MAPPED = ("L", "I;16B")  # modes Pillow reads by mapping the file (Image._MAPMODES)
MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def _open(blob: bytes) -> tuple[str, str, int, int, int, int]:
    s = blob[:256]
    if not s.startswith(MAGIC) or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0, *struct.unpack("!64i", s))
    if w[11] not in MODES:
        raise SyntaxError("unsupported McIdas format")
    if w[10] <= 0 or w[9] <= 0:
        raise SyntaxError("not identified by this driver")
    mode, raw = MODES[w[11]]
    return mode, raw, w[10], w[9], w[34] + w[15], w[15] + w[10] * w[11] * w[14]


def opens(blob: bytes) -> tuple[str, str, int, int, int, int]:
    """(mode, raw mode, width, height, offset, stride)."""
    return falls_through(_open, blob)


def decode_mcidas(blob: bytes) -> np.ndarray:
    """McIdas bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    mode, raw, w, h, offset, stride = opens(blob)
    check_size("McIdas", w, h)
    row = rawmode.row_bytes(raw, w)
    if mode in MAPPED and offset >= 0 and offset + h * stride <= len(blob):
        # Pillow maps the file: a stride of 0 or below is a row's bytes, and
        # a shorter one overlaps the rows
        step = stride if stride > 0 else row
        if offset + (h - 1) * step + row > len(blob):
            raise ValueError("McIdas image data is too short (buffer is not large enough)")
        buf = np.frombuffer(blob, np.uint8)
        rows = np.stack([buf[offset + y * step:offset + y * step + row] for y in range(h)])
    else:
        rows = rawmode.raw_rows(blob, offset, h, row, stride, fmt="McIdas")
    return rawmode.to_rgba(mode, rawmode.unpack(raw, rows, w))
