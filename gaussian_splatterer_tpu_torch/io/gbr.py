"""GIMP brush (GBR) decoding with numpy, for textures on hosts without
Pillow.

``decode_gbr(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: versions 1 and 2 (with the ``GIMP`` magic and spacing), one
byte a pixel (grey) or four (RGBA), the pixels after the header and its
comment.

Pillow's reading is kept with its quirks: the comment is the header's
size less 20 (version 1) or 28 (version 2) bytes, and a count of -1
reads to the end of the file, leaving no pixels (one below -1 refuses
the file); pixels past those the image needs are ignored.

Where Pillow refuses a file this module raises ValueError naming GBR:
pixel data that ends early, a file above Pillow's pixel limit.  A header
that ends early, a header size under 20, a version other than 1 and 2, a
side of 0, a depth other than 1 and 4 or a version 2 without its magic
turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20
            and struct.unpack_from(">I", prefix, 4)[0] in (1, 2))


def _open(blob: bytes) -> tuple[int, int, int, int]:
    """GbrImageFile._open with Pillow's exceptions -> (w, h, depth, where
    the pixels start)."""
    header, version, w, h, depth = (struct.unpack(">I", blob[o:o + 4])[0]
                                    for o in range(0, 20, 4))
    if header < 20:
        raise SyntaxError("not a GIMP brush")
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    if w == 0 or h == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    pos = 20
    if version == 1:
        comment = header - 20
    else:
        comment = header - 28
        if blob[20:24] != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        struct.unpack(">I", blob[24:28])
        pos = 28
    if comment < -1:
        raise ValueError("read length must be non-negative or -1")
    check_size("GBR", w, h)
    return w, h, depth, len(blob) if comment == -1 else min(len(blob), pos + comment)


def opens(blob: bytes) -> tuple[int, int, int, int]:
    return falls_through(_open, blob)


def decode_gbr(blob: bytes) -> np.ndarray:
    """GBR bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    w, h, depth, pos = opens(blob)
    data = blob[pos:pos + w * h * depth]
    if len(data) < w * h * depth:
        raise ValueError("GBR pixel data is too short (not enough image data)")
    v = np.frombuffer(data, np.uint8).reshape(h, w, depth)
    if depth == 4:
        return v.copy()
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = v
    return rgba
