"""Kodak Photo CD (PCD) decoding with numpy, for textures on hosts without
Pillow.

``decode_pcd(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the 768 x 512 base image at ``96 * 2048`` (Pillow reads no
other resolution), its rows in pairs (two rows of luma, then a row of
half-width Cb and one of Cr shared by the pair), converted by Pillow's
PhotoYCC unpacker (``YCC;P``) as ``ycc_to_rgb`` sets out; turned a
quarter turn (``orientation`` 1: 90 degrees counter-clockwise, 3: 270)
as the header says.

Where Pillow refuses a file this module raises ValueError naming PCD:
image data that ends early.  A file without ``PCD_`` at byte 2048 or
whose header ends early turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat
from gaussian_splatterer_tpu_torch.io.rawmode import step_table

W, H = 768, 512
START = 96 * 2048


# The PhotoYCC tables of Pillow's ``YCC;P`` unpacker as it reads them: R =
# L[y] + CR[cr], G = L[y] + GR[cr] + GB[cb], B = L[y] + CB[cb], clipped to
# [0, 255]; L[y] is round(1.3584 y), the chroma tables run by steps of
# ``low`` plus each digit.
_L = np.round(1.3584 * np.arange(256)).astype(np.int64)
_CR = step_table(-249, 1, (
    "1111101111011111011111011110111110111101111101111101111011111011110111110111110111101"
    "1111011110111110111110111101111101111011111011111010110111110111110111101111101111011"
    "1110111110111101111101111011111011111011110111110111101111101111101111011111011110111"
))
_CB = step_table(-345, 1, (
    "1121112111121111211121111211121111211121111211112111211112111211112111121112111121112"
    "1111211112111211112111211112111211112111121112111121112111121111211121011211121111211"
    "1121112111121112111121111211121111211121111211121111211112111211112111211112111121112"
))
_GR = step_table(139, -1, (
    "0000001000000000000010000000000000100000000000010000000000000100000000000001000000000"
    "0001000000000000010000000000000100000000000001000000100000100000000000001000000000000"
    "0100000000000001000000000000100000000000001000000000000010000000000001000000000000010"
))
_GB = step_table(55, -1, (
    "1010110101011010101101010110101010110101011010101101010110101011010101101010110101011"
    "0101011010101101010110101011010101011010101101010110101011010101101010111101011010101"
    "1010101101010110101011010101011010101101010110101011010101101010110101011010101101010"
))


def opens(blob: bytes) -> int:
    """The orientation (0 to 3)."""
    s = blob[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise NotThisFormat("not a PCD file")
    if len(s) < 1539:
        raise NotThisFormat("PCD header ends early")
    return s[1538] & 3


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Pillow's ``YCC;P`` unpacker: PhotoYCC samples -> (..., 3) uint8."""
    y, cb, cr = (np.asarray(c, np.int64) for c in (y, cb, cr))
    lum = _L[y]
    rgb = np.stack([lum + _CR[cr], lum + _GR[cr] + _GB[cb], lum + _CB[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd(blob: bytes) -> np.ndarray:
    """PCD bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    orientation = opens(blob)
    pair = 3 * W
    data = np.frombuffer(blob[START:START + pair * (H // 2)], np.uint8)
    if data.size < pair * (H // 2):
        raise ValueError("PCD image data is too short (image file is truncated)")
    d = data.reshape(H // 2, pair)
    x = np.arange(W)
    y = d[:, :2 * W].reshape(H, W)
    cb = np.repeat(d[:, 2 * W + x // 2], 2, axis=0)
    cr = np.repeat(d[:, (5 * W) // 2 + x // 2], 2, axis=0)
    rgba = np.full((H, W, 4), 255, np.uint8)
    rgba[..., :3] = ycc_to_rgb(y, cb, cr)
    if orientation == 1:
        rgba = np.rot90(rgba, 1)
    elif orientation == 3:
        rgba = np.rot90(rgba, 3)
    return np.ascontiguousarray(rgba)
