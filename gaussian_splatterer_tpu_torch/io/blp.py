"""Blizzard texture (BLP1, BLP2) decoding with numpy, for textures on hosts
without Pillow.

``decode_blp(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: BLP1 as JPEG (the shared header joined to the first mipmap,
io/jpeg.py) or as 256-colour palette indices (encodings 4 and 5); BLP2
as palette indices or as DXT1, DXT3 and DXT5 blocks; the first mipmap.

Pillow's reading is kept with its quirks:

  * the image is RGBA when the header's alpha field is not 0, else RGB
    (opaque), whatever the encoding;
  * Pillow decodes BLP's DXT blocks in Python, not as DDS's are: a 5- or
    6-bit colour is shifted up without its high bits repeated, the
    in-between colours of DXT3 and DXT5 are always the four-colour ones,
    and every mean is floored;
  * the blocks of a row of 4 x 4 blocks are written row after row of
    ``4 * ceil(W / 4)`` pixels, which Pillow then reads as rows of ``W``
    pixels: a width that is not a multiple of 4 shears the picture;
  * a palette index takes the palette entry's alpha (BGRA) when the image
    is RGBA; BLP1's indices are read from just past the palette, not from
    the mipmap's offset;
  * BLP1's JPEG is decoded to RGB and its bytes read as BGR, so red and
    blue swap; a JPEG's pixels are read at the BLP's width;
  * pixels past those the image needs are dropped.

Where Pillow refuses a file this module raises ValueError naming BLP:
encoding 3 (raw BGRA) and every encoding, compression and alpha encoding
not listed (Pillow's ``BLPFormatError``), data that ends early or gives
fewer pixels than the image needs, a JPEG io/jpeg.py refuses, a file
above Pillow's pixel limit.  A header that ends early or a side of 0
turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through


def _open(blob: bytes) -> dict:
    """BlpImageFile._open with Pillow's exceptions."""
    magic = blob[:4]
    compression = struct.unpack("<i", blob[4:8])[0]
    if magic == b"BLP1":
        alpha = struct.unpack("<I", blob[8:12])[0] != 0
        w, h = struct.unpack("<II", blob[12:20])
        encoding = struct.unpack("<i", blob[20:24])[0]
        alpha_encoding, offset = None, 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack("<bbb", blob[8:11])
        alpha = alpha != 0
        w, h = struct.unpack("<II", blob[12:20])
        offset = 20
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return {"magic": magic, "compression": compression, "encoding": encoding, "alpha": alpha,
            "alpha_encoding": alpha_encoding, "w": w, "h": h, "offset": offset}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


class _Reader:
    """The decoder's file position and ``ImageFile._safe_read``."""

    def __init__(self, blob: bytes, pos: int):
        self.blob, self.pos = blob, pos

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        data = self.blob[self.pos:self.pos + n]
        if len(data) < n:
            raise ValueError("BLP data ends early (truncated file read)")
        self.pos += n
        return data


def _palette(r: _Reader) -> np.ndarray:
    return np.frombuffer(r.read(1024), np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]


def _indexed(r: _Reader, length: int, palette: np.ndarray, alpha: bool) -> np.ndarray:
    idx = np.frombuffer(r.read(length), np.uint8)
    return palette[idx][:, :4 if alpha else 3]


def unpack_565(c: np.ndarray) -> np.ndarray:
    """(..., ) 16-bit colours -> (..., 3) int64, Pillow's BLP unpack_565
    (shifted, no bit replication)."""
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], axis=-1)


def _colours(b: np.ndarray, four: np.ndarray) -> np.ndarray:
    """(N, 8) colour halves -> (N, 4, 4) int64 RGBA of the four codes."""
    c0 = b[:, 0] | b[:, 1] << 8
    c1 = b[:, 2] | b[:, 3] << 8
    e0, e1 = unpack_565(c0), unpack_565(c1)
    f = four[:, None]
    p = np.zeros((len(b), 4, 4), np.int64)
    p[:, 0, :3], p[:, 1, :3] = e0, e1
    p[:, 2, :3] = np.where(f, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p[:, 3, :3] = np.where(f, (2 * e1 + e0) // 3, 0)
    p[..., 3] = 255
    p[:, 3, 3] = np.where(four, 255, 0)
    return p


def _codes(b: np.ndarray) -> np.ndarray:
    lut = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24
    return (lut[:, None] >> (2 * np.arange(16))) & 3


def dxt_blocks(blocks: np.ndarray, kind: str) -> np.ndarray:
    """(N, 8 or 16) uint8 blocks -> (N, 16, 4) int64 RGBA texels, as
    BlpImagePlugin's decode_dxt1/3/5 give them."""
    b = blocks.astype(np.int64)
    if kind == "dxt1":
        c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8
        p = _colours(b, c0 > c1)
        return np.take_along_axis(p, _codes(b)[..., None], axis=1)
    p = _colours(b[:, 8:], np.ones(len(b), bool))
    out = np.take_along_axis(p, _codes(b[:, 8:])[..., None], axis=1)
    if kind == "dxt3":
        nib = (b[:, :8, None] >> np.array([0, 4])) & 0xF
        out[..., 3] = nib.reshape(len(b), 16) * 17
        return out
    a0, a1 = b[:, 0:1], b[:, 1:2]
    lut = sum(b[:, 2 + k] << (8 * k) for k in range(6))
    code = (lut[:, None] >> (3 * np.arange(16))) & 7
    gt = a0 > a1
    mixed7 = ((8 - code) * a0 + (code - 1) * a1) // 7
    mixed5 = ((6 - code) * a0 + (code - 1) * a1) // 5
    a = np.where(gt, mixed7, np.where(code == 6, 0, np.where(code == 7, 255, mixed5)))
    a = np.where(code == 0, a0, np.where(code == 1, a1, a))
    out[..., 3] = a
    return out


def _dxt(r: _Reader, w: int, h: int, kind: str, alpha: bool) -> np.ndarray:
    size = 8 if kind == "dxt1" else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(r.read(bw * bh * size), np.uint8).reshape(bh * bw, size)
    px = dxt_blocks(blocks, kind).reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    px = px.reshape(-1, 4).astype(np.uint8)
    return px if alpha or kind != "dxt1" else px[:, :3]


def _jpeg(r: _Reader) -> np.ndarray:
    """BLP1's JPEG: the shared header, then the first mipmap -> Pillow's
    ``convert("RGB")`` bytes as (N, 3), in the BGR order Pillow reads
    them."""
    head = r.read(struct.unpack("<I", r.read(4))[0])
    r.read(r.offsets[0] - r.pos)
    rgb = decode_jpeg(head + r.read(r.lengths[0]), cmyk=True)[..., :3]
    check_size("BLP JPEG", rgb.shape[1], rgb.shape[0])
    return rgb.reshape(-1, 3)


def decode_blp(blob: bytes) -> np.ndarray:
    """BLP bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    w, h, alpha = head["w"], head["h"], head["alpha"]
    check_size("BLP", w, h)
    r = _Reader(blob, head["offset"])
    try:
        r.offsets = struct.unpack("<16I", r.read(64))
        r.lengths = struct.unpack("<16I", r.read(64))
    except ValueError:
        raise ValueError("BLP header ends early (truncated BLP file)") from None
    comp, enc = head["compression"], head["encoding"]
    if head["magic"] == b"BLP1":
        if comp == 0:
            px = _jpeg(r)
        elif comp == 1 and enc in (4, 5):
            px = _indexed(r, r.lengths[0], _palette(r), alpha)
        else:
            raise ValueError(f"unsupported BLP1 (compression {comp}, encoding {enc})")
    else:
        palette = _palette(r)
        r.pos = r.offsets[0]
        kinds = {0: "dxt1", 1: "dxt3", 7: "dxt5"}
        if comp != 1:
            raise ValueError(f"unknown BLP compression {comp}")
        if enc == 1:
            px = _indexed(r, r.lengths[0], palette, alpha)
        elif enc == 2 and head["alpha_encoding"] in kinds:
            px = _dxt(r, w, h, kinds[head["alpha_encoding"]], alpha)
        elif enc == 2:
            raise ValueError(f"unsupported BLP alpha encoding {head['alpha_encoding']}")
        else:
            raise ValueError(f"unknown BLP encoding {enc}")
    jpeg = comp == 0 and head["magic"] == b"BLP1"
    raw = 3 if jpeg or not alpha else 4  # bytes a pixel of Pillow's raw mode
    flat = px.reshape(-1)
    if flat.size < w * h * raw:
        raise ValueError("BLP image data is too short (not enough image data)")
    v = flat[:w * h * raw].reshape(h, w, raw)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :raw] = v[..., ::-1] if jpeg else v  # a JPEG's RGB bytes read as BGR
    return rgba
