"""PNG decoding with ``zlib`` and numpy, for textures on hosts without Pillow.

``decode_png_rgba(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12).

Coverage: every colour type at every bit depth the format allows it, grey
1/2/4/8/16, RGB 8/16, palette 1/2/4/8, grey+alpha 8/16 and RGBA 8/16; the
five row filters; Adam7 interlacing (seven passes, each with its own rows
and filters); ``PLTE``; ``tRNS`` as a palette alpha table, a grey key or an
RGB key.

Pillow's conversion is kept with its quirks:

  * grey at 1, 2 and 4 bits scales to 8 bits by 255, 85 and 17;
  * 16-bit grey opens as Pillow's ``I;16`` and converts by clipping at 255,
    not by scaling: 15,420 reads as 255;
  * 16-bit RGB, RGBA and grey+alpha keep each sample's high byte
    (0x12ff reads as 18);
  * a grey or RGB key is compared, by its low byte, with the 8-bit values
    after the conversions above (so a 16-bit RGB key 0x1234 keys the pixels
    whose high byte is 0x34, a 2-bit grey key other than 0 keys nothing, a
    16-bit grey key 300 keys the pixels of value 44); a 1-bit key keys 0 or,
    if it is not 0, 1;
  * a palette index past ``PLTE``'s entries, or any index of a palette
    image without ``PLTE``, reads as opaque black, or black under its
    ``tRNS`` alpha where the table reaches it; ``tRNS`` entries past the
    palette's end are opaque;
  * ``tRNS`` on grey+alpha or RGBA, and ``PLTE`` on a non-palette image,
    are ignored;
  * the CRCs of the chunks before the first ``IDAT`` are checked, those of
    the image data are not; the image data is the first run of ``IDAT``
    chunks, and bytes past its last row are ignored.

Where Pillow refuses a file this module raises ValueError naming PNG: a
colour type and bit depth outside the list above, a filter method other
than 0, a ``PLTE`` of more than 256 entries, a palette ``tRNS`` table of
more than 256 entries, a grey key of fewer than 2 bytes or an RGB key of
fewer than 6, a bad CRC before the image data, image data that ends early.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass
_GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
_SIMPLE_PALETTE = re.compile(b"^\xff*\x00\xff*$")  # one transparent entry, as Pillow reads it


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter(buf: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The first ``h * (stride + 1)`` bytes of ``buf``: ``h`` filtered rows
    -> (h, stride) uint8 raw rows; the native loop (native/src/codecs.cpp)
    where the library is built, else ``unfilter_python``."""
    got = native.png_unfilter(buf, h, stride, bpp)
    if got is None:
        return unfilter_python(buf, h, stride, bpp)
    rows, bad = got
    if bad >= 0:
        raise ValueError(f"unknown PNG filter type {bad}")
    return rows


def unfilter_python(buf: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain twin of ``unfilter``."""
    rows = buf[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            c, up = [0] * stride, prev.tolist()
            for x, v in enumerate(line.tolist()):
                left = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                c[x] = (v + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) raw rows -> (h, w, ch) int64 samples at their own depth."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.reshape(h, -1, 2).astype(np.int64)
        s = (s[..., 0] << 8) | s[..., 1]
    elif depth == 8:
        s = rows.astype(np.int64)
    else:  # packed, the leftmost sample in the high bits
        shifts = np.arange(8 - depth, -1, -depth)
        s = ((rows[..., None].astype(np.int64) >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return s[:, :w * ch].reshape(h, w, ch)


def _chunks(blob: bytes):
    """The chunks as (type, data) up to and including the first run of
    IDAT chunks, which comes as one ("IDAT", joined data); CRCs checked
    before it."""
    if blob[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat = 8, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        if kind == b"IDAT":
            idat.append(data)
        elif idat:
            break
        else:
            if not re.fullmatch(rb"\w{4}", kind):
                raise ValueError(f"broken PNG file (chunk {kind!r})")
            crc = blob[pos + 8 + length:pos + 12 + length]
            if len(data) < length or crc != struct.pack(">I", zlib.crc32(kind + data)):
                raise ValueError(f"broken PNG file (bad checksum in {kind.decode('latin-1')})")
            if kind == b"IEND":
                break
            yield kind, data
        pos += 12 + length
    if not idat:
        raise ValueError("PNG without image data (IDAT)")
    yield b"IDAT", b"".join(idat)


def _read(blob: bytes):
    """PNG bytes -> (samples (H, W, C) int64 at their own depth, colour
    type, bit depth, palette (256, 4) uint8 or None, tRNS bytes or None)."""
    header = plte = trns = raw = None
    for kind, data in _chunks(blob):
        if kind == b"IHDR":
            if len(data) < 13:
                raise ValueError("truncated PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"PLTE":
            plte = data
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            raw = data
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, method, interlace = header
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {ctype})")
    if method:
        raise ValueError(f"PNG with unknown filter method {method}")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    try:
        buf = np.frombuffer(zlib.decompressobj().decompress(raw), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"corrupt PNG image data ({exc})") from None
    out = np.zeros((h, w, ch), np.int64)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        size = ph * (stride + 1)
        if buf.size < pos + size:
            raise ValueError("PNG image data is too short (truncated file)")
        rows = unfilter(buf[pos:], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += size
    palette = None
    if ctype == 3:
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        plte = plte or b""
        n = len(plte) // 3
        if n > 256:
            raise ValueError(f"PNG palette of {n} entries (at most 256)")
        palette[:n, :3] = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)
    return out, ctype, depth, palette, trns


def _key(trns: bytes, n: int) -> list[int]:
    if len(trns) < 2 * n:
        raise ValueError(f"PNG tRNS key of {len(trns)} bytes (needs {2 * n})")
    return list(struct.unpack(f">{n}H", trns[:2 * n]))


def decode_png_rgba(blob: bytes, trns: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (rows top to bottom as stored),
    Pillow's ``convert("RGBA")`` of the file; ``trns=False`` ignores the
    ``tRNS`` chunk, as Pillow's ICO plugin does with a PNG entry."""
    s, ctype, depth, palette, key = _read(blob)
    trns = key if trns else None
    h, w, _ = s.shape
    if ctype == 3:
        if trns is not None:
            if _SIMPLE_PALETTE.match(trns):
                i = trns.find(b"\x00")
                if i >= 256:
                    raise ValueError(f"PNG tRNS index {i} out of the palette's range")
                palette[i, 3] = 0
            elif len(trns) > 256:
                raise ValueError(f"PNG tRNS table of {len(trns)} entries (at most 256)")
            else:
                palette[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        return palette[s[..., 0]]
    if ctype == 0:
        v8 = np.minimum(s, 255) if depth == 16 else s * _GREY_SCALE[depth]
    else:
        v8 = s >> 8 if depth == 16 else s  # the high byte
    rgba = np.full((h, w, 4), 255, np.uint8)
    if ctype in (0, 4):
        rgba[..., :3] = v8[..., :1]
    else:
        rgba[..., :3] = v8[..., :3]
    if ctype in (4, 6):
        rgba[..., 3] = v8[..., -1]
    elif trns is not None:
        if ctype == 0:
            key = _key(trns, 1)[0]
            key = [(255 if key else 0) if depth == 1 else key & 0xFF] * 3
        else:
            key = [k & 0xFF for k in _key(trns, 3)]
        rgba[(rgba[..., :3] == np.array(key, np.uint8)).all(axis=-1), 3] = 0
    return rgba


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 (rows top to bottom as stored),
    Pillow's ``convert("RGB")`` of the file."""
    return np.ascontiguousarray(decode_png_rgba(blob)[..., :3])
