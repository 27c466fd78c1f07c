"""Sun raster (``.ras``) decoding with numpy, for textures on hosts without
Pillow.

``decode_sun(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: depths 1, 4, 8, 24 and 32; types 0, 1, 3, 4 and 5 (raw) and 2
(run-length encoded); a colour map of up to 256 RGB entries for depths 4
and 8.  The run-length loop runs in C++ (native/src/codecs.cpp) when the
native library is built; ``rle_rows_python`` is its plain twin.

Pillow's reading is kept with its quirks:

  * depth 1 is read inverted (a set bit black); depth 24 is BGR and depth
    32 BGRX, the pad byte last, except for type 3, whose pixels are RGB
    and RGBX;
  * the colour map is planar (its reds, its greens, then its blues) and
    holds a third of its length in entries; an index past them reads as
    the grey of its value; depths 1, 24 and 32 ignore no map: one there
    refuses the file;
  * raw rows are padded to 16 bits; run-length rows are not, and a run
    goes on into the next rows;
  * bytes past the last row are ignored.

Where Pillow refuses a file this module raises ValueError naming SUN: a
colour map on a depth other than 4 and 8, or of more than 256 entries,
data that ends early, a file above Pillow's pixel limit.  A header that
ends early, a depth, file type or map type Pillow does not read, a map
over 1024 bytes or a side of 0 turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

MAGIC = 0x59A66A95
OK, ENDS_EARLY = 0, 1  # rle_rows' statuses


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == MAGIC


def opens(blob: bytes) -> dict:
    """SunImageFile._open: mode, raw mode, size, tile kind and offset, the
    colour map's bytes or None."""
    s = blob[:32]
    if len(s) < 32:
        raise NotThisFormat("SUN header ends early")
    _, w, h, depth, _, file_type, map_type, map_length = struct.unpack(">8I", s)
    if depth == 1:
        mode, raw = "1", "1;I"
    elif depth == 4:
        mode, raw = "L", "L;4"
    elif depth == 8:
        mode, raw = "L", "L"
    elif depth in (24, 32):
        mode = "RGB"
        raw = ("RGB" if file_type == 3 else "BGR") + ("X" if depth == 32 else "")
    else:
        raise NotThisFormat("Unsupported Mode/Bit Depth")
    palette = None
    if map_length:
        if map_length > 1024:
            raise NotThisFormat("Unsupported Color Palette Length")
        if map_type != 1:
            raise NotThisFormat("Unsupported Palette Type")
        palette = blob[32:32 + map_length]
        if mode == "L":
            mode, raw = "P", raw.replace("L", "P")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("Unsupported Sun Raster file type")
    if w == 0 or h == 0:
        raise NotThisFormat("SUN image of no pixels")
    check_size("SUN", w, h)
    return {"mode": mode, "raw": raw, "w": w, "h": h, "depth": depth, "rle": file_type == 2,
            "offset": 32 + map_length, "palette": palette}


def rle_rows_python(data: bytes, line: int, rows: int) -> tuple[np.ndarray, int]:
    """Pillow's SunRleDecode: ``rows`` lines of ``line`` bytes from
    ``data`` -> ((rows, line) uint8, OK or ENDS_EARLY).  0x80 0 is a 0x80
    byte, 0x80 n v a run of n + 1 bytes v, which goes on into the next
    lines; any other byte is itself."""
    out = np.zeros(rows * line, np.uint8)
    total = rows * line
    pos = x = 0
    n = len(data)
    while x < total:
        if pos >= n:
            return out.reshape(rows, line), ENDS_EARLY
        b = data[pos]
        if b == 0x80:
            if pos + 1 >= n:
                return out.reshape(rows, line), ENDS_EARLY
            count = data[pos + 1]
            if count == 0:
                out[x] = 0x80
                x += 1
                pos += 2
                continue
            if pos + 2 >= n:
                return out.reshape(rows, line), ENDS_EARLY
            count += 1
            out[x:x + count] = data[pos + 2]
            x += count
            pos += 3
        else:
            out[x] = b
            x += 1
            pos += 1
    return out.reshape(rows, line), OK


def rle_rows(data: bytes, line: int, rows: int) -> tuple[np.ndarray, int]:
    got = native.sun_rle(data, line, rows)
    return got if got is not None else rle_rows_python(data, line, rows)


def _palette(data: bytes) -> np.ndarray:
    n = len(data) // 3
    if n > 256:
        raise ValueError("SUN colour map of more than 256 entries (invalid palette size)")
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if n:
        pal[:n] = np.frombuffer(data, np.uint8, 3 * n).reshape(3, n).T
    return pal


def decode_sun(blob: bytes) -> np.ndarray:
    """SUN bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    mode, raw, w, h, depth = head["mode"], head["raw"], head["w"], head["h"], head["depth"]
    if head["palette"] is not None and mode not in ("P", "L"):
        raise ValueError(f"SUN colour map on a {depth}-bit image (illegal image mode)")
    palette = _palette(head["palette"]) if mode == "P" else None
    line = rawmode.row_bytes(raw, w)
    if head["rle"]:
        rows, status = rle_rows(blob[head["offset"]:], line, h)
        if status != OK:
            raise ValueError("SUN run-length data is too short (image file is truncated)")
    else:
        stride = (w * depth + 15) // 16 * 2
        rows = rawmode.raw_rows(blob, head["offset"], h, line, stride, fmt="SUN")
    return rawmode.to_rgba(mode, rawmode.unpack(raw, rows, w), palette)
