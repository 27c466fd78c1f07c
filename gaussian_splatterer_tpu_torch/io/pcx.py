"""PCX (Paintbrush) decoding with numpy, for textures on hosts without
Pillow.

``decode_pcx(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: 1 bit a pixel in one plane (black and white), two or four 1-bit
planes through the header's 16-colour palette, 8 bits in one plane
(version 5) through the 256-colour palette that follows a 0x0C byte at the
file's end, and 24-bit RGB as three 8-bit planes (version 5); run-length
encoded.  The run-length loop runs in C++ (native/src/codecs.cpp) when the
native library is built; ``rle_lines_python`` is its plain twin.

Pillow's reading is kept with its quirks:

  * an 8-bit image whose trailing palette is the grey ramp (entry i is
    (i, i, i)), or that has none (no 0x0C 769 bytes from the end), reads
    as grey;
  * the line of each row is ``planes * stride`` bytes, where ``stride`` is
    the header's bytes a line when it equals ``(width * bits + 7) // 8``
    and that count rounded up to even otherwise; Pillow's decoder then
    moves the planes together: two or four 1-bit planes to ``(width + 7)
    // 8`` bytes apart, and 8-bit planes to ``width`` bytes apart when the
    line holds ``line // width`` planes of more than ``width`` bytes each
    (so a 3-pixel RGB line padded to 4 bytes a plane stays as it is, and
    its planes are read at 3-byte steps);
  * a run that passes the end of a line loses the bytes past it, and the
    file is refused once its last row is read.

Where Pillow refuses a file this module raises ValueError naming PCX: a
4-bit single plane, 2 bits a pixel and every other layout not listed
("unknown PCX mode"), an 8-bit image under 769 bytes long, a run past a
line's end, data that ends early, a file above Pillow's pixel limit.  A
bounding box of no pixels turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

HEADER = 128
OK, ENDS_EARLY, OVERRUN = 0, 1, 2  # rle_lines' statuses
_BITS = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}  # Pillow's unpackers


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def opens(blob: bytes, whole: bytes | None = None) -> dict:
    """PcxImageFile._open's header: the mode, size, planes, line bytes and
    palette (768 RGB bytes or None).  ``whole`` is the file when ``blob``
    is a page of it (a DCX page), whose 256-colour palette Pillow still
    seeks from the file's end."""
    whole = blob if whole is None else whole
    s = blob[:68]
    if not accept(s):
        raise NotThisFormat("not a PCX file")
    if len(s) < 16:
        raise NotThisFormat("PCX header ends early")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    if len(s) < 68:
        raise NotThisFormat("PCX header ends early")
    version, bits, planes = s[1], s[3], s[65]
    stride_given = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        raw = "1"
    elif bits == 1 and planes in (2, 4):
        raw, palette = f"P;{planes}L", s[16:64] + bytes(768 - 48)
    elif version == 5 and bits == 8 and planes == 1:
        raw = "L"
        if len(whole) < 769:
            raise ValueError("PCX file shorter than its 769-byte palette (invalid seek)")
        tail = whole[-769:]
        if tail[0] == 12 and tail[1:] != bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)):
            raw, palette = "P", tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        raw = "RGB;L"
    else:
        raise ValueError(f"unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    check_size("PCX", w, h)
    stride = (w * bits + 7) // 8
    if stride_given != stride:
        stride += stride % 2
    return {"raw": raw, "w": w, "h": h, "planes": planes, "line": planes * stride,
            "palette": palette}


def rle_lines_python(data: bytes, line: int, rows: int) -> tuple[np.ndarray, int]:
    """Pillow's PCX run-length decoder: ``rows`` lines of ``line`` bytes
    from ``data`` -> ((rows, line) uint8, OK, ENDS_EARLY or OVERRUN)."""
    out = np.zeros((rows, line), np.uint8)
    x = y = pos = 0
    n = len(data)
    overrun = False
    while y < rows:
        if pos >= n:
            return out, ENDS_EARLY
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 2 > n:
                return out, ENDS_EARLY
            count = b & 0x3F
            take = min(count, line - x)
            overrun |= take < count
            out[y, x:x + take] = data[pos + 1]
            x += take
            pos += 2
        else:
            out[y, x] = b
            x += 1
            pos += 1
        if x >= line:
            x, y = 0, y + 1
    return out, OVERRUN if overrun else OK


def rle_lines(data: bytes, line: int, rows: int) -> tuple[np.ndarray, int]:
    got = native.pcx_rle(data, line, rows)
    return got if got is not None else rle_lines_python(data, line, rows)


def decode_pcx(blob: bytes, whole: bytes | None = None) -> np.ndarray:
    """PCX bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture;
    ``whole`` as for ``opens``."""
    head = opens(blob, whole)
    raw, w, h, line = head["raw"], head["w"], head["h"], head["line"]
    if (w * _BITS[raw] + 7) // 8 > line:
        raise ValueError("PCX line shorter than its pixels (buffer overrun)")
    lines, status = rle_lines(blob[HEADER:], line, h)
    if status == ENDS_EARLY:
        raise ValueError("PCX image data is too short (truncated file)")
    if status == OVERRUN:
        raise ValueError("PCX run past the end of a line (buffer overrun)")
    bits = _BITS[raw]
    if bits in (2, 4):  # Pillow moves the planes of a padded line together
        size, bands, step = (w + 7) // 8, bits, line // bits
    else:
        size, bands = w, line // w
        step = line // bands if bands else 0
    if step > size:
        for i in range(1, bands):
            lines[:, i * size:(i + 1) * size] = lines[:, i * step:i * step + size].copy()
    rgba = np.full((h, w, 4), 255, np.uint8)
    if raw == "RGB;L":
        rgba[..., :3] = lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1)
        return rgba
    if raw in ("L", "P"):
        v = lines[:, :w].astype(np.int64)
    else:
        s = (w + 7) // 8
        planes = 1 if raw == "1" else head["planes"]
        v = np.zeros((h, w), np.int64)
        for p in range(planes):
            v |= np.unpackbits(lines[:, p * s:(p + 1) * s], axis=1)[:, :w].astype(np.int64) << p
        if raw == "1":
            v *= 255
    if head["palette"] is None:
        rgba[..., :3] = v[..., None]
    else:
        rgba[..., :3] = np.frombuffer(head["palette"], np.uint8).reshape(256, 3)[v]
    return rgba
