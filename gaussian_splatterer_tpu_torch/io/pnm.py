"""PNM (PBM, PGM, PPM) decoding with numpy, for textures on hosts without
Pillow.

``decode_pnm(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12).

Coverage: ``P1``-``P6``, plain (ASCII) and raw, with ``#`` comments in the
header and in plain data; maxval 1-65535; grey PFM (``Pf``, 32-bit floats
of either byte order); and Pillow's own extensions ``P0CMYK`` (CMYK),
``PyP`` (indices), ``PyRGBA`` and ``PyCMYK``, raw, maxval 1-65535.

Pillow's conversion is kept with its quirks:

  * a sample of maxval other than 255 scales as ``round(v / maxval * 255)``
    (half to even: 7 of 15 reads as 119), clipped at 255 where a raw sample
    exceeds maxval;
  * grey of maxval above 255 opens as Pillow's 32-bit ``I``, scaled to
    65535 the same way (or read as it is at maxval 65535), and converts by
    clipping at 255, not by scaling: 500 of 1000 reads as 255;
  * RGB of maxval above 255 scales its 16-bit samples to 8 bits;
  * in PBM, 1 is black;
  * a comment ends at a CR or LF, and glues the text on either side of it
    into one token;
  * a PFM's rows are stored bottom-up, little-endian when its scale is
    negative; the floats convert as Pillow's ``F`` to ``L``: truncated
    towards zero and clipped to [0, 255], not scaled (0.99 reads as 0,
    254.9 as 254, NaN as 0), whatever the scale;
  * CMYK converts as Pillow's ``cmyk2rgb`` (io/jpeg.py's ``cmyk_to_rgb``);
  * ``PyP`` carries no palette, so each of its pixels reads as opaque
    black.

Where Pillow refuses a file this module raises ValueError naming PNM: a
token of more than 10 characters, a maxval of 0 or above 65535, a PFM
scale of 0 or not finite, a plain value above maxval or not a number, a
plain PBM character other than 0 and 1, data that ends early.  A magic
number Pillow's PPM plugin does not list (``P7``, PAM, and ``PF``, colour
PFM, among them) turns the file away (``NotThisFormat``): no other plugin
of Pillow 12.1 takes it, so Pillow refuses it as an unidentified image.
"""

from __future__ import annotations

import math
import re

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import raw_rows
from gaussian_splatterer_tpu_torch.io.jpeg import cmyk_to_rgb
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

_WHITESPACE = b" \t\n\v\f\r"
_BANDS = {b"P1": 1, b"P2": 1, b"P3": 3, b"P4": 1, b"P5": 1, b"P6": 3, b"Pf": 1, b"P0CMYK": 4,
          b"PyP": 1, b"PyRGBA": 4, b"PyCMYK": 4}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == ord("P") and prefix[1] in b"0123456fy"


def _token(blob: bytes, pos: int) -> tuple[bytes, int]:
    """Pillow's header token from ``pos`` -> (token, position after the
    whitespace that ended it)."""
    token = b""
    while len(token) <= 10:
        if pos >= len(blob):
            break
        c = blob[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if token:
                break
        elif c == b"#":
            while pos < len(blob) and blob[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
        else:
            token += c
    if not token:
        raise ValueError("PNM header ends early (truncated file)")
    if len(token) > 10:
        raise ValueError(f"PNM header token too long: {token[:11]!r}")
    return token, pos


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"PNM header value {token!r} is not a number") from None


def _scale(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    return np.minimum(top, np.rint(v / maxval * top)).astype(np.int64)


def decode_pnm(blob: bytes) -> np.ndarray:
    """PNM bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    magic = b""
    pos = 0
    while pos < min(len(blob), 6):
        c = blob[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _BANDS:
        raise NotThisFormat(f"not a PPM file (magic {magic[:6]!r})")
    bands, plain, bilevel = _BANDS[magic], magic in (b"P1", b"P2", b"P3"), magic in (b"P1", b"P4")
    token, pos = _token(blob, pos)
    w = _int(token)
    token, pos = _token(blob, pos)
    h = _int(token)
    if magic == b"Pf":
        return _pfm(blob, pos, w, h)
    maxval = 1
    if not bilevel:
        token, pos = _token(blob, pos)
        maxval = _int(token)
        if not 0 < maxval < 65536:
            raise ValueError(f"PNM maxval {maxval} (1 to 65535)")
    if w <= 0 or h <= 0:
        raise NotThisFormat("PNM image of no pixels")
    check_size("PNM", w, h)
    wide = magic in (b"P2", b"P5") and maxval > 255  # Pillow's mode I
    need = w * h * bands
    if plain:
        text = blob[pos:]
        while True:  # Pillow drops each comment with the CR or LF that ends it
            start = text.find(b"#")
            if start < 0:
                break
            ends = [i for i in (text.find(b"\n", start), text.find(b"\r", start)) if i >= 0]
            text = text[:start] + (text[min(ends) + 1:] if ends else b"")
        if bilevel:
            chars = re.sub(rb"[ \t\n\v\f\r]", b"", text)
            if chars.strip(b"01"):
                raise ValueError("PNM plain PBM data holds characters other than 0 and 1")
            if len(chars) < need:
                raise ValueError("PNM image data is too short (not enough image data)")
            v = (np.frombuffer(chars[:need], np.uint8) == ord("0")).astype(np.int64) * 255
        else:
            tokens = text.split()[:need]
            if len(tokens) < need:
                raise ValueError("PNM image data is too short (not enough image data)")
            if any(len(t) > 10 for t in tokens):
                raise ValueError("PNM plain value too long")
            v = np.array([_int(t) for t in tokens], np.int64)
            if (v < 0).any() or (v > maxval).any():
                raise ValueError(f"PNM plain value outside 0-{maxval}")
            v = _scale(v, maxval, 65535 if wide else 255)
    elif bilevel:
        rows = raw_rows(blob, pos, h, (w + 7) // 8, 0, False, "PNM")
        v = (1 - np.unpackbits(rows, axis=1)[:, :w].astype(np.int64)) * 255
    else:
        size = 1 if maxval < 256 else 2
        rows = raw_rows(blob, pos, h, w * bands * size, 0, False, "PNM").astype(np.int64)
        v = rows if size == 1 else (rows[:, 0::2] << 8 | rows[:, 1::2])
        if maxval != 255 and not (wide and maxval == 65535):
            v = _scale(v, maxval, 65535 if wide else 255)
    v = np.minimum(np.asarray(v).reshape(h, w, bands), 255)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if magic in (b"P0CMYK", b"PyCMYK"):
        rgba[..., :3] = cmyk_to_rgb([255 - v[..., c] for c in range(4)], ycck=False)
    elif magic == b"PyRGBA":
        rgba[...] = v
    elif magic != b"PyP":  # PyP: no palette, every index reads as black
        rgba[..., :3] = v
    else:
        rgba[..., :3] = 0
    return rgba


def _pfm(blob: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """A grey PFM's scale and bottom-up float rows from ``pos``."""
    token, pos = _token(blob, pos)
    try:
        scale = float(token)
    except ValueError:
        raise ValueError(f"PFM scale {token!r} is not a number") from None
    if scale == 0.0 or not math.isfinite(scale):
        raise ValueError("PFM scale must be finite and non-zero")
    if w <= 0 or h <= 0:
        raise NotThisFormat("PFM image of no pixels")
    check_size("PNM", w, h)
    rows = raw_rows(blob, pos, h, 4 * w, 0, True, "PNM")
    with np.errstate(invalid="ignore"):  # signalling NaNs
        f = rows.view("<f4" if scale < 0 else ">f4").astype(np.float64)
    v = np.clip(np.trunc(np.nan_to_num(f, nan=0.0)), 0, 255)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = v.astype(np.uint8)[..., None]
    return rgba
