"""PNM (PBM, PGM, PPM) decoding with numpy, for textures on hosts without
Pillow.

``decode_pnm(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12).

Coverage: ``P1``-``P6``, plain (ASCII) and raw, with ``#`` comments in the
header and in plain data; maxval 1-65535.

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
    into one token.

Where Pillow refuses a file this module raises ValueError naming PNM: a
token of more than 10 characters, a maxval of 0 or above 65535, a plain
value above maxval or not a number, a plain PBM character other than 0 and
1, data that ends early; ``P7`` (PAM) and ``Pf``/``PF`` (PFM) too.
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import raw_rows

_WHITESPACE = b" \t\n\v\f\r"
_BANDS = {b"P1": 1, b"P2": 1, b"P3": 3, b"P4": 1, b"P5": 1, b"P6": 3}
_REFUSED = {b"P7": "PAM (P7)", b"Pf": "PFM (Pf)", b"PF": "PFM (PF)"}


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
    if magic in _REFUSED:
        raise ValueError(f"unsupported PNM ({_REFUSED[magic]})")
    if magic not in _BANDS:
        raise ValueError(f"not a PNM file Pillow reads (magic {magic[:6]!r})")
    bands, plain, bilevel = _BANDS[magic], magic in (b"P1", b"P2", b"P3"), magic in (b"P1", b"P4")
    token, pos = _token(blob, pos)
    w = _int(token)
    token, pos = _token(blob, pos)
    h = _int(token)
    maxval = 1
    if not bilevel:
        token, pos = _token(blob, pos)
        maxval = _int(token)
        if not 0 < maxval < 65536:
            raise ValueError(f"PNM maxval {maxval} (1 to 65535)")
    wide = bands == 1 and maxval > 255  # Pillow's mode I
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
    v = np.asarray(v).reshape(h, w, bands)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = np.minimum(v, 255)
    return rgba
