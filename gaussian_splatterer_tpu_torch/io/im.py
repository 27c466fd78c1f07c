"""IFUNC Image Memory (IM) decoding with numpy, for textures on hosts
without Pillow.

``decode_im(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the ``Key: value`` header up to its 0x1A byte, then the first
image, in every ``Image type`` of ``ImImagePlugin.OPEN`` that Pillow
reads: black and white, grey, 2- and 4-bit palette indices, RGB
(interleaved, line-interleaved ``;L`` or planar ``RGB3``/``RYB3``), RGBA,
RGBX, LA, PA, CMYK and YCC line-interleaved, 16-bit grey (little- or
big-endian), 32-bit integers and the ``F`` images of 8 to 32 bits (packed
by Pillow's ``bit`` decoder where the width is not 8, 16 or 32), each
converted to RGBA as Pillow converts its mode (io/rawmode.py); the
``Lut`` palette after the header.

Pillow's reading is kept with its quirks:

  * rows are stored bottom-up;
  * a ``Lut`` that is not a grey ramp turns a grey image into a palette
    image and LA into PA (planar RGB, ``RGB;L``); a grey one that is not
    linear is kept aside and not applied, nor is the ``Lut`` of an RGB
    image;
  * ``RGB3``/``RYB3`` planes are green, red, blue in that order;
  * an image type that is not in ``OPEN`` becomes the mode as written,
    read with the raw mode of the type before it (grey by default);
  * a palette image without a palette reads its indices through a black
    palette; bytes past the image are ignored.

Where Pillow refuses a file this module raises ValueError naming IM: an
image type whose raw mode Pillow lacks (``RLB``, ``RYB``, ``PA`` without
a ``Lut``), a mode it cannot make, a size that is not two integers, a
number in the header Pillow cannot read, data that ends early, a file
above Pillow's pixel limit.  A header Pillow does not take as IM, a mode
left empty, a side of 0 or below, or a ``Lut`` that ends early turns the
file away (``NotThisFormat``).
"""

from __future__ import annotations

import io
import re

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
COMMENT, FRAMES, LUT, SCALE, SIZE, MODE = ("Comment", "File size (no of images)", "Lut",
                                           "Scale (x,y)", "Image size (x*y)", "Image type")
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _open(blob: bytes) -> dict:
    """ImImageFile._open with Pillow's exceptions."""
    fp = io.BytesIO(blob)
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    raw = "L"
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, raw = OPEN[v]
        info[k] = v
        n += k in TAGS
    if not n:
        raise SyntaxError("Not an IM file")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if LUT in info:
        lut = fp.read(768)
        grey = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        linear = grey and all(lut[i] == i for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = raw = "P"
            else:
                mode, raw = "PA", "PA;L"
            palette = lut
        del linear  # Pillow keeps a grey Lut aside and never applies it
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return {"mode": mode, "raw": raw, "size": size, "palette": palette, "offset": fp.tell()}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


def _bit_rows(blob: bytes, offset: int, w: int, h: int, bits: int) -> np.ndarray:
    """Pillow's ``bit`` decoder (fill 3, pad 8, unsigned): each row's
    ``bits``-bit samples, lowest bit first, rows byte-aligned, bottom-up.
    At a new row the decoder drops its bit count but not its buffer, so
    the unused high bits of a row's last byte are OR-ed into the low bits
    of the next row's first byte."""
    line = (w * bits + 7) // 8
    rows = rawmode.raw_rows(blob, offset, h, line, fmt="IM")
    spare = 8 * line - w * bits
    if spare:
        for y in range(1, h):  # in file order
            rows[y, 0] |= rows[y - 1, line - 1] >> (8 - spare)
    rows = rows[::-1]
    b = np.unpackbits(rows, axis=1, bitorder="little")[:, :w * bits].reshape(h, w, bits)
    return (b.astype(np.int64) << np.arange(bits)).sum(axis=2).astype(np.float32)


def decode_im(blob: bytes) -> np.ndarray:
    """IM bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    mode, raw, size, offset = head["mode"], head["raw"], head["size"], head["offset"]
    if not (isinstance(size, tuple) and len(size) == 2 and all(type(v) is int for v in size)):
        raise ValueError(f"IM image size {size!r} is not two integers")
    w, h = size
    check_size("IM", w, h)
    palette = None
    if mode in ("P", "PA"):
        palette = np.zeros((256, 3), np.uint8)
        if head["palette"] is not None:
            palette[:] = np.frombuffer(head["palette"], np.uint8).reshape(3, 256).T
    if raw.startswith("F;") and raw[2:].isdigit() and int(raw[2:]) not in (8, 16, 32):
        bits = int(raw[2:])
        if mode != "F" or not 1 <= bits < 32:
            raise ValueError(f"IM bit decoder for mode {mode!r} at {bits} bits")
        return rawmode.to_rgba("F", _bit_rows(blob, offset, w, h, bits))
    if raw in ("RGB;T", "RYB;T"):
        if mode != "RGB":
            raise ValueError(f"IM planes into mode {mode!r} (unknown raw mode)")
        planes = [rawmode.raw_rows(blob, offset + i * w * h, h, w, bottom_up=True, fmt="IM")
                  for i in range(3)]
        return rawmode.to_rgba("RGB", np.stack([planes[1], planes[0], planes[2]], axis=-1))
    if raw not in rawmode.PAIRS.get(mode, ()):
        raise ValueError(f"IM image of mode {mode!r}, raw mode {raw!r} (unknown raw mode)")
    rows = rawmode.raw_rows(blob, offset, h, rawmode.row_bytes(raw, w), bottom_up=True,
                            fmt="IM")
    return rawmode.to_rgba(mode, rawmode.unpack(raw, rows, w), palette)
