"""Apple icon (ICNS) decoding with numpy, for textures on hosts without
Pillow.

``decode_icns(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the icon Pillow picks: of the sizes whose elements the file
holds, the largest (``IcnsFile.bestsize``: by width, height, then scale),
read as a PNG (io/png.py) or a JPEG 2000 file (io/jpeg2000.py) where its
PNG or JPEG 2000 element is there, else as 24-bit RGB (``it32``, ``ih32``,
``il32``, ``is32``; raw or run-length encoded) with its 8-bit mask
(``t8mk``, ``h8mk``, ``l8mk``, ``s8mk``) as alpha.
The run-length loop runs in C++ (native/src/codecs.cpp) when the native
library is built; ``rle_channels_python`` is its plain twin.

Pillow's reading is kept with its quirks:

  * a PNG element is read as Pillow's PNG plugin opens it, past the
    element's end if its chunks go on, and its ``tRNS`` is dropped (the
    icon's ``info`` does not carry it over); its size must be one the
    file's sizes allow (``IcnsImageFile.size``), else the file is refused;
  * an RGB element is raw when its length is exactly three bytes a pixel,
    else each channel is run-length encoded in turn, reading on past the
    element's end if need be; a run that passes a channel's end refuses
    the file;
  * a JPEG 2000 element is the element's bytes read as a JPEG 2000 file,
    so one that starts with the short signature ``0D 0A 87 0A`` (which
    Pillow's ``read_png_or_jpeg2000`` takes and its JPEG 2000 plugin does
    not open) refuses the file;
  * without a mask the icon is opaque; ``it32`` starts with four zero
    bytes.

Where Pillow refuses a file this module raises ValueError naming ICNS: an
element of another kind, a channel or mask that ends early, a PNG
io/png.py refuses, a JPEG 2000 element io/jpeg2000.py refuses.  A header that
ends early, a block of length 0, or no icon element turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through
from gaussian_splatterer_tpu_torch.io import jpeg2000
from gaussian_splatterer_tpu_torch.io.png import decode_png_rgba

MAGIC = b"icns"
# (width, height, scale) -> the element kinds Pillow reads for it, in order
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
RGB_KINDS = (b"it32", b"ih32", b"il32", b"is32")
MASK_KINDS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")
OK, ENDS_EARLY, OVERRUN = 0, 1, 2  # rle_channels' statuses


def _open(blob: bytes) -> tuple[dict, list, tuple]:
    """IcnsFile's block walk and bestsize with Pillow's exceptions ->
    (kind -> (start, length), the sizes held, the best size)."""
    sig, filesize = struct.unpack(">4sI", blob[:8])
    if sig != MAGIC:
        raise SyntaxError("not an icns file")
    dct, i = {}, 8
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", blob[i:i + 8])
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        dct[sig] = (i, blocksize - 8)
        i += blocksize - 8
    sizes = [size for size, kinds in SIZES.items() if any(k in dct for k in kinds)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    return dct, sizes, max(sizes)


def opens(blob: bytes) -> tuple[dict, list, tuple]:
    return falls_through(_open, blob)


def rle_channels_python(data: bytes, pixels: int) -> tuple[np.ndarray, int]:
    """IcnsImagePlugin.read_32's run-length loop: three channels of
    ``pixels`` bytes from ``data`` -> ((3, pixels) uint8, OK, ENDS_EARLY
    where the file ends first or a read comes short, or OVERRUN where a
    run or a literal passes a channel's end)."""
    out = np.zeros((3, pixels), np.uint8)
    pos, n = 0, len(data)
    for band in range(3):
        x, left = 0, pixels
        while left > 0:
            if pos >= n:
                return out, ENDS_EARLY
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                if pos >= n:
                    return out, ENDS_EARLY
                out[band, x:x + count] = data[pos]
                pos += 1
            else:
                count = b + 1
                chunk = np.frombuffer(data[pos:pos + count], np.uint8)
                pos += len(chunk)
                out[band, x:x + len(chunk)] = chunk[:pixels - x]
                if len(chunk) < count:
                    return out, ENDS_EARLY
            x += count
            left -= count
        if left != 0:
            return out, OVERRUN
    return out, OK


def rle_channels(data: bytes, pixels: int) -> tuple[np.ndarray, int]:
    got = native.icns_rle(data, pixels)
    return got if got is not None else rle_channels_python(data, pixels)


def _rgb(blob: bytes, kind: bytes, start: int, length: int, side: int) -> np.ndarray:
    if kind == b"it32":
        if blob[start:start + 4] != bytes(4):
            raise ValueError("ICNS it32 element without its four zero bytes")
        start, length = start + 4, length - 4
    n = side * side
    if length == 3 * n:
        data = blob[start:start + length]
        if len(data) < length:
            raise ValueError("ICNS RGB element ends early (buffer is not large enough)")
        return np.frombuffer(data, np.uint8).reshape(side, side, 3)
    planes, status = rle_channels(blob[start:], n)
    if status != OK:
        raise ValueError("ICNS RGB channel ends early or a run passes its end "
                         "(Error reading channel)")
    return planes.reshape(3, side, side).transpose(1, 2, 0)


def _allowed(sizes: list, w: int, h: int) -> bool:
    """IcnsImageFile's size setter: whether Pillow takes (w, h)."""
    for size in sizes:
        sw, sh = size[0] * size[2], size[1] * size[2]
        if sh / h == sw // w:
            return True
    return False


def _jpeg2000(element: bytes) -> np.ndarray:
    """A JPEG 2000 element as ``read_png_or_jpeg2000`` reads it: the
    element's bytes opened as a JPEG 2000 file, where any refusal of
    ``_open`` (the short signature ``0D 0A 87 0A`` among them) refuses the
    icon, then Pillow's decompression-bomb check and ``convert("RGBA")``."""
    try:
        _, (w, h), _, _ = jpeg2000.opens(element)
    except jpeg2000.NotThisFormat as exc:
        raise ValueError(f"ICNS JPEG 2000 element: {exc}") from None
    check_size("ICNS JPEG 2000", w, h)
    return jpeg2000.decode_jpeg2000(element)


def decode_icns(blob: bytes) -> np.ndarray:
    """ICNS bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    dct, sizes, best = opens(blob)
    side = best[0] * best[2]
    rgb = mask = png = None
    for kind in SIZES[best]:
        if kind not in dct:
            continue
        start, length = dct[kind]
        if kind in RGB_KINDS:
            rgb = _rgb(blob, kind, start, length, side)
        elif kind in MASK_KINDS:
            data = blob[start:start + side * side]
            if len(data) < side * side:
                raise ValueError("ICNS mask ends early (buffer is not large enough)")
            mask = np.frombuffer(data, np.uint8).reshape(side, side)
        else:
            sig = blob[start:start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                png = decode_png_rgba(blob[start:], trns=False)
                check_size("ICNS PNG", png.shape[1], png.shape[0])
            elif (sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a"))
                  or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"):
                png = _jpeg2000(blob[start:start + length])
            else:
                raise ValueError("Unsupported icon subimage format (ICNS)")
    if png is not None:
        out = png
    elif rgb is None:
        raise ValueError("ICNS mask without its RGB element (KeyError: 'RGB')")
    else:
        out = np.full((side, side, 4), 255, np.uint8)
        out[..., :3] = rgb
        if mask is not None:
            out[..., 3] = mask
    h, w = out.shape[:2]
    if w == 0 or h == 0:
        raise ValueError("ICNS icon of no pixels (division by zero)")
    if not _allowed(sizes, w, h):
        raise ValueError("ICNS icon of a size the file does not allow (This is not one of "
                         "the allowed sizes of this image)")
    return out
