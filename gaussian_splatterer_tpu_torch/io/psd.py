"""Photoshop PSD decoding with numpy, for textures on hosts without Pillow.

``decode_psd(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1):
the merged image of the image-data section, which Pillow opens as the
file's first frame whatever layers the file holds.

Coverage: 8-bit grey, duotone and multichannel (read as grey), indexed,
RGB, CMYK and LAB, and 1-bit bitmap; raw or PackBits (RLE) image data, with
its per-row byte counts.  The PackBits rows run in C++ (native/src/
codecs.cpp) when the native library is built; ``packbits_rows_python`` is
their plain twin.

Pillow's reading is kept with its quirks:

  * RGB with exactly four channels reads as RGBA; channels past the
    mode's (a fifth RGB channel, a second grey one, a fifth CMYK one) are
    ignored;
  * CMYK channels are stored inverted and convert to RGB as Pillow's
    ``cmyk2rgb`` (io/jpeg.py's ``cmyk_to_rgb``);
  * a bitmap pixel of 1 reads as white;
  * LAB converts through io/lab.py (littleCMS's transform, the stored
    channels as it is handed them) and reads alpha 0: the fourth byte of
    Pillow's pixel, which its band unpackers leave unset;
  * an indexed image reads its colours from a 768-byte colour-mode section
    (256 reds, then greens, then blues); without one every pixel is black;
  * the per-row byte counts only place each channel's data: the PackBits
    packets run on from row to row, and a packet that runs past the end
    of a row loses the bytes past it.

Where Pillow refuses a file this module raises ValueError naming PSD:
fewer channels than the mode needs, image data compressed other than raw
or PackBits (ZIP; Pillow makes no tile of it and cannot load the image),
image data that ends early, a file
above Pillow's pixel limit.  A version other than 1, 16- and 32-bit channels and
any mode Pillow lacks turn the file away (``NotThisFormat``): Pillow then
tries its other plugins, and no other takes a PSD.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.jpeg import cmyk_to_rgb
from gaussian_splatterer_tpu_torch.io.lab import lab_to_rgb
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

SIGNATURE = b"8BPS"
# (Photoshop colour mode, bits a channel) -> (Pillow's mode, channels it needs)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


def _u16(b: bytes) -> int:
    return struct.unpack(">H", b[:2])[0]


def _u32(b: bytes) -> int:
    return struct.unpack(">I", b[:4])[0]


def _open(blob: bytes) -> dict:
    """PsdImageFile._open's reading, with Pillow's exceptions."""
    fp = io.BytesIO(blob)
    read = fp.read
    s = read(26)
    if not s.startswith(SIGNATURE) or _u16(s[4:6]) != 1:
        raise SyntaxError("not a PSD file")
    bits, channels, psd_mode = _u16(s[22:24]), _u16(s[12:14]), _u16(s[24:26])
    mode, need = MODES[(psd_mode, bits)]
    if need > channels:
        raise OSError(f"not enough channels ({channels} for {mode})")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    w, h = _u32(s[18:22]), _u32(s[14:18])
    palette = None
    size = _u32(read(4))
    if size:
        data = read(size)
        if mode == "P" and size == 768:
            palette = data
    size = _u32(read(4))  # image resources
    if size:
        end = fp.tell() + size
        while fp.tell() < end:
            read(4)
            _u16(read(2))
            name = read(read(1)[0])
            if not len(name) & 1:
                read(1)
            data = read(_u32(read(4)))
            if len(data) & 1:
                read(1)
    size = _u32(read(4))  # layer and mask information
    if size:
        end = fp.tell() + size
        _u32(read(4))
        fp.seek(end)
    compression = _u16(read(2))
    offsets = []
    offset = fp.tell()
    if compression == 0:
        offsets = [offset + c * w * h for c in range(need)]
    elif compression == 1:
        counts = read(need * h * 2)
        offset = fp.tell()
        for c in range(need):
            offsets.append(offset)
            offset += sum(struct.unpack_from(f">{h}H", counts, 2 * c * h)) if h else 0
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return {"mode": mode, "w": w, "h": h, "palette": palette, "compression": compression,
            "offsets": offsets}


def opens(blob: bytes) -> dict:
    """The header as Pillow reads it; ``NotThisFormat`` where Pillow tries
    its next plugin, ValueError where it refuses the file."""
    head = falls_through(_open, blob)
    check_size("PSD", head["w"], head["h"])
    return head


def packbits_rows_python(data: bytes, row: int, rows: int) -> tuple[np.ndarray, int]:
    """Pillow's PackBits decoder: ``rows`` rows of ``row`` bytes from
    ``data`` -> ((rows, row) uint8, the rows completed before the data
    ran out).  A packet that runs past a row's end loses the bytes past
    it; 128 is a no-op."""
    out = np.zeros((rows, row), np.uint8)
    x = y = pos = 0
    n = len(data)
    while y < rows and pos < n:
        b = data[pos]
        if b == 128:
            pos += 1
            continue
        if b > 128:
            if pos + 2 > n:
                break
            take = min(257 - b, row - x)
            out[y, x:x + take] = data[pos + 1]
            pos += 2
        else:
            if pos + b + 2 > n:
                break
            take = min(b + 1, row - x)
            out[y, x:x + take] = np.frombuffer(data, np.uint8, take, pos + 1)
            pos += b + 2
        x += take
        if x >= row:
            x, y = 0, y + 1
    return out, y


def packbits_rows(data: bytes, row: int, rows: int) -> tuple[np.ndarray, int]:
    got = native.packbits_rows(data, row, rows)
    return got if got is not None else packbits_rows_python(data, row, rows)


def decode_psd(blob: bytes) -> np.ndarray:
    """PSD bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    mode, w, h = head["mode"], head["w"], head["h"]
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    for offset in head["offsets"]:
        if head["compression"] == 0:
            data = np.frombuffer(blob[offset:offset + h * row], np.uint8)
            if data.size < h * row:
                raise ValueError("PSD image data is too short (truncated file)")
            plane, done = data.reshape(h, row), h
        else:
            plane, done = packbits_rows(blob[offset:], row, h)
        if done < h:
            raise ValueError("PSD PackBits image data is too short (truncated file)")
        planes.append(plane)
    if not planes:
        raise ValueError(f"unsupported PSD (image data compression {head['compression']}: "
                         "cannot load this image)")
    rgba = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        rgba[..., :3] = (np.unpackbits(planes[0], axis=1)[:, :w] * 255)[..., None]
    elif mode == "L":
        rgba[..., :3] = planes[0][..., None]
    elif mode == "P":
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        if head["palette"] is not None:
            table[:, :3] = np.frombuffer(head["palette"], np.uint8).reshape(3, 256).T
        rgba = table[planes[0]]
    elif mode == "CMYK":
        rgba[..., :3] = cmyk_to_rgb(planes[:4], ycck=False)
    elif mode == "LAB":  # the stored channels, through littleCMS's transform; alpha is
        # the fourth byte of Pillow's pixel, which its band unpackers leave 0
        rgba[..., :3] = lab_to_rgb(np.stack(planes[:3], axis=-1))
        rgba[..., 3] = 0
    else:
        for c, plane in enumerate(planes):
            rgba[..., c] = plane
    return rgba
