"""SGI image (``.sgi``, ``.rgb``, ``.bw``) decoding with numpy, for
textures on hosts without Pillow.

``decode_sgi(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: verbatim and RLE data at 8 and 16 bits a sample; one channel
(grey, dimension 1 or 2), three (RGB) or four (RGBA) at dimension 3.
Rows are stored bottom-up, each channel in its own plane.  The RLE rows
run in C++ (native/src/codecs.cpp) when the native library is built;
``rle_rows_python`` is their plain twin.

Pillow's reading is kept with its quirks:

  * a 16-bit sample reads as its high byte;
  * RLE rows are placed by the offset and length tables; a row's length
    counts its packets, not its bytes (a length of 2**31 or more counts
    none, and the row keeps what it held), so a row stops at its zero count,
    at its length's last packet if that is not a zero count (which ends
    the image where it is: the rows above are black, transparent for
    RGBA), or where a run would pass the row's width (which refuses the
    file); a row that stops short keeps the pixels of the row below it
    past its end.

Where Pillow refuses a file this module raises ValueError naming SGI: two
channels (LA) and the other mode tuples Pillow lacks, a compression byte
other than 0 and 1 (no tile: Pillow cannot load the image), data that
ends early,
RLE tables or rows that point outside the file, a file above Pillow's
pixel limit.  A header that ends early or a side of 0 turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

MAGIC = 474
HEADER = 512
# (bytes a sample, dimension, channels) -> Pillow's mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}
OK, STOPPED, OVERRUN = 0, 1, 2  # rle_rows' statuses


def opens(blob: bytes) -> tuple[int, int, int, int, int]:
    """(compression, bytes a sample, width, height, channels)."""
    if len(blob) < 12:
        raise NotThisFormat("SGI header ends early")
    compression, bpc = blob[2], blob[3]
    dimension, w, h, z = struct.unpack_from(">4H", blob, 4)
    if (bpc, dimension, z) not in MODES:
        raise ValueError(f"unsupported SGI image mode ({bpc} bytes a sample, dimension "
                         f"{dimension}, {z} channels)")
    if w == 0 or h == 0:
        raise NotThisFormat("SGI image of no pixels")
    check_size("SGI", w, h)
    return compression, bpc, w, h, len(MODES[(bpc, dimension, z)])


def rle_rows_python(data: bytes, w: int, h: int, z: int, bpc: int) -> tuple[np.ndarray, int]:
    """Pillow's SGI RLE decoder on the file past its 512-byte header ->
    ((h, w * z * bpc) uint8 rows in file order, bottom-up, the channels
    interleaved; OK, STOPPED or OVERRUN)."""
    size = len(data)
    rows = np.zeros((h, w * z * bpc), np.uint8)
    if size < 8 * z * h:
        return rows, OVERRUN
    starts = struct.unpack_from(f">{z * h}I", data, 0)
    lengths = struct.unpack_from(f">{z * h}I", data, 4 * z * h)
    line = np.zeros((w, z, bpc), np.uint8)
    src_bytes = np.frombuffer(data, np.uint8)
    last = size - 1  # the decoder may read up to here
    for y in range(h):
        for c in range(z):
            start, length = starts[y + c * h], lengths[y + c * h]
            if start < HEADER:
                return rows, OVERRUN
            src, x = start - HEADER, 0
            for left in range(length if length < 1 << 31 else 0, 0, -1):  # a C int
                if src + bpc - 1 > last:
                    return rows, OVERRUN
                pixel = data[src + bpc - 1]
                src += bpc
                if left == 1 and pixel:
                    return rows, STOPPED
                count = pixel & 0x7F
                if not count:
                    break
                if x + count > w:
                    return rows, OVERRUN
                if pixel & 0x80:
                    if src + bpc * count > last:
                        return rows, OVERRUN
                    line[x:x + count, c] = src_bytes[src:src + bpc * count].reshape(count, bpc)
                    src += bpc * count
                else:
                    if src + bpc - 1 > last:
                        return rows, OVERRUN
                    line[x:x + count, c] = src_bytes[src:src + bpc]
                    src += bpc
                x += count
        rows[y] = line.reshape(-1)
    return rows, OK


def rle_rows(data: bytes, w: int, h: int, z: int, bpc: int) -> tuple[np.ndarray, int]:
    got = native.sgi_rle(data, w, h, z, bpc)
    return got if got is not None else rle_rows_python(data, w, h, z, bpc)


def decode_sgi(blob: bytes) -> np.ndarray:
    """SGI bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    compression, bpc, w, h, z = opens(blob)
    if compression == 0:
        page = w * h * bpc
        data = np.frombuffer(blob[HEADER:HEADER + z * page], np.uint8)
        if data.size < z * page:
            raise ValueError("SGI image data is too short (truncated file)")
        s = data.reshape(z, h, w, bpc)[..., 0].transpose(1, 2, 0)
    elif compression == 1:
        rows, status = rle_rows(blob[HEADER:], w, h, z, bpc)
        if status == OVERRUN:
            raise ValueError("SGI RLE table or row points outside the file")
        s = rows.reshape(h, w, z, bpc)[..., 0]
    else:
        raise ValueError(f"unsupported SGI (compression {compression}: cannot load this image)")
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = s[..., :3] if z >= 3 else s[..., :1]
    if z == 4:
        rgba[..., 3] = s[..., 3]
    return np.ascontiguousarray(rgba[::-1])
