"""QOI ("Quite OK Image") decoding, for textures on hosts without Pillow.

``decode_qoi(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: three and four channels; the whole op set (INDEX, DIFF, LUMA,
RUN, RGB, RGBA).  The op loop is byte-serial: it runs in C++ (native/src/
codecs.cpp) when the native library is built, and ``decode_ops_python``
is its plain twin.

Pillow's reading is kept with its quirks:

  * a channel count other than 3 reads as four channels;
  * the colour space byte and the end marker are ignored, and so are the
    pixels of a run past the image's last pixel;
  * an INDEX op into a slot no pixel filled reads (0, 0, 0, 0); a run
    leaves the slots as they are; a three-channel image keeps the alpha
    of each pixel in its slots (255, or what an RGBA op gave).

Where Pillow refuses a file this module raises ValueError naming QOI: ops
that end before the image's last pixel, a file above Pillow's pixel limit.
A width or height of 0 and a header that ends early turn the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

SIGNATURE = b"qoif"
OK, ENDS_EARLY = 0, 1  # decode_ops' statuses


def opens(blob: bytes) -> tuple[int, int, int]:
    """(width, height, channels as Pillow reads them: 3 or 4)."""
    if len(blob) < 13:
        raise NotThisFormat("QOI header ends early")
    w, h = struct.unpack_from(">II", blob, 4)
    if w == 0 or h == 0:
        raise NotThisFormat("QOI image of no pixels")
    check_size("QOI", w, h)
    return w, h, 3 if blob[12] == 3 else 4


def decode_ops_python(data: bytes, pixels: int, channels: int) -> tuple[np.ndarray, int]:
    """The ops in ``data`` -> ((pixels, channels) uint8, OK or ENDS_EARLY)."""
    out = bytearray()
    slots: dict[int, bytes] = {}
    prev = b"\x00\x00\x00\xff"
    need, pos, n = pixels * channels, 0, len(data)

    def result(status: int) -> tuple[np.ndarray, int]:
        flat = bytes(out[:need]) + bytes(max(0, need - len(out)))
        return np.frombuffer(flat, np.uint8).reshape(pixels, channels), status

    while len(out) < need:
        if pos >= n:
            return result(ENDS_EARLY)
        b = data[pos]
        pos += 1
        if b == 0xFE:
            px = data[pos:pos + 3] + prev[3:]
            pos += 3
        elif b == 0xFF:
            px = data[pos:pos + 4]
            pos += 4
        elif b >> 6 == 0:
            px = slots.get(b, b"\x00\x00\x00\x00")
        elif b >> 6 == 1:
            px = bytes(((prev[0] + (b >> 4 & 3) - 2) & 255, (prev[1] + (b >> 2 & 3) - 2) & 255,
                        (prev[2] + (b & 3) - 2) & 255, prev[3]))
        elif b >> 6 == 2:
            if pos >= n:
                return result(ENDS_EARLY)
            dg, second = (b & 63) - 32, data[pos]
            pos += 1
            px = bytes(((prev[0] + dg + (second >> 4) - 8) & 255, (prev[1] + dg) & 255,
                        (prev[2] + dg + (second & 15) - 8) & 255, prev[3]))
        else:
            out += prev[:channels] * ((b & 63) + 1)
            continue
        if len(px) < 4:
            return result(ENDS_EARLY)
        slots[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        prev = px
        out += px[:channels]
    return result(OK)


def decode_ops(data: bytes, pixels: int, channels: int) -> tuple[np.ndarray, int]:
    got = native.qoi_decode(data, pixels, channels)
    return got if got is not None else decode_ops_python(data, pixels, channels)


def decode_qoi(blob: bytes) -> np.ndarray:
    """QOI bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    w, h, channels = opens(blob)
    px, status = decode_ops(blob[14:], w * h, channels)
    if status != OK:
        raise ValueError("QOI data ends before the image's last pixel (truncated file)")
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :channels] = px.reshape(h, w, channels)
    return rgba
