"""WebP decoding for textures on hosts without Pillow.

``decode_webp(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12 with
libwebp 1.6), for every WebP file Pillow reads: this module reads the RIFF
container as libwebp's demuxer does, and the bit-serial decoders run in the
native library (native/src/webp.cpp): the VP8 key frame of RFC 6386 with
libwebp's output stage (its "fancy" chroma upsampler and 14-bit YUV -> RGB),
the VP8L image of RFC 9649, and the ``ALPH`` plane.

Coverage: a simple file (one ``VP8 `` or ``VP8L`` chunk) and the extended
form (``VP8X``: flags and a 24-bit canvas size stored minus one); ``ALPH``
raw or VP8L-coded, under each of its four filters (none, horizontal,
vertical, gradient); an animation (``ANIM`` and ``ANMF``), whose first frame
is read, as Pillow opens an animation; ``ICCP``, ``EXIF``, ``XMP `` and
unknown chunks skipped (``convert`` does not apply the ICC profile); odd
chunk sizes and their padding byte; bytes past the RIFF size ignored.

Pillow's reading is kept with its quirks:

  * the colours are not premultiplied by alpha;
  * a file "has alpha" as libwebp's ``WebPGetFeatures`` says, never by
    its pixels: an animation by the ``VP8X`` alpha flag; a VP8L image by
    its header's alpha bit, whatever the flag; a VP8 image by the flag or
    an ``ALPH`` chunk before it.  A file without alpha reads with alpha
    255 everywhere, whatever its pixels hold;
  * without the ``VP8X`` alpha flag an ``ALPH`` chunk is dropped (so such
    a file "has alpha" and reads opaque);
  * an animation's first frame sits on a canvas cleared to transparent
    black, whatever the ``ANIM`` background colour (opaque black when the
    file has no alpha); a frame's size is its bitstream's, not the size
    its ``ANMF`` header states.

Where Pillow refuses a file this module raises ValueError naming WebP and
the stage: a RIFF size past the data (a truncated file) or smaller than a
chunk; a chunk past the RIFF size; a ``VP8X`` chunk smaller than 10 bytes,
an unknown flag, a second ``VP8X``; a still image whose size is not the
canvas's, or an image chunk outside ``ANMF`` in an animation; an ``ANMF``
before ``ANIM``, or a frame past the canvas; ``ALPH`` after the image or
with ``VP8L``; a VP8 frame that is not a shown key frame, has a bad start
code or a zero size, or whose partitions or macroblocks run past the data;
a bad VP8L signature or version, an incomplete prefix code, a transform
twice, a colour cache of more than 11 bits, a backward reference out of
the image, a stream that ends early; an ``ALPH`` with reserved bits, an
unknown method or pre-processing, or a plane that ends early; more pixels
than Pillow's decompression-bomb limit.  Pillow reads no WebP file this
module refuses.

The decoders need the native library: without ``g++`` (``native.lib()`` is
None) a WebP file raises ValueError saying so.  There is no Python twin of
them; the plain reference is Pillow's decode (tests/test_torch_webp.py).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
VALID_FLAGS = 0x3E  # ICC, alpha, EXIF, XMP, animation
MAX_PIXELS = 2 * 89478485  # above this Pillow raises DecompressionBombError
MAX_CHUNK = (1 << 32) - 10

# native/src/webp.cpp's statuses
STATUS = {
    1: "VP8 frame header (not a shown key frame, bad start code or zero size)",
    2: "VP8 partitions past the data",
    3: "VP8 data ends before the last macroblock",
    4: "VP8L header (bad signature or version)",
    5: "VP8L transform used twice",
    6: "VP8L prefix code not complete",
    7: "VP8L colour cache of more than 11 bits",
    8: "VP8L backward reference out of the image",
    9: "VP8L data ends before the image",
    10: "ALPH header (reserved bits, unknown method or pre-processing)",
    11: "ALPH plane ends early",
    12: "image size differs from the container's",
    13: "out of memory",
}


def _le24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


class _Frame:
    def __init__(self, x: int = 0, y: int = 0):
        self.x, self.y = x, y
        self.alpha: tuple[int, int] | None = None  # (payload offset, declared size)
        self.image: tuple[int, int, bool] | None = None  # (offset, available size, lossless)
        self.width = self.height = 0
        self.alpha_bit = False  # a VP8L header's


def _features(data: bytes, at: int, size: int, declared: int, lossless: bool):
    """WebPGetFeatures on an image chunk's payload: (width, height, alpha
    bit), checking what libwebp checks before it decodes."""
    if lossless:
        if size < 5 or data[at] != 0x2F or data[at + 4] >> 5:
            raise ValueError("WebP: VP8L header (bad signature or version)")
        bits = struct.unpack_from("<I", data, at + 1)[0]
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool(bits >> 28 & 1)
    if size < 10:
        raise ValueError("WebP: VP8 frame header cut short")
    tag = _le24(data, at)
    w = (data[at + 6] | data[at + 7] << 8) & 0x3FFF
    h = (data[at + 8] | data[at + 9] << 8) & 0x3FFF
    if (data[at + 3:at + 6] != b"\x9d\x01\x2a" or tag & 1 or (tag >> 1) & 7 > 3
            or not (tag >> 4) & 1 or tag >> 5 >= declared or not w or not h):
        raise ValueError("WebP: VP8 frame header (not a shown key frame, bad start code, "
                         "zero size or partition 0 past the chunk)")
    return w, h, False


def _store_frame(data: bytes, pos: int, end: int, frame: _Frame) -> int:
    """libwebp's StoreFrame: an optional ``ALPH`` and an image chunk from
    ``pos``; returns the position after them."""
    while True:
        if end - pos < 8:
            raise ValueError("WebP: chunk header cut short")
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        padded = size + (size & 1)
        if size > MAX_CHUNK or padded > end - pos - 8:
            raise ValueError(f"WebP: {fourcc!r} chunk past the end of the file")
        if fourcc == b"ALPH" and frame.alpha is None and frame.image is None:
            frame.alpha = (pos + 8, size)
        elif fourcc in (b"VP8 ", b"VP8L") and frame.image is None:
            lossless = fourcc == b"VP8L"
            if lossless and frame.alpha is not None:
                raise ValueError("WebP: ALPH chunk before a VP8L image")
            frame.width, frame.height, frame.alpha_bit = _features(data, pos + 8, padded, size,
                                                                   lossless)
            frame.image = (pos + 8, padded, lossless)
        else:
            return pos
        pos += 8 + padded
        if pos == end:
            return pos


def _parse(data: bytes):
    """The demuxer: (canvas width, height, whether the file has alpha,
    first frame)."""
    end = len(data)
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):
        frame = _Frame()
        pos = _store_frame(data, 12, end, frame)
        if frame.image is None:
            raise ValueError("WebP: no image chunk")
        if 0 < end - pos < 8:
            raise ValueError("WebP: bytes after the image that are not a chunk")
        return frame.width, frame.height, frame.alpha_bit, frame
    if first != b"VP8X":
        raise ValueError(f"WebP: unknown first chunk {first!r}")
    size = struct.unpack_from("<I", data, 16)[0]
    padded = size + (size & 1)
    if size < 10 or size > MAX_CHUNK or padded > end - 20:
        raise ValueError("WebP: VP8X chunk too small or past the end of the file")
    flags = data[20]
    cw, ch = _le24(data, 24) + 1, _le24(data, 27) + 1
    animated = bool(flags & ANIMATION_FLAG)
    pos = 20 + padded
    frames: list[_Frame] = []
    anim = False
    while pos < end:
        if end - pos < 8:
            raise ValueError("WebP: bytes after the last chunk that are not a chunk")
        fourcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        padded = size + (size & 1)
        if size > MAX_CHUNK or padded > end - pos - 8:
            raise ValueError(f"WebP: {fourcc!r} chunk past the end of the file")
        if fourcc == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise ValueError("WebP: an image chunk outside ANMF in an animation, or twice")
            frame = _Frame()
            pos = _store_frame(data, pos, end, frame)
            lossless = frame.image is not None and frame.image[2]
            has_alpha = (frame.alpha_bit if lossless else bool(flags & ALPHA_FLAG)
                         ) or frame.alpha is not None
            if not flags & ALPHA_FLAG:  # the demuxer drops alpha the flags do not announce
                frame.alpha = None
            frames.append(frame)
            continue
        if fourcc == b"ANIM":
            if padded < 6:
                raise ValueError("WebP: ANIM chunk too small")
            anim = True
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("WebP: ANMF before ANIM")
            if padded < 16:
                raise ValueError("WebP: ANMF chunk too small")
            x, y = 2 * _le24(data, pos + 8), 2 * _le24(data, pos + 11)
            frame = _Frame(x, y)
            after = _store_frame(data, pos + 24, end, frame) if padded > 16 else pos + 24
            if after - (pos + 24) > padded - 16:
                raise ValueError("WebP: ANMF frame past its chunk")
            if animated and frame.image is None and frame.alpha is not None:
                raise ValueError("WebP: ANMF with ALPH and no image")
            if animated and frame.image is not None:  # an empty ANMF is skipped
                frames.append(frame)
            pos = after
            continue
        pos += 8 + padded
    if not frames:
        raise ValueError("WebP: no image")
    if animated:
        has_alpha = bool(flags & ALPHA_FLAG)
    if flags & ~VALID_FLAGS & 0xFF:
        raise ValueError(f"WebP: unknown VP8X flags 0x{flags:02x}")
    for f in frames:
        if f.image is None:
            raise ValueError("WebP: a frame without an image")
        if animated:
            if f.x + f.width > cw or f.y + f.height > ch:
                raise ValueError("WebP: a frame past the canvas")
        elif (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
            raise ValueError(f"WebP: image {f.width}x{f.height} is not the canvas {cw}x{ch}")
    return cw, ch, has_alpha, frames[0]


def _check(status: int, what: str) -> None:
    if status:
        raise ValueError(f"WebP: {what}: {STATUS.get(status, f'status {status}')}")


def decode_webp(blob: bytes) -> np.ndarray:
    """WebP file bytes -> (H, W, 4) uint8 RGBA, as Pillow reads it (the
    first frame of an animation)."""
    if len(blob) < 20 or blob[:4] != b"RIFF" or blob[8:12] != b"WEBP":
        raise ValueError("WebP: not a RIFF WEBP file")
    riff_size = struct.unpack_from("<I", blob, 4)[0]
    if riff_size < 8 or riff_size > MAX_CHUNK:
        raise ValueError(f"WebP: RIFF size {riff_size}")
    if len(blob) < riff_size + 8:
        raise ValueError(f"WebP: truncated: {len(blob)} bytes of {riff_size + 8}")
    data = bytes(blob[:riff_size + 8])
    cw, ch, has_alpha, frame = _parse(data)
    if cw * ch > MAX_PIXELS:
        raise ValueError(f"WebP: {cw}x{ch} past Pillow's decompression-bomb limit")
    if native.lib() is None:
        raise ValueError("WebP: decoding needs the native library "
                         "(native/src/webp.cpp, built with g++), which did not build")
    canvas = np.zeros((ch, cw, 4), np.uint8)
    view = canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width]
    at, size, lossless = frame.image
    _check(native.webp_image(lossless, data[at:at + size], view),
           "VP8L image" if lossless else "VP8 image")
    if frame.alpha is not None:
        a_at, a_size = frame.alpha
        plane, status = native.webp_alpha(data[a_at:a_at + a_size], frame.width, frame.height)
        _check(status, "ALPH plane")
        view[..., 3] = plane
    if not has_alpha:
        canvas[..., 3] = 255
    return canvas
