"""Autodesk FLI/FLC animation decoding with numpy, for textures on hosts
without Pillow.

``decode_fli(blob)`` gives the (H, W, 4) uint8 RGBA of the first frame
that Pillow's ``Image.open(path).convert("RGBA")`` gives, byte for byte
(Pillow 12.1).

Coverage: the first frame's chunks as Pillow's C decoder (FliDecode.c)
runs them: BLACK (13), BRUN (15), COPY (16), LC (12), SS2 (7) and the
stamp (18, skipped); the palette of the first colour chunk (4: 8-bit, or
11: 6-bit shifted up by 2) of the first frame, read by Pillow's
``_open``, over a grey ramp.  The chunk loop runs in C++
(native/src/codecs.cpp) when the native library is built;
``frame_python`` is its plain twin.

Pillow's reading is kept with its quirks:

  * the frame is decoded only once the whole of it (its size, one pad
    byte spared) has been read; the image starts black (index 0);
  * a colour chunk's skip and count are taken as written, an entry past
    255 turning the file away; a shifted 6-bit value keeps its low 8 bits;
  * a chunk's size of 0, a size past the frame's end, a chunk of an
    unknown type, a run or a line that passes the image's edge as the C
    decoder checks them, refuse the file; a COPY chunk whose pixels pass
    the frame's end makes Pillow read on from that chunk as if it began
    a frame.

Where Pillow refuses a file this module raises ValueError naming FLI: a
frame whose chunks break these rules, a frame that ends early, a frame
size under 8 or of another chunk type, a file above Pillow's pixel limit.
A header Pillow does not take, a palette chunk cut short, no frame after
the header, or a side of 0 turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

OVERRUN, BROKEN, UNKNOWN = -1, -2, -3  # Pillow's decoder error codes


def accept(p: bytes) -> bool:
    return (len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", p, 14)[0] in (0, 3))


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def _open(blob: bytes) -> dict:
    """FliImageFile._open and the seek to frame 0, with Pillow's
    exceptions -> size, palette, the first frame's size."""
    s = blob[:128]
    if not (accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    w, h = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    pos = 128
    s = blob[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:
        pos = 128 + _i32(s)
        s = blob[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                pos += chunk_size - 6
                if pos < 0:
                    raise OSError("FLI chunk before the start of the file (invalid seek)")
            s = blob[pos:pos + 6]
            pos += len(s)
            chunk_type = _i16(s, 4)
            if chunk_type in (4, 11):
                shift = 2 if chunk_type == 11 else 0
                i = 0
                (count,) = struct.unpack("<H", blob[pos:pos + 2])
                pos += 2
                for _ in range(count):
                    s = blob[pos:pos + 2]
                    pos += len(s)
                    i += s[0]
                    n = s[1] or 256
                    s = blob[pos:pos + 3 * n]
                    pos += len(s)
                    for k in range(0, len(s), 3):
                        palette[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
                        i += 1
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    s = blob[128:132]
    if not s:
        raise EOFError("missing frame size")
    framesize = _i32(s)
    if w == 0 or h == 0:
        raise SyntaxError("not identified by this driver")
    pal = np.array(palette, np.int64) & 0xFF
    return {"w": w, "h": h, "palette": pal.astype(np.uint8), "framesize": framesize}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


def frame_python(buf: bytes, img: np.ndarray) -> tuple[int, int]:
    """One call of Pillow's FliDecode on ``buf`` into the (H, W) uint8
    ``img`` -> (bytes consumed, or -1 at the frame's end; 0 or an error
    code)."""
    ysize, xsize = img.shape
    nb = len(buf)
    if nb < 4:
        return 0, 0
    framesize = struct.unpack_from("<i", buf)[0]  # a C int, as Pillow reads it
    if nb + nb % 2 < framesize:
        return 0, 0
    if nb < 8:
        return -1, OVERRUN
    if _i16(buf, 4) != 0xF1FA:
        return -1, UNKNOWN
    chunks = _i16(buf, 6)
    ptr, left = 16, nb - 16
    for _ in range(chunks):
        if left < 10:
            return -1, OVERRUN
        data = ptr + 6
        end = ptr + left  # ERR_IF_DATA_OOB's limit
        kind = _i16(buf, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2, word delta
            lines = _i16(buf, data)
            data += 2
            y = l_ = 0
            while l_ < lines and y < ysize:
                row = y
                if data + 2 > end:
                    return -1, OVERRUN
                packets = _i16(buf, data)
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= ysize:
                            return -1, OVERRUN
                        row = y
                    else:
                        img[row, xsize - 1] = packets & 0xFF
                    if data + 2 > end:
                        return -1, OVERRUN
                    packets = _i16(buf, data)
                    data += 2
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return -1, OVERRUN
                    x += buf[data]
                    if buf[data + 1] >= 128:
                        if data + 4 > end:
                            return -1, OVERRUN
                        i = 256 - buf[data + 1]
                        if x + i + i > xsize:
                            break
                        img[row, x:x + 2 * i:2] = buf[data + 2]
                        img[row, x + 1:x + 2 * i:2] = buf[data + 3]
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * buf[data + 1]
                        if x + i > xsize:
                            break
                        if data + 2 + i > end:
                            return -1, OVERRUN
                        img[row, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l_ += 1
                y += 1
            if l_ < lines:
                return -1, OVERRUN
        elif kind == 12:  # LC, byte delta
            y = _i16(buf, data)
            ymax = y + _i16(buf, data + 2)
            data += 4
            while y < ymax and y < ysize:
                if data + 1 > end:
                    return -1, OVERRUN
                packets = buf[data]
                data += 1
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return -1, OVERRUN
                    x += buf[data]
                    if buf[data + 1] & 0x80:
                        i = 256 - buf[data + 1]
                        if x + i > xsize:
                            break
                        if data + 3 > end:
                            return -1, OVERRUN
                        img[y, x:x + i] = buf[data + 2]
                        data += 3
                    else:
                        i = buf[data + 1]
                        if x + i > xsize:
                            break
                        if data + 2 + i > end:
                            return -1, OVERRUN
                        img[y, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 2)
                        data += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return -1, OVERRUN
        elif kind == 13:  # BLACK
            img[:] = 0
        elif kind == 15:  # BRUN
            for y in range(ysize):
                data += 1
                x = 0
                while x < xsize:
                    if data + 2 > end:
                        return -1, OVERRUN
                    if buf[data] & 0x80:
                        i = 256 - buf[data]
                        if x + i > xsize:
                            break
                        if data + i + 1 > end:
                            return -1, OVERRUN
                        img[y, x:x + i] = np.frombuffer(buf, np.uint8, i, data + 1)
                        data += i + 1
                    else:
                        i = buf[data]
                        if x + i > xsize:
                            break
                        img[y, x:x + i] = buf[data + 1]
                        data += 2
                    x += i
                if x != xsize:
                    return -1, OVERRUN
        elif kind == 16:  # COPY
            if data + xsize * ysize > end:
                return ptr, 0
            img[:] = np.frombuffer(buf, np.uint8, xsize * ysize, data).reshape(ysize, xsize)
        else:
            return -1, UNKNOWN
        advance = _i32(buf, ptr)
        if advance == 0:
            return -1, BROKEN
        if advance > left:
            return -1, OVERRUN
        ptr += advance
        left -= advance
    return -1, 0


def frame(buf: bytes, img: np.ndarray) -> tuple[int, int]:
    got = native.fli_frame(buf, img)
    return got if got is not None else frame_python(buf, img)


def decode_fli(blob: bytes) -> np.ndarray:
    """FLI/FLC bytes -> (H, W, 4) uint8 RGBA of the first frame."""
    head = opens(blob)
    w, h, block = head["w"], head["h"], head["framesize"]
    check_size("FLI", w, h)
    img = np.zeros((h, w), np.uint8)
    pos, b = 128, b""
    while True:  # ImageFile.load's loop: reads of the frame's size
        s = blob[pos:pos + block] if block > 0 else b""
        pos += len(s)
        if not s:
            raise ValueError("FLI frame ends early (image file is truncated)")
        b += s
        n, err = frame(b, img)
        if n < 0:
            break
        b = b[n:]
    if err < 0:
        raise ValueError(f"FLI frame is broken (decoder error {err})")
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = head["palette"][img]
    return rgba
