"""Microsoft Paint (MSP) decoding with numpy, for textures on hosts
without Pillow.

``decode_msp(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: version 1 (``DanM``, raw rows) and version 2 (``LinS``, rows
run-length encoded through a row map), black and white.  The version 2
run-length loop runs in C++ (native/src/codecs.cpp) when the native
library is built; ``rle_rows_python`` is its plain twin.

Pillow's reading is kept with its quirks:

  * a row of length 0 in the row map is white;
  * each row's runs are written one after the other and read as rows of
    ``ceil(W / 8)`` bytes, so a row that decodes to more or fewer bytes
    moves the rows after it; a literal cut by its row's end is shorter;
  * bytes past those the image needs are ignored.

Where Pillow refuses a file this module raises ValueError naming MSP: a
row map or row that ends early, a run cut by its row's end ("Corrupted
MSP file"), fewer bytes than the image needs, a file above Pillow's pixel
limit.  A header that ends early, a checksum that is not 0 or a side of 0
turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size

OK, ENDS_EARLY, CORRUPT = 0, 1, 2  # rle_rows' statuses


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def opens(blob: bytes) -> tuple[bool, int, int]:
    """(version 2, width, height)."""
    s = blob[:32]
    if len(s) < 32:
        raise NotThisFormat("MSP header ends early")
    words = struct.unpack("<16H", s)
    checksum = 0
    for v in words:
        checksum ^= v
    if checksum:
        raise NotThisFormat("bad MSP checksum")
    w, h = words[2], words[3]
    if w == 0 or h == 0:
        raise NotThisFormat("MSP image of no pixels")
    check_size("MSP", w, h)
    return s.startswith(b"LinS"), w, h


def rle_rows_python(data: bytes, w: int, h: int) -> tuple[bytes, int]:
    """MspDecoder: the row map and rows from ``data`` (the file past its
    32-byte header) -> (the bytes written, at most the image's, OK,
    ENDS_EARLY or CORRUPT)."""
    blank = b"\xff" * ((w + 7) // 8)
    cap = len(blank) * h
    if len(data) < 2 * h:
        return b"", ENDS_EARLY
    rowmap = struct.unpack_from(f"<{h}H", data)
    out = bytearray()
    pos = 2 * h
    for rowlen in rowmap:
        if rowlen == 0:
            out += blank
            continue
        row = data[pos:pos + rowlen]
        pos += len(row)
        if len(row) != rowlen:
            return bytes(out[:cap]), ENDS_EARLY
        idx = 0
        while idx < rowlen:
            runtype = row[idx]
            idx += 1
            if runtype == 0:
                if idx + 2 > rowlen:
                    return bytes(out[:cap]), CORRUPT
                out += row[idx + 1:idx + 2] * row[idx]
                idx += 2
            else:
                out += row[idx:idx + runtype]
                idx += runtype
    return bytes(out[:cap]), OK


def rle_rows(data: bytes, w: int, h: int) -> tuple[bytes, int]:
    got = native.msp_rle(data, w, h)
    return got if got is not None else rle_rows_python(data, w, h)


def decode_msp(blob: bytes) -> np.ndarray:
    """MSP bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    v2, w, h = opens(blob)
    line = (w + 7) // 8
    if v2:
        data, status = rle_rows(blob[32:], w, h)
        if status == ENDS_EARLY:
            raise ValueError("MSP row map or row ends early (truncated MSP file)")
        if status == CORRUPT:
            raise ValueError("MSP run cut by its row's end (Corrupted MSP file)")
        if len(data) < line * h:
            raise ValueError("MSP rows give too few bytes (not enough image data)")
        rows = np.frombuffer(data, np.uint8, line * h).reshape(h, line)
    else:
        rows = rawmode.raw_rows(blob, 32, h, line, fmt="MSP")
    return rawmode.to_rgba("1", rawmode.unpack("1", rows, w))
