"""LZW decoding for GIF and TIFF (io/gif.py, io/tiff.py).

``decode_lzw(data, min_bits, tiff, limit)`` runs the native loop
(``native/src/codecs.cpp``) when the native library is built, else
``decode_lzw_python``, its plain twin: both give the same bytes and the same
status for every input, broken ones included.

The two forms: TIFF's codes are read from the high bit of each byte, its
literals are bytes (``min_bits`` 8) and its code width grows one code early
(9 bits up to the table's 510th entry); GIF's are read from the low bit, its
literals have ``min_bits`` bits and its width grows when the table reaches a
power of two.  Both start at ``min_bits + 1`` bits, stop growing at 12, and
add no entries to a full table of 4,096 (GIF's deferred clear).
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch import native

OK, OUT_OF_CODES, BAD_CODE = 0, 1, 2


def decode_lzw_python(data: bytes, min_bits: int, tiff: bool, limit: int
                      ) -> tuple[np.ndarray, int]:
    """LZW codes -> (at most ``limit`` bytes as uint8, status): ``OK`` at
    the end code or once ``limit`` bytes are out, ``OUT_OF_CODES`` when the
    data ends first, ``BAD_CODE`` at a code the table does not hold."""
    clear = 1 << min_bits
    eoi = clear + 1
    table = [bytes([c]) for c in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    acc = nbits = pos = 0
    status = OK
    while len(out) < limit:
        width = min(12, (len(table) + 1 if tiff else len(table)).bit_length())
        while nbits < width and pos < len(data):
            if tiff:
                acc = (acc << 8) | data[pos]
            else:
                acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        if nbits < width:
            status = OUT_OF_CODES
            break
        nbits -= width
        if tiff:
            code = acc >> nbits
            acc &= (1 << nbits) - 1
        else:
            code = acc & ((1 << width) - 1)
            acc >>= width
        if code == clear:
            del table[clear + 2:]
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            if code > clear:
                status = BAD_CODE
                break
            entry = table[code]
        else:
            if code > len(table):
                status = BAD_CODE
                break
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
    return np.frombuffer(bytes(out[:limit]), np.uint8), status


def decode_lzw(data: bytes, min_bits: int, tiff: bool, limit: int) -> tuple[np.ndarray, int]:
    """``decode_lzw_python``'s result, from the native loop where the
    library is built."""
    got = native.lzw_decode(data, min_bits, tiff, limit)
    return got if got is not None else decode_lzw_python(data, min_bits, tiff, limit)
