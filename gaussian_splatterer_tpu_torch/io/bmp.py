"""BMP and DIB decoding with numpy, for textures on hosts without Pillow.

``decode_bmp(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12);
``decode_bmp(blob, dib=True)`` reads a DIB, the same bitmap without the
14-byte file header (Pillow's DIB plugin).

Coverage: the OS/2 core header (12 bytes), the Windows header (40), V2 and
V3 (52, 56), OS/2 v2 (64), V4 (108) and V5 (124); 1, 4 and 8 bits a pixel
through a palette of ``ClrUsed`` entries or the full table; 16 and 32 bits
under BI_RGB and under BI_BITFIELDS with the masks Pillow accepts (5-6-5
and 5-5-5 at 16 bits; at 32 bits the byte orders BGRX, XBGR, BGXR, ABGR,
RGBA, BGRA and BGAR, and all-zero masks as BGRA); 24 bits; RLE8 and RLE4
with their end-of-line, end-of-bitmap and delta escapes; bottom-up and
top-down (negative height) rows.

Pillow's conversion is kept with its quirks:

  * a 32-bit BI_RGB pixel ignores its fourth byte: alpha 255, as Pillow
    writes RGBA and reads it back;
  * a 16-bit pixel scales each channel by 255 / 31 (or 255 / 63), truncated
    (21 reads as 172); the top bit of a 5-5-5 pixel is ignored;
  * an alpha mask counts only where the header holds one (V3 and later):
    the masks after a 40-byte header are three;
  * a palette of grey entries (entry i is (i, i, i), or black and white
    for a 2-entry palette) is no palette: the pixel data is read as 8-bit
    grey, or as 1-bit where the palette has 2 entries, whatever the bit
    depth says; below 8 bits (a grey palette of more than 2 entries) Pillow
    maps the file and reads a row of ``w`` bytes at each narrow row's
    start, so the rows overlap: read so where those bytes lie in the file,
    refused where the last row runs past its end (Pillow then shows memory
    past the file, which no port can know); an index past a real palette's
    entries reads as opaque black;
  * in RLE, skipped pixels (end-of-line and delta escapes) take index 0, a
    delta escape skips two bytes before its two offsets, an absolute run
    of an odd count in RLE4 drops its last pixel, and the runs re-align to
    even offsets of the file.

Where Pillow refuses a file this module raises ValueError naming BMP: other
header sizes, bit depths and compressions (JPEG and PNG in BMP among them),
other bitfield masks, a palette of no entries or more than 256, pixel data
that ends early (RLE included).
"""

from __future__ import annotations

import struct

import numpy as np

DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_COMPRESSIONS = {4: "JPEG", 5: "PNG", 6: "ALPHABITFIELDS"}
# bitfield masks -> the byte order of a 32-bit pixel, or a 16-bit layout
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}
_RAW_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16,
             "BGR": 24}


def _u(blob: bytes, pos: int, fmt: str) -> tuple:
    size = struct.calcsize(fmt)
    if len(blob) < pos + size:
        raise ValueError("BMP header is too short (truncated file)")
    return struct.unpack_from(fmt, blob, pos)


def raw_rows(blob: bytes, pos: int, h: int, row: int, stride: int, bottom_up: bool,
             fmt: str = "BMP") -> np.ndarray:
    """``h`` rows of ``row`` bytes, ``max(stride, row)`` apart, from
    ``pos`` -> (h, row) uint8, the top row first.  The last row needs no
    padding after it, as in Pillow's raw decoder."""
    step = max(stride, row)
    if h and len(blob) < pos + (h - 1) * step + row:
        raise ValueError(f"{fmt} image data is too short (truncated file)")
    buf = np.frombuffer(blob, np.uint8, len(blob) - pos, pos) if h else np.zeros(0, np.uint8)
    rows = np.lib.stride_tricks.as_strided(buf, (h, row), (step, 1)) if h else \
        np.zeros((0, row), np.uint8)
    return np.ascontiguousarray(rows[::-1] if bottom_up else rows)


def unpack_bits(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, stride) packed rows, the leftmost sample in the high bits ->
    (h, w) int64 samples."""
    if bits == 8:
        return rows[:, :w].astype(np.int64)
    shifts = np.arange(8 - bits, -1, -bits)
    s = (rows[..., None].astype(np.int64) >> shifts) & ((1 << bits) - 1)
    return s.reshape(rows.shape[0], -1)[:, :w]


def _rle(blob: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """Pillow's BMP run-length decoder from ``pos`` -> w * h indices in
    file order; raises where it gives fewer."""
    data = bytearray()
    x, need, n = 0, w * h, len(blob)
    while len(data) < need:
        if pos + 2 > n:
            break
        count, byte = blob[pos], blob[pos + 1]
        pos += 2
        if count:  # a run
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                data += (pair * ((count + 1) // 2))[:count]
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            data += bytes(-len(data) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow skips two bytes, then reads right, up
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise ValueError("BMP RLE delta escape is cut short (truncated file)")
            right, up = blob[pos + 2], blob[pos + 3]
            pos += 4
            data += bytes(right + up * w)
            x = len(data) % w
        else:  # absolute: ``byte`` literal pixels
            size = byte // 2 if rle4 else byte
            chunk = blob[pos:pos + size]
            pos += len(chunk)
            if rle4:
                data += bytes(v for b in chunk for v in (b >> 4, b & 0x0F))
            else:
                data += chunk
            if len(chunk) < size:
                break
            x += byte
            pos += pos % 2  # the runs align to even offsets of the file
    if len(data) < need:
        raise ValueError("BMP RLE image data is too short (not enough image data)")
    return np.frombuffer(bytes(data[:need]), np.uint8).reshape(h, w)


def decode_bmp(blob: bytes, dib: bool = False) -> np.ndarray:
    """BMP bytes (or DIB bytes with ``dib``) -> (H, W, 4) uint8 RGBA, row 0
    the top of the picture."""
    if dib:
        return decode_bitmap(blob, 0, 0)[0]
    if blob[:2] != b"BM":
        raise ValueError("not a BMP file")
    return decode_bitmap(blob, 14, _u(blob, 10, "<I")[0])[0]


def decode_bitmap(blob: bytes, hpos: int, offset: int, halve: bool = False,
                  bgra: bool = False) -> tuple[np.ndarray, int]:
    """Pillow's ``BmpImageFile._bitmap`` on the header at ``hpos``, the
    pixel data at ``offset`` (0: right after the header, masks and
    palette) -> (the (H, W, 4) uint8 RGBA, the pixel data's offset).  With
    ``halve`` only the first half of the rows is read, as the ICO and CUR
    plugins read an icon's colour bitmap; with ``bgra`` a 32-bit BI_RGB
    pixel keeps its fourth byte as alpha, as the CUR plugin reads a cursor
    whose bitmap starts at byte 22."""
    size = _u(blob, hpos, "<I")[0]
    if size not in DIB_HEADER_SIZES:
        raise ValueError(f"unsupported BMP header size {size}")
    head = blob[hpos + 4:hpos + size]
    if len(head) < size - 4:
        raise ValueError("BMP header is too short (truncated file)")
    pos = hpos + size
    masks = None
    if size == 12:
        w, h, _, bits = struct.unpack_from("<4H", head)
        comp, colours, pad, top_down = _RAW, 0, 3, False
    else:
        top_down = head[7] == 0xFF
        w, h = struct.unpack_from("<II", head)
        if top_down:
            h = 2 ** 32 - h
        bits, comp = struct.unpack_from("<HI", head, 10)
        colours, pad = struct.unpack_from("<I", head, 28)[0], 4
        if comp == _BITFIELDS:
            if len(head) >= 52:
                masks = struct.unpack_from("<4I", head, 36)
            elif len(head) >= 48:
                masks = struct.unpack_from("<3I", head, 36) + (0,)
            else:
                masks = _u(blob, pos, "<3I") + (0,)
                pos += 12
    colours = colours or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colours
    if bits not in _RAW_MODES:
        raise ValueError(f"unsupported BMP pixel depth ({bits} bits)")
    mode, raw = ("P" if bits <= 8 else "RGB"), _RAW_MODES[bits]
    if bgra and bits == 32 and comp == _RAW:
        mode, raw = "RGBA", "BGRA"
    if halve:
        h //= 2
    if comp == _BITFIELDS:
        if bits == 32 and masks in _MASKS32:
            raw = _MASKS32[masks]
            mode = "RGBA" if "A" in raw else "RGB"
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            raw = "BGR"
        elif bits == 16 and masks[:3] in _MASKS16:
            raw = _MASKS16[masks[:3]]
        else:
            raise ValueError(f"unsupported BMP bitfields layout ({bits} bits, masks "
                             f"{tuple(hex(m) for m in masks)})")
    elif comp in (_RLE8, _RLE4):
        if bits > 8:
            raise ValueError(f"unsupported BMP (RLE at {bits} bits a pixel)")
    elif comp != _RAW:
        raise ValueError(f"unsupported BMP compression "
                         f"({_COMPRESSIONS.get(comp, comp)})")
    palette = None
    overlap = False
    if mode == "P":
        if not 0 < colours <= 256:
            raise ValueError(f"unsupported BMP palette of {colours} entries")
        table = blob[pos:pos + pad * colours]
        pos += len(table)
        grey = [0, 255] if colours == 2 else range(colours)
        if all(table[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(grey)):
            mode = raw = "1" if colours == 2 else "L"
            if mode == "L" and bits < 8:
                # Pillow maps the file and reads a row of w bytes at each
                # narrower row's start: the rows overlap, and the last runs on
                # past its own bytes
                overlap = True
        else:
            n = len(table) // pad
            palette = np.zeros((256, 4), np.uint8)
            palette[:, 3] = 255
            palette[:n, :3] = np.frombuffer(table, np.uint8, pad * n).reshape(n, pad)[:, 2::-1]
    start = offset or pos
    if comp in (_RLE8, _RLE4):
        if mode == "1":
            raise ValueError("unsupported BMP (RLE with a black and white palette)")
        px = _rle(blob, start, w, h, comp == _RLE4)
        px = px[::-1] if not top_down else px
        v = px.astype(np.int64)
    elif overlap:
        stride = ((w * bits + 31) >> 3) & ~3
        if h and (start + h * stride > len(blob) or start + (h - 1) * stride + w > len(blob)):
            raise ValueError(f"unsupported BMP (a grey palette of {colours} entries at {bits} "
                             "bits a pixel, whose 8-bit rows Pillow reads past the end of "
                             "the file)")
        buf = np.frombuffer(blob, np.uint8)
        rows = np.lib.stride_tricks.as_strided(buf[start:], (h, w), (stride, 1)) if h else \
            np.zeros((0, w), np.uint8)
        v = np.ascontiguousarray(rows if top_down else rows[::-1]).astype(np.int64)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        row = (w * (_RAW_BITS.get(raw, 32)) + 7) // 8
        rows = raw_rows(blob, start, h, row, stride, not top_down)
        if raw in ("1", "P;1", "P;4", "P", "L"):
            v = unpack_bits(rows, w, _RAW_BITS[raw])
        else:
            return _true_colour(rows, w, raw), start
    if mode == "1":
        v = v * 255
    if palette is not None:
        return palette[v], start
    rgba = np.full(v.shape + (4,), 255, np.uint8)
    rgba[..., :3] = v[..., None].astype(np.uint8)
    return rgba, start


def _true_colour(rows: np.ndarray, w: int, raw: str) -> np.ndarray:
    h = rows.shape[0]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if raw.startswith("BGR;"):
        p = rows.reshape(h, w, 2).astype(np.int64)
        p = p[..., 0] | (p[..., 1] << 8)
        g_bits = 6 if raw == "BGR;16" else 5
        for c, shift, bits in ((2, 0, 5), (1, 5, g_bits), (0, 5 + g_bits, 5)):
            top = (1 << bits) - 1
            rgba[..., c] = ((p >> shift) & top) * 255 // top
        return rgba
    px = rows.reshape(h, w, len(raw))
    for i, c in enumerate(raw):
        if c in "RGBA":
            rgba[..., "RGBA".index(c)] = px[..., i]
    return rgba
