"""Small PNG and TGA writers for the texture tests and their fixtures
(tests/test_torch_textures.py, tests/data/textures/make_fixtures.py): the
variants Pillow does not write (Adam7, 2- and 4-bit grey, 16-bit RGB and
RGBA, keys at 16 bits, 16-bit TGA, colour maps with a first entry, grey
with a map), with ``zlib`` and ``struct``."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(s: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) uint8 rows, sub-byte samples
    packed from the high bits."""
    h = s.shape[0]
    v = s.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return v.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    per = 8 // depth
    v = np.pad(v, ((0, 0), (0, -v.shape[1] % per))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (v << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, first: int | None) -> bytes:
    """Raw rows -> filtered rows: row y with filter type (first + y) % 5,
    or type 0 throughout where ``first`` is None."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = 0 if first is None else (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, depth: int, ctype: int, interlace: bool = False,
              plte=None, trns=None, filters: bool = True) -> bytes:
    """(H, W, C) integer samples at ``depth`` -> PNG bytes.  ``plte`` and
    ``trns`` are the chunks' bytes; with ``filters`` the rows cycle
    through the five filter types, else all take type 0."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, i if filters else None)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += png_chunk(b"PLTE", bytes(plte))
    if trns is not None:
        out += png_chunk(b"tRNS", bytes(trns))
    return out + png_chunk(b"IDAT", zlib.compress(raw, 9)) + png_chunk(b"IEND", b"")


def _rle_row(px: np.ndarray) -> bytes:
    """(n, nb) pixels of one row -> TGA run-length packets: runs of two or
    more equal pixels as run packets, the rest as literals."""
    out, i, n = bytearray(), 0, len(px)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and (px[j] == px[i]).all():
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += px[i].tobytes()
        else:
            while j < n and j - i < 128 and not (j + 1 < n and (px[j] == px[j + 1]).all()):
                j += 1
            out.append(j - i - 1)
            out += px[i:j].tobytes()
        i = j
    return bytes(out)


def tga_bytes(pixels: np.ndarray, img_type: int, depth: int, desc: int = 0x20,
              cmap: bytes | None = None, cmap_bits: int = 0, cmap_first: int = 0,
              id_field: bytes = b"", width: int | None = None) -> bytes:
    """(H, W, nb) bytes of each pixel as stored, rows in file order -> TGA
    bytes; the run-length types (9, 10, 11) code each row on its own.
    ``width`` is the picture's width where it is not W (1-bit rows)."""
    h, w, nb = pixels.shape
    px = pixels.astype(np.uint8)
    n_map = 0 if cmap is None else len(cmap) // ((cmap_bits + 7) // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(cmap is not None), img_type,
                       cmap_first, n_map, cmap_bits, 0, 0, width or w, h, depth, desc)
    data = (b"".join(_rle_row(px[y]) for y in range(h)) if img_type & 8
            else px.tobytes())
    return head + id_field + (cmap or b"") + data
