"""TGA decoding with numpy, for textures on hosts without Pillow.

``decode_tga(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12).

Coverage: image types 1 and 9 (colour-mapped, 8-bit indices into a map of
16- or 24-bit entries, the map starting at any first-entry index), 2 and 10
(true colour at 16, 24 or 32 bits) and 3 and 11 (grey: 1 bit uncompressed,
8 bits, or 16 bits as grey and alpha), raw or run-length encoded, with
either origin bit.

Pillow's conversion is kept with its quirks:

  * a 32-bit pixel keeps its fourth byte as alpha whatever the descriptor's
    alpha bits say;
  * a 16-bit pixel or map entry (5 bits a channel) scales each channel by
    255 / 31, truncated (21 reads as 172), and its top bit is an inverted
    alpha: 255 where it is 0, 0 where it is 1, whatever the descriptor says;
  * a 24-bit map entry is opaque; the entries before the first-entry index
    and past the map's end read as opaque black;
  * a grey image that carries a colour map reads its bytes as indices into
    that map (an 8-bit one as a colour-mapped image, a 16-bit one with its
    second byte as alpha);
  * a run-length packet may not run past the end of a row, a literal packet
    may.

Where Pillow refuses a file this module raises ValueError naming TGA: the
image types 0 and others not listed, 15-bit pixels or map entries, 32-bit
map entries, 16-bit indices, a colour-mapped type without a map, a
true-colour or 1-bit grey image with a map, a map that reaches past entry
256, a run-length 1-bit image, a run past a row's end, data that ends
early.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat


def opens(blob: bytes) -> None:
    """TgaImageFile._open's checks: ``NotThisFormat`` where Pillow tries
    its next plugin.  TGA has no signature; Pillow tries it whatever the
    file is called."""
    if len(blob) < 18:
        raise NotThisFormat("TGA file too short")
    w, h = struct.unpack_from("<HH", blob, 12)
    if blob[1] not in (0, 1) or w == 0 or h == 0 or blob[16] not in (1, 8, 16, 24, 32):
        raise NotThisFormat(f"not a TGA file Pillow reads (colour map type {blob[1]}, {w}x{h}, "
                            f"{blob[16]} bits a pixel)")
    if blob[2] not in (1, 2, 3, 9, 10, 11):
        raise NotThisFormat(f"unsupported TGA (image type {blob[2]}, {blob[16]} bits a pixel)")
    if blob[1] and blob[7] not in (16, 24, 32):
        raise NotThisFormat(f"unsupported TGA ({blob[7]}-bit colour map entries)")


def _unpack_15z(lo_hi: np.ndarray) -> np.ndarray:
    """(..., 2) uint8 little-endian 16-bit pixels -> (..., 4) uint8 RGBA."""
    p = lo_hi[..., 0].astype(np.int64) | (lo_hi[..., 1].astype(np.int64) << 8)
    out = np.empty(p.shape + (4,), np.uint8)
    for c, shift in enumerate((10, 5, 0)):
        out[..., c] = ((p >> shift) & 31) * 255 // 31
    out[..., 3] = np.where(p & 0x8000, 0, 255)
    return out


def _rle(blob: bytes, pos: int, h: int, row: int, nb: int) -> np.ndarray:
    """Run-length packets from ``pos`` -> (h, row) uint8 rows as stored."""
    data = np.empty(h * row, np.uint8)
    out, end = 0, h * row
    while out < end:
        if pos >= len(blob):
            raise ValueError("TGA image data is too short (truncated file)")
        head = blob[pos]
        n = ((head & 0x7F) + 1) * nb
        run = bool(head & 0x80)  # one pixel repeated, else n bytes of pixels
        if pos + 1 + (nb if run else n) > len(blob):
            raise ValueError("TGA image data is too short (truncated file)")
        if run:
            if out % row + n > row:
                raise ValueError("TGA run-length packet runs past the end of a row")
            data[out:out + n] = np.tile(np.frombuffer(blob, np.uint8, nb, pos + 1), n // nb)
            pos += 1 + nb
        else:  # literal pixels may continue on the next rows
            data[out:min(out + n, end)] = np.frombuffer(blob, np.uint8, min(n, end - out),
                                                        pos + 1)
            pos += 1 + n
        out += n
    return data.reshape(h, row)


def decode_tga(blob: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    if len(blob) < 18:
        raise ValueError("TGA file too short")
    id_len, cmap_type, img_type = blob[0], blob[1], blob[2]
    first, n_map, map_bits = struct.unpack("<HHB", blob[3:8])
    w, h, depth, desc = struct.unpack("<HHBB", blob[12:18])
    if cmap_type not in (0, 1) or w == 0 or h == 0 or depth not in (1, 8, 16, 24, 32):
        raise ValueError(f"not a TGA file Pillow reads (colour map type {cmap_type}, "
                         f"{w}x{h}, {depth} bits a pixel)")
    kind = img_type & 7
    known = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}
    if img_type not in (1, 2, 3, 9, 10, 11) or (kind, depth) not in known:
        raise ValueError(f"unsupported TGA (image type {img_type}, {depth} bits a pixel)")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        if map_bits not in (16, 24):
            raise ValueError(f"unsupported TGA ({map_bits}-bit colour map entries)")
        if first + n_map > 256:
            raise ValueError(f"TGA colour map of {first + n_map} entries (at most 256)")
        if kind == 2 or depth == 1:
            raise ValueError(f"unsupported TGA (image type {img_type} at {depth} bits "
                             "with a colour map)")
        size = n_map * map_bits // 8
        entries = np.frombuffer(blob[pos:pos + size], np.uint8)
        pos += size
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        n = len(entries) // (map_bits // 8)
        if map_bits == 16:
            palette[first:first + n] = _unpack_15z(entries[:2 * n].reshape(n, 2))
        else:
            palette[first:first + n, :3] = entries[:3 * n].reshape(n, 3)[:, ::-1]
    elif kind == 1:
        raise ValueError(f"TGA of image type {img_type} without a colour map")
    row = (w * depth + 7) // 8
    if img_type & 8:
        if depth == 1:
            raise ValueError("run-length encoded 1-bit TGA is not supported")
        rows = _rle(blob, pos, h, row, depth // 8)
    else:
        if len(blob) < pos + h * row:
            raise ValueError("TGA image data is too short (truncated file)")
        rows = np.frombuffer(blob, np.uint8, h * row, pos).reshape(h, row)
    if depth == 1:
        v = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        rgba = np.repeat(v[..., None], 4, axis=2)
        rgba[..., 3] = 255
    elif palette is not None:  # a colour-mapped image, or grey read through the map
        px = rows.reshape(h, w, depth // 8)
        rgba = palette[px[..., 0]]
        if depth == 16:
            rgba[..., 3] = px[..., 1]
    elif kind == 3:
        px = rows.reshape(h, w, depth // 8)
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., :3] = px[..., :1]
        if depth == 16:
            rgba[..., 3] = px[..., 1]
    elif depth == 16:
        rgba = _unpack_15z(rows.reshape(h, w, 2))
    else:
        bgra = rows.reshape(h, w, depth // 8)
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., :3] = bgra[..., 2::-1]
        if depth == 32:
            rgba[..., 3] = bgra[..., 3]
    if not desc & 0x20:  # stored bottom row first
        rgba = rgba[::-1]
    if desc & 0x10:  # stored right to left
        rgba = rgba[:, ::-1]
    return np.ascontiguousarray(rgba)
