"""TIFF decoding with ``zlib`` and numpy, for textures on hosts without Pillow.

``decode_tiff(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12, which
hands compressed files to libtiff and reads uncompressed ones itself).

Coverage: the first image (IFD 0), little- or big-endian; strips or tiles;
``PlanarConfiguration`` 1 and 2; compression none (1), LZW (5, decoded by
io/lzw.py), Deflate (8, 32946) and PackBits (32773); predictor 1, and 2 at
8 and 16 bits; ``Photometric`` 0 and 1 (1, 2, 4, 8 and 16 bits, grey and
alpha at 8), 2 (RGB at 8 and 16 bits with ``ExtraSamples`` 0, 1 or 2, or
none), 3 (palette at 1, 2, 4 and 8 bits, and an 8-bit palette index with an
unused or an alpha sample) and 5 (CMYK at 8 bits, with up to two unused
samples).

Pillow's conversion is kept with its quirks:

  * 16-bit grey is clipped at 255, not scaled (35,485 reads as 255), and
    white-is-zero 16-bit grey is not inverted;
  * 16-bit RGB and RGBA keep each sample's high byte;
  * associated alpha (``ExtraSamples`` 1) is un-premultiplied as
    ``min(255, c * 255 // a)``, 0 where alpha is 0;
  * a fourth sample without ``ExtraSamples`` is alpha;
  * the palette is the ``ColorMap`` values // 256;
  * CMYK converts as Pillow's ``cmyk2rgb`` (io/jpeg.py's ``cmyk_to_rgb``);
  * PackBits and uncompressed files ignore the predictor;
  * an uncompressed file reads every strip or tile offset it lists, those
    past the image's last one again from the top, in the order of the
    offsets (so the largest of several offsets of one strip wins); with
    ``PlanarConfiguration`` 2 each plane is read with the band's letter of
    Pillow's raw mode: 8-bit samples (1-bit for bilevel) whatever the file's
    depth, and white-is-zero grey not inverted;
  * a compressed file with ``PlanarConfiguration`` 2 loses the alpha plane
    of grey or palette with alpha (alpha 0), and un-premultiplies RGB by a
    fourth plane that ``ExtraSamples`` does not name.

Where Pillow or libtiff refuses a file, and for the variants not listed
above, this module raises ValueError naming TIFF and the variant: BigTIFF,
JPEG, CCITT, LogLuv and the other compressions, floating-point and signed
samples, YCbCr, CIELab and the other photometric interpretations, 12-bit
and 32-bit samples, ``FillOrder`` 2, predictor 3, predictor 2 below 8 bits,
old-style LZW, orientations that swap the axes, data that ends early.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import raw_rows, unpack_bits
from gaussian_splatterer_tpu_torch.io.jpeg import cmyk_to_rgb
from gaussian_splatterer_tpu_torch.io.lzw import OK, decode_lzw

_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                 32946: "Deflate", 34676: "SGI LogLuv", 34677: "SGI LogLuv24",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
# the integer field types: BYTE, SHORT, LONG, SBYTE, SSHORT, SLONG, IFD, LONG8,
# SLONG8, IFD8
_TYPE_CODE = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q",
              18: "Q"}


def _modes() -> dict:
    """Pillow's OPEN_INFO for the variants read here: (photometric, bits
    per sample, extra samples) -> (kind, Pillow's raw mode); kinds "1",
    "L", "1I" and "LI" (white is zero), "I16", "LA", "RGB", "RGBA", "RGBa"
    (associated alpha), "P", "PA", "CMYK"."""
    modes = {}
    for photo, inv in ((0, "I"), (1, "")):
        modes[(photo, (1,), ())] = ("1" + inv, "1;" + inv if inv else "1")
        for b in (2, 4):
            modes[(photo, (b,), ())] = ("L" + inv, f"L;{b}{inv}")
        modes[(photo, (8,), ())] = ("L" + inv, "L;I" if inv else "L")
        modes[(photo, (16,), ())] = ("I16", "I;16")
    modes[(1, (8, 8), (2,))] = ("LA", "LA")
    for b, suffix in ((8, ""), (16, ";16")):
        modes[(2, (b,) * 3, ())] = ("RGB", "RGB" + suffix)
        for extra, kind, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                                 ((1,), "RGBa", "RGBa"), ((2,), "RGBA", "RGBA")):
            modes[(2, (b,) * 4, extra)] = (kind, raw + suffix)
    modes[(2, (8,) * 4, (999,))] = ("RGBA", "RGBA")
    for tail, kind, raw in (((0, 0), "RGB", "RGBXX"), ((0, 0, 0), "RGB", "RGBXXX"),
                            ((1, 0), "RGBa", "RGBaX"), ((1, 0, 0), "RGBa", "RGBaXX"),
                            ((2, 0), "RGBA", "RGBAX"), ((2, 0, 0), "RGBA", "RGBAXX")):
        modes[(2, (8,) * (3 + len(tail)), tail)] = (kind, raw)
    for b in (1, 2, 4, 8):
        modes[(3, (b,), ())] = ("P", "P" if b == 8 else f"P;{b}")
    modes[(3, (8, 8), (0,))] = ("P", "PX")
    modes[(3, (8, 8), (2,))] = ("PA", "PA")
    for tail in ((), (0,), (0, 0)):
        modes[(5, (8,) * (4 + len(tail)), tail)] = ("CMYK", "CMYK" + "X" * len(tail))
    return modes


_MODES = _modes()


def _ifd(blob: bytes, e: str) -> dict:
    """IFD 0 -> {tag: tuple of ints} for the integer tags."""
    pos = struct.unpack_from(e + "I", blob, 4)[0]
    if len(blob) < pos + 2:
        raise ValueError("TIFF directory past the end of the file (truncated file)")
    n = struct.unpack_from(e + "H", blob, pos)[0]
    if len(blob) < pos + 2 + 12 * n:
        raise ValueError("TIFF directory is cut short (truncated file)")
    tags = {}
    for i in range(n):
        tag, kind, count = struct.unpack_from(e + "HHI", blob, pos + 2 + 12 * i)
        if kind not in _TYPE_CODE:
            continue
        size = struct.calcsize(_TYPE_CODE[kind]) * count
        at = pos + 10 + 12 * i
        if size > 4:
            at = struct.unpack_from(e + "I", blob, at)[0]
            if len(blob) < at + size:
                raise ValueError(f"TIFF tag {tag} past the end of the file (truncated file)")
        tags[tag] = struct.unpack_from(f"{e}{count}{_TYPE_CODE[kind]}", blob, at)
    return tags


def _packbits(data: bytes, size: int) -> bytes:
    out, pos = bytearray(), 0
    while len(out) < size:
        if pos >= len(data):
            raise ValueError("TIFF PackBits data ends early (truncated file)")
        n = data[pos]
        if n < 128:
            out += data[pos + 1:pos + 2 + n]
            pos += 2 + n
        elif n > 128:
            if pos + 1 >= len(data):
                raise ValueError("TIFF PackBits data ends early (truncated file)")
            out += data[pos + 1:pos + 2] * (257 - n)
            pos += 2
        else:
            pos += 1
    return bytes(out[:size])


def _inflate(data: bytes, comp: int, size: int) -> np.ndarray:
    """One compressed strip or tile -> its ``size`` bytes, as libtiff."""
    if comp == 5:
        if len(data) >= 2 and data[0] == 0 and data[1] & 1:
            raise ValueError("unsupported TIFF (old-style LZW)")
        out, status = decode_lzw(data, 8, True, size)
        if status != OK:
            raise ValueError("corrupt TIFF LZW data" if status == 2 else
                             "TIFF LZW data ends early (truncated file)")
    elif comp == 32773:
        out = np.frombuffer(_packbits(data, size), np.uint8)
    else:
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(data, size), np.uint8)
        except zlib.error as exc:
            raise ValueError(f"corrupt TIFF Deflate data ({exc})") from None
    if out.size < size:
        raise ValueError("TIFF image data ends early (truncated file)")
    return out


def _samples(rows: np.ndarray, w: int, n: int, bits: int, big: bool) -> np.ndarray:
    """(h, row bytes) -> (h, w, n) int64 samples at their own depth."""
    h = rows.shape[0]
    if bits == 16:
        s = rows[:, :2 * w * n].reshape(h, w * n, 2).astype(np.int64)
        s = (s[..., 0] << 8 | s[..., 1]) if big else (s[..., 1] << 8 | s[..., 0])
    else:
        s = unpack_bits(rows, w * n, bits)
    return s.reshape(h, w, n)


def decode_tiff(blob: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA of its first image, row 0 the top."""
    if blob[:4] in (b"II\x2b\x00", b"MM\x00\x2b"):
        raise ValueError("unsupported TIFF (BigTIFF)")
    if blob[:4] not in (b"II\x2a\x00", b"MM\x00\x2a") or len(blob) < 8:
        raise ValueError("not a TIFF file")
    big = blob[:2] == b"MM"
    tags = _ifd(blob, ">" if big else "<")

    def get(tag, default=None):
        v = tags.get(tag, default)
        return v[0] if isinstance(v, tuple) and len(v) == 1 else v

    comp, planar, photo = get(259, 1), get(284, 1), get(262, 0)
    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"unsupported TIFF (compression {_COMPRESSIONS.get(comp, comp)})")
    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF without its dimensions")
    w, h = get(256), get(257)
    if get(266, 1) != 1:
        raise ValueError("unsupported TIFF (FillOrder 2)")
    if get(274, 1) in (5, 6, 7, 8):
        raise ValueError(f"unsupported TIFF (orientation {get(274)}, axes swapped)")
    fmt = tuple(tags.get(339, (1,)))
    if fmt != (1,) * len(fmt):
        raise ValueError(f"unsupported TIFF (sample format {fmt}: signed or floating point)")
    bps, extra = tuple(tags.get(258, (1,))), tuple(tags.get(338, ()))
    spp = get(277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    key = (photo, bps, extra)
    if len(bps) != spp or key not in _MODES or (big and key == (0, (16,), ())):
        raise ValueError(f"unsupported TIFF (photometric {photo}, bits per sample {bps}, "
                         f"extra samples {extra})")
    kind, rawmode = _MODES[key]
    bits = bps[0]
    # libtiff undoes the predictor for LZW and Deflate only
    predictor = get(317, 1) if comp in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise ValueError(f"unsupported TIFF (predictor {predictor} at {bits} bits)")
    tiled = 324 in tags
    if tiled:
        cw, ch = get(322), get(323)
        offsets, counts = tags[324], tags.get(325, ())
    else:
        cw, ch = w, min(get(278, h) or h, h)
        offsets, counts = tags.get(273, ()), tags.get(279, ())
    if not cw or not ch or not isinstance(cw, int) or not isinstance(ch, int):
        raise ValueError("TIFF strips or tiles of no size")
    planes = spp if planar == 2 else 1
    across, down = -(-w // cw), -(-h // ch)
    per_plane = across * down
    if len(offsets) < planes * per_plane or (comp != 1 and len(counts) < len(offsets)):
        raise ValueError("TIFF with fewer strip or tile offsets than its image needs")
    if comp == 1 and planar == 2:
        # Pillow reads each plane with one letter of its raw mode
        if (kind in ("LA", "PA") or len(offsets) != planes * per_plane
                or not all(c in "1LPRGBACMYK" for c in rawmode[:planes])):
            raise ValueError(f"unsupported TIFF (uncompressed, planar configuration 2, "
                             f"Pillow's raw mode {rawmode})")
        bits, kind = (1 if kind[0] == "1" else 8), kind.rstrip("I")
    elif planar == 2 and "X" in rawmode and (not tiled or kind == "P"):
        raise ValueError(f"unsupported TIFF ({'tiles' if tiled else 'strips'} in planar "
                         f"configuration 2 with unused samples, Pillow's raw mode {rawmode})")
    elif planar == 2 and photo == 2 and not extra and spp == 4:
        kind = "RGBa"  # libtiff's reading of an unlabelled fourth plane
    # (index of the strip or tile in the file's list, its region): libtiff
    # reads those the image needs; Pillow reads every offset of an
    # uncompressed file, a strip or tile past the image's last one again
    # over the first, in the order of the offsets, so the largest offset of
    # a region wins
    chunks = [(i, i) for i in range(planes * per_plane)]
    if comp == 1 and planar != 2:
        last = {}
        for i, off in enumerate(offsets):
            r = i % per_plane
            if r not in last or off >= offsets[last[r]]:
                last[r] = i
        chunks = sorted((i, r) for r, i in last.items())
    n = spp if planar != 2 else 1
    # Pillow's stride of a raw tile at the right edge, in bytes
    expected = (3 if photo == 2 else 4 if photo == 5 else 1) + len(extra)
    step = int(cw * sum(bps) / 8 / (expected if planar == 2 else 1))
    s = np.zeros((down * ch, across * cw, spp), np.int64)
    for i, r in chunks:
        p, (ty, tx) = r // per_plane, divmod(r % per_plane, across)
        x, y, off = tx * cw, ty * ch, offsets[i]
        rh = min(ch, h - y) if comp == 1 or not tiled else ch
        rw = min(cw, w - x) if comp == 1 else cw
        row = -(-rw * n * bits // 8)
        if comp == 1:
            rows = raw_rows(blob, off, rh, row, step if x + cw > w else 0, False, "TIFF")
        else:
            if len(blob) < off + counts[i]:
                raise ValueError("TIFF strip or tile past the end of the file "
                                 "(truncated file)")
            rows = _inflate(blob[off:off + counts[i]], comp, rh * row)[:rh * row]
            rows = rows.reshape(rh, row)
        v = _samples(rows, rw, n, bits, big)
        if predictor == 2:
            v = np.cumsum(v, axis=1) & ((1 << bits) - 1)
        s[y:y + rh, x:x + rw, p:p + n] = v
    s = s[:h, :w]
    rgba = _convert(s, kind, bits, tags)
    if planar == 2 and comp != 1 and kind in ("LA", "PA"):
        rgba[..., 3] = 0
    return rgba


def _convert(s: np.ndarray, kind: str, bits: int, tags: dict) -> np.ndarray:
    h, w, _ = s.shape
    rgba = np.full((h, w, 4), 255, np.uint8)
    v8 = s >> 8 if bits == 16 else s
    if kind in ("1", "1I", "L", "LI", "I16", "LA"):
        g = s[..., 0]
        if kind == "I16":
            g = np.minimum(g, 255)
        else:
            top = (1 << bits) - 1
            g = (top - g if kind.endswith("I") else g) * (255 // top)
        rgba[..., :3] = g[..., None]
        if kind == "LA":
            rgba[..., 3] = s[..., 1]
    elif kind in ("P", "PA"):
        cmap = np.asarray(tags.get(320, ()), np.int64) // 256
        k = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:k] = cmap[:3 * k].reshape(3, k).T
        rgba[..., :3] = palette[s[..., 0]]
        if kind == "PA":
            rgba[..., 3] = s[..., 1]
    elif kind == "CMYK":
        rgba[..., :3] = cmyk_to_rgb([255 - s[..., c] for c in range(4)], ycck=False)
    else:
        rgba[..., :3] = v8[..., :3]
        if kind == "RGBA":
            rgba[..., 3] = v8[..., 3]
        elif kind == "RGBa":
            a = v8[..., 3:4]
            c = np.where(a == 255, v8[..., :3],
                         np.minimum(255, v8[..., :3] * 255 // np.maximum(a, 1)))
            rgba[..., :3] = np.where(a == 0, 0, c)
            rgba[..., 3] = a[..., 0]
    return rgba
