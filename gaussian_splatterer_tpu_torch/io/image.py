"""PNG load/save with ``zlib`` and ``struct`` only (counterpart of
gaussian_splatterer_tpu.io.image's ``save_png`` / ``load_png``).

Conventions, as in the JAX package: framework images are (H, W, 3) float32
in [0, 1] whose row 0 is framebuffer row y = 0 (GL-style, bottom-up), so
PNG export flips vertically by default (reference screenshot path
src/ui/tools/UiPanelToolsView.cpp:237-239).  Quantisation is the
reference's value * 256 clamped to [0, 255] (src/Trainer.cu:25-27).

The writer emits 8-bit RGB, non-interlaced, filter type 0.  The reader
takes 8-bit grey, grey+alpha, RGB and RGBA, non-interlaced, with any of the
five PNG row filters.

Textures load to (H, W, 4) float32 RGBA in [0, 1] with row 0 the top of the
file, as Pillow's ``convert("RGBA")`` gives them (the tracer's texel lookup
flips V itself); a missing texture is an 8x8 mid-grey (0x80) opaque
fallback (src/rtx/RtxHost.cpp:23-36).  Texture formats: PNG as above,
TGA, uncompressed or run-length encoded true colour at 24 or 32 bits, and
JPEG as Pillow decodes it (io/jpeg.py).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def float_image_to_u8(img: np.ndarray) -> np.ndarray:
    """Reference quantisation: value*256, clamped to [0, 255] (src/Trainer.cu:25-27)."""
    return np.clip((np.asarray(img, np.float32) * 256.0).astype(np.int32), 0, 255).astype(
        np.uint8
    )


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (rows top to bottom as given)."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"encode_png wants (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 per row
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            c, up = [0] * stride, prev.tolist()
            for x, v in enumerate(line.tolist()):
                left = c[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                c[x] = (v + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _decode_png_samples(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 samples as stored (C = 1, 2, 3 or 4)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)


def _to_rgba(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 grey, grey+alpha, RGB or RGBA -> (H, W, 4) uint8."""
    h, w, ch = px.shape
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = px[..., :1] if ch <= 2 else px[..., :3]
    if ch in (2, 4):
        out[..., 3] = px[..., -1]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 (rows top to bottom as stored)."""
    return np.ascontiguousarray(_to_rgba(_decode_png_samples(blob))[..., :3])


def decode_png_rgba(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (rows top to bottom as stored)."""
    return _to_rgba(_decode_png_samples(blob))


def decode_tga(blob: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture.
    True colour only: image type 2 (uncompressed) or 10 (run-length
    encoded), 24 or 32 bits a pixel."""
    if len(blob) < 18:
        raise ValueError("TGA file too short")
    id_len, cmap_type, img_type = blob[0], blob[1], blob[2]
    cmap_len, cmap_bits = struct.unpack("<H", blob[5:7])[0], blob[7]
    w, h, bpp, desc = struct.unpack("<HHBB", blob[12:18])
    if img_type not in (2, 10) or bpp not in (24, 32):
        raise ValueError(f"unsupported TGA (image type {img_type}, {bpp} bits a pixel)")
    nb = bpp // 8
    pos = 18 + id_len + (cmap_len * ((cmap_bits + 7) // 8) if cmap_type else 0)
    count = w * h
    if img_type == 2:
        data = np.frombuffer(blob, np.uint8, count * nb, pos)
    else:
        data = np.empty(count * nb, np.uint8)
        out = 0
        while out < count:
            head = blob[pos]
            n = (head & 0x7F) + 1
            if head & 0x80:  # one pixel repeated n times
                data[out * nb:(out + n) * nb] = np.tile(
                    np.frombuffer(blob, np.uint8, nb, pos + 1), n)
                pos += 1 + nb
            else:  # n literal pixels
                data[out * nb:(out + n) * nb] = np.frombuffer(blob, np.uint8, n * nb, pos + 1)
                pos += 1 + n * nb
            out += n
    bgra = data.reshape(h, w, nb)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = bgra[..., 2::-1]
    if nb == 4:
        rgba[..., 3] = bgra[..., 3]
    if not desc & 0x20:  # stored bottom row first
        rgba = rgba[::-1]
    if desc & 0x10:  # stored right to left
        rgba = rgba[:, ::-1]
    return np.ascontiguousarray(rgba)


def load_texture_rgba(path: str) -> np.ndarray:
    """Texture file -> (H, W, 4) float32 RGBA in [0, 1], row 0 the top of
    the file.  PNG, TGA and JPEG (io/jpeg.py); any other format, and the
    JPEG variants io/jpeg.py does not read, raise ValueError."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] == _SIGNATURE:
        rgba = decode_png_rgba(blob)
    elif blob[:3] == b"\xff\xd8\xff":
        try:
            rgba = decode_jpeg(blob)
        except ValueError as exc:
            raise ValueError(f"{path}: {exc}") from None
    elif path.lower().endswith(".tga"):
        rgba = decode_tga(blob)
    else:
        raise ValueError(f"{path}: unknown texture format (PNG, TGA or JPEG)")
    return rgba.astype(np.float32) / 255.0


def blank_texture() -> np.ndarray:
    tex = np.full((8, 8, 4), 0x80 / 255.0, np.float32)
    tex[..., 3] = 1.0
    return tex


def save_png(img: np.ndarray, path: str, flip_vertical: bool = True) -> None:
    """img: (H, W, 3) float in [0, 1] or uint8."""
    arr = img if img.dtype == np.uint8 else float_image_to_u8(img)
    if flip_vertical:
        arr = arr[::-1]
    with open(path, "wb") as fh:
        fh.write(encode_png(np.ascontiguousarray(arr)))


def load_png(path: str, flip_vertical: bool = True) -> np.ndarray:
    with open(path, "rb") as fh:
        arr = decode_png(fh.read()).astype(np.float32) / 255.0
    if flip_vertical:
        arr = arr[::-1]
    return arr
