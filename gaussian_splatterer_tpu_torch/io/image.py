"""Image load/save with ``zlib`` and ``struct`` only (counterpart of
gaussian_splatterer_tpu.io.image's ``save_png`` / ``load_png`` /
``load_texture_rgba``).

Conventions, as in the JAX package: framework images are (H, W, 3) float32
in [0, 1] whose row 0 is framebuffer row y = 0 (GL-style, bottom-up), so
PNG export flips vertically by default (reference screenshot path
src/ui/tools/UiPanelToolsView.cpp:237-239).  Quantisation is the
reference's value * 256 clamped to [0, 255] (src/Trainer.cu:25-27).

The writer emits 8-bit RGB, non-interlaced, filter type 0.  The readers
give Pillow's ``Image.open(path).convert("RGBA")`` (or ``"RGB"``) byte for
byte: PNG of every colour type and bit depth, interlaced or not, with
``PLTE`` and ``tRNS`` (io/png.py), TGA of image types 1, 2, 3, 9, 10 and 11
(io/tga.py), JPEG (io/jpeg.py), BMP and DIB (io/bmp.py), TIFF (io/tiff.py),
DDS (io/dds.py), GIF (io/gif.py), PNM (io/pnm.py) and WebP, lossy, lossless,
with alpha or animated (io/webp.py); each module lists what it reads, the
quirks of Pillow's it keeps and what it refuses.

Textures load to (H, W, 4) float32 RGBA in [0, 1] with row 0 the top of the
file, as the JAX package loads them (the tracer's texel lookup flips V
itself); a missing texture is an 8x8 mid-grey (0x80) opaque fallback
(src/rtx/RtxHost.cpp:23-36).  Each format but TGA is recognised by the
signature Pillow's plugin accepts (``signature_decoder``); a TGA by its
``.tga`` extension, last.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch.io.bmp import DIB_HEADER_SIZES, decode_bmp
from gaussian_splatterer_tpu_torch.io.dds import decode_dds
from gaussian_splatterer_tpu_torch.io.gif import decode_gif
from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg
from gaussian_splatterer_tpu_torch.io.png import SIGNATURE as _SIGNATURE
from gaussian_splatterer_tpu_torch.io.png import decode_png, decode_png_rgba
from gaussian_splatterer_tpu_torch.io.pnm import decode_pnm
from gaussian_splatterer_tpu_torch.io.tga import decode_tga
from gaussian_splatterer_tpu_torch.io.tiff import decode_tiff
from gaussian_splatterer_tpu_torch.io.webp import decode_webp


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


def signature_decoder(blob: bytes):
    """The decoder of the format whose signature ``blob`` starts with, or
    None: each decoder maps the file's bytes to (H, W, 4) uint8 RGBA."""
    if blob[:8] == _SIGNATURE:
        return decode_png_rgba
    if blob[:3] == b"\xff\xd8\xff":
        return decode_jpeg
    if blob[:2] == b"BM":
        return decode_bmp
    if len(blob) >= 4 and struct.unpack_from("<I", blob)[0] in DIB_HEADER_SIZES:
        return lambda b: decode_bmp(b, dib=True)
    if blob[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return decode_tiff
    if blob[:4] == b"DDS ":
        return decode_dds
    if blob[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif
    if blob[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P7", b"Pf", b"PF"):
        return decode_pnm
    if blob[:4] == b"RIFF" and blob[8:12] == b"WEBP" and blob[12:16] in (b"VP8 ", b"VP8L",
                                                                         b"VP8X"):
        return decode_webp
    return None


def load_texture_rgba(path: str) -> np.ndarray:
    """Texture file -> (H, W, 4) float32 RGBA in [0, 1], row 0 the top of
    the file.  PNG, JPEG, BMP, TIFF, DDS, GIF, PNM, WebP and TGA; any
    other format, and the variants of those that their modules do not read,
    raise ValueError."""
    with open(path, "rb") as fh:
        blob = fh.read()
    decode = signature_decoder(blob)
    if decode is None and path.lower().endswith(".tga"):
        decode = decode_tga
    if decode is None:
        raise ValueError(f"{path}: unknown texture format (PNG, JPEG, BMP, TIFF, DDS, GIF, "
                         "PNM, WebP or TGA)")
    try:
        rgba = decode(blob)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
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
