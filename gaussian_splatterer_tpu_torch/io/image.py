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
(io/tga.py), JPEG (io/jpeg.py), BMP and DIB (io/bmp.py), TIFF in every coding
Pillow reads (io/tiff.py; Zstandard through io/zstd.py),
DDS (io/dds.py), GIF (io/gif.py), PNM and grey PFM (io/pnm.py), WebP,
lossy, lossless, with alpha or animated (io/webp.py), PSD (io/psd.py), QOI
(io/qoi.py), SGI (io/sgi.py), PCX (io/pcx.py), ICO (io/ico.py), CUR
(io/cur.py), and the last readers Pillow registers: BLP (io/blp.py), FTEX
(io/ftex.py), ICNS (io/icns.py), DCX (io/dcx.py), XBM (io/xbm.py), XPM
(io/xpm.py), GBR (io/gbr.py), SUN (io/sun.py), MSP (io/msp.py), IM
(io/im.py), FLI (io/fli.py), SPIDER (io/spider.py), FITS (io/fits.py),
McIdas (io/mcidas.py), PIXAR (io/pixar.py), IMT (io/imt.py), XVThumb
(io/xvthumb.py), PCD (io/pcd.py) and IPTC (io/iptc.py), and JPEG 2000,
JP2 or raw codestream, 5/3 or 9/7 (io/jpeg2000.py), over Pillow's raw
modes and conversions (io/rawmode.py); each module lists what it reads,
the quirks of Pillow's it keeps and what it refuses.

Textures load to (H, W, 4) float32 RGBA in [0, 1] with row 0 the top of the
file, as the JAX package loads them (the tracer's texel lookup flips V
itself); a missing texture is an 8x8 mid-grey (0x80) opaque fallback
(src/rtx/RtxHost.cpp:23-36).

A file's format is found by its content, as ``Image.open`` finds it, never
by its name: ``FORMATS`` lists Pillow 12.1's 43 plugins in the order of
``Image.ID``, each with its ``accept`` test of the first 16
bytes, the checks of its ``_open`` that turn a file away (``opens``; a
reader raises ``NotThisFormat`` there, and the next format is tried) and
the port's decoder, or None for a format Pillow reads and the port does
not (io/pillow_open.py says which of those could take a file of a format
the port reads, TGA above all, which has no signature).  A decoder's
``ValueError`` refuses the file, as Pillow refuses it.  The readers of
BMP, DIB, GIF, JPEG, PNG, DDS, TIFF and WebP refuse every file their
format's ``accept`` takes and they cannot read, where Pillow would try its
next plugin on some of them; of the port's readers after theirs only IM,
IMT, IPTC, PCD and SPIDER, which have no signature, could take a file
that starts with theirs, and only one contrived to hold their headers
too, and a file that another of Pillow's plugins would read is refused
either way.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, NamedTuple, Optional

import numpy as np

from gaussian_splatterer_tpu_torch.io import (blp, cur, dcx, fits, fli, ftex, gbr, icns, ico, im,
                                              imt, iptc, jpeg2000, mcidas, msp, pcd, pcx, pixar,
                                              pnm, psd, qoi, sgi, spider, sun, tga, xbm, xpm,
                                              xvthumb)
from gaussian_splatterer_tpu_torch.io.bmp import DIB_HEADER_SIZES, decode_bmp
from gaussian_splatterer_tpu_torch.io.dds import decode_dds
from gaussian_splatterer_tpu_torch.io.gif import decode_gif
from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg
from gaussian_splatterer_tpu_torch.io.pillow_open import FOREIGN, ORDER, NotThisFormat
from gaussian_splatterer_tpu_torch.io.png import SIGNATURE as _SIGNATURE
from gaussian_splatterer_tpu_torch.io.png import decode_png, decode_png_rgba  # noqa: F401
from gaussian_splatterer_tpu_torch.io.tiff import decode_tiff
from gaussian_splatterer_tpu_torch.io.webp import decode_webp

READS = ("PNG, JPEG, BMP, DIB, GIF, PNM, PFM, TIFF, DDS, WebP, TGA, PSD, QOI, SGI, PCX, ICO, CUR, "
         "BLP, DCX, FITS, FLI, FTEX, GBR, ICNS, IM, IMT, IPTC, JPEG 2000, McIdas, MSP, PCD, "
         "PIXAR, SPIDER, SUN, XBM, XPM, XVThumb")


class Format(NamedTuple):
    name: str
    accept: Callable[[bytes], bool]  # Pillow's test of the first 16 bytes
    opens: Optional[Callable[[bytes], object]]  # the _open checks, or None
    decode: Optional[Callable[[bytes], np.ndarray]]  # -> (H, W, 4) uint8; None: not read


def _dib_accept(p: bytes) -> bool:
    return len(p) >= 4 and struct.unpack_from("<I", p)[0] in DIB_HEADER_SIZES


def _always(p: bytes) -> bool:
    return True


def _webp_accept(p: bytes) -> bool:
    return p[:4] == b"RIFF" and p[8:12] == b"WEBP" and p[12:16] in (b"VP8 ", b"VP8L", b"VP8X")


_READERS = {
    "BMP": (lambda p: p[:2] == b"BM", None, decode_bmp),
    "DIB": (_dib_accept, None, lambda b: decode_bmp(b, dib=True)),
    "GIF": (lambda p: p[:6] in (b"GIF87a", b"GIF89a"), None, decode_gif),
    "JPEG": (lambda p: p[:3] == b"\xff\xd8\xff", None, decode_jpeg),
    "PPM": (pnm.accept, None, pnm.decode_pnm),
    "PNG": (lambda p: p[:8] == _SIGNATURE, None, decode_png_rgba),
    "CUR": (lambda p: p[:4] == cur.SIGNATURE, cur.opens, cur.decode_cur),
    "PCX": (pcx.accept, pcx.opens, pcx.decode_pcx),
    "DDS": (lambda p: p[:4] == b"DDS ", None, decode_dds),
    "ICO": (lambda p: p[:4] == ico.SIGNATURE, ico.opens, ico.decode_ico),
    "TIFF": (lambda p: p[:4] in (b"MM\0*", b"II*\0", b"MM*\0", b"II\0*", b"MM\0+", b"II+\0"),
             None, decode_tiff),
    "PSD": (lambda p: p[:4] == psd.SIGNATURE, psd.opens, psd.decode_psd),
    "QOI": (lambda p: p[:4] == qoi.SIGNATURE, qoi.opens, qoi.decode_qoi),
    "SGI": (lambda p: len(p) >= 2 and p[0] << 8 | p[1] == sgi.MAGIC, sgi.opens, sgi.decode_sgi),
    "TGA": (_always, tga.opens, tga.decode_tga),
    "WEBP": (_webp_accept, None, decode_webp),
    "BLP": (lambda p: p[:4] in (b"BLP1", b"BLP2"), blp.opens, blp.decode_blp),
    "DCX": (dcx.accept, dcx.opens, dcx.decode_dcx),
    "FITS": (lambda p: p[:6] == b"SIMPLE", fits.opens, fits.decode_fits),
    "FLI": (fli.accept, fli.opens, fli.decode_fli),
    "FTEX": (lambda p: p[:4] == ftex.MAGIC, ftex.opens, ftex.decode_ftex),
    "GBR": (gbr.accept, gbr.opens, gbr.decode_gbr),
    "ICNS": (lambda p: p[:4] == icns.MAGIC, icns.opens, icns.decode_icns),
    "IM": (_always, im.opens, im.decode_im),
    "IMT": (_always, imt.opens, imt.decode_imt),
    "IPTC": (_always, iptc.opens, iptc.decode_iptc),
    "JPEG2000": (jpeg2000.accept, jpeg2000.opens, jpeg2000.decode_jpeg2000),
    "MCIDAS": (lambda p: p[:8] == mcidas.MAGIC, mcidas.opens, mcidas.decode_mcidas),
    "MSP": (msp.accept, msp.opens, msp.decode_msp),
    "PCD": (_always, pcd.opens, pcd.decode_pcd),
    "PIXAR": (lambda p: p[:4] == pixar.MAGIC, pixar.opens, pixar.decode_pixar),
    "SPIDER": (_always, spider.opens, spider.decode_spider),
    "SUN": (sun.accept, sun.opens, sun.decode_sun),
    "XBM": (xbm.accept, xbm.opens, xbm.decode_xbm),
    "XPM": (xpm.accept, xpm.opens, xpm.decode_xpm),
    "XVTHUMB": (lambda p: p[:6] == xvthumb.MAGIC, xvthumb.opens, xvthumb.decode_xvthumb),
}
FORMATS = tuple(Format(name, *(_READERS.get(name) or (*FOREIGN[name], None))) for name in ORDER)


def read_texture(blob: bytes) -> tuple[str, np.ndarray]:
    """A texture file's bytes -> (the name of the format that read it, the
    (H, W, 4) uint8 RGBA, row 0 the top of the file), Pillow's
    ``Image.open(...).convert("RGBA")``.  The first of ``FORMATS`` whose
    ``accept`` takes the first 16 bytes and whose ``opens`` and decoder do
    not turn the file away (``NotThisFormat``) reads it; a format the port
    does not read, a decoder's refusal and bytes that every format turns
    away raise ValueError."""
    prefix, turned_away = blob[:16], []
    for fmt in FORMATS:
        if not fmt.accept(prefix):
            continue
        try:
            if fmt.opens is not None:
                fmt.opens(blob)
            if fmt.decode is None:
                raise ValueError(f"a {fmt.name} file, which Pillow reads and the port does not")
            return fmt.name, fmt.decode(blob)
        except NotThisFormat as exc:
            if fmt.decode is not None:
                turned_away.append(f"{fmt.name}: {exc}")
    raise ValueError(f"unknown texture format (the port reads {READS})"
                     + "".join(f"; {why}" for why in turned_away))


def decode_texture(blob: bytes) -> np.ndarray:
    """``read_texture``'s RGBA."""
    return read_texture(blob)[1]


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


def load_texture_rgba(path: str) -> np.ndarray:
    """Texture file -> (H, W, 4) float32 RGBA in [0, 1], row 0 the top of
    the file, the format found by content in Pillow's order (``FORMATS``).
    A format the port does not read, and the variants of its formats that
    their modules do not read, raise ValueError."""
    with open(path, "rb") as fh:
        blob = fh.read()
    try:
        rgba = decode_texture(blob)
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
    """An image file of any format the texture loader reads -> (H, W, 3)
    float32 RGB in [0, 1], Pillow's ``convert("RGB")``; flipped to the
    framework's bottom-up rows by default."""
    with open(path, "rb") as fh:
        blob = fh.read()
    try:
        rgb = decode_texture(blob)[..., :3]
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    arr = rgb.astype(np.float32) / 255.0
    if flip_vertical:
        arr = arr[::-1]
    return arr
