"""Writes the texture fixtures of tests/test_torch_textures.py and
chip_smoke.py phase 21 from the 256^2 mushroom texture of
gaussian_splatterer_tpu_torch.scripts.scenes (quantised as the port's
save_png quantises), and beside each its Pillow decode
(``Image.open(path).convert("RGBA")``) as an 8-bit RGBA PNG,
``<name>.pillow.png``:

  * mushroom256_palette_trns.png: 8-bit palette of the texture's colours
    and one more entry, transparent in the tRNS table, which every fourth
    band of 16 texel columns takes, so the mushroom has holes (zlib, the
    five row filters in turn);
  * mushroom256_rgba16.png: 16-bit RGBA, each sample the 8-bit value in the
    high byte and a pattern in the low one, the cap's spots half
    transparent (zlib, the five row filters in turn);
  * mushroom256_adam7.png: 8-bit RGB, Adam7 interlaced (zlib);
  * mushroom256_map_rle.tga: type 9, run-length encoded, 24-bit colour map
    (Pillow);
  * mushroom256_cmyk.jpg: CMYK JPEG with its Adobe APP14 marker (Pillow,
    quality 90);
  * mushroom256_bitfields.bmp: 32-bit BMP with a V5 header and an alpha
    mask (BI_BITFIELDS), the spots half transparent;
  * mushroom256_lzw_pred2.tif: RGBA TIFF, unassociated alpha, LZW with the
    horizontal predictor, strips of 32 rows;
  * mushroom256_dxt1.dds: DXT1 of the keyed palette PNG's decode (Pillow),
    so a quarter of the texels are punched out;
  * mushroom256_trns.gif: the keyed palette PNG as an interlaced GIF with
    its transparent index (Pillow);
  * mushroom256.ppm: raw PPM (P6, Pillow);
  * mushroom256_lossy.webp: a simple lossy WebP (VP8, quality 90, Pillow);
  * mushroom256_lossy_alpha.webp: the keyed palette PNG's decode as lossy
    WebP with alpha (VP8X, ALPH at Pillow's default alpha quality 100, so
    lossless, and VP8, quality 90): the WebP cut-out;
  * mushroom256_lossless.webp: lossless WebP (VP8L, method 6), the spots
    half transparent;
  * mushroom256_anim.webp: a two-frame animation, the keyed palette PNG's
    decode and then that decode rotated a quarter turn (Pillow, lossless
    and lossy frames mixed), whose first frame Pillow reads;

  * mushroom256_rgba.qoi: QOI of the texture, the spots half transparent
    (Pillow);
  * mushroom256_verbatim.sgi and mushroom256_rle.sgi: SGI of the texture, verbatim
    RGB (Pillow) and run-length encoded RGBA (the writer; Pillow writes
    verbatim only);
  * mushroom256_rgb.pcx, mushroom256_l.pcx, mushroom256_p.pcx and
    mushroom256_1.pcx: PCX of the texture in RGB, grey, a palette of its
    colours and black and white (Pillow);
  * mushroom256_icon.ico: an icon of the texture at 256, 48 and 16 pixels, PNG
    entries (Pillow);
  * mushroom256_grey.pfm: the texture's grey as a grey PFM (Pf), the floats
    v * 1.25 - 20.4 so that some clip at 0 and 255 and most carry a
    fraction (Pillow);
  * mushroom256_cutout.psd: the keyed palette PNG's decode as an RGBA PSD,
    PackBits (the writer; Pillow does not write PSD): the PSD cut-out;
  * mushroom256_cursor.cur: a 256^2 cursor of the keyed palette PNG's pixels,
    8 bits a pixel through its palette, with its AND mask (the writer);

  * mushroom256_arith_420.jpg, mushroom256_arith_progressive.jpg,
    mushroom256_lossless_p6.jpg, mushroom256_lossless_grey_p7.jpg and
    mushroom256_arith.tif: arithmetic-coded and lossless JPEG (the
    writers; Pillow writes neither), see ``jpeg_codings``;
  * mushroom256_jpeg_rgb.tif: JPEG in TIFF, photometric RGB (Pillow through
    libtiff, quality 90);
  * mushroom256_jpeg_ycbcr420.tif: JPEG in TIFF, YCbCr 4:2:0 in strips of 16
    rows, the tables in JPEGTables (the writer over Pillow's JPEG encoder;
    Pillow's TIFF writer cannot subsample);
  * mushroom256_g4_fill2.tif: the texture's black-and-white as CCITT Group 4
    with FillOrder 2 (Pillow through libtiff);
  * mushroom256_g3_2d.tif: the same as two-dimensional Group 3 (T4Options 1,
    Pillow through libtiff);
  * mushroom256_lzma.tif: LZMA RGB (Pillow through libtiff);
  * mushroom256_bigtiff.tif: a little-endian BigTIFF, LZW RGB (Pillow);
  * mushroom256_float.tif: the texture's grey as float samples, v * 1.25 -
    20.4 (Pillow, uncompressed);
  * mushroom256_signed16.tif: the grey as signed 16-bit samples, (v - 60) *
    3, so that some clip at 0 and at 255 (the writer, Deflate);
  * mushroom256_float_pred3.tif: the float grey with the floating-point
    predictor, LZW in tiles of 64 (the writer);
  * mushroom256_ycbcr_raw.tif: uncompressed YCbCr of the texture, with the
    bytes Pillow's RGBX raw mode reads past the data (the writer);
  * mushroom256_ycbcr420_lzw.tif, mushroom256_ycbcr422_tiles.tif,
    mushroom256_cielab.tif and mushroom256_lab.psd: YCbCr 4:2:0 (LZW strips)
    and 4:2:2 (Deflate tiles) in libtiff's subsampled layout, and the
    texture's L*a*b* as a CIELab TIFF and a PackBits LAB PSD (the writers),
    see ``lab_ycbcr``;
  * mushroom256_bc6h_uf16.dds and mushroom256_bc6h_sf16.dds: DX10 DDS of
    4,096 BC6H blocks each, seeded random bytes (every block is valid);
  * mushroom256_zstd_pred2.tif: Zstandard RGBA with predictor 2 (Pillow
    through libtiff, ``compression="zstd"``: Pillow's ``"tiff_zstd"`` writes
    an uncompressed file without a word, so ``zstd_tiffs`` checks tag 259);

and from tests/data/jpeg/mushroom1024_q90_420.png (the 1024^2 JPEG
fixture's Pillow decode) mushroom1024_jpeg.tif, JPEG in TIFF of its pixels
(photometric RGB, Pillow through libtiff), beside its Pillow decode
mushroom1024_jpeg.pillow.png; mushroom1024_g4.tif, Group 4 of its
black-and-white (Pillow), beside mushroom1024_g4.pillow.png;
mushroom1024_lzw.tif, an LZW TIFF of its pixels
(Pillow), whose Pillow decode is that PNG's; mushroom1024_lossless.webp,
lossless WebP of its pixels, likewise; and mushroom1024_q90.webp, lossy
WebP at quality 90, beside its Pillow decode mushroom1024_q90.pillow.png;
and mushroom1024.qoi, QOI of its pixels (Pillow; smaller than a PackBits
PSD of them), whose Pillow decode is that PNG's; and mushroom1024_zstd.tif,
a Zstandard TIFF of its pixels (Pillow: strips of 21 rows, each a frame of
a 4 MiB window), beside mushroom1024_zstd.pillow.png; the JPEG 2000
fixtures (``jpeg2000``): mushroom256_53.jp2, reversible 5/3 RGBA;
mushroom256_rpcl.j2k, an irreversible 9/7 RGB codestream in RPCL order, in
96^2 tiles offset by (3, 2), the image offset by (7, 5); and
mushroom1024_9x7.jp2, irreversible at a rate of 20 (about 150 KB), beside
mushroom1024_9x7.pillow.png.

    python tests/data/textures/make_fixtures.py
"""

import io
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

from texture_writers import (arith_jpeg_bytes, blp_bytes, bmp_bytes, bmp_rows,  # noqa: E402
                             dds_bytes, dxt_bytes, fits_bytes, fli_brun, fli_bytes, fli_colour,
                             ftex_bytes, gbr_bytes, icns_bytes, icns_rgb, icon_bitmap, icon_dir,
                             im_bytes, imt_bytes, iptc_bytes, lossless_jpeg_bytes, mcidas_bytes,
                             msp_bytes, pixar_bytes, png_bytes, psd_bytes, sgi_bytes, sun_bytes,
                             tiff_bytes, xpm_bytes, xvthumb_bytes)

from gaussian_splatterer_tpu_torch.io.image import float_image_to_u8  # noqa: E402
from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_texture  # noqa: E402

N = 256


def palette_trns(rgba: np.ndarray) -> None:
    colours, idx = np.unique(rgba[..., :3].reshape(-1, 3), axis=0, return_inverse=True)
    idx = idx.reshape(N, N, 1)
    hole = len(colours)  # one entry more, transparent
    idx[:, (np.arange(N) // 16) % 4 == 0] = hole
    plte = np.concatenate([colours, [[0, 0, 0]]]).astype(np.uint8).tobytes()
    with open(os.path.join(HERE, "mushroom256_palette_trns.png"), "wb") as fh:
        fh.write(png_bytes(idx, 8, 3, plte=plte, trns=bytes([255] * hole + [0])))


def rgba16(rgba: np.ndarray) -> None:
    yy, xx = np.mgrid[0:N, 0:N]
    low = ((xx * 7 + yy * 3) & 0xFF)[..., None]
    with open(os.path.join(HERE, "mushroom256_rgba16.png"), "wb") as fh:
        fh.write(png_bytes((rgba.astype(np.int64) << 8) | low, 16, 6))


def adam7(rgba: np.ndarray) -> None:
    with open(os.path.join(HERE, "mushroom256_adam7.png"), "wb") as fh:
        fh.write(png_bytes(rgba[..., :3].astype(np.int64), 8, 2, interlace=True))


def map_rle(rgba: np.ndarray) -> None:
    p = Image.fromarray(rgba[..., :3]).quantize(256, dither=Image.Dither.NONE)
    p.save(os.path.join(HERE, "mushroom256_map_rle.tga"), compression="tga_rle")


def cmyk(rgba: np.ndarray) -> None:
    rgb = rgba[..., :3].astype(np.int64)
    k = 255 - rgb.max(axis=-1, keepdims=True)
    c = np.where(k < 255, (255 - rgb - k) * 255 // np.maximum(255 - k, 1), 0)
    img = Image.fromarray(np.concatenate([c, k], axis=-1).astype(np.uint8), "CMYK")
    img.save(os.path.join(HERE, "mushroom256_cmyk.jpg"), quality=90)


def bitfields(rgba: np.ndarray) -> None:
    bgra = rgba[::-1][..., [2, 1, 0, 3]]  # bottom row first
    with open(os.path.join(HERE, "mushroom256_bitfields.bmp"), "wb") as fh:
        fh.write(bmp_bytes(bmp_rows(bgra, 32), N, N, 32, 124, 3,
                           masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))


def lzw_pred2(rgba: np.ndarray) -> None:
    with open(os.path.join(HERE, "mushroom256_lzw_pred2.tif"), "wb") as fh:
        fh.write(tiff_bytes(rgba, 8, 2, compression=5, predictor=2, extra=(2,),
                            rows_per_strip=32))


def keyed() -> Image.Image:
    return Image.open(os.path.join(HERE, "mushroom256_palette_trns.png"))


def dxt1(rgba: np.ndarray) -> None:
    keyed().convert("RGBA").save(os.path.join(HERE, "mushroom256_dxt1.dds"),
                                 pixel_format="DXT1")


def gif_trns(rgba: np.ndarray) -> None:
    keyed().save(os.path.join(HERE, "mushroom256_trns.gif"), interlace=True)


def ppm(rgba: np.ndarray) -> None:
    Image.fromarray(rgba[..., :3]).save(os.path.join(HERE, "mushroom256.ppm"))


def webp(rgba: np.ndarray) -> None:
    Image.fromarray(rgba[..., :3]).save(os.path.join(HERE, "mushroom256_lossy.webp"),
                                        quality=90)
    cut_out = keyed().convert("RGBA")
    cut_out.save(os.path.join(HERE, "mushroom256_lossy_alpha.webp"), quality=90)
    Image.fromarray(rgba).save(os.path.join(HERE, "mushroom256_lossless.webp"), lossless=True,
                               method=6)
    cut_out.save(os.path.join(HERE, "mushroom256_anim.webp"), save_all=True,
                 append_images=[cut_out.transpose(Image.Transpose.ROTATE_90)], duration=100,
                 allow_mixed=True, quality=90)


def qoi(rgba: np.ndarray) -> None:
    Image.fromarray(rgba).save(os.path.join(HERE, "mushroom256_rgba.qoi"))


def sgi(rgba: np.ndarray) -> None:
    Image.fromarray(rgba[..., :3]).save(os.path.join(HERE, "mushroom256_verbatim.sgi"))
    with open(os.path.join(HERE, "mushroom256_rle.sgi"), "wb") as fh:
        fh.write(sgi_bytes(rgba, 1, rle=True))


def pcx(rgba: np.ndarray) -> None:
    rgb = Image.fromarray(rgba[..., :3])
    rgb.save(os.path.join(HERE, "mushroom256_rgb.pcx"))
    rgb.convert("L").save(os.path.join(HERE, "mushroom256_l.pcx"))
    keyed().convert("RGB").quantize(256, dither=Image.Dither.NONE).save(
        os.path.join(HERE, "mushroom256_p.pcx"))
    rgb.convert("1").save(os.path.join(HERE, "mushroom256_1.pcx"))


def ico(rgba: np.ndarray) -> None:
    Image.fromarray(rgba).save(os.path.join(HERE, "mushroom256_icon.ico"),
                               sizes=[(256, 256), (48, 48), (16, 16)])


def pfm(rgba: np.ndarray) -> None:
    grey = np.asarray(Image.fromarray(rgba[..., :3]).convert("L"), np.float32)
    Image.fromarray(grey * np.float32(1.25) - np.float32(20.4), "F").save(
        os.path.join(HERE, "mushroom256_grey.pfm"))


def psd(rgba: np.ndarray) -> None:
    cut_out = np.asarray(keyed().convert("RGBA"))
    with open(os.path.join(HERE, "mushroom256_cutout.psd"), "wb") as fh:
        fh.write(psd_bytes(cut_out.transpose(2, 0, 1), 3, rle=True))


def cur(rgba: np.ndarray) -> None:
    p = keyed()
    idx = np.asarray(p)
    plte = np.asarray(p.getpalette(), np.uint8).reshape(-1, 3)
    table = np.zeros((256, 4), np.uint8)
    table[:len(plte), :3] = plte[:, ::-1]  # BGR0
    mask = np.asarray(p.convert("RGBA"))[..., 3] == 0
    bitmap = icon_bitmap(idx, 8, mask, table.tobytes())
    with open(os.path.join(HERE, "mushroom256_cursor.cur"), "wb") as fh:
        fh.write(icon_dir([(0, 0, 0, 128, 128, bitmap)], kind=2))


def _write(name: str, blob: bytes) -> None:
    with open(os.path.join(HERE, name), "wb") as fh:
        fh.write(blob)


def pillow_readers(rgba: np.ndarray) -> None:
    """The fixtures of tests/test_torch_pillow_readers.py (the last 19
    formats Pillow registers that the port reads)."""
    rgb = Image.fromarray(rgba[..., :3])
    grey = np.asarray(rgb.convert("L"))
    p = keyed().convert("RGB").quantize(256, dither=Image.Dither.NONE)
    idx, plte = np.asarray(p), np.asarray(p.getpalette()[:768], np.uint8).reshape(-1, 3)
    plte = np.concatenate([plte, np.zeros((256 - len(plte), 3), np.uint8)])
    cut_out = np.asarray(keyed().convert("RGBA"))
    _write("mushroom256_dxt5_cutout.blp", blp_bytes(2, N, N, dxt_bytes(cut_out, "dxt5"),
                                                    encoding=2, alpha=8, alpha_encoding=7))
    p.save(os.path.join(HERE, "mushroom256_blp_palette.blp"))
    _write("mushroom256_ftex.ftc", ftex_bytes(N, N, 0, dxt_bytes(rgba, "dxt1")))
    small = np.asarray(rgb.resize((32, 32)))
    icon = Image.fromarray(np.asarray(keyed().convert("RGB"))).quantize(
        64, dither=Image.Dither.NONE).convert("RGBA")
    buf = io.BytesIO()
    icon.save(buf, format="PNG", optimize=True)
    _write("mushroom256_icns.icns", icns_bytes([(b"il32", icns_rgb(small)),
                                                (b"l8mk", bytes([255]) * 1024),
                                                (b"ic08", buf.getvalue())]))
    cut128 = np.asarray(Image.fromarray(cut_out).resize((128, 128), Image.Resampling.NEAREST))
    _write("mushroom128_icns_rle.icns", icns_bytes([(b"it32", bytes(4) + icns_rgb(cut128[..., :3])),
                                                    (b"t8mk", cut128[..., 3].tobytes())]))
    buf = io.BytesIO()
    p.save(buf, format="PCX")
    _write("mushroom256_dcx.dcx", struct.pack("<II", 0x3ADE68B1, 12) + bytes(4) + buf.getvalue())
    rgb.convert("1").save(os.path.join(HERE, "mushroom256_xbm.xbm"))
    _write("mushroom256_xpm.xpm", xpm_bytes(idx, [tuple(c) for c in plte[:idx.max() + 1]]))
    _write("mushroom256_gbr.gbr", gbr_bytes(grey, 2))
    _write("mushroom256_sun_rle.ras", sun_bytes(idx.astype(np.uint8).tobytes(), N, N, 8, 2,
                                                plte.T.tobytes()))
    _write("mushroom256_msp.msp", msp_bytes(np.asarray(rgb.convert("1")) > 0, 2))
    _write("mushroom256_im_lut.im", im_bytes(b"Greyscale image", N, N,
                                             idx[::-1].astype(np.uint8).tobytes(),
                                             plte.T.tobytes()))
    _write("mushroom256_fli.flc", fli_bytes(N, N, [fli_colour(plte, six_bit=True),
                                                   fli_brun(idx)]))
    Image.fromarray(grey.astype(np.float32) * np.float32(1.25) - np.float32(20.4), "F").save(
        os.path.join(HERE, "mushroom256_spider.spider"), format="SPIDER")
    _write("mushroom256_fits.fits", fits_bytes(grey, 8))
    _write("mushroom256_mcidas.mcidas", mcidas_bytes(grey, 1))
    _write("mushroom256_pixar.pxr", pixar_bytes(rgba[..., :3]))
    _write("mushroom256_imt.imt", imt_bytes(grey))
    r, g, b = (rgba[..., c].astype(np.int64) for c in range(3))
    _write("mushroom256_xvthumb.xvthumb", xvthumb_bytes((r >> 5) << 5 | (g >> 5) << 2 | b >> 6))
    buf = io.BytesIO()
    rgb.convert("L").save(buf, format="JPEG", quality=90)
    _write("mushroom256_iptc.iim", iptc_bytes(N, N, 1, buf.getvalue(), compression=5))


def tiff_codecs(rgba: np.ndarray) -> None:
    rgb = Image.fromarray(rgba[..., :3])
    rgb.save(os.path.join(HERE, "mushroom256_jpeg_rgb.tif"), compression="jpeg", quality=90)
    with open(os.path.join(HERE, "mushroom256_jpeg_ycbcr420.tif"), "wb") as fh:
        fh.write(tiff_bytes(rgba[..., :3], 8, 6, compression=7, jpeg_subsampling=2,
                            rows_per_strip=16))
    bilevel = rgb.convert("1")
    bilevel.save(os.path.join(HERE, "mushroom256_g4_fill2.tif"), compression="group4",
                 tiffinfo={266: 2})
    bilevel.save(os.path.join(HERE, "mushroom256_g3_2d.tif"), compression="group3",
                 tiffinfo={292: 1})
    rgb.save(os.path.join(HERE, "mushroom256_lzma.tif"), compression="lzma")
    rgb.save(os.path.join(HERE, "mushroom256_bigtiff.tif"), compression="tiff_lzw", big_tiff=True)
    grey = np.asarray(rgb.convert("L"), np.float32)
    fgrey = grey * np.float32(1.25) - np.float32(20.4)
    Image.fromarray(fgrey, "F").save(os.path.join(HERE, "mushroom256_float.tif"))
    with open(os.path.join(HERE, "mushroom256_signed16.tif"), "wb") as fh:
        s16 = ((grey.astype(np.int64) - 60) * 3) & 0xFFFF
        fh.write(tiff_bytes(s16[..., None], 16, 1, compression=8, sample_format=2,
                            rows_per_strip=32))
    with open(os.path.join(HERE, "mushroom256_float_pred3.tif"), "wb") as fh:
        fh.write(tiff_bytes(fgrey[..., None], 32, 1, compression=5, predictor=3, tile=(64, 64),
                            sample_format=3))
    with open(os.path.join(HERE, "mushroom256_ycbcr_raw.tif"), "wb") as fh:
        ycc = np.asarray(rgb.convert("YCbCr")).astype(np.int64)
        fh.write(tiff_bytes(ycc, 8, 6, pad=bytes(N * N)))


def lab_ycbcr(rgba: np.ndarray) -> None:
    """YCbCr TIFFs in libtiff's subsampled layout and LAB textures (the
    writer; Pillow's TIFF writer cannot subsample and Pillow writes no LAB
    file): LZW 4:2:0 strips of 16 rows, Deflate 4:2:2 tiles of 64, a
    CIELab TIFF (LZW, a* and b* stored signed) and a PackBits LAB PSD of
    the texture's L*a*b* (Pillow's conversion through littleCMS)."""
    rgb = Image.fromarray(rgba[..., :3])
    ycc = np.asarray(rgb.convert("YCbCr")).astype(np.int64)
    _write("mushroom256_ycbcr420_lzw.tif", tiff_bytes(ycc, 8, 6, 5, ycbcr_subsampling=(2, 2),
                                                      rows_per_strip=16))
    _write("mushroom256_ycbcr422_tiles.tif", tiff_bytes(ycc, 8, 6, 8, ycbcr_subsampling=(2, 1),
                                                        tile=(64, 64)))
    lab = np.asarray(rgb.convert("LAB"))  # L*, a* + 128, b* + 128
    _write("mushroom256_cielab.tif", tiff_bytes(lab.astype(np.int64) ^ np.array([0, 128, 128]),
                                                8, 8, 5, rows_per_strip=32))
    _write("mushroom256_lab.psd", psd_bytes(lab.transpose(2, 0, 1), 9, rle=True))


def jpeg_codings(rgba: np.ndarray) -> None:
    """The JPEG codings Pillow reads and does not write (the writers):
    arithmetic-coded sequential 4:2:0 with a DAC segment and restarts,
    arithmetic-coded progressive, lossless RGB (predictor 6) and grey
    (predictor 7, point transform 1), and an arithmetic-coded JPEG-in-TIFF."""
    rgb = rgba[..., :3]
    grey = np.asarray(Image.fromarray(rgb).convert("L"))[..., None]
    _write("mushroom256_arith_420.jpg", arith_jpeg_bytes(
        rgb, sampling=[(2, 2), (1, 1), (1, 1)], quality=90, restart=16,
        dac=[(0x00, 0x21), (0x01, 0x10), (0x10, 8), (0x11, 3)]))
    _write("mushroom256_arith_progressive.jpg", arith_jpeg_bytes(rgb, quality=85,
                                                                 progressive=True))
    _write("mushroom256_lossless_p6.jpg", lossless_jpeg_bytes(rgb, 6))
    _write("mushroom256_lossless_grey_p7.jpg", lossless_jpeg_bytes(grey, 7, pt=1,
                                                                   restart_rows=32))
    _write("mushroom256_arith.tif", tiff_bytes(
        rgb.astype(np.int64), 8, 6, compression=7, rows_per_strip=64,
        jpeg_encoder=lambda c: arith_jpeg_bytes(c, quality=90, jfif=False)))


def bc6h(rgba: np.ndarray) -> None:
    rng = np.random.default_rng(22)
    for name, dxgi in (("uf16", 95), ("sf16", 96)):
        blocks = rng.integers(0, 256, (N // 4) * (N // 4) * 16).astype(np.uint8).tobytes()
        with open(os.path.join(HERE, f"mushroom256_bc6h_{name}.dds"), "wb") as fh:
            fh.write(dds_bytes(blocks, N, N, dxgi=dxgi))


def tiff_1024() -> None:
    rgb = Image.open(os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")).convert("RGB")
    rgb.save(os.path.join(HERE, "mushroom1024_jpeg.tif"), compression="jpeg", quality=90)
    rgb.convert("1").save(os.path.join(HERE, "mushroom1024_g4.tif"), compression="group4")
    for name in ("mushroom1024_jpeg", "mushroom1024_g4"):
        Image.open(os.path.join(HERE, f"{name}.tif")).convert("RGBA").save(
            os.path.join(HERE, f"{name}.pillow.png"), optimize=True)


def zstd_tiffs(rgba: np.ndarray) -> None:
    """The Zstandard TIFFs (Pillow through libtiff); each file's tag 259 is
    checked, since Pillow writes ``compression="tiff_zstd"`` uncompressed."""
    rgb = Image.open(os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")).convert("RGB")
    for img, name, info in ((Image.fromarray(rgba), "mushroom256_zstd_pred2", {317: 2}),
                            (rgb, "mushroom1024_zstd", {})):
        path = os.path.join(HERE, f"{name}.tif")
        img.save(path, compression="zstd", tiffinfo=info)
        with Image.open(path) as im:
            assert im.tag_v2[259] == 50000, f"{name}: Pillow wrote compression {im.tag_v2[259]}"
            im.convert("RGBA").save(os.path.join(HERE, f"{name}.pillow.png"), optimize=True)


def qoi_1024() -> None:
    rgb = Image.open(os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")).convert("RGB")
    rgb.save(os.path.join(HERE, "mushroom1024.qoi"))


def lzw_1024() -> None:
    png = os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")
    Image.open(png).convert("RGB").save(os.path.join(HERE, "mushroom1024_lzw.tif"),
                                        compression="tiff_lzw")


def webp_1024() -> None:
    rgb = Image.open(os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")).convert("RGB")
    rgb.save(os.path.join(HERE, "mushroom1024_lossless.webp"), lossless=True)
    rgb.save(os.path.join(HERE, "mushroom1024_q90.webp"), quality=90)
    Image.open(os.path.join(HERE, "mushroom1024_q90.webp")).convert("RGBA").save(
        os.path.join(HERE, "mushroom1024_q90.pillow.png"), optimize=True)


def jpeg2000(rgba: np.ndarray) -> None:
    """The JPEG 2000 fixtures (Pillow through OpenJPEG 2.5.4): a reversible
    RGBA JP2, an irreversible RGB codestream in RPCL order with tiles and an
    image offset, and a 1024^2 irreversible JP2 at a rate of 20 (about 150
    KB), beside its Pillow decode."""
    Image.fromarray(rgba).save(os.path.join(HERE, "mushroom256_53.jp2"))
    Image.fromarray(rgba[..., :3]).save(os.path.join(HERE, "mushroom256_rpcl.j2k"),
                                        irreversible=True, progression="RPCL", tile_size=(96, 96),
                                        offset=(7, 5), tile_offset=(3, 2), num_resolutions=4)
    rgb = Image.open(os.path.join(TESTS, "data", "jpeg", "mushroom1024_q90_420.png")).convert("RGB")
    path = os.path.join(HERE, "mushroom1024_9x7.jp2")
    rgb.save(path, irreversible=True, quality_mode="rates", quality_layers=[20])
    Image.open(path).convert("RGBA").save(os.path.join(HERE, "mushroom1024_9x7.pillow.png"),
                                          optimize=True)


def main() -> None:
    rgba = float_image_to_u8(mushroom_texture(n=N, spot_alpha=0.5))
    for write in (palette_trns, rgba16, adam7, map_rle, cmyk, bitfields, lzw_pred2, dxt1,
                  gif_trns, ppm, webp, qoi, sgi, pcx, ico, pfm, psd, cur, tiff_codecs, bc6h,
                  pillow_readers, jpeg_codings, lab_ycbcr, zstd_tiffs, jpeg2000):
        write(rgba)
    lzw_1024()
    tiff_1024()
    webp_1024()
    qoi_1024()
    for name in sorted(os.listdir(HERE)):
        if name.startswith(("mushroom256", "mushroom128")) and not name.endswith(
                (".pillow.png", ".py")):
            path = os.path.join(HERE, name)
            Image.open(path).convert("RGBA").save(
                os.path.join(HERE, name.rsplit(".", 1)[0] + ".pillow.png"), optimize=True)


if __name__ == "__main__":
    main()
