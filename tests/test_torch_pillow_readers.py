"""The port's readers of the last 19 formats Pillow registers that give
pixels without other software (io/blp.py, io/ftex.py, io/icns.py,
io/dcx.py, io/xbm.py, io/xpm.py, io/gbr.py, io/sun.py, io/msp.py,
io/im.py, io/fli.py, io/spider.py, io/fits.py, io/mcidas.py, io/pixar.py,
io/imt.py, io/xvthumb.py, io/pcd.py, io/iptc.py) against the JAX
package's load_texture_rgba, which is Pillow's
``Image.open(path).convert("RGBA")``: every writer case byte-equal, the
committed fixtures equal to the JAX decode and to their ``.pillow.png``,
the quirks Pillow keeps, the dispatch over all of ``Image.ID``, refused
variants, the native byte loops (SUN's, MSP's and ICNS's run lengths,
FLI's frame chunks) equal to their Python twins, and seeded mutants of
each format read alike or refused by both."""

import io
import os
import shutil
import struct
import warnings

import numpy as np
import pytest
from PIL import Image
from texture_writers import (blp_bytes, dxt_bytes, fits_bytes, fli_brun, fli_bytes, fli_chunk,
                             fli_colour, fli_lc, fli_ss2, ftex_bytes, gbr_bytes, icns_bytes,
                             icns_rgb, im_bytes, imt_bytes, iptc_bytes, mcidas_bytes, msp_bytes,
                             pcd_bytes, pixar_bytes, sun_bytes, xpm_bytes, xvthumb_bytes)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import fli, icns, msp, sun
from gaussian_splatterer_tpu_torch.io import image as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
W, H = 37, 29
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _runs(rng, shape, high: int = 256) -> np.ndarray:
    """Seeded samples in [0, high) with runs along each row and repeated
    rows (for the run-length coders)."""
    s = rng.integers(0, high, shape)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]
    s[::4] = s[0]
    return s


def _both(path):
    """(the JAX package's result or None where it raises, the port's or
    None where it raises ValueError)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jimage.load_texture_rgba(str(path))
    except Exception:  # noqa: BLE001 (Pillow raises what its plugin raises)
        want = None
    try:
        got = timage.load_texture_rgba(str(path))
    except ValueError:
        got = None
    return want, got


def _pillow(fmt, mode, w=W, h=H, **save):
    def make(rng):
        px = _runs(rng, (h, w, 4)).astype(np.uint8)
        out = io.BytesIO()
        Image.fromarray(px, "RGBA").convert(mode).save(out, format=fmt, **save)
        return out.getvalue()
    return make


# -- writer cases --

def _cutout(rng, w=40, h=32):
    px = _runs(rng, (h, w, 4)).astype(np.uint8)
    px[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, 255)
    return px


def _blp_dxt(kind, alpha, w=40, h=32):
    def make(rng):
        blocks = dxt_bytes(_cutout(rng, -(-w // 4) * 4, -(-h // 4) * 4), kind)
        return blp_bytes(2, w, h, blocks, encoding=2, alpha=alpha,
                         alpha_encoding={"dxt1": 0, "dxt3": 1, "dxt5": 7}[kind])
    return make


def _blp_palette(version, alpha):
    def make(rng):
        pal = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
        idx = _runs(rng, (H, W)).astype(np.uint8).tobytes()
        if version == 1:
            return blp_bytes(1, W, H, idx, compression=1, encoding=5, alpha=alpha, palette=pal)
        return blp_bytes(2, W, H, idx, encoding=1, alpha=alpha, palette=pal)
    return make


def _blp_jpeg(mode, alpha=0, split=200):
    def make(rng):
        out = io.BytesIO()
        Image.fromarray(_cutout(rng)[..., :3]).convert(mode).save(out, "JPEG", quality=90)
        j = out.getvalue()
        return blp_bytes(1, 40, 32, j[split:], compression=0, alpha=alpha, jpeg_header=j[:split])
    return make


def _ftex(fmt):
    def make(rng):
        if fmt == 0:
            return ftex_bytes(W, H, 0, dxt_bytes(_cutout(rng, 40, 32), "dxt1"))
        return ftex_bytes(W, H, 1, _runs(rng, (H, W, 3)).astype(np.uint8).tobytes())
    return make


def _png(rng, side, mode="RGBA"):
    out = io.BytesIO()
    Image.fromarray(_runs(rng, (side, side, 4)).astype(np.uint8)).convert(mode).save(out, "PNG")
    return out.getvalue()


def _icns(*kinds):
    def make(rng):
        elements = []
        for kind in kinds:
            side = {b"is32": 16, b"s8mk": 16, b"il32": 32, b"l8mk": 32, b"ih32": 48,
                    b"h8mk": 48, b"it32": 128, b"t8mk": 128, b"icp4": 16, b"icp5": 32,
                    b"ic07": 128}[kind]
            if kind.endswith(b"mk"):
                elements.append((kind, _runs(rng, (side, side)).astype(np.uint8).tobytes()))
            elif kind.startswith(b"ic"):
                elements.append((kind, _png(rng, side, "P" if kind == b"icp5" else "RGBA")))
            else:
                rgb = icns_rgb(_runs(rng, (side, side, 3)), rle=kind != b"ih32")
                elements.append((kind, (bytes(4) if kind == b"it32" else b"") + rgb))
        return icns_bytes(elements)
    return make


def _dcx(mode):
    def make(rng):
        out = io.BytesIO()
        Image.fromarray(_runs(rng, (H, W, 4)).astype(np.uint8)).convert(mode).save(out, "PCX")
        page = out.getvalue()
        return struct.pack("<II", 0x3ADE68B1, 12) + bytes(4) + page
    return make


def _xpm(colours, cpp=1, none_key=False):
    def make(rng):
        cols = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(colours)]
        idx = _runs(rng, (H, W), colours)
        return xpm_bytes(idx, cols, cpp, none_key)
    return make


def _gbr(version, depth):
    def make(rng):
        px = _runs(rng, (H, W, 4) if depth == 4 else (H, W)).astype(np.uint8)
        return gbr_bytes(px, version)
    return make


def _sun(depth, file_type, colour_map=False):
    def make(rng):
        stride = (W * depth + 15) // 16 * 2
        line = (W * depth + 7) // 8
        rows = _runs(rng, (H, stride)).astype(np.uint8)
        if file_type == 2:
            rows = rows[:, :line]
        cmap = rng.integers(0, 256, 3 * (1 << min(depth, 8))).astype(np.uint8).tobytes() \
            if colour_map else b""
        return sun_bytes(rows.tobytes(), W, H, depth, file_type, cmap)
    return make


def _msp(version):
    def make(rng):
        bits = (_runs(rng, (H, W), 2) > 0).astype(np.uint8)
        bits[3] = 1
        return msp_bytes(bits, version)
    return make


def _im(kind, bands, bits=8, lut=None):
    def make(rng):
        n = {8: W * H * bands, 32: 4 * W * H * bands}.get(bits, (W * bits + 7) // 8 * H)
        data = _runs(rng, (1, n)).astype(np.uint8).tobytes()
        table = b""
        if lut == "colour":
            table = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
        elif lut == "grey":
            table = bytes(np.tile(np.arange(256)[::-1], 3).astype(np.uint8))
        return im_bytes(kind, W, H, data, table)
    return make


def _fli(*kinds, six_bit=False):
    def make(rng):
        img = _runs(rng, (H, 38)).astype(np.uint8)
        chunks = [fli_colour(rng.integers(0, 256, (256, 3)), six_bit)]
        for kind in kinds:
            if kind == "brun":
                chunks.append(fli_brun(img))
            elif kind == "copy":
                chunks.append(fli_chunk(16, img.tobytes()))
            elif kind == "lc":
                chunks.append(fli_lc(img[5:20] ^ 7, 5))
            elif kind == "ss2":
                chunks.append(fli_ss2(img[:20] ^ 3))
            elif kind == "black":
                chunks.append(fli_chunk(13, b""))
        return fli_bytes(38, H, chunks)
    return make


def _fits(bitpix, gzip_tile=False):
    def make(rng):
        s = rng.normal(120, 120, (H, W)) if bitpix < 0 else _runs(rng, (H, W), 1 << 15 if
                                                                   bitpix > 8 else 256)
        if bitpix == 16:
            s = s - 10000
        return fits_bytes(s, bitpix, [("OBJECT", "'test'")], gzip_tile)
    return make


def _mcidas(size):
    def make(rng):
        return mcidas_bytes(_runs(rng, (H, W), 1 << min(8 * size, 20)) - (size == 4) * 50,
                            size, prefix=3)
    return make


CASES = {
    "blp2_dxt1": _blp_dxt("dxt1", 0),
    "blp2_dxt1_alpha": _blp_dxt("dxt1", 8),
    "blp2_dxt3": _blp_dxt("dxt3", 8),
    "blp2_dxt5": _blp_dxt("dxt5", 8),
    "blp2_dxt5_no_alpha": _blp_dxt("dxt5", 0),
    "blp2_dxt5_sheared": _blp_dxt("dxt5", 8, 37, 30),
    "blp2_palette": _blp_palette(2, 0),
    "blp2_palette_alpha": _blp_palette(2, 8),
    "blp1_palette_alpha": _blp_palette(1, 8),
    "blp1_jpeg": _blp_jpeg("RGB"),
    "blp1_jpeg_alpha": _blp_jpeg("RGB", 1, 300),
    "blp1_jpeg_cmyk": _blp_jpeg("CMYK", 0, 100),
    "blp_pillow": _pillow("BLP", "P"),
    "ftex_dxt1": _ftex(0),
    "ftex_rgb": _ftex(1),
    "icns_rle_with_masks": _icns(b"is32", b"s8mk", b"il32", b"l8mk"),
    "icns_raw_48": _icns(b"is32", b"ih32", b"h8mk"),
    "icns_it32_no_mask": _icns(b"il32", b"it32"),
    "icns_png": _icns(b"is32", b"icp4", b"icp5"),
    "dcx_rgb": _dcx("RGB"),
    "dcx_palette": _dcx("P"),
    "xbm_pillow": _pillow("XBM", "1"),
    "xpm_palette": _xpm(40),
    "xpm_two_characters": _xpm(300, cpp=2),
    "xpm_none_key_unused": _xpm(5, none_key=True),
    "gbr_v1_grey": _gbr(1, 1),
    "gbr_v2_rgba": _gbr(2, 4),
    "sun_1": _sun(1, 1),
    "sun_4_map": _sun(4, 1, True),
    "sun_8_grey_rle": _sun(8, 2),
    "sun_8_map_rle": _sun(8, 2, True),
    "sun_24_bgr": _sun(24, 1),
    "sun_24_rgb": _sun(24, 3),
    "sun_32_rle": _sun(32, 2),
    "msp_v1": _msp(1),
    "msp_v2": _msp(2),
    "msp_pillow": _pillow("MSP", "1"),
    "im_pillow_rgb": _pillow("IM", "RGB"),
    "im_pillow_rgba": _pillow("IM", "RGBA"),
    "im_pillow_cmyk": _pillow("IM", "CMYK"),
    "im_pillow_la": _pillow("IM", "LA"),
    "im_pillow_p": _pillow("IM", "P"),
    "im_pillow_1": _pillow("IM", "1"),
    "im_pillow_ycc": _pillow("IM", "YCbCr"),
    "im_b4": _im(b"B4 image", 1, 4),
    "im_b4_colour_lut": _im(b"B4 image", 1, 8, "colour"),
    "im_grey_lut_ignored": _im(b"Greyscale image", 1, 8, "grey"),
    "im_pa_lut": _im(b"PA image", 2, 8, "colour"),
    "im_rgb3": _im(b"RGB3 image", 3),
    "im_x24": _im(b"X 24 image", 3),
    "im_32s": _im(b"L 32S image", 1, 32),
    "im_float": _im(b"L 32F image", 1, 32),
    "im_bits_12": _im(b"L*12 image", 1, 12),
    "im_16b": _im(b"L 16B image", 2),
    "fli_brun": _fli("brun"),
    "fli_copy_lc": _fli("copy", "lc", six_bit=True),
    "fli_black_ss2": _fli("black", "ss2"),
    "spider_pillow": lambda rng: _spider(rng),
    "fits_8": _fits(8),
    "fits_16": _fits(16),
    "fits_32": _fits(32),
    "fits_float": _fits(-32),
    "fits_double": _fits(-64),
    "fits_gzip_16": _fits(16, True),
    "mcidas_8": _mcidas(1),
    "mcidas_16": _mcidas(2),
    "mcidas_32": _mcidas(4),
    "pixar": lambda rng: pixar_bytes(_runs(rng, (H, W, 3))),
    "imt": lambda rng: imt_bytes(_runs(rng, (H, W))),
    "xvthumb": lambda rng: xvthumb_bytes(_runs(rng, (H, W))),
    "iptc_raw_grey": lambda rng: iptc_bytes(W, H, 1, _runs(rng, (H, W)).astype(np.uint8)
                                            .tobytes(), chunk=500),
    "iptc_raw_rgb_band": lambda rng: iptc_bytes(W, H, 3, _runs(rng, (H, W)).astype(np.uint8)
                                                .tobytes(), band=2),
    "iptc_jpeg": lambda rng: iptc_bytes(W, H, 1, _jpeg(rng, "RGB"), compression=5),
    "iptc_jpeg_cmyk_band": lambda rng: iptc_bytes(W, H, 4, _jpeg(rng, "L"), compression=5,
                                                  band=1),
}


def _spider(rng):
    out = io.BytesIO()
    f = rng.normal(100, 90, (H, W)).astype(np.float32)
    Image.fromarray(f, "F").save(out, format="SPIDER")
    return out.getvalue()


def _jpeg(rng, mode):
    out = io.BytesIO()
    Image.fromarray(_runs(rng, (H, W, 3)).astype(np.uint8)).convert(mode).save(out, "JPEG")
    return out.getvalue()


def _pcd(orientation):
    def make(rng):
        y = _runs(rng, (512, 768))
        return pcd_bytes(y, rng.integers(0, 256, (256, 384)), rng.integers(0, 256, (256, 384)),
                         orientation)
    return make


CASES.update({"pcd": _pcd(0), "pcd_turned_90": _pcd(1), "pcd_turned_270": _pcd(3)})


@pytest.mark.parametrize("name", list(CASES))
def test_writer_case_equals_jax(tmp_path, name):
    """Every case (at most 40 x 32 but PCD's 768 x 512 and ICNS's 128^2,
    seeded from its name), loaded by path: the port's floats equal the JAX
    package's, byte for byte, and the format is the one Pillow names."""
    path = tmp_path / f"{name}.bin"
    blob = CASES[name](_rng(name))
    path.write_bytes(blob)
    want = jimage.load_texture_rgba(str(path))
    got = timage.load_texture_rgba(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with Image.open(path) as img:
        assert timage.read_texture(blob)[0] == img.format.upper()


def test_quirks_of_the_new_formats():
    """Values Pillow gives and the port keeps: BLP's 5:6:5 colours shifted
    without their high bits and a BLP1 JPEG's red and blue swapped; SUN's
    32-bit pixels BGRX, the pad byte last; FITS's 16-bit samples read
    little-endian; the XPM ``None`` key's characters as the first
    palette alphas (and a pixel of that key refused); an ICNS JPEG 2000
    element read as Pillow reads it."""
    block = struct.pack("<HHI", 0xFFFF, 0x0841, 0)  # c0 white, c1 (1, 2, 1) in 5:6:5
    dxt1 = blp_bytes(2, 4, 4, block, encoding=2, alpha_encoding=0)
    assert timage.decode_texture(dxt1)[0, 0].tolist() == [248, 252, 248, 255]
    jpeg = _jpeg(_rng("q"), "RGB")
    blp1 = blp_bytes(1, W, H, jpeg[200:], compression=0, jpeg_header=jpeg[:200])
    np.testing.assert_array_equal(timage.decode_texture(blp1)[..., :3],
                                  timage.decode_texture(jpeg)[..., 2::-1])
    bgrx = sun_bytes(bytes([10, 20, 30, 40] * 3), 3, 1, 32)  # width 1 or 2 reads as GBR
    assert timage.decode_texture(bgrx)[0, 0].tolist() == [30, 20, 10, 255]
    fits = fits_bytes(np.array([[1]]), 16)  # stored 00 01, read as 0x0100
    assert timage.decode_texture(fits)[0, 0].tolist() == [255, 255, 255, 255]
    fits = fits_bytes(np.array([[0x2300]]), 16)  # stored 23 00, read as 0x0023
    assert timage.decode_texture(fits)[0, 0].tolist() == [35, 35, 35, 255]
    xpm = xpm_bytes(np.zeros((1, 2), int), [(9, 8, 7)], none_key=True)
    assert timage.decode_texture(xpm)[0, 0].tolist() == [9, 8, 7, ord("$")]
    with pytest.raises(ValueError, match="palette lacks"):
        timage.decode_texture(xpm.replace(b'"##",', b'"#$",'))
    buf = io.BytesIO()
    Image.fromarray(_rng("j").integers(0, 256, (256, 256, 4), dtype=np.uint8)).save(buf, "JPEG2000")
    j2k = icns_bytes([(b"ic08", buf.getvalue())])
    with Image.open(io.BytesIO(j2k)) as im:
        np.testing.assert_array_equal(timage.decode_texture(j2k), np.asarray(im.convert("RGBA")))


# -- the dispatch over all of Image.ID --

def _with_name(blob, fname, reads=True):
    return blob, fname, reads


DISPATCH = {  # name -> (bytes, file name, the JAX package reads it)
    "im_under_png": (CASES["im_pillow_rgb"](_rng("d1")), "t.png", True),
    "spider_without_extension": (CASES["spider_pillow"](_rng("d2")), "t", True),
    "iptc_under_jpg": (CASES["iptc_raw_grey"](_rng("d3")), "t.jpg", True),
    "xbm_under_tga": (CASES["xbm_pillow"](_rng("d4")), "t.tga", True),
    "pcd_under_tif": (CASES["pcd"](_rng("d5")), "t.tif", True),
    "sun_under_bmp": (CASES["sun_8_map_rle"](_rng("d6")), "t.bmp", True),
    "gbr_depth_2_turned_away": (bytes(CASES["gbr_v1_grey"](_rng("d7"))[:16]) + struct.pack(
        ">I", 2) + bytes(100), "t.gbr", False),
    "wmf_refused": (b"\x01\x00\x00\x00" + bytes(60), "t.wmf", False),
    "mpeg_refused": (b"\x00\x00\x01\xb3\x10\x01\x00" + bytes(40), "t.mpg", False),
    "eps_refused": (b"%!PS-Adobe-3.0\n" + bytes(40), "t.eps", False),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_follows_pillow(tmp_path, name):
    """The format is found by content in Image.ID's order, under any name;
    the formats the port does not read (MPEG, WMF, EPS) are refused by both
    here, as a GBR brush of another depth is."""
    blob, fname, reads = DISPATCH[name]
    path = tmp_path / fname
    path.write_bytes(blob)
    want, got = _both(path)
    assert (want is not None) == reads
    assert (got is not None) == reads
    if reads:
        np.testing.assert_array_equal(got, want)


def test_foreign_formats_are_the_eight():
    """FORMATS covers every reader Pillow registers, in Image.ID's order,
    and only AVIF and the six that need other software are not read by
    the port."""
    Image.preinit()
    Image.init()
    assert [f.name for f in timage.FORMATS] == list(Image.ID)
    foreign = [f.name for f in timage.FORMATS if f.decode is None]
    assert foreign == ["AVIF", "BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF"]


REFUSED = {  # name -> (bytes, message, the JAX package refuses it too)
    "blp_raw_bgra": (blp_bytes(2, 2, 2, bytes(16), encoding=3), "BLP encoding 3", True),
    "blp_alpha_encoding_8": (blp_bytes(2, 4, 4, bytes(16), encoding=2, alpha_encoding=8),
                             "alpha encoding", True),
    "blp_truncated": (CASES["blp2_dxt5"](_rng("r1"))[:-40], "BLP", True),
    "ftex_format_2": (ftex_bytes(2, 2, 2, bytes(12)), "Invalid texture compression", True),
    "ftex_two_formats": (ftex_bytes(2, 2, 1, bytes(12))[:20] + struct.pack("<i", 2)
                         + ftex_bytes(2, 2, 1, bytes(12))[24:], "AssertionError", True),
    "icns_mask_only": (icns_bytes([(b"s8mk", bytes(256))]), "RGB", True),
    "icns_run_past_channel": (icns_bytes([(b"is32", b"\xff\x01" * 3 + bytes(800))]),
                              "channel", True),
    "xpm_named_colour": (b'/* XPM */\n"1 1 1 1",\n"a c red",\n"a"\n', "XPM", True),
    "sun_map_on_24_bits": (sun_bytes(bytes(10), 3, 1, 24, colour_map=bytes(6)),
                           "colour map", True),
    "msp_truncated_rows": (CASES["msp_v2"](_rng("r2"))[:-30], "MSP", True),
    "im_rlb": (im_bytes(b"RLB image", 2, 2, bytes(12)), "raw mode", True),
    "fli_unknown_chunk": (fli_bytes(4, 4, [fli_chunk(99, bytes(4))]), "FLI", True),
    "fits_no_image": (fits_bytes(np.zeros((0, 0)), 8), "FITS", True),
    "fits_gzip_float": (CASES["fits_gzip_16"](_rng("r3")).replace(
        b"ZBITPIX =                   16", b"ZBITPIX =                  -32"), "FITS", True),
    "imt_no_form_feed": (imt_bytes(np.zeros((2, 2)))[:-5], "IMT", True),
    "iptc_compression_3": (iptc_bytes(2, 2, 1, bytes(4), compression=3), "IPTC", True),
    "pcd_truncated": (CASES["pcd"](_rng("r4"))[:-100], "PCD", True),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_variants_raise(tmp_path, name):
    """A variant Pillow refuses raises ValueError naming it, and the JAX
    package refuses it too."""
    blob, match, jax_refuses = REFUSED[name]
    path = tmp_path / f"{name}.bin"
    path.write_bytes(blob)
    want, _ = _both(path)
    assert (want is None) == jax_refuses
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


# -- the committed fixtures --

NEW_FIXTURES = ("mushroom256_dxt5_cutout.blp", "mushroom256_blp_palette.blp",
                "mushroom256_ftex.ftc", "mushroom256_icns.icns", "mushroom256_dcx.dcx",
                "mushroom256_xbm.xbm", "mushroom256_xpm.xpm", "mushroom256_gbr.gbr",
                "mushroom256_sun_rle.ras", "mushroom256_msp.msp", "mushroom256_im_lut.im",
                "mushroom256_fli.flc", "mushroom256_spider.spider", "mushroom256_fits.fits",
                "mushroom256_mcidas.mcidas", "mushroom256_pixar.pxr", "mushroom256_imt.imt",
                "mushroom256_xvthumb.xvthumb", "mushroom256_iptc.iim",
                "mushroom128_icns_rle.icns")


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each fixture equals the JAX
    package's load and the 8-bit RGBA PNG of its Pillow decode."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    decode = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, timage.load_texture_rgba(decode))
    assert got.shape[:2] == ((128, 128) if "128" in name else (256, 256))


# -- the native loops and the mutants --

def _loop_inputs(rng, loop):
    n = int(rng.integers(0, 400))
    data = rng.integers(0, 256, n).astype(np.uint8)
    if n:
        data[rng.integers(0, n, n // 3)] = rng.choice([0, 1, 2, 0x7F, 0x80, 0x81, 0xFE, 0xFF])
    data = data.tobytes()
    if loop == "sun":
        return sun.rle_rows_python, native.sun_rle, (
            data, int(rng.integers(1, 20)), int(rng.integers(1, 10)))
    if loop == "msp":
        h = int(rng.integers(1, 8))
        rowmap = struct.pack(f"<{h}H", *(int(v) for v in rng.integers(0, 40, h)))
        return msp.rle_rows_python, native.msp_rle, (rowmap + data, int(rng.integers(1, 40)), h)
    if loop == "icns":
        return icns.rle_channels_python, native.icns_rle, (data, int(rng.integers(1, 60)))
    return _fli_python, _fli_native, (_fli_frame(rng, data), int(rng.integers(1, 12)),
                                      int(rng.integers(1, 9)))


def _fli_frame(rng, data: bytes) -> bytes:
    """A frame header and chunks of seeded types and sizes over ``data``."""
    chunks, pos = [], 0
    for _ in range(int(rng.integers(0, 4))):
        size = int(rng.integers(0, 90))
        kind = int(rng.choice([4, 7, 11, 12, 13, 15, 16, 18, 99]))
        chunks.append(struct.pack("<IH", int(rng.choice([size + 6, 0, size + 3, 7])), kind)
                      + data[pos:pos + size])
        pos += size
    body = b"".join(chunks)
    return struct.pack("<IHH8x", int(rng.choice([16 + len(body), 5, 16 + len(body) + 9])),
                       int(rng.choice([0xF1FA, 0xF1FA, 0x1234])), len(chunks)) + body


def _fli_python(buf, w, h):
    img = np.full((h, w), 7, np.uint8)
    return img, fli.frame_python(buf, img)


def _fli_native(buf, w, h):
    img = np.full((h, w), 7, np.uint8)
    return img, native.fli_frame(buf, img)


@needs_gxx
@pytest.mark.parametrize("loop", ["sun", "msp", "icns", "fli"])
def test_native_loop_equals_python(loop):
    """Each byte loop in C++ against its Python twin on 400 seeded inputs,
    broken ones included: the same bytes and the same status."""
    rng = _rng(loop)
    assert native.lib() is not None
    for _ in range(400):
        python, cxx, args = _loop_inputs(rng, loop)
        want, got = python(*args), cxx(*args)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def _mutant(rng, blob: bytes) -> bytes:
    b = bytearray(blob)
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(b[:rng.integers(1, len(b))])
    if kind == 1:
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
    elif kind == 2:
        b[rng.integers(0, min(len(b), 80))] = rng.integers(0, 256)
    else:
        at = rng.integers(0, len(b))
        b[at:at] = rng.integers(0, 256, rng.integers(1, 8)).astype(np.uint8).tobytes()
    return bytes(b)


FORMATS = ("blp", "ftex", "icns", "dcx", "xbm", "xpm", "gbr", "sun", "msp", "im_", "fli",
           "spider", "fits", "mcidas", "pixar", "imt", "xvthumb", "pcd", "iptc")
# fault C-8 (ROADMAP, fixed): a JPEG inside BLP1 or IPTC that is cut short or
# damaged, which Pillow's libjpeg-turbo refused or decoded otherwise than
# io/jpeg.py; none is left at the test's seeds
KNOWN: dict = {}


@pytest.mark.parametrize("fmt", FORMATS)
def test_mutants_agree_with_jax(tmp_path, fmt):
    """20 seeded mutants (truncations, byte flips, insertions) of the
    format's writer cases: each is read to the JAX package's bytes, or
    refused by both (the port with ValueError), but for the recorded
    faults, whose counts at this seed are held exactly."""
    rng = _rng(fmt)
    names = [n for n in CASES if n.startswith(fmt) and n not in ("pcd_turned_90",
                                                               "pcd_turned_270")]
    sources = [CASES[n](_rng(n)) for n in names]
    path = tmp_path / "m.bin"
    faults = {}
    for i in range(20):
        path.write_bytes(_mutant(rng, sources[i % len(sources)]))
        want, got = _both(path)
        if (want is None) == (got is None) and (want is None or np.array_equal(got, want)):
            continue
        fault = "C-8" if fmt in ("blp", "iptc") else "new"
        faults[fault] = faults.get(fault, 0) + 1
    assert faults == KNOWN.get(fmt, {})


MUTANT_SCRIPT = r"""
import sys
import numpy as np
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.image import read_texture
assert native.lib() is not None
rng = np.random.default_rng(23)
counts = {"array": 0, "ValueError": 0}
for path in sys.argv[1:]:
    blob = open(path, "rb").read()
    for _ in range(150):
        b = bytearray(blob)
        kind = rng.integers(0, 3)
        if kind == 0:
            b = b[:rng.integers(1, len(b))]
        else:
            lo = 0 if kind == 1 else min(len(b) - 1, 300)
            for _ in range(rng.integers(1, 6)):
                b[rng.integers(lo, len(b))] = rng.integers(0, 256)
        try:
            read_texture(bytes(b))
            counts["array"] += 1
        except ValueError:
            counts["ValueError"] += 1
print(counts)
"""


@needs_gxx
def test_mutated_fixtures_never_crash_the_native_loops(tmp_path):
    """150 seeded mutants of each fixture whose decode runs a new native
    loop (SUN's and MSP's run lengths, FLI's frame chunks, ICNS's run
    lengths) through read_texture, all in one subprocess: each gives an
    array or ValueError, and the process exits 0 (a crash in the C++ fails
    this test only)."""
    import subprocess
    import sys

    names = ("mushroom256_sun_rle.ras", "mushroom256_msp.msp", "mushroom256_fli.flc",
             "mushroom128_icns_rle.icns")
    paths = [os.path.join(FIXTURES, n) for n in names]
    script = tmp_path / "mutants.py"
    script.write_text(MUTANT_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script), *paths], capture_output=True, text=True,
                          timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])  # noqa: S307 (our own dict literal)
    assert counts["array"] + counts["ValueError"] == 150 * len(paths)
    assert counts["ValueError"] > 0


# -- the repairs of fault C-7 this reader set brought (ROADMAP C) --

@pytest.mark.parametrize("back", [1, 6, 12, 19, 25])
def test_lzma_strip_damaged_past_its_data_reads_as_libtiff(tmp_path, back):
    """An LZMA TIFF strip damaged ``back`` bytes from its end, in the xz
    stream's end marker, check, index or footer: libtiff keeps the strip,
    whose bytes all came before the damage, and so does the port."""
    from test_torch_tiff_codecs import CASES as TIFF_CASES

    blob = bytearray(TIFF_CASES["lzma_pillow_rgb"](_rng("lzma")))
    ifd = struct.unpack_from("<I", blob, 4)[0]
    entries = {struct.unpack_from("<H", blob, ifd + 2 + 12 * i)[0]:
               struct.unpack_from("<I", blob, ifd + 2 + 12 * i + 8)[0]
               for i in range(struct.unpack_from("<H", blob, ifd)[0])}
    offset, count = entries[273], entries[279]
    blob[offset + count - back] ^= 0x55
    path = tmp_path / "lzma.tif"
    path.write_bytes(bytes(blob))
    want, got = _both(path)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
