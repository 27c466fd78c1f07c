"""The port's BMP, TIFF, DDS, GIF and PNM input (io/bmp.py, io/tiff.py,
io/dds.py, io/gif.py, io/pnm.py behind io/image.load_texture_rgba) against
the JAX package's, which is Pillow's ``Image.open(path).convert("RGBA")``:
equal bytes for every variant each module reads, Pillow's quirks included;
the variants refused raise ValueError naming the format, and so does a
truncated file of each format; the native byte loops (native/src/codecs.cpp)
equal their Python twins; the committed fixtures equal their Pillow
decodes."""

import io
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image
from texture_writers import (bmp_bytes, bmp_rows, dds_bytes, gif_bytes, lzw_bytes, pnm_bytes,
                             tiff_bytes)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io.lzw import decode_lzw_python
from gaussian_splatterer_tpu_torch.io.png import unfilter_python

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
W, H = 37, 29
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _runs(rng, shape, high: int) -> np.ndarray:
    """Seeded samples in [0, high) with runs along each row and repeated
    rows, as textures have them (for RLE, LZW and the predictors)."""
    s = rng.integers(0, high, shape)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]
    s[::4] = s[0]
    return s


def _pillow(fmt, mode, **save):
    """A file Pillow writes from a seeded RGBA picture converted to
    ``mode``."""
    def make(rng):
        px = _runs(rng, (H, W, 4), 256).astype(np.uint8)
        px[::3, ::2, 3] = 0  # a quarter transparent or more, for the alpha paths
        if mode == "I;16":
            img = Image.fromarray(_runs(rng, (H, W), 700).astype(np.uint16))
        elif mode == "I":
            img = Image.fromarray(_runs(rng, (H, W), 1500).astype(np.int32))
        else:
            img = Image.fromarray(px, "RGBA").convert(mode)
        out = io.BytesIO()
        img.save(out, format=fmt, **save)
        return out.getvalue()
    return make


# -- BMP --------------------------------------------------------------------

def _bmp(bits, header=40, comp=0, colours=0, grey=False, masks=None, top_down=False,
         dib=False, high=None):
    def make(rng):
        pad = 3 if header == 12 else 4
        palette = b""
        if bits <= 8:
            n = colours or 1 << bits
            ent = ([(0, 0, 0), (255, 255, 255)] if n == 2 else [(i, i, i) for i in range(n)]
                   ) if grey else rng.integers(0, 256, (n, 3)).tolist()
            palette = b"".join(bytes([b, g, r]) + bytes(pad - 3) for r, g, b in ent)
            data = bmp_rows(_runs(rng, (H, W), high or 1 << bits), bits)
        else:
            data = bmp_rows(_runs(rng, (H, W, bits // 8), 256), bits)
        return bmp_bytes(data, W, -H if top_down else H, bits, header, comp, palette, masks,
                         colours, dib)
    return make


def _rle(rle4):
    """Run-length data with every escape: runs (some past the row's end),
    absolute runs (odd counts in RLE4), end of line, delta, end of bitmap."""
    def make(rng):
        out = bytearray()
        for y in range(H):
            x = 0
            if y % 7 == 3:  # a delta: two skipped bytes, then right 5 and up 1
                out += bytes([0, 2, 0x55, 0xAA, 5, 1])
                continue
            while x < W - 6:
                n = int(rng.integers(3, 9))
                if rng.random() < 0.5:
                    out += bytes([n, int(rng.integers(0, 256))])
                else:
                    vals = rng.integers(0, 256, n // 2 if rle4 else n).astype(np.uint8)
                    out += bytes([0, n]) + vals.tobytes() + bytes(len(vals) % 2)
                x += n
            out += bytes([W, 7]) if y % 5 == 0 else bytes([0, 0])  # past the end / EOL
        out += bytes([0, 1])
        bits = 4 if rle4 else 8
        palette = b"".join(bytes([b, g, r, 0]) for r, g, b in
                           rng.integers(0, 256, (1 << bits, 3)).tolist())
        return bmp_bytes(bytes(out), W, H, bits, 40, 2 if rle4 else 1, palette)
    return make


BMP_CASES = {
    **{f"pillow_{m}": _pillow("BMP", m) for m in ("1", "L", "P", "RGB", "RGBA")},
    "rle8": _rle(False),
    "rle4": _rle(True),
    "pal1": _bmp(1),
    "pal4_clrused_5": _bmp(4, colours=5, high=16),  # indices past the table read black
    "pal8_core_header": _bmp(8, header=12),
    "grey8_two_entries_reads_as_1": _bmp(8, colours=2, grey=True, high=2),
    "rgb16_555": _bmp(16),  # 21 -> 172, top bit ignored
    "rgb24_top_down": _bmp(24, top_down=True),
    "rgb32_bi_rgb_alpha_dropped": _bmp(32, header=124),
    "bitfields16_565": _bmp(16, comp=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
    "bitfields16_555_v4": _bmp(16, header=108, comp=3, masks=(0x7C00, 0x3E0, 0x1F, 0x8000)),
    "bitfields32_v5_alpha": _bmp(32, header=124, comp=3,
                                 masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "bitfields32_v3_abgr": _bmp(32, header=56, comp=3,
                                masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    "bitfields32_after_40_xbgr": _bmp(32, comp=3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    "os2_v2_header_64": _bmp(8, header=64),
    "dib_v5_24": _bmp(24, header=124, dib=True),
    "dib_pal4": _bmp(4, dib=True),
    # a grey palette below 8 bits: Pillow maps the file and reads a row of W
    # bytes at each narrow row's start; the bytes after the data hold the
    # last row's rest
    "grey4_palette_rows_overlap": lambda rng: bmp_bytes(
        bmp_rows(_runs(rng, (H, W), 16), 4) + _runs(rng, (1, W), 256).astype(np.uint8).tobytes(),
        W, H, 4, palette=b"".join(bytes([i, i, i, 0]) for i in range(16))),
}


# -- TIFF -------------------------------------------------------------------

def _tiff(bits, photo, n, high=None, cmap=False, **kw):
    def make(rng):
        s = _runs(rng, (H, W, n), high or 1 << bits)
        colormap = rng.integers(0, 65536, 3 << bits).tolist() if cmap else None
        return tiff_bytes(s, bits, photo, colormap=colormap, **kw)
    return make


TIFF_CASES = {
    **{f"pillow_{m}_{c}": _pillow("TIFF", m, compression=c)
       for m in ("RGB", "RGBA", "L", "P", "CMYK") for c in
       ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate")},
    "pillow_1_lzw": _pillow("TIFF", "1", compression="tiff_lzw"),
    "pillow_I16_deflate": _pillow("TIFF", "I;16", compression="tiff_deflate"),  # clipped
    "tiles_rgb_lzw_pred2": _tiff(8, 2, 3, tile=(16, 16), compression=5, predictor=2),
    "tiles_raw_rgba": _tiff(8, 2, 4, tile=(32, 16), extra=(2,)),
    "strips_deflate_pred2_16bit_rgb": _tiff(16, 2, 3, rows_per_strip=5, compression=8,
                                            predictor=2),  # the high byte
    "planar_rgba_lzw": _tiff(8, 2, 4, planar=2, extra=(2,), compression=5, rows_per_strip=7),
    "planar_rgb_raw": _tiff(8, 2, 3, planar=2, rows_per_strip=9),
    "planar_rgb16_raw_reads_8_bits": _tiff(16, 2, 3, planar=2),  # Pillow reads 8 bits
    "planar_rgba_unlabelled_deflate": _tiff(8, 2, 4, planar=2, compression=32946),
    "assoc_alpha_lzw": _tiff(8, 2, 4, extra=(1,), compression=5),
    "assoc_alpha_16bit_big_endian": _tiff(16, 2, 4, extra=(1,), big_endian=True),
    "unassoc_alpha_16bit_packbits": _tiff(16, 2, 4, extra=(2,), compression=32773),
    "rgbx_unused": _tiff(8, 2, 4, extra=(0,), compression=8),
    "rgba_extra_unused": _tiff(8, 2, 5, extra=(2, 0), tile=(16, 16), compression=5),
    "palette1": _tiff(1, 3, 1, cmap=True),
    "palette2_lzw": _tiff(2, 3, 1, cmap=True, compression=5),
    "palette4_big_endian": _tiff(4, 3, 1, cmap=True, big_endian=True),
    "palette8_alpha": _tiff(8, 3, 2, cmap=True, extra=(2,), compression=8),
    **{f"white_is_zero_{b}": _tiff(b, 0, 1) for b in (1, 2, 4, 8, 16)},
    **{f"black_is_zero_{b}_lzw": _tiff(b, 1, 1, compression=5) for b in (2, 4)},
    "grey16_big_endian_clipped": _tiff(16, 1, 1, high=600, big_endian=True),
    "grey_alpha_pred2": _tiff(8, 1, 2, extra=(2,), compression=5, predictor=2),
    "cmyk_unused_packbits": _tiff(8, 5, 5, extra=(0,), compression=32773),
    "raw_ignores_predictor": _tiff(8, 2, 3, predictor=2),
}


# -- DDS --------------------------------------------------------------------

def _dds_blocks(size, fourcc=b"", dxgi=None, mode_bits=False):
    """Random blocks under a written header (BC7: each block's mode bit
    forced, one mode in eight of them, the reserved mode in some)."""
    def make(rng):
        n = (-(-W // 4)) * (-(-H // 4))
        data = rng.integers(0, 256, (n, size)).astype(np.int64)
        if mode_bits:
            m = np.arange(n) % 9
            low = np.where(m < 8, 1 << np.minimum(m, 7), 0)
            data[:, 0] = np.where(m < 8, (data[:, 0] | low) & ~(low - 1) & 0xFF, 0)
        return dds_bytes(data.astype(np.uint8).tobytes(), W, H, fourcc, dxgi)
    return make


def _dds_raw(flags, bitcount, masks=(0, 0, 0, 0), extra=0, dxgi=None):
    def make(rng):
        data = _runs(rng, (H, W, bitcount // 8), 256).astype(np.uint8).tobytes()
        return dds_bytes(rng.integers(0, 256, extra).astype(np.uint8).tobytes() + data, W, H,
                         dxgi=dxgi, flags=flags, bitcount=bitcount, masks=masks)
    return make


DDS_CASES = {
    **{f"pillow_{f}": _pillow("DDS", "RGBA", pixel_format=f) for f in ("DXT1", "DXT3", "DXT5")},
    "pillow_BC5": _pillow("DDS", "RGB", pixel_format="BC5"),
    **{f"pillow_uncompressed_{m}": _pillow("DDS", m) for m in ("RGB", "RGBA", "L", "LA")},
    "dxt1_random_blocks": _dds_blocks(8, b"DXT1"),  # three-colour blocks: alpha 0 at 3
    "ati1": _dds_blocks(8, b"ATI1"),
    "bc4u": _dds_blocks(8, b"BC4U"),
    "ati2": _dds_blocks(16, b"ATI2"),
    "bc5s": _dds_blocks(16, b"BC5S"),
    **{f"dx10_{n}": _dds_blocks(8 if n in (71, 80) else 16, dxgi=n)
       for n in (71, 74, 77, 80, 83, 84)},
    **{f"dx10_bc7_{n}": _dds_blocks(16, dxgi=n, mode_bits=True) for n in (97, 98, 99)},
    "dx10_r8g8b8a8": _dds_raw(0x4, 32, dxgi=28),
    "rgb16_565_masks": _dds_raw(0x40, 16, (0xF800, 0x7E0, 0x1F, 0)),
    "rgba32_10bit_masks": _dds_raw(0x41, 32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    "palette8": _dds_raw(0x20, 8, extra=1024),
}


# -- GIF --------------------------------------------------------------------

def _gif_frames(n_frames=1, local=False, at=(0, 0), interlace=False, transparency=None,
                size=(W, H), frame=(W, H), min_bits=8, grey=False, clear_every=0):
    def make(rng):
        table = (bytes(v for i in range(256) for v in (i, i, i)) if grey
                 else rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        frames = [dict(idx=_runs(rng, frame[::-1], 1 << min_bits), at=at, interlace=interlace,
                       transparency=transparency, clear_every=clear_every,
                       palette=rng.integers(0, 256, 48).astype(np.uint8).tobytes()
                       if local else None) for _ in range(n_frames)]
        return gif_bytes(frames, size, table[:3 << min_bits], min_bits)
    return make


def _pillow_animated(rng):
    frames = [Image.fromarray(_runs(rng, (H, W, 3), 256).astype(np.uint8)) for _ in range(3)]
    out = io.BytesIO()
    frames[0].save(out, format="GIF", save_all=True, append_images=frames[1:], duration=40)
    return out.getvalue()


GIF_CASES = {
    "pillow_P_transparency": _pillow("GIF", "P", transparency=3, interlace=False),
    "pillow_RGB_interlaced": _pillow("GIF", "RGB", interlace=True),
    "pillow_L": _pillow("GIF", "L"),
    "pillow_animated_first_frame": _pillow_animated,
    "local_table": _gif_frames(local=True, min_bits=4),
    "offset_frame_past_screen": _gif_frames(at=(5, 3), size=(20, 12), transparency=7),
    "small_frame_off_origin": _gif_frames(at=(4, 6), frame=(13, 9), min_bits=3),
    "interlaced_clear_codes": _gif_frames(interlace=True, clear_every=40, min_bits=2),
    "grey_table": _gif_frames(grey=True, transparency=0),
    "two_frames_transparent": _gif_frames(n_frames=2, transparency=200),
}


# -- PNM --------------------------------------------------------------------

def _pnm(magic, maxval=255, high=None):
    def make(rng):
        shape = (H, W, 3) if magic in (b"P3", b"P6") else (H, W)
        return pnm_bytes(_runs(rng, shape, high or maxval + 1), magic, maxval,
                         comment=b"written for a test")
    return make


PNM_CASES = {
    **{f"pillow_{m}": _pillow("PPM", m) for m in ("1", "L", "RGB", "I")},
    "plain_p1": _pnm(b"P1", 1),
    "plain_p2": _pnm(b"P2", 200),
    "plain_p3_maxval15": _pnm(b"P3", 15),  # 7 -> 119
    "plain_p2_maxval1000": _pnm(b"P2", 1000),  # mode I, clipped
    "plain_p3_maxval300": _pnm(b"P3", 300),
    "raw_p5_maxval1000": _pnm(b"P5", 1000),  # 500 -> 255
    "raw_p5_maxval65535": _pnm(b"P5", 65535),
    "raw_p5_maxval3": _pnm(b"P5", 3),
    "raw_p6_maxval4095": _pnm(b"P6", 4095),
    "raw_p6_over_maxval": _pnm(b"P6", 100, high=256),  # clipped at 255
}

CASES = {f"{fmt}_{name}": make for fmt, cases in (
    ("bmp", BMP_CASES), ("tiff", TIFF_CASES), ("dds", DDS_CASES), ("gif", GIF_CASES),
    ("pnm", PNM_CASES)) for name, make in cases.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_format_variant_equals_jax(tmp_path, name):
    """Every variant (at most 37 x 29, seeded from its name), loaded by
    path: the port's floats equal the JAX package's, byte for byte."""
    path = tmp_path / f"{name}.bin"
    path.write_bytes(CASES[name](_rng(name)))
    want = jimage.load_texture_rgba(str(path))
    got = timage.load_texture_rgba(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quirks_of_the_table():
    """The values Pillow gives and the port keeps: 5-5-5 BMP 21 -> 172 with
    the top bit ignored, BI_RGB alpha dropped, 16-bit grey TIFF clipped,
    16-bit RGB TIFF's high byte, PNM scaling and clipping, DXT1's
    punch-through texels."""
    dec = timage.decode_texture
    b555 = bmp_bytes(struct.pack("<2H", 0x8000 | 21 << 10 | 1 << 5, 0), 2, 1, 16)
    assert dec(b555)[0, 0].tolist() == [172, 8, 0, 255]
    b32 = bmp_bytes(bytes([1, 2, 3, 4]), 1, 1, 32)
    assert dec(b32)[0, 0].tolist() == [3, 2, 1, 255]
    t16 = tiff_bytes(np.array([[[35485], [200]]]), 16, 1)
    assert dec(t16)[0, :, 0].tolist() == [255, 200]
    t48 = tiff_bytes(np.array([[[0x12FF, 0x3400, 0xFFFF]]]), 16, 2, compression=5)
    assert dec(t48)[0, 0].tolist() == [0x12, 0x34, 0xFF, 255]
    p3 = pnm_bytes(np.array([[[7, 1, 15]]]), b"P3", 15)
    assert dec(p3)[0, 0].tolist() == [119, 17, 255, 255]
    p5 = pnm_bytes(np.array([[500, 3]]), b"P5", 1000)
    assert dec(p5)[0, :, 0].tolist() == [255, 197]  # round(3 / 1000 * 65535), clipped
    px = np.full((8, 8, 4), 200, np.uint8)
    px[::2, ::2, 3] = 0
    out = io.BytesIO()
    Image.fromarray(px, "RGBA").save(out, format="DDS", pixel_format="DXT1")
    dxt1 = dec(out.getvalue())
    assert (dxt1[..., 3] == 0).mean() == 0.25


def _tiff_tags(tags, bits=8, photo=2, n=3, **kw):
    return lambda rng: tiff_bytes(np.zeros((4, 5, n), np.int64), bits, photo, tags=tags, **kw)


def _old_style_lzw(rng):
    """An LZW TIFF whose strip (at offset 8) starts as old-style LZW does."""
    blob = tiff_bytes(np.zeros((4, 5, 3), np.int64), 8, 2, compression=5)
    return blob[:8] + b"\x00\x01" + blob[10:]


# name -> (make, message, Pillow refuses it too)
REFUSED = {
    "bmp_jpeg_compression": (lambda rng: bmp_bytes(bytes(16), 2, 2, 24, 40, 4),
                             "BMP compression \\(JPEG\\)", True),
    "bmp_2_bits": (lambda rng: bmp_bytes(bytes(8), 2, 2, 2), "BMP pixel depth", True),
    "bmp_header_20": (lambda rng: b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(30),
                      "BMP header size 20", True),
    "bmp_grey_palette_4_bits": (_bmp(4, grey=True), "BMP \\(a grey palette of 16", False),
    "bmp_v2_header_holds_no_alpha_mask": (_bmp(32, header=52, comp=3, masks=(
        0xFF, 0xFF00, 0xFF0000, 0xFF000000)), "BMP bitfields layout", True),
    "bmp_bitfields_masks": (lambda rng: bmp_bytes(bytes(16), 2, 2, 32, 40, 3,
                                                  masks=(0xF, 0xF0, 0xF00, 0)),
                            "BMP bitfields layout", True),
    "tiff_bigtiff": (lambda rng: b"II+\x00\x08\x00\x00\x00" + bytes(16), "TIFF without",
                     True),
    "tiff_jpeg": (_tiff_tags({258: (3, [12, 12, 12]), 259: (3, [7])}),
                  "bits per sample \\(12, 12, 12\\)", True),
    "tiff_ccitt_group4": (_tiff_tags({259: (3, [4])}, photo=1, n=1), "TIFF \\(CCITT with",
                          True),
    "tiff_logluv": (_tiff_tags({259: (3, [34676])}), "TIFF \\(compression SGI LogLuv", True),
    "tiff_float": (_tiff_tags({339: (3, [3, 3, 3])}), "sample format \\(3, 3, 3\\)", True),
    "tiff_ycbcr": (_tiff_tags({530: (3, [2, 4])}, photo=6, compression=5),
                   "TIFF \\(YCbCr subsampling \\(2, 4\\)", True),
    "tiff_12_bit": (_tiff_tags({258: (3, [12])}, bits=8, photo=1, n=1, big_endian=True),
                    "bits per sample \\(12,\\)", True),
    "tiff_fill_order_2": (_tiff_tags({266: (3, [2])}, n=4, extra=(2,)), "fill order 2", True),
    "tiff_predictor_3": (_tiff_tags({317: (3, [3])}, compression=5), "TIFF \\(predictor 3",
                         True),
    "tiff_old_style_lzw": (_old_style_lzw, "TIFF \\(old-style LZW", False),
    "dds_bc6h": (lambda rng: dds_bytes(bytes(16 * 4), 8, 8, dxgi=94), "DDS \\(DXGI format 94",
                 True),
    "dds_fourcc_dxt2": (lambda rng: dds_bytes(bytes(16), 4, 4, b"DXT2"), "DDS \\(FourCC",
                        True),
    "dds_header_size": (lambda rng: b"DDS " + struct.pack("<I", 100) + bytes(120),
                        "DDS header size", True),
    "gif_code_size_9": (lambda rng: b"GIF89a\x02\x00\x02\x00\x00\x00\x00,\x00\x00\x00"
                        b"\x00\x02\x00\x02\x00\x00\x09\x02\x00\x00\x00;",
                        "GIF \\(LZW minimum code size 9", False),
    "gif_without_image": (lambda rng: b"GIF89a\x02\x00\x02\x00\x00\x00\x00;",
                          "GIF without an image", True),
    "gif_grey_local_table_under_global_transparent": (
        lambda rng: gif_bytes([dict(idx=_runs(rng, (H, W), 256), transparency=5,
                                    palette=bytes(v for i in range(256) for v in (i, i, i)))],
                              (W, H), rng.integers(0, 256, 768).astype(np.uint8).tobytes()),
        "GIF \\(a grey local table under a global one", True),
    "pnm_pam": (lambda rng: b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"
                + bytes(4), "unknown texture format", True),
    "pnm_pfm": (lambda rng: b"Pf\n2 2\n0.0\n" + bytes(16), "PFM scale must be finite", True),
    "pnm_pfm_colour": (lambda rng: b"PF\n2 2\n-1.0\n" + bytes(48), "unknown texture format",
                       True),
    "pnm_maxval_0": (lambda rng: b"P5\n2 2\n0\n" + bytes(4), "PNM maxval 0", True),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_variants_raise(tmp_path, name):
    """A variant the port does not read raises ValueError naming its
    format and the variant; where Pillow refuses it too, so does the JAX
    package."""
    make, match, pillow_refuses = REFUSED[name]
    path = tmp_path / f"{name}.bin"
    path.write_bytes(make(_rng(name)))
    if pillow_refuses:
        with pytest.raises(Exception):
            jimage.load_texture_rgba(str(path))
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


TRUNCATED = {
    "bmp": ("BMP", BMP_CASES["pillow_RGB"]),
    "bmp_rle8": ("BMP", BMP_CASES["rle8"]),
    "tiff_raw": ("TIFF", TIFF_CASES["pillow_RGB_raw"]),
    "tiff_lzw": ("TIFF", TIFF_CASES["pillow_RGB_tiff_lzw"]),
    "tiff_deflate": ("TIFF", TIFF_CASES["pillow_RGB_tiff_adobe_deflate"]),
    "tiff_packbits": ("TIFF", TIFF_CASES["pillow_RGB_packbits"]),
    "dds_dxt1": ("DDS", DDS_CASES["pillow_DXT1"]),
    "dds_bc7": ("DDS", DDS_CASES["dx10_bc7_98"]),
    "gif": ("GIF", GIF_CASES["local_table"]),
    "pnm_raw": ("PNM", PNM_CASES["pillow_RGB"]),
    "pnm_plain": ("PNM", PNM_CASES["plain_p3_maxval15"]),
}


@pytest.mark.parametrize("name", list(TRUNCATED))
@pytest.mark.parametrize("keep", [0.2, 0.7])
def test_truncated_file_raises_value_error(tmp_path, name, keep):
    """A file cut short inside its header or its image data raises
    ValueError naming the format, never another exception."""
    fmt, make = TRUNCATED[name]
    blob = make(_rng(name))
    path = tmp_path / f"{name}.bin"
    path.write_bytes(blob[:max(8, int(len(blob) * keep))])
    with pytest.raises(ValueError, match=fmt):
        timage.load_texture_rgba(str(path))


@needs_gxx
@pytest.mark.parametrize("bpp", range(1, 9))
def test_native_unfilter_equals_python(bpp):
    """PNG's row unfilter in C++ against its Python twin: random bytes,
    every filter type in turn and at random, and a bad filter type."""
    rng = np.random.default_rng(bpp)
    h, stride = 23, 9 * bpp
    buf = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
    buf[:, 0] = np.arange(h) % 5
    buf[h // 2:, 0] = rng.integers(0, 5, h - h // 2)
    got, bad = native.png_unfilter(buf.ravel(), h, stride, bpp)
    assert bad == -1
    np.testing.assert_array_equal(got, unfilter_python(buf.ravel(), h, stride, bpp))
    buf[9, 0] = 7
    assert native.png_unfilter(buf.ravel(), h, stride, bpp)[1] == 7
    with pytest.raises(ValueError, match="unknown PNG filter type 7"):
        unfilter_python(buf.ravel(), h, stride, bpp)


@needs_gxx
@pytest.mark.parametrize("form", ["gif2", "gif5", "gif8", "tiff"])
def test_native_lzw_equals_python(form):
    """The LZW decoder in C++ against its Python twin, in GIF's form (2, 5
    and 8-bit literals) and TIFF's: whole streams with clear codes and a
    full table, streams cut short, bit-flipped and random, at limits
    below, at and past the data."""
    tiff = form == "tiff"
    bits = 8 if tiff else int(form[3:])
    rng = np.random.default_rng(len(form) + bits)
    for trial in range(6):
        n = int(rng.integers(1, 9000))
        data = np.minimum(rng.integers(0, 1 << bits, n), rng.integers(0, 1 << bits, n))
        data[::3] = data[0]
        data = data.astype(np.uint8).tobytes()
        whole = lzw_bytes(data, bits, tiff, clear_every=(0, 300, 5000)[trial % 3])
        assert decode_lzw_python(whole, bits, tiff, n)[0].tobytes() == data
        flipped = bytearray(whole)
        flipped[len(whole) // 3] ^= 0x24
        streams = (whole, whole[:len(whole) // 2], bytes(flipped),
                   rng.integers(0, 256, 300).astype(np.uint8).tobytes())
        for stream in streams:
            for limit in (n // 3, n, n + 50):
                want = decode_lzw_python(stream, bits, tiff, limit)
                got = native.lzw_decode(stream, bits, tiff, limit)
                assert got[1] == want[1]
                np.testing.assert_array_equal(got[0], want[0])


NEW_FIXTURES = ("mushroom256_bitfields.bmp", "mushroom256_lzw_pred2.tif",
                "mushroom256_dxt1.dds", "mushroom256_trns.gif", "mushroom256.ppm")


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixtures_equal_their_pillow_decodes(name):
    """tests/data/textures (make_fixtures.py): each new texture against
    the 8-bit RGBA PNG of its Pillow decode beside it."""
    got = timage.load_texture_rgba(os.path.join(FIXTURES, name))
    want = timage.load_texture_rgba(os.path.join(FIXTURES, f"{name.rsplit('.', 1)[0]}"
                                                 ".pillow.png"))
    assert got.shape == (256, 256, 4)
    np.testing.assert_array_equal(got, want)
    if name.endswith(".dds"):
        assert (got[..., 3] == 0).mean() == 0.25  # the punched-out texels


def test_lzw_tiff_fixture_equals_the_jpeg_fixtures_png():
    """mushroom1024_lzw.tif holds the pixels of
    tests/data/jpeg/mushroom1024_q90_420.png, decoded natively and by the
    Python loops alike."""
    png = os.path.join(os.path.dirname(FIXTURES), "jpeg", "mushroom1024_q90_420.png")
    got = timage.load_texture_rgba(os.path.join(FIXTURES, "mushroom1024_lzw.tif"))
    np.testing.assert_array_equal(got, timage.load_texture_rgba(png))
