"""The port's TIFF codecs and layouts beyond PR 19's (io/tiff.py, io/ccitt.py,
io/jpeg.py's decode_jpeg_stream behind io/image.load_texture_rgba) against
the JAX package's, which is Pillow's ``Image.open(path).convert("RGBA")``
(libtiff for compressed files): BigTIFF, FillOrder 2 on every compression
the port reads, the grey sample formats (signed 8-bit, 12-bit, signed
16-bit, 32-bit integer and float), predictor 2 at 32 bits and 3, JPEG in
strips and tiles at photometric 1, 2 and 6, raw YCbCr, LZMA and CCITT 2, 3
and 4, each byte-equal on its writer cases and fixtures; the variants both
refuse, and those Pillow reads and the port refuses on purpose; the
palette rules of faults C-10 and C-12 (a ColorMap Pillow or libtiff lacks,
one Pillow finds too long) and the directory rules of C-11, C-13 and C-14;
seeded mutants equal to Pillow or refused by both, but for faults C-5 (CCITT
data that ends early, where Pillow leaves rows uninitialised) and C-9 (a
JPEG stream smaller than its strip), counted, with 120 three-flip
JPEG-in-TIFF mutants among them; the CCITT loop in C++ equal to its Python
twin and never crashing the process, nor the Zstandard decoder."""

import io
import lzma
import os
import shutil
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image
from texture_writers import tiff_bytes

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import ccitt
from gaussian_splatterer_tpu_torch.io import image as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
W, H = 37, 29
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _runs(rng, shape, high: int = 256) -> np.ndarray:
    """Seeded samples in [0, high) with runs along each row and repeated
    rows, as textures have them."""
    s = rng.integers(0, high, shape)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]
    s[::4] = s[0]
    return s


def _both(path):
    """(the JAX package's result or None where it raises, the port's or
    None where it raises ValueError, the port's message)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jimage.load_texture_rgba(str(path))
    except Exception:  # noqa: BLE001 (Pillow raises what its plugin raises)
        want = None
    try:
        return want, timage.load_texture_rgba(str(path)), ""
    except ValueError as exc:
        return want, None, str(exc)


def _pillow(mode, **save):
    """A TIFF Pillow writes (through libtiff where compressed) of a seeded
    picture converted to ``mode``."""
    def make(rng):
        px = _runs(rng, (H, W, 3)).astype(np.uint8)
        img = Image.fromarray(px)
        if mode == "1":
            img = Image.fromarray(np.cumsum(rng.random((H, W)) < 0.15, axis=1) % 2 == 1)
        elif mode == "F":
            img = Image.fromarray(rng.normal(120, 150, (H, W)).astype(np.float32), "F")
        elif mode == "I":
            img = Image.fromarray(_runs(rng, (H, W), 900).astype(np.int32) - 300, "I")
        elif mode != "RGB":
            img = img.convert(mode)
        out = io.BytesIO()
        img.save(out, format="TIFF", **save)
        return out.getvalue()
    return make


def _tiff(bits, photo, n=1, high=None, fmt=1, float_=False, **kw):
    """A TIFF of seeded samples from the test writer."""
    def make(rng):
        if float_:
            s = rng.normal(100, 160, (H, W, n)).astype(np.float32)
            s[0, :6, 0] = (-3.7, 300.6, 12.5, 13.5, np.nan, np.inf)
        else:
            s = _runs(rng, (H, W, n), high or (1 << bits))
        return tiff_bytes(s, bits, photo, sample_format=3 if float_ else fmt, **kw)
    return make


def _patch_short(blob: bytes, tag: int, value: int) -> bytes:
    """A classic TIFF with the SHORT value of ``tag`` in IFD 0 replaced."""
    e = ">" if blob[:2] == b"MM" else "<"
    at = struct.unpack_from(e + "I", blob, 4)[0]
    b = bytearray(blob)
    for i in range(struct.unpack_from(e + "H", blob, at)[0]):
        pos = at + 2 + 12 * i
        if struct.unpack_from(e + "H", blob, pos)[0] == tag:
            struct.pack_into(e + "HHIH", b, pos, tag, 3, 1, value)
            return bytes(b)
    raise KeyError(tag)


def _first_strip_tables():
    """A JPEG strip encoder whose strips after the first carry no DQT or
    DHT segment (Pillow's JPEG of each strip, its tables cut out)."""
    seen = []

    def encode(chunk):
        out = io.BytesIO()
        Image.fromarray(chunk).save(out, format="JPEG", quality=90, subsampling=0)
        blob = out.getvalue()
        if not seen:
            seen.append(True)
            return blob
        keep, pos = bytearray(blob[:2]), 2
        while blob[pos + 1] != 0xDA:
            size = struct.unpack(">H", blob[pos + 2:pos + 4])[0]
            if blob[pos + 1] not in (0xDB, 0xC4):
                keep += blob[pos:pos + 2 + size]
            pos += 2 + size
        return bytes(keep + blob[pos:])
    return encode


def _photometric_0(make):
    return lambda rng: _patch_short(make(rng), 262, 0)


CASES = {
    # BigTIFF
    "bigtiff_pillow_raw": _pillow("RGB", big_tiff=True),
    "bigtiff_pillow_lzw": _pillow("RGB", big_tiff=True, compression="tiff_lzw"),
    "bigtiff_tiles_deflate": _tiff(8, 2, 4, extra=(2,), tile=(16, 16), compression=8,
                                   big_tiff=True),
    "bigtiff_strips_16bit": _tiff(16, 1, high=600, rows_per_strip=7, big_tiff=True),
    # FillOrder 2 on each compression
    **{f"fill2_{c}": _pillow("RGB", compression=c, tiffinfo={266: 2})
       for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma", "jpeg")},
    **{f"fill2_{c}": _pillow("1", compression=c, tiffinfo={266: 2})
       for c in ("group3", "group4", "tiff_ccitt", "raw")},
    "fill2_group3_2d": _pillow("1", compression="group3", tiffinfo={266: 2, 292: 1}),
    "fill2_grey4_raw": _tiff(4, 1, fill_order=2),
    "fill2_white_is_zero_8_lzw": _tiff(8, 0, compression=5, fill_order=2),
    "fill2_palette2_lzw": _tiff(2, 3, colormap=list(range(0, 3 * 4 * 5000, 5000)), fill_order=2,
                                compression=5),
    "fill2_palette8_raw": _tiff(8, 3, colormap=list(range(0, 3 * 256 * 80, 80)), fill_order=2),
    "fill2_grey16_raw": _tiff(16, 1, high=700, fill_order=2),
    "fill2_grey16_deflate": _tiff(16, 1, high=700, compression=8, fill_order=2),
    "fill2_tiles_lzma": _tiff(8, 2, 3, tile=(16, 16), compression=34925, fill_order=2),
    # the grey sample formats
    "signed8_raw": _tiff(8, 1, fmt=2),
    "signed8_lzw": _tiff(8, 1, fmt=2, compression=5),
    "grey12_raw": _tiff(12, 1, high=4096),
    "grey12_deflate_strips": _tiff(12, 1, high=300, compression=8, rows_per_strip=5),
    "signed16_raw": _tiff(16, 1, fmt=2),
    "signed16_big_endian_raw": _tiff(16, 1, fmt=2, big_endian=True),
    "signed16_big_endian_lzw_swapped": _tiff(16, 1, fmt=2, big_endian=True, compression=5),
    "signed16_pred2_deflate": _tiff(16, 1, fmt=2, compression=8, predictor=2),
    "unsigned32_raw": _tiff(32, 1, high=1 << 31),
    "unsigned32_deflate_pred2": _tiff(32, 1, high=600, compression=8, predictor=2),
    "signed32_big_endian_raw": _tiff(32, 1, fmt=2, high=1 << 31, big_endian=True),
    "signed32_big_endian_lzma_swapped": _tiff(32, 1, fmt=2, high=1 << 31, big_endian=True,
                                              compression=34925),
    "float_raw": _tiff(32, 1, float_=True),
    "float_white_is_zero_raw": _tiff(32, 0, float_=True),
    "float_big_endian_raw": _tiff(32, 1, float_=True, big_endian=True),
    "float_big_endian_deflate_swapped": _tiff(32, 1, float_=True, big_endian=True,
                                              compression=8),
    "float_pred2_lzw": _tiff(32, 1, float_=True, compression=5, predictor=2),
    "float_pred3_lzw": _tiff(32, 1, float_=True, compression=5, predictor=3),
    "float_pred3_deflate_tiles": _tiff(32, 1, float_=True, compression=8, predictor=3,
                                       tile=(16, 16)),
    "float_pred3_big_endian_lzma": _tiff(32, 1, float_=True, compression=34925, predictor=3,
                                         big_endian=True),
    "float_planar2_raw": _tiff(32, 1, float_=True, planar=2),
    "pillow_F_raw": _pillow("F"),
    "pillow_F_deflate": _pillow("F", compression="tiff_adobe_deflate"),
    "pillow_I_lzw": _pillow("I", compression="tiff_lzw"),
    # JPEG
    "jpeg_pillow_rgb": _pillow("RGB", compression="jpeg", quality=80),
    "jpeg_pillow_grey": _pillow("L", compression="jpeg"),
    "jpeg_pillow_ycbcr": _pillow("YCbCr", compression="jpeg"),
    "jpeg_ycbcr_420_strips": _tiff(8, 6, 3, compression=7, jpeg_subsampling=2,
                                   rows_per_strip=16),
    "jpeg_ycbcr_422_strips_of_8": _tiff(8, 6, 3, compression=7, jpeg_subsampling=1,
                                        rows_per_strip=8),
    "jpeg_ycbcr_420_tiles": _tiff(8, 6, 3, compression=7, jpeg_subsampling=2, tile=(16, 16)),
    "jpeg_ycbcr_420_without_subsampling_tag": _tiff(8, 6, 3, compression=7,
                                                    jpeg_subsampling=2, tags={530: None}),
    "jpeg_rgb_tiles_fill2_ignored": _tiff(8, 2, 3, compression=7, fill_order=2, tile=(16, 16)),
    "jpeg_rgb_tiles": _tiff(8, 2, 3, compression=7, tile=(32, 16)),
    "jpeg_grey_tiles": _tiff(8, 1, 1, compression=7, tile=(16, 32)),
    "jpeg_rgb_big_endian": _tiff(8, 2, 3, compression=7, rows_per_strip=24, big_endian=True),
    # raw YCbCr: Pillow's RGBX raw mode over the bytes that follow
    "ycbcr_raw_padded": _tiff(8, 6, 3, pad=bytes(range(256)) * 8),
    "ycbcr_raw_subsampled_padded": _tiff(8, 6, 3, tags={530: (3, [2, 2])},
                                         pad=bytes(range(255, -1, -1)) * 8),
    "ycbcr_raw_planar": _tiff(8, 6, 3, planar=2),
    # LZMA
    "lzma_pillow_rgb": _pillow("RGB", compression="lzma"),
    "lzma_pillow_grey": _pillow("L", compression="lzma"),
    "lzma_pillow_bilevel": _pillow("1", compression="lzma"),
    "lzma_pred2_rgba_tiles": _tiff(8, 2, 4, extra=(2,), compression=34925, predictor=2,
                                   tile=(16, 16)),
    "lzma_rgb16": _tiff(16, 2, 3, compression=34925, rows_per_strip=10),
    # Zstandard (tests/test_torch_zstd.py holds the rest)
    "zstd_pillow_rgb": _pillow("RGB", compression="zstd"),
    "zstd_pred2_rgba_tiles": _tiff(8, 2, 4, extra=(2,), compression=50000, predictor=2,
                                   tile=(16, 16)),
    "zstd_palette2_fill2": _tiff(2, 3, colormap=list(range(0, 3 * 4 * 5000, 5000)),
                                 fill_order=2, compression=50000),
    # CCITT
    "ccitt_rle_pillow": _pillow("1", compression="tiff_ccitt"),
    "group3_pillow": _pillow("1", compression="group3"),
    "group3_2d_pillow": _pillow("1", compression="group3", tiffinfo={292: 1}),
    "group3_2d_fill_bits_pillow": _pillow("1", compression="group3", tiffinfo={292: 5}),
    "group4_pillow": _pillow("1", compression="group4"),
    "group4_strips_pillow": _pillow("1", compression="group4", tiffinfo={278: 6}),
    "group4_white_is_zero": _photometric_0(_pillow("1", compression="group4")),
    "group3_white_is_zero": _photometric_0(_pillow("1", compression="group3")),
    # orientations Pillow flips (fault C-6) or turns (5-8 swap the axes of
    # the 37 x 29 picture), raw, in LZW tiles and in JPEG strips
    **{f"orientation_{o}": _tiff(8, 2, 3, tags={274: (3, [o])}) for o in (2, 3, 4, 5, 7, 8)},
    "orientation_6_swaps_axes": _tiff(8, 2, 3, tags={274: (3, [6])}),
    "orientation_3_lzw": _tiff(8, 1, compression=5, tags={274: (3, [3])}),
    **{f"orientation_{o}_lzw_tiles": _tiff(8, 2, 3, compression=5, tile=(16, 16),
                                           tags={274: (3, [o])}) for o in (5, 6, 7, 8)},
    **{f"orientation_{o}_jpeg_strips": _tiff(8, 6, 3, compression=7, rows_per_strip=16,
                                             tags={274: (3, [o])}) for o in (5, 6, 7, 8)},
    "orientation_6_grey_raw_strips": _tiff(8, 1, rows_per_strip=5, tags={274: (3, [6])}),
    # libtiff decodes every strip with one decompressor: tables the first
    # strip defines serve the strips without them
    "jpeg_tables_kept_across_strips": lambda rng: tiff_bytes(
        _runs(rng, (H, W, 3)), 8, 6, compression=7, rows_per_strip=8,
        jpeg_encoder=_first_strip_tables()),
    # Pillow keeps the first of an Orientation's several values
    "orientation_of_two_values_jpeg": _tiff(8, 6, 3, compression=7, rows_per_strip=16,
                                            tags={274: (3, [6, 1])}),
    # short ColorMaps: Pillow pads them with black; libtiff passes over a
    # wrong-sized one at 8 bits
    "palette8_raw_colormap_of_3": _tiff(8, 3, colormap=[40000, 20000, 60000]),
    "palette8_lzw_colormap_of_384": _tiff(8, 3, colormap=list(range(0, 384 * 150, 150)),
                                          compression=5),
    "palette4_raw_colormap_of_768": _tiff(4, 3, colormap=list(range(0, 768 * 80, 80))),
    # fault C-11: Pillow stops at Photometric, whose values run past the end
    # of the file, so it never sees FillOrder 2; libtiff reads the strip
    # reversed all the same
    "fill2_lzw_fill_order_past_pillows_directory": lambda rng: _patch_entry(
        CASES["fill2_palette2_lzw"](rng), 262, count=25857),
    # fault C-13: Pillow skips an IFD8 entry in a classic TIFF (Photometric 0)
    "photometric_of_type_ifd8_lzw": lambda rng: _patch_entry(
        CASES["fill2_palette2_lzw"](rng), 262, kind=18),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tiff_variant_equals_jax(tmp_path, name):
    """Every case (at most 37 x 29, seeded from its name), loaded by path:
    the port's floats equal the JAX package's, byte for byte."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(CASES[name](_rng(name)))
    want, got, why = _both(path)
    assert want is not None
    assert got is not None, why
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quirks_of_the_grey_formats():
    """Values Pillow gives and the port keeps: floats truncated and
    clipped, signed 8-bit read as its bytes, signed 16-bit clipped at 0,
    a compressed big-endian signed sample byte-swapped."""
    f = np.array([[[-3.7], [300.6], [12.5], [13.5], [np.nan], [0.99]]], np.float32)
    got = timage.decode_texture(tiff_bytes(f, 32, 1, sample_format=3))
    assert got[0, :, 0].tolist() == [0, 255, 12, 13, 0, 0]
    s8 = tiff_bytes(np.array([[[255], [128], [7]]]), 8, 1, sample_format=2)
    assert timage.decode_texture(s8)[0, :, 0].tolist() == [255, 128, 7]
    s16 = np.array([[[0xFFFF], [300], [0x0100]]])
    assert timage.decode_texture(tiff_bytes(s16, 16, 1, sample_format=2))[0, :, 0].tolist() \
        == [0, 255, 255]
    swapped = tiff_bytes(s16, 16, 1, sample_format=2, big_endian=True, compression=5)
    assert timage.decode_texture(swapped)[0, :, 0].tolist() == [0, 255, 1]


def _oj_peg(rng):
    """An old-style JPEG TIFF (compression 6): a whole JFIF stream behind
    JPEGInterchangeFormat."""
    out = io.BytesIO()
    Image.fromarray(_runs(rng, (16, 16, 3)).astype(np.uint8)).save(out, format="JPEG")
    jpg = out.getvalue()
    blob = tiff_bytes(np.zeros((16, 16, 3), np.int64), 8, 6, tags={
        259: (3, [6]), 513: (4, [8]), 514: (4, [len(jpg)])})
    return blob[:8] + jpg + blob[8 + len(jpg):] if len(jpg) <= 16 * 16 * 3 else blob


# name -> (make, the port's message, the JAX package refuses it too)
REFUSED = {
    "old_style_jpeg": (_oj_peg, "TIFF \\(compression old-style JPEG", True),
    "zstd_pillow": (lambda rng: _damage_first_frame(_pillow("RGB", compression="zstd")(rng)),
                    "corrupt TIFF Zstandard data \\(Unknown frame descriptor", True),
    "webp_in_tiff": (_tiff(8, 2, 3, tags={259: (3, [50001])}), "TIFF \\(compression WebP",
                     True),
    "logluv": (_tiff(16, 32844, 3, tags={259: (3, [34676])}), "TIFF \\(compression SGI LogLuv",
               True),
    "cielab": (_tiff(8, 9, 3), "TIFF \\(photometric 9", True),
    "ycbcr_lzw_rgba_interface": (_tiff(8, 6, 3, compression=5, ycbcr_subsampling=(1, 4)),
                                 "YCbCr subsampling \\(1, 4\\)", True),
    "ycbcr_raw_truncated": (_tiff(8, 6, 3), "truncated", True),
    # planar configuration 2 with an unused sample: Pillow's libtiff decoder
    # refuses strips; its PX unpacker reads two bytes a pixel from a palette
    # tile's one-byte plane, past libtiff's tile buffer in the tile's lower half
    "planar2_strips_unused_sample": (_tiff(8, 2, 4, compression=5, planar=2, extra=[0],
                                           rows_per_strip=8), "planar configuration 2 with "
                                     "unused samples", True),
    "planar2_palette_tiles_unused_sample": (
        lambda rng: tiff_bytes(_runs(rng, (H, W, 2)), 8, 3, 8, planar=2, extra=[0],
                               tile=(16, 16), colormap=rng.integers(0, 65536, 768).tolist()),
        "tiles in planar configuration 2 with unused samples", False),
    "ycbcr_pillow_raw_truncated": (_pillow("YCbCr"), "truncated", True),
    "grey12_big_endian": (_tiff(12, 1, high=4096, big_endian=True), "bits per sample \\(12,",
                          True),
    "unsigned32_big_endian": (_tiff(32, 1, big_endian=True), "bits per sample \\(32,", True),
    "float_rgb": (_tiff(32, 2, 3, float_=True), "sample format \\(3, 3, 3\\)", True),
    "bigtiff_big_endian": (_tiff(16, 1, big_tiff=True, big_endian=True), "TIFF", True),
    "jpeg_stream_sampling_below_tag": (_tiff(8, 6, 3, compression=7, tags={530: (3, [2, 2])}),
                                       "JPEG sampling factors", True),
    "fill2_jpeg_ycbcr": (_tiff(8, 6, 3, compression=7, fill_order=2), "fill order 2", True),
    "fill2_white_is_zero_8_raw": (_tiff(8, 0, fill_order=2), "raw mode L;IR", True),
    "fill2_palette4_raw": (_tiff(4, 3, colormap=list(range(0, 3 * 16 * 1000, 1000)),
                                 fill_order=2), "raw mode P;4R", True),
    "predictor3_integer": (_tiff(16, 1, compression=5, predictor=3), "predictor 3", True),
    "predictor2_grey12": (_tiff(12, 1, high=4096, compression=5, predictor=2), "predictor 2",
                          True),
    "fill2_rgba": (_tiff(8, 2, 4, extra=(2,), compression=5, fill_order=2), "fill order 2",
                   True),
    "jpeg_12_bit": (_tiff(8, 2, 3, compression=7, tags={258: (3, [12, 12, 12])}),
                    "bits per sample \\(12, 12, 12\\)", True),
    "jpeg_rgb_subsampled": (_tiff(8, 2, 3, compression=7, jpeg_subsampling=2),
                            "JPEG sampling factors", True),
    "group4_grey8": (_tiff(8, 1, tags={259: (3, [4])}), "CCITT with 1 samples of 8 bits", True),
    "ccitt_rle_truncated": (lambda rng: _truncate_strip(_pillow("1", compression="tiff_ccitt")
                                                        (rng)), "corrupt TIFF CCITT", True),
    # fault C-10: a palette without tag 320 (Pillow's _setup raises KeyError)
    # or with more than 256 entries (Pillow's putpalette)
    "fill2_palette8_raw_without_colormap": (
        _tiff(8, 3, colormap=list(range(0, 3 * 256 * 80, 80)), fill_order=2, tags={320: None}),
        "without its ColorMap", True),
    "fill2_palette2_lzw_without_colormap": (
        _tiff(2, 3, colormap=list(range(0, 3 * 4 * 5000, 5000)), fill_order=2, compression=5,
              tags={320: None}), "without its ColorMap", True),
    "palette8_raw_colormap_of_266": (_tiff(8, 3, colormap=list(range(0, 3 * 266 * 80, 80))),
                                     "invalid palette size", True),
    "palette8_lzw_colormap_of_771_values": (
        _tiff(8, 3, colormap=list(range(0, 771 * 80, 80)), compression=5),
        "invalid palette size", True),
    # fault C-12: libtiff takes no ColorMap of the wrong size below 8 bits,
    # nor one that comes before BitsPerSample, and refuses the directory
    "palette2_lzw_colormap_of_6": (_tiff(2, 3, colormap=list(range(0, 6 * 5000, 5000)),
                                         compression=5), "ColorMap libtiff does not take", True),
    "palette2_lzw_without_bits_per_sample": (
        lambda rng: _patch_entry(CASES["fill2_palette2_lzw"](rng), 258, tag_to=33026),
        "ColorMap libtiff does not take", True),
    # fault C-14: RowsPerStrip times a row's bytes past INT_MAX
    "rows_per_strip_past_int_max_lzw": (
        lambda rng: _patch_entry(CASES["fill2_palette2_lzw"](rng), 278, value=0x85000000),
        "rows a strip", True),
    # fault C-15: Pillow keeps an UNDEFINED FillOrder as bytes, no mode's key
    "fill_order_undefined_raw": (
        lambda rng: _patch_entry(CASES["fill2_palette8_raw"](rng), 266, kind=7),
        "unsupported TIFF", True),
}


def _patch_entry(blob: bytes, tag: int, kind=None, count=None, value=None,
                 tag_to=None) -> bytes:
    """A little-endian classic TIFF with IFD 0's entry of ``tag`` given
    another type, count, inline value or tag number."""
    at = struct.unpack_from("<I", blob, 4)[0]
    b = bytearray(blob)
    for i in range(struct.unpack_from("<H", blob, at)[0]):
        pos = at + 2 + 12 * i
        if struct.unpack_from("<H", blob, pos)[0] == tag:
            for field, fmt, v in ((0, "<H", tag_to), (2, "<H", kind), (4, "<I", count),
                                  (8, "<I", value)):
                if v is not None:
                    struct.pack_into(fmt, b, pos + field, v)
            return bytes(b)
    raise KeyError(tag)


def _damage_first_frame(blob: bytes) -> bytes:
    """The file with the magic number of strip 0's Zstandard frame broken."""
    im = Image.open(io.BytesIO(blob))
    off = im.tag_v2[273][0]
    return blob[:off] + bytes([blob[off] ^ 1]) + blob[off + 1:]


def _truncate_strip(blob: bytes) -> bytes:
    """The file with strip 0's byte count halved (a strip whose data ends
    early; the file stays whole)."""
    im = Image.open(io.BytesIO(blob))
    return _patch_long(blob, 279, im.tag_v2[279][0] // 2)


def _patch_long(blob: bytes, tag: int, value: int) -> bytes:
    e = ">" if blob[:2] == b"MM" else "<"
    at = struct.unpack_from(e + "I", blob, 4)[0]
    b = bytearray(blob)
    for i in range(struct.unpack_from(e + "H", blob, at)[0]):
        pos = at + 2 + 12 * i
        t, kind, count = struct.unpack_from(e + "HHI", blob, pos)
        if t == tag:
            where = pos + 8 if count * (2 if kind == 3 else 4) <= 4 else \
                struct.unpack_from(e + "I", blob, pos + 8)[0]
            struct.pack_into(e + ("H" if kind == 3 else "I"), b, where, value)
            return bytes(b)
    raise KeyError(tag)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_variants(tmp_path, name):
    """The variants the port refuses with ValueError naming them: where
    Pillow refuses too, so does the JAX package; where it reads them (a
    palette tile with an unused sample), the port refuses on purpose."""
    make, match, jax_refuses = REFUSED[name]
    path = tmp_path / f"{name}.tif"
    path.write_bytes(make(_rng(name)))
    want, _, _ = _both(path)
    assert (want is None) == jax_refuses
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


NEW_FIXTURES = ("mushroom256_jpeg_rgb.tif", "mushroom256_jpeg_ycbcr420.tif",
                "mushroom256_g4_fill2.tif", "mushroom256_g3_2d.tif", "mushroom256_lzma.tif",
                "mushroom256_bigtiff.tif", "mushroom256_float.tif", "mushroom256_signed16.tif",
                "mushroom256_float_pred3.tif", "mushroom256_ycbcr_raw.tif",
                "mushroom1024_jpeg.tif", "mushroom1024_g4.tif")


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each fixture equals the JAX
    package's load and the 8-bit RGBA PNG of its Pillow decode."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    decode = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, timage.load_texture_rgba(decode))
    assert got.shape[:2] == ((1024, 1024) if "1024" in name else (256, 256))


def _fax_inputs(rng):
    comp = int(rng.choice([2, 3, 3, 4]))
    t4 = int(comp == 3 and rng.integers(0, 2))
    n = int(rng.integers(0, 160))
    data = rng.integers(0, 256, n).astype(np.uint8)
    data[rng.random(n) < 0.3] = 0
    return (comp, t4, int(rng.integers(1, 80)), int(rng.integers(1, 12)), data.tobytes(),
            bool(rng.integers(0, 2)))


@needs_gxx
def test_native_fax_loop_equals_python():
    """The CCITT decoder in C++ against its Python twin on 300 seeded inputs
    of three strips each, broken ones included: the same rows, status, rows
    written and run arrays (kept from strip to strip)."""
    rng = _rng("fax")
    assert native.lib() is not None
    for _ in range(300):
        comp, t4, width, rows, data, lsb = _fax_inputs(rng)
        a, b = ccitt.FaxState(width, comp, t4), ccitt.FaxState(width, comp, t4)
        for _ in range(3):
            want = ccitt.decode_fax_python(data, a, rows, lsb)
            got = native.fax_decode(data, b, rows, lsb)
            assert got[1:] == want[1:]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(b.runs, a.runs)


def test_fax_twin_reads_pillows_files(monkeypatch):
    """The Python twin alone (the native library hidden) reads Pillow's
    Group 3, Group 4 and modified Huffman files with long runs (make-up and
    extended make-up codes) as Pillow does."""
    monkeypatch.setattr(native, "fax_decode", lambda *a: None)
    rng = _rng("long runs")
    px = np.cumsum(rng.random((12, 3000)) < 0.004, axis=1) % 2 == 1
    for comp, info in (("group4", {}), ("group3", {292: 1}), ("tiff_ccitt", {})):
        out = io.BytesIO()
        Image.fromarray(px).save(out, format="TIFF", compression=comp, tiffinfo=info)
        want = np.asarray(Image.open(io.BytesIO(out.getvalue())).convert("RGBA"))
        np.testing.assert_array_equal(timage.decode_texture(out.getvalue()), want)


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


def _flips(rng, blob: bytes) -> bytes:
    """Three seeded byte flips past the 8-byte header."""
    b = bytearray(blob)
    for _ in range(3):
        b[rng.integers(8, len(b))] = rng.integers(0, 256)
    return bytes(b)


MUTANT_SOURCES = {
    "bigtiff": ("bigtiff_pillow_lzw", "bigtiff_tiles_deflate", "bigtiff_pillow_raw"),
    "jpeg": ("jpeg_pillow_ycbcr", "jpeg_ycbcr_420_tiles", "jpeg_rgb_tiles", "jpeg_pillow_grey"),
    "jpeg_flips": ("jpeg_pillow_ycbcr", "jpeg_ycbcr_420_tiles", "jpeg_rgb_tiles",
                   "jpeg_pillow_grey"),
    "ccitt": ("group4_pillow", "group3_2d_pillow", "ccitt_rle_pillow", "group3_pillow"),
    "lzma": ("lzma_pillow_rgb", "lzma_pred2_rgba_tiles"),
    "grey": ("float_pred3_lzw", "signed16_raw", "grey12_raw", "float_raw",
             "signed32_big_endian_raw"),
    "fill2": ("fill2_tiff_lzw", "fill2_group4", "fill2_raw"),
    "ycbcr": ("ycbcr_raw_padded", "ycbcr_raw_subsampled_padded"),
    "zstd": ("zstd_pillow_rgb", "zstd_pred2_rgba_tiles", "zstd_palette2_fill2"),
    # the palettes of fault C-10: many of their mutants lose tag 320
    "palette": ("fill2_palette8_raw", "fill2_palette2_lzw"),
}
# (mutants, mutation) of a group other than the 60 mixed mutants
MUTATIONS = {"jpeg_flips": (120, _flips), "palette": (200, _mutant)}
# the mutants at these seeds that fall in a recorded fault (ROADMAP C): C-5,
# CCITT data that ends early, where Pillow returns rows it never wrote; C-9,
# a JPEG stream smaller than its strip or tile, where Pillow shows what
# libtiff's buffer held before (uninitialised, or an earlier strip's bytes);
# C-7 (fixed: none is left), the rest
KNOWN = {"ccitt": {"C-5": 9}, "fill2": {"C-5": 2}, "jpeg_flips": {"C-9": 0}}


@pytest.mark.parametrize("group", list(MUTANT_SOURCES))
def test_mutants_agree_with_jax(tmp_path, group):
    """60 seeded mutants (truncations, byte flips, insertions) of the
    group's writer cases, or the group's own number and mutation
    (``MUTATIONS``: 120 JPEG-in-TIFFs with three byte flips each, where
    libtiff's handling of damaged JPEG strips and directories shows; 200
    of the palettes, a tenth of which lose tag 320, fault C-10): each
    is read to the JAX package's bytes or refused by both (the port with
    ValueError), but for the recorded faults, whose counts at this seed are
    held exactly."""
    rng = _rng(group)
    sources = [CASES[n](_rng(n)) for n in MUTANT_SOURCES[group]]
    n, mutate = MUTATIONS.get(group, (60, _mutant))
    path = tmp_path / "m.tif"
    faults = {k: 0 for k in KNOWN.get(group, {})}
    for i in range(n):
        path.write_bytes(mutate(rng, sources[i % len(sources)]))
        want, got, why = _both(path)
        if (want is None) == (got is None) and (want is None or np.array_equal(got, want)):
            continue
        fault = next((f for f in ("C-5", "C-9") if want is not None and f"fault {f}" in why),
                     "C-7")
        faults[fault] = faults.get(fault, 0) + 1
    assert faults == KNOWN.get(group, {})


@needs_gxx
def test_xz_decoder_equals_its_twin_and_lzma():
    """io/xz.py's C++ decoder against its Python twin, and both against
    ``lzma`` where ``lzma`` decodes: LZMA strips of the writer's and
    Pillow's cases (libtiff's delta + LZMA2 chain), whole and with 60
    seeded byte flips and cuts each."""
    from gaussian_splatterer_tpu_torch.io import xz

    rng = _rng("xz twin")
    for name in MUTANT_SOURCES["lzma"]:
        blob = CASES[name](_rng(name))
        im = Image.open(io.BytesIO(blob))
        offsets, counts = im.tag_v2.get(273) or im.tag_v2[324], im.tag_v2.get(279) or \
            im.tag_v2[325]
        for off, n in zip(offsets, counts):
            data = blob[off:off + n]
            size = len(lzma.decompress(data))
            assert xz.decode_until_error_python(data, size) == native.xz_until_error(data, size) \
                == lzma.decompress(data)
            for _ in range(60):
                m = bytearray(data)
                if rng.integers(0, 2):
                    m = m[:rng.integers(1, len(m))]
                else:
                    m[rng.integers(0, len(m))] ^= int(rng.integers(1, 256))
                m = bytes(m)
                want = xz.decode_until_error_python(m, size)
                assert native.xz_until_error(m, size) == want
                try:
                    ref = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(m, size)
                except lzma.LZMAError:
                    continue
                assert want[:len(ref)] == ref


CRASH_SCRIPT = r"""
import sys
import numpy as np
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.image import read_texture
assert native.lib() is not None
rng = np.random.default_rng(22)
counts = {"array": 0, "ValueError": 0}
for path in sys.argv[1:]:
    blob = open(path, "rb").read()
    for _ in range(60):
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
    """60 seeded mutants of each CCITT, BC6H and Zstandard fixture through
    read_texture (the C++ fax decoder, BC6H blocks and Zstandard decoder),
    all in one subprocess: each gives an array or ValueError, and the
    process exits 0 (a crash in the C++ fails this test only)."""
    names = ("mushroom256_g4_fill2.tif", "mushroom256_g3_2d.tif", "mushroom256_bc6h_uf16.dds",
             "mushroom256_bc6h_sf16.dds", "mushroom256_zstd_pred2.tif", "mushroom1024_zstd.tif")
    script = tmp_path / "mutants.py"
    script.write_text(CRASH_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    paths = [os.path.join(FIXTURES, n) for n in names]
    proc = subprocess.run([sys.executable, str(script), *paths], capture_output=True, text=True,
                          timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])  # noqa: S307 (our own dict literal)
    assert counts["array"] + counts["ValueError"] == 60 * len(names)
    assert counts["ValueError"] > 0
