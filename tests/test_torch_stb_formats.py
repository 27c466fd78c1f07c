"""The port's PSD, QOI, SGI, PCX, ICO, CUR and PFM input and its texture
dispatch (io/psd.py, io/qoi.py, io/sgi.py, io/pcx.py, io/ico.py, io/cur.py,
io/pnm.py and io/image.py's ``FORMATS`` behind load_texture_rgba) against
the JAX package's, which is Pillow's ``Image.open(path).convert("RGBA")``:
the committed fixtures and every writer case byte-equal; a format found by
content in Pillow's order, never by name (a TGA under .png or no extension,
a TGA with a 10-byte ID refused as Pillow's PCX plugin refuses it, P7 and
PF refused by both); seeded mutants of each reader equal to Pillow or
refused by both; the native byte loops equal their Python twins and never
crash the process; load_png reads what the JAX package's reads, as RGB."""

import io
import os
import shutil
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image
from texture_writers import (icon_bitmap, icon_dir, pcx_bytes, pnm_ext_bytes, psd_bytes,
                             psd_resource, sgi_bytes, tga_bytes)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io import pcx, psd, qoi, sgi

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


# -- writer cases: the variants Pillow reads and does not write --

def _psd(mode, channels, rle, bits=8, **kw):
    def make(rng):
        if bits == 1:
            planes = rng.integers(0, 256, (channels, H, (W + 7) // 8))
        else:
            planes = _runs(rng, (H, W, channels)).transpose(2, 0, 1)
        return psd_bytes(planes, mode, bits, rle=rle, **kw)
    return make


def _psd_indexed(rng):
    return psd_bytes(_runs(rng, (1, H, W)), 2, rle=True,
                     colour_data=rng.integers(0, 256, 768).astype(np.uint8).tobytes())


def _psd_sections(rng):
    res = psd_resource(1005, b"odd", b"nm") + psd_resource(1039, b"icc!")
    return psd_bytes(_runs(rng, (3, H, W)), 3, rle=True, colour_data=b"\x01" * 5,
                     resources=res, layers=struct.pack(">I", 0) + b"xy")


def _psd_long_packets(rng):
    """Each row one packet longer than the row, a run of 128 or a literal
    of 60 bytes: Pillow drops the bytes past each row's end."""
    head = psd_bytes(np.zeros((3, H, W)), 3, rle=True)[:26 + 12 + 2]
    rows = [bytes([0x81, int(rng.integers(0, 256))]) if y % 2 else
            bytes([59]) + rng.integers(0, 256, 60).astype(np.uint8).tobytes()
            for y in range(3 * H)]
    return head + struct.pack(f">{3 * H}H", *map(len, rows)) + b"".join(rows)


def _sgi(z, bpc, rle, dim=None):
    def make(rng):
        s = _runs(rng, (H, W, z))
        if bpc == 2:
            s = s << 8 | rng.integers(0, 256, s.shape)
        return sgi_bytes(s, bpc, rle=rle, dimension=dim)
    return make


def _pcx(bits, planes, pad, stated=True, by_line=True, palette="none"):
    def make(rng):
        stride = (W * bits + 7) // 8 + (1 if pad else 0)
        lines = _runs(rng, (H, planes * stride))
        ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
        pal = {"none": None, "ramp": ramp,
               "colours": rng.integers(0, 256, 768).astype(np.uint8).tobytes()}[palette]
        return pcx_bytes(lines, W, bits, planes, palette16=bytes(range(3, 51)), palette256=pal,
                         stride=stride if stated else stride + 2, by_line=by_line)
    return make


def _icon_entry(rng, size, bits, png=False, trns=False):
    if png:
        img = Image.fromarray(_runs(rng, (size, size, 4)).astype(np.uint8), "RGBA")
        if trns:
            img = img.convert("RGB").quantize(16)
        out = io.BytesIO()
        img.save(out, format="PNG", **({"transparency": 3} if trns else {}))
        return (size % 256, size % 256, 0, 1, 32, out.getvalue())
    mask = rng.integers(0, 2, (size, size))
    if bits <= 8:
        colour = rng.integers(0, 1 << bits, (size, size))
        pal = rng.integers(0, 256, 4 << bits).astype(np.uint8).tobytes()
    else:
        colour, pal = _runs(rng, (size, size, bits // 8)), b""
    return (size % 256, size % 256, 0, 1, bits, icon_bitmap(colour, bits, mask, pal))


def _ico(*specs):
    def make(rng):
        return icon_dir([_icon_entry(rng, *spec) for spec in specs], 1)
    return make


def _cur(*sizes, bits=8, header_at_22=False):
    def make(rng):
        entries = []
        for size in sizes:
            *_, data = _icon_entry(rng, size, bits)
            entries.append((size, size, 0, 1, 1, data))
        blob = icon_dir(entries, 2)
        if not header_at_22:  # move the bitmaps two bytes on
            n = len(entries)
            blob = bytearray(blob[:6 + 16 * n] + b"\0\0" + blob[6 + 16 * n:])
            for i in range(n):
                at = 6 + 16 * i + 12
                blob[at:at + 4] = struct.pack("<I", struct.unpack_from("<I", blob, at)[0] + 2)
        return bytes(blob)
    return make


def _cur_offset_0(rng):
    *_, data = _icon_entry(rng, 8, 24)
    return icon_dir([(8, 8, 0, 1, 1, data)], 2)[:6] + struct.pack(
        "<BBBBHHII", 8, 8, 0, 0, 1, 1, len(data), 0) + data


def _pillow(fmt, mode, **save):
    def make(rng):
        px = _runs(rng, (H, W, 4)).astype(np.uint8)
        px[::3, ::2, 3] = 0
        out = io.BytesIO()
        Image.fromarray(px, "RGBA").convert(mode).save(out, format=fmt, **save)
        return out.getvalue()
    return make


def _pfm(scale, nan=False):
    def make(rng):
        f = rng.normal(120, 120, (H, W)).astype(np.float32)
        f[0, :5] = (0.5, 254.99, 255.0, -0.0, 1e30)
        if nan:
            f[1, 1:4] = (np.nan, np.inf, -np.inf)
        order = "<f4" if scale < 0 else ">f4"
        return b"Pf\n%d %d\n%r\n" % (W, H, scale) + f[::-1].astype(order).tobytes()
    return make


def _pnm_ext(magic, channels, maxval=255):
    def make(rng):
        return pnm_ext_bytes(_runs(rng, (H, W, channels), maxval + 1), magic, maxval)
    return make


CASES = {
    "psd_grey_raw": _psd(1, 1, False),
    "psd_grey_rle_two_channels": _psd(1, 2, True),
    "psd_duotone": _psd(8, 1, True),
    "psd_multichannel": _psd(7, 3, False),
    "psd_bitmap_raw": _psd(0, 1, False, bits=1),
    "psd_bitmap_rle": _psd(0, 1, True, bits=1),
    "psd_indexed_rle": _psd_indexed,
    "psd_indexed_without_colours": _psd(2, 1, False),
    "psd_rgb_raw": _psd(3, 3, False),
    "psd_rgb_rle": _psd(3, 3, True),
    "psd_rgba_rle": _psd(3, 4, True),
    "psd_rgb_five_channels": _psd(3, 5, True),
    "psd_cmyk_raw": _psd(4, 4, False),
    "psd_cmyk_rle_five_channels": _psd(4, 5, True),
    "psd_sections": _psd_sections,
    "psd_packets_past_rows": _psd_long_packets,
    "qoi_rgb": _pillow("QOI", "RGB"),
    "qoi_rgba": _pillow("QOI", "RGBA"),
    "sgi_grey_verbatim_pillow": _pillow("SGI", "L"),
    "sgi_rgba_verbatim_pillow": _pillow("SGI", "RGBA"),
    "sgi_grey_dim1_rle": _sgi(1, 1, True, dim=1),
    "sgi_rgb_rle": _sgi(3, 1, True),
    "sgi_rgba_rle": _sgi(4, 1, True),
    "sgi_grey16_verbatim": _sgi(1, 2, False),
    "sgi_rgb16_verbatim": _sgi(3, 2, False),
    "sgi_rgba16_rle": _sgi(4, 2, True),
    "pcx_rgb_pillow": _pillow("PCX", "RGB"),
    "pcx_l_pillow": _pillow("PCX", "L"),
    "pcx_p_pillow": _pillow("PCX", "P"),
    "pcx_1_pillow": _pillow("PCX", "1"),
    "pcx_1bit_stated_stride": _pcx(1, 1, True),
    "pcx_two_planes": _pcx(1, 2, False),
    "pcx_four_planes": _pcx(1, 4, False),
    "pcx_four_planes_padded": _pcx(1, 4, True),
    "pcx_four_planes_unstated_stride": _pcx(1, 4, True, stated=False),
    "pcx_rgb_padded_runs_across_lines": _pcx(8, 3, True, by_line=False),
    "pcx_8bit_ramp_palette": _pcx(8, 1, True, palette="ramp"),
    "pcx_8bit_colours": _pcx(8, 1, False, palette="colours"),
    "pcx_8bit_no_palette": _pcx(8, 1, False, palette="none"),
    "ico_pillow_png": _pillow("ICO", "RGBA", sizes=[(16, 16), (32, 32)]),
    "ico_bmp_1bit_mask": _ico((16, 1)),
    "ico_bmp_4bit_mask": _ico((7, 4)),
    "ico_bmp_8bit_mask": _ico((33, 8)),
    "ico_bmp_24bit_mask": _ico((9, 24)),
    "ico_bmp_32bit_alpha": _ico((12, 32)),
    "ico_png_trns_ignored": _ico((10, 8, True, True)),
    "ico_largest_then_least_depth": _ico((8, 32), (16, 24), (16, 4), (16, 8), (4, 8)),
    "cur_one_entry_32bit_at_22": _cur(8, bits=32, header_at_22=True),
    "cur_32bit_elsewhere_opaque": _cur(8, bits=32),
    "cur_8bit": _cur(16, bits=8, header_at_22=True),
    "cur_strictly_larger_replaces": _cur(4, 8, 6, bits=4),
    "cur_wider_only_keeps_first": _cur(8, 8, bits=1),
    "cur_bitmap_offset_0": _cur_offset_0,
    "pfm_little_endian": _pfm(-1.0),
    "pfm_big_endian_scaled": _pfm(2.5),
    "pfm_nan_inf": _pfm(-1.0, nan=True),
    "pfm_pillow": lambda rng: _save_f(rng),
    "p0cmyk": _pnm_ext(b"P0CMYK", 4),
    "p0cmyk_maxval_1000": _pnm_ext(b"P0CMYK", 4, 1000),
    "pyp": _pnm_ext(b"PyP", 1),
    "pyrgba": _pnm_ext(b"PyRGBA", 4),
    "pycmyk_maxval_15": _pnm_ext(b"PyCMYK", 4, 15),
}


def _save_f(rng):
    out = io.BytesIO()
    Image.fromarray(rng.normal(100, 90, (H, W)).astype(np.float32), "F").save(out, format="PPM")
    return out.getvalue()


@pytest.mark.parametrize("name", list(CASES))
def test_writer_case_equals_jax(tmp_path, name):
    """Every case (at most 37 x 29, seeded from its name), loaded by path:
    the port's floats equal the JAX package's, byte for byte."""
    path = tmp_path / f"{name}.bin"
    path.write_bytes(CASES[name](_rng(name)))
    want = jimage.load_texture_rgba(str(path))
    got = timage.load_texture_rgba(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quirks_of_the_new_formats(tmp_path):
    """Values Pillow gives and the port keeps: a PFM's floats truncated and
    clipped, PyP black, a CUR's mask ignored, a 32-bit cursor's alpha only
    at byte 22, ICO's AND mask as alpha."""
    f = np.array([[0.99, 254.9, -3.5, 300.0]], np.float32)
    got = timage.decode_texture(b"Pf\n4 1\n-1.0\n" + f.astype("<f4").tobytes())
    assert got[0, :, 0].tolist() == [0, 254, 0, 255]
    assert timage.decode_texture(pnm_ext_bytes(np.full((1, 2, 1), 7), b"PyP"))[0].tolist() == \
        [[0, 0, 0, 255]] * 2
    bgra = np.array([[[10, 20, 30, 40]]])
    at22 = icon_dir([(1, 1, 0, 0, 0, icon_bitmap(bgra, 32, np.ones((1, 1))))], 2)
    assert timage.decode_texture(at22)[0, 0].tolist() == [30, 20, 10, 40]
    assert timage.read_texture(_cur(1, bits=32)(_rng("q")))[1][0, 0, 3] == 255
    ico = icon_dir([(2, 1, 0, 1, 24, icon_bitmap(np.full((1, 2, 3), 9), 24,
                                                   np.array([[1, 0]])))], 1)
    assert timage.decode_texture(ico)[0, :, 3].tolist() == [0, 255]


# -- the dispatch: by content, in Pillow's order --

def _tga(id_field=b"", rle=False):
    px = np.arange(4 * 5 * 4).reshape(4, 5, 4) % 251
    return tga_bytes(px, 10 if rle else 2, 32, id_field=id_field)


DISPATCH = {  # name -> (bytes, file name, the JAX package reads it)
    "tga_under_png": (_tga(), "t_tga.png", True),
    "tga_without_extension": (_tga(), "t_noext", True),
    "tga_1_byte_id_under_png": (_tga(b"x"), "t_tga.png", True),
    "tga_1_byte_id_without_extension": (_tga(b"x"), "t_noext", True),
    "tga_rle_under_jpg": (_tga(rle=True), "t.jpg", True),
    "tga_10_byte_id": (_tga(b"0123456789"), "id10.tga", False),
    "tga_10_byte_id_under_png": (_tga(b"0123456789"), "id10.png", False),
    "tga_10_byte_id_without_extension": (_tga(b"0123456789"), "id10", False),
    "pam_p7": (b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(4), "t.pam",
               False),
    "pfm_colour_pf": (b"PF\n2 2\n-1.0\n" + bytes(48), "t.pfm", False),
    "noise": (bytes(np.random.default_rng(3).integers(1, 256, 300).astype(np.uint8)), "t.png",
              False),
    "psd_under_tga": (_psd(3, 3, True)(_rng("d")), "t.tga", True),
    "qoi_without_extension": (_pillow("QOI", "RGB")(_rng("q")), "q", True),
    "ico_under_bmp": (_ico((8, 8))(_rng("i")), "i.bmp", True),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_follows_pillow(tmp_path, name):
    """The format is found by content, in Image.ID's order: a TGA reads
    under any name; a TGA with a 10-byte ID is refused by both, as Pillow's
    PCX plugin takes it and refuses it ("unknown PCX mode", fault C-4); P7,
    PF and noise are refused by both."""
    blob, fname, reads = DISPATCH[name]
    path = tmp_path / fname
    path.write_bytes(blob)
    want, got = _both(path)
    assert (want is not None) == reads
    if reads:
        assert got is not None
        np.testing.assert_array_equal(got, want)
    else:
        assert got is None
        with pytest.raises(ValueError, match="PCX mode" if "10_byte" in name else
                           "unknown texture format"):
            timage.load_texture_rgba(str(path))


def test_formats_follow_image_id():
    """FORMATS is Pillow 12.1's Image.ID, each format once, and the
    unknown-format message names every format the port reads."""
    Image.preinit()
    Image.init()
    ids = list(Image.ID)
    names = [f.name for f in timage.FORMATS]
    assert names == ids
    read = [f.name for f in timage.FORMATS if f.decode is not None]
    assert read == [i for i in ids if i not in ("AVIF", "BUFR", "EPS", "GRIB", "HDF5", "MPEG",
                                                "WMF")]
    with pytest.raises(ValueError, match="unknown texture format") as err:
        timage.decode_texture(b"\x01" * 40)
    for fmt in ("PNG", "JPEG", "BMP", "GIF", "PNM", "PFM", "TIFF", "DDS", "WebP", "TGA", "PSD",
                "QOI", "SGI", "PCX", "ICO", "CUR", "BLP", "FITS", "SUN", "XPM", "XVThumb"):
        assert fmt in str(err.value)


REFUSED = {  # name -> (bytes, message, the JAX package refuses it too)
    "psd_16_bit": (psd_bytes(np.zeros((3, 2, 2)), 3, 16), "unknown texture format", True),
    "psd_too_few_channels": (psd_bytes(np.zeros((2, 2, 2)), 3, channels=2), "channels", True),
    "psd_zip": (psd_bytes(np.zeros((3, 2, 2)), 3, compression=2), "PSD", True),
    "psd_lab": (psd_bytes(np.zeros((3, 2, 2)), 9, 16), "PSD: \\(9, 16\\)", True),
    "psd_truncated_rle": (psd_bytes(np.zeros((3, 4, 9)), 3, rle=True)[:-3], "PSD", True),
    "sgi_la": (sgi_bytes(np.zeros((2, 2, 2))), "SGI image mode", True),
    "sgi_compression_2": (sgi_bytes(np.zeros((2, 2, 3)), compression=2), "SGI", True),
    "sgi_truncated": (sgi_bytes(np.zeros((4, 4, 3)))[:-5], "SGI", True),
    "pcx_4bit_plane": (pcx_bytes(np.zeros((2, 2)), 4, 4, 1), "unknown PCX mode", True),
    "pcx_2bit_plane": (pcx_bytes(np.zeros((2, 2)), 4, 2, 1), "unknown PCX mode", True),
    "pcx_8bit_under_769_bytes": (pcx_bytes(np.zeros((2, 4)), 4, 8, 1), "769", True),
    "pcx_run_past_line": (pcx_bytes(np.zeros((2, 12)), 4, 8, 3)[:128]
                          + bytes([0xC8, 1, 0xC8, 1, 0xC8, 1, 0xC8, 1]) + bytes(800),
                          "run past the end of a line", True),
    "qoi_truncated": (_pillow("QOI", "RGB")(_rng("t"))[:-40], "QOI", True),
    "pfm_scale_inf": (b"Pf\n1 1\ninf\n" + bytes(4), "PFM scale", True),
    "ico_mask_missing": (_ico((8, 8))(_rng("m"))[:-20], "ICO", True),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_variants_raise(tmp_path, name):
    """A variant the port does not read raises ValueError naming it; where
    Pillow refuses it too, so does the JAX package."""
    blob, match, jax_refuses = REFUSED[name]
    path = tmp_path / f"{name}.bin"
    path.write_bytes(blob)
    want, _ = _both(path)
    assert (want is None) == jax_refuses
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


NEW_FIXTURES = ("mushroom256_rgba.qoi", "mushroom256_verbatim.sgi", "mushroom256_rle.sgi",
                "mushroom256_rgb.pcx", "mushroom256_l.pcx", "mushroom256_p.pcx",
                "mushroom256_1.pcx", "mushroom256_icon.ico", "mushroom256_grey.pfm",
                "mushroom256_cutout.psd", "mushroom256_cursor.cur", "mushroom1024.qoi")


def _pillow_decode(name):
    if name == "mushroom1024.qoi":
        return os.path.join(FIXTURES, "..", "jpeg", "mushroom1024_q90_420.png")
    return os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each fixture equals the JAX
    package's load and the 8-bit RGBA PNG of its Pillow decode."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    np.testing.assert_array_equal(got, timage.load_texture_rgba(_pillow_decode(name)))
    assert got.shape[:2] == ((1024, 1024) if "1024" in name else (256, 256))


@pytest.mark.parametrize("name", ["mushroom256_cutout.psd", "mushroom256_grey.pfm",
                                  "mushroom256_icon.ico", "mushroom256_rle.sgi",
                                  "mushroom256_map_rle.tga"])
def test_load_png_reads_what_jax_reads(name, tmp_path):
    """load_png reads any format the texture loader reads, as RGB and
    flipped, as the JAX package's does (fault C-3); a TGA under .png
    too."""
    path = os.path.join(FIXTURES, name)
    np.testing.assert_array_equal(timage.load_png(path), jimage.load_png(path))
    renamed = tmp_path / "t.png"
    renamed.write_bytes(open(path, "rb").read())
    np.testing.assert_array_equal(timage.load_png(str(renamed)), jimage.load_png(str(renamed)))


# -- the native loops and the mutants --

def _loop_inputs(rng, loop):
    n = int(rng.integers(0, 400))
    data = rng.integers(0, 256, n).astype(np.uint8)
    if n:
        data[rng.integers(0, n, n // 3)] = rng.choice([0, 1, 127, 128, 129, 0xC1, 0xFE, 0xFF])
    data = data.tobytes()
    if loop == "packbits":
        return psd.packbits_rows_python, native.packbits_rows, (
            data, int(rng.integers(1, 20)), int(rng.integers(1, 10)))
    if loop == "pcx":
        return pcx.rle_lines_python, native.pcx_rle, (
            data, int(rng.integers(1, 20)), int(rng.integers(1, 10)))
    if loop == "qoi":
        return qoi.decode_ops_python, native.qoi_decode, (
            data, int(rng.integers(1, 80)), int(rng.choice([3, 4])))
    w, h, z, bpc = (int(rng.integers(1, 8)), int(rng.integers(1, 5)), int(rng.choice([1, 3, 4])),
                    int(rng.choice([1, 2])))
    tables = b"".join(int(rng.integers(500, 520 + 8 * z * h + n)).to_bytes(4, "big")
                      for _ in range(z * h))
    tables += b"".join(int(rng.integers(0, 20) if rng.random() < 0.8 else
                           rng.integers(0, 1 << 32)).to_bytes(4, "big") for _ in range(z * h))
    return sgi.rle_rows_python, native.sgi_rle, (tables + data, w, h, z, bpc)


@needs_gxx
@pytest.mark.parametrize("loop", ["packbits", "sgi", "pcx", "qoi"])
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


MUTANT_SOURCES = {
    "psd": ("psd_rgba_rle", "psd_bitmap_rle", "psd_indexed_rle", "psd_cmyk_raw"),
    "qoi": ("qoi_rgb", "qoi_rgba"),
    "sgi": ("sgi_rgba_rle", "sgi_rgba16_rle", "sgi_rgb16_verbatim"),
    "pcx": ("pcx_four_planes_padded", "pcx_rgb_padded_runs_across_lines", "pcx_8bit_colours",
            "pcx_1_pillow"),
    "ico": ("ico_largest_then_least_depth", "ico_bmp_4bit_mask", "ico_pillow_png"),
    "cur": ("cur_one_entry_32bit_at_22", "cur_strictly_larger_replaces"),
    "pfm": ("pfm_little_endian", "p0cmyk_maxval_1000", "pyrgba"),
}


@pytest.mark.parametrize("fmt", list(MUTANT_SOURCES))
def test_mutants_agree_with_jax(tmp_path, fmt):
    """60 seeded mutants (truncations, byte flips, insertions) of the
    format's writer cases: each is read to the JAX package's bytes, or
    refused by both (the port with ValueError)."""
    rng = _rng(fmt)
    sources = [CASES[n](_rng(n)) for n in MUTANT_SOURCES[fmt]]
    path = tmp_path / "m.bin"
    for i in range(60):
        path.write_bytes(_mutant(rng, sources[i % len(sources)]))
        want, got = _both(path)
        assert (want is None) == (got is None), f"mutant {i}"
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f"mutant {i}")


MUTANT_SCRIPT = r"""
import sys
import numpy as np
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.image import read_texture
assert native.lib() is not None
rng = np.random.default_rng(21)
counts = {"array": 0, "ValueError": 0}
for path in sys.argv[1:]:
    blob = open(path, "rb").read()
    for _ in range(200):
        b = bytearray(blob)
        kind = rng.integers(0, 3)
        if kind == 0:
            b = b[:rng.integers(1, len(b))]
        else:
            lo = 0 if kind == 1 else min(len(b) - 1, 600)
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
    """200 seeded mutants of each 256^2 fixture whose decode runs a native
    loop (PSD's PackBits, SGI's and PCX's run lengths, QOI's ops) through
    read_texture, all in one subprocess: each gives an array or ValueError,
    and the process exits 0 (a crash in the C++ fails this test only)."""
    names = ("mushroom256_cutout.psd", "mushroom256_rle.sgi", "mushroom256_rgb.pcx",
             "mushroom256_rgba.qoi")
    script = tmp_path / "mutants.py"
    script.write_text(MUTANT_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    paths = [os.path.join(FIXTURES, n) for n in names]
    proc = subprocess.run([sys.executable, str(script), *paths], capture_output=True, text=True,
                          timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])  # noqa: S307 (our own dict literal)
    assert counts["array"] + counts["ValueError"] == 200 * len(names)
    assert counts["ValueError"] > 0
