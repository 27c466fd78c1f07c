"""The port's texture input (io/png.py, io/tga.py, io/jpeg.py behind
io/image.load_texture_rgba) against the JAX package's, which is Pillow's
``Image.open(path).convert("RGBA")``: equal bytes for every PNG colour type
and bit depth, interlaced or not, with PLTE and the three forms of tRNS, and
for TGA image types 1, 2, 3, 9, 10 and 11, Pillow's quirks included; the
variants Pillow refuses raise ValueError naming the format; a fully keyed
texture renders as the background in both tracers; the committed fixtures
equal their committed Pillow decodes."""

import os
import struct

import numpy as np
import pytest
from PIL import Image
from texture_writers import PNG_CHANNELS, png_bytes, tga_bytes

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch.io import image as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
W, H = 37, 29


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _runs(rng, shape, high: int) -> np.ndarray:
    """Seeded samples in [0, high) with runs along each row (for RLE and the
    row filters) and equal pixels across rows (for keys)."""
    s = rng.integers(0, high, shape)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]
    s[::4] = s[0]
    return s


def _png(depth, ctype, interlace=False, trns=None, plte=None, high=None):
    def make(rng):
        s = _runs(rng, (H, W, PNG_CHANNELS[ctype]), high or (1 << depth))
        t = trns(s) if callable(trns) else trns
        return png_bytes(s, depth, ctype, interlace, plte=plte, trns=t)
    return make


def _key(s, n):  # the first pixel's samples as a key
    return struct.pack(f">{n}H", *s[0, 0, :n].tolist())


def _pillow_png(mode, **save):
    def make(rng):
        px = _runs(rng, (H, W, 4), 256).astype(np.uint8)
        px[::5, ::7] = (7, 7, 7, 255)  # for the keys
        img = Image.fromarray(px, "RGBA").convert(mode if mode != "I;16" else "RGBA")
        if mode == "I;16":
            img = Image.fromarray(_runs(rng, (H, W), 400).astype(np.uint16))
        return img, dict(format="PNG", **save)
    return make


def _pillow_tga(mode, rle):
    def make(rng):
        px = _runs(rng, (H, W, 4), 256).astype(np.uint8)
        img = Image.fromarray(px, "RGBA").convert(mode)
        return img, dict(format="TGA", **({"compression": "tga_rle"} if rle else {}))
    return make


PALETTE = bytes(range(3, 3 + 3 * 11))  # 11 entries: indices past them read black
PNG_CASES = {
    **{f"grey{d}": _png(d, 0) for d in (1, 2, 4, 8, 16)},
    "grey16_over_255": _png(16, 0, high=700),  # Pillow clips at 255
    "grey1_key1": _png(1, 0, trns=struct.pack(">H", 1)),
    "grey2_key0": _png(2, 0, trns=struct.pack(">H", 0)),
    "grey2_key2": _png(2, 0, trns=struct.pack(">H", 2)),  # keys nothing in Pillow
    "grey8_key": _png(8, 0, trns=lambda s: _key(s, 1)),
    "grey16_key": _png(16, 0, high=300, trns=struct.pack(">H", 300)),  # keys 44
    "rgb8_key": _png(8, 2, trns=lambda s: _key(s, 3)),
    "rgb16": _png(16, 2),
    "rgb16_key": _png(16, 2, trns=lambda s: _key(s, 3)),  # keys nothing in Pillow
    "rgb16_key_low_bytes": _png(16, 2, trns=lambda s: struct.pack(
        ">3H", *((s[0, 0] >> 8) | 0x1200).tolist())),
    **{f"palette{d}": _png(d, 3, plte=PALETTE) for d in (1, 2, 4)},
    "palette8_past_plte": _png(8, 3, plte=PALETTE, high=16),
    "palette8_table": _png(8, 3, plte=PALETTE, high=11, trns=bytes([0, 64, 128, 200])),
    "palette4_table_past_plte": _png(4, 3, plte=PALETTE[:9], trns=bytes(range(0, 250, 20))),
    "palette8_one_index": _png(8, 3, plte=PALETTE, high=11, trns=b"\xff\xff\x00\xff"),
    "palette2_without_plte": _png(2, 3, trns=b"\x10"),
    "grey_alpha16": _png(16, 4),
    "rgba16": _png(16, 6),
    "rgba8_trns_ignored": _png(8, 6, trns=b"\x00\x01\x00\x02\x00\x03"),
    "adam7_rgb8": _png(8, 2, interlace=True),
    "adam7_grey2_key": _png(2, 0, interlace=True, trns=struct.pack(">H", 0)),
    "adam7_palette4_table": _png(4, 3, interlace=True, plte=PALETTE, trns=bytes([9, 0, 99])),
    "adam7_grey_alpha8": _png(8, 4, interlace=True),
    "adam7_rgba16": _png(16, 6, interlace=True),
    "adam7_grey16_key": _png(16, 0, interlace=True, high=256,
                             trns=lambda s: struct.pack(">H", int(s[0, 0, 0]) | 0x300)),
    "pillow_P_bits1": _pillow_png("P", bits=1),
    "pillow_P_bits2": _pillow_png("P", bits=2),
    "pillow_P_bits4": _pillow_png("P", bits=4),
    "pillow_P_transparency_index": _pillow_png("P", transparency=3),
    "pillow_P_transparency_table": _pillow_png("P", transparency=bytes(range(0, 256, 9))),
    "pillow_I16": _pillow_png("I;16"),
    "pillow_RGB_transparency": _pillow_png("RGB", transparency=(7, 7, 7)),
    "pillow_L_transparency": _pillow_png("L", transparency=7),
    "pillow_1_transparency": _pillow_png("1", transparency=0),
    "pillow_RGBA_optimize": _pillow_png("RGBA", optimize=True),
}


def _tga(img_type, depth, desc=0x20, cmap_bits=0, n_map=0, first=0, high=256, nb=None,
         id_field=b""):
    def make(rng):
        px = _runs(rng, (H, W, nb or depth // 8), high)
        cmap = (rng.integers(0, 256, n_map * cmap_bits // 8).astype(np.uint8).tobytes()
                if cmap_bits else None)
        return tga_bytes(px, img_type, depth, desc, cmap, cmap_bits, first, id_field)
    return make


def _tga_bits():  # 1-bit grey, rows packed from the high bit
    def make(rng):
        return tga_bytes(rng.integers(0, 256, (H, (W + 7) // 8, 1)), 3, 1, 0x20, width=W)
    return make


TGA_CASES = {
    **{f"pillow_{m}{'_rle' if rle else ''}": _pillow_tga(m, rle)
       for m in ("1", "L", "LA", "P", "RGB", "RGBA") for rle in (False, True)
       if not (m == "1" and rle)},
    "type1_map16_first3": _tga(1, 8, cmap_bits=16, n_map=9, first=3, high=16),
    "type1_map24_bottom_up": _tga(1, 8, 0x00, cmap_bits=24, n_map=12, high=14),
    "type9_map16": _tga(9, 8, cmap_bits=16, n_map=20, high=24),
    "type9_map24_first5_right_to_left": _tga(9, 8, 0x30, cmap_bits=24, n_map=7, first=5,
                                             high=14),
    "type2_16": _tga(2, 16),
    "type2_16_alpha_bit": _tga(2, 16, 0x21),
    "type10_16_bottom_up": _tga(10, 16, 0x01),
    "type2_32_no_alpha_bits": _tga(2, 32, 0x20),
    "type10_32_right_to_left": _tga(10, 32, 0x38),
    "type10_24_bottom_right": _tga(10, 24, 0x10, id_field=b"texture"),
    "type3_8": _tga(3, 8),
    "type3_1": _tga_bits(),
    "type11_8_bottom_up": _tga(11, 8, 0x00),
    "type3_16_grey_alpha": _tga(3, 16),
    "type11_16_grey_alpha": _tga(11, 16, 0x08),
    "type3_8_with_map": _tga(3, 8, cmap_bits=24, n_map=5, high=9),
    "type11_16_with_map16": _tga(11, 16, cmap_bits=16, n_map=6, high=9),
}


def _write(tmp_path, name, made) -> str:
    if isinstance(made, bytes):
        path = tmp_path / f"{name}.{'tga' if made[:4] != b'\x89PNG' else 'png'}"
        path.write_bytes(made)
    else:
        img, save = made
        path = tmp_path / f"{name}.{save['format'].lower()}"
        img.save(path, **save)
    return str(path)


@pytest.mark.parametrize("name", list(PNG_CASES) + [f"tga_{n}" for n in TGA_CASES])
def test_texture_variant_equals_jax(tmp_path, name):
    """Every variant at 37 x 29 (seeded from its name), loaded by path:
    the port's floats equal the JAX package's, byte for byte."""
    make = PNG_CASES[name] if name in PNG_CASES else TGA_CASES[name[4:]]
    path = _write(tmp_path, name, make(_rng(name)))
    got = timage.load_texture_rgba(path)
    want = jimage.load_texture_rgba(path)
    assert got.shape == (H, W, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _tga_run_past_row(rng):
    return struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 3, 2, 8, 0x20) + bytes(
        [0x83, 9, 0x01, 1, 2])


def _png_bad_crc(rng):
    blob = bytearray(png_bytes(np.zeros((2, 2, 1), np.int64), 8, 3, plte=PALETTE))
    blob[blob.index(b"PLTE") + 4] ^= 1
    return bytes(blob)


REFUSED = {
    "png_plte_over_256": (_png(8, 3, plte=bytes(771)), "PNG palette of 257 entries"),
    "png_table_over_256": (_png(8, 3, plte=PALETTE, trns=b"\x01" * 257),
                           "PNG tRNS table of 257 entries"),
    "png_short_rgb_key": (_png(8, 2, trns=b"\x00\x01"), "PNG tRNS key of 2 bytes"),
    "png_bad_crc": (_png_bad_crc, "broken PNG file"),
    "png_rgb_at_4_bits": (lambda rng: png_bytes(np.zeros((2, 2, 3), np.int64), 4, 2),
                          "unsupported PNG \\(bit depth 4, colour type 2\\)"),
    "tga_15_bit": (_tga(2, 15, nb=2), "not a TGA file"),
    "tga_map15": (_tga(1, 8, cmap_bits=15, n_map=4, high=4), "15-bit colour map"),
    "tga_map32": (_tga(1, 8, cmap_bits=32, n_map=4, high=4), "32-bit colour map"),
    "tga_map_past_256": (_tga(1, 8, cmap_bits=24, n_map=10, first=250, high=4),
                         "TGA colour map of 260 entries"),
    "tga_truecolour_with_map": (_tga(2, 24, cmap_bits=24, n_map=2),
                                "unsupported TGA \\(image type 2 at 24 bits with a colour"),
    "tga_type1_without_map": (_tga(1, 8, high=4), "TGA of image type 1 without a colour map"),
    "tga_run_past_row": (_tga_run_past_row, "TGA run-length packet runs past"),
    "tga_rle_1_bit": (lambda rng: struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 8,
                                              2, 1, 0x20) + bytes([0x81, 0xAA, 0x81, 0x55]),
                      "run-length encoded 1-bit TGA"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_variants_pillow_refuses_raise(tmp_path, name):
    """Where the JAX package's Pillow refuses a file, the port raises
    ValueError naming the format and the variant, never loading it."""
    make, match = REFUSED[name]
    path = _write(tmp_path, name, make(_rng(name)))
    with pytest.raises(Exception):
        jimage.load_texture_rgba(path)
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(path)


def _keyed(kind: str) -> bytes:
    """A 4 x 4 texture every pixel of which is keyed transparent."""
    if kind == "palette":
        return png_bytes(np.full((4, 4, 1), 2), 4, 3, plte=PALETTE, trns=b"\xff\xff\x00")
    if kind == "rgb_key":
        return png_bytes(np.full((4, 4, 3), 200), 8, 2, trns=struct.pack(">3H", 200, 200, 200))
    return png_bytes(np.full((4, 4, 1), 9), 8, 0, trns=struct.pack(">H", 9))


@pytest.mark.parametrize("kind", ["palette", "rgb_key", "grey_key"])
def test_keyed_texture_renders_the_background(tmp_path, kind):
    """Fault C-2: a PNG whose every pixel its tRNS keys out, loaded by path
    onto tests/test_torch_rt.py's quad.  The tracer's stochastic alpha lets
    every ray through, so both packages' RtxHost.render (seed 7, 8 samples)
    give exactly the background, and each other's frame."""
    from test_torch_rt import RES, front_camera, hosts, jax_camera, quad_mesh

    path = str(tmp_path / "keyed.png")
    with open(path, "wb") as fh:
        fh.write(_keyed(kind))
    port, jax_host = hosts(quad_mesh(half=2.0), path, 8)
    bg = (0.2, 0.5, 0.9)
    cam = front_camera()
    img_t = port.render(cam, bg, 8, RES, RES, seed=7).numpy()
    img_j = np.asarray(jax_host.render(jax_camera(cam), bg, 8, RES, RES, seed=7))
    acc = np.zeros(3, np.float32)
    for _ in range(8):
        acc += np.asarray(bg, np.float32)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(img_t, np.broadcast_to(acc / np.float32(8), img_t.shape))
    assert not port._texture[..., 3].any()


FIXTURE_NAMES = ("mushroom256_palette_trns.png", "mushroom256_rgba16.png",
                 "mushroom256_adam7.png", "mushroom256_map_rle.tga", "mushroom256_cmyk.jpg")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixtures_equal_their_pillow_decodes(name):
    """tests/data/textures (make_fixtures.py): each texture against the
    8-bit RGBA PNG of its Pillow decode beside it."""
    got = timage.load_texture_rgba(os.path.join(FIXTURES, name))
    stem = name.rsplit(".", 1)[0]
    want = timage.load_texture_rgba(os.path.join(FIXTURES, f"{stem}.pillow.png"))
    assert got.shape == (256, 256, 4)
    np.testing.assert_array_equal(got, want)
