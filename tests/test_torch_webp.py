"""The port's WebP input (io/webp.py over native/src/webp.cpp, behind
io/image.load_texture_rgba) against the JAX package's, which is Pillow's
``Image.open(path).convert("RGBA")``: equal bytes, tolerance 0.

Pillow-written files at four sizes (37x29, 1x1, 16x16, 257x3: partial
macroblocks, odd widths and heights, the upsampler's edges): lossy at
qualities 0, 50 and 100 and methods 0 and 6, opaque and with alpha at
``alpha_quality`` 0, 50 and 100 (VP8L-coded ALPH, its filters and level
quantisation); lossless at methods 0-6, with and without alpha (predictor,
cross-colour, subtract-green, colour cache, meta prefix codes); 2-, 4- and
16-colour lossless images (colour indexing with 8, 4 and 2 pixels bundled);
a two-frame animation with mixed lossy and lossless frames.  Hand-assembled
containers (tests/texture_writers.py): raw ALPH under each filter, an ANMF
first frame offset inside a larger canvas, ICCP/EXIF and odd-sized unknown
chunks, and the cases where the file's "has alpha" and its pixels part.

VP8 paths that no Pillow-written file reaches: Pillow cannot ask libwebp for
the simple loop filter or for more than one token partition, and ``cwebp``
is not installed.  Frames written here instead (``texture_writers.vp8_frame``:
the header's fields chosen, every bit after them seeded at random, so the
probability updates, modes and tokens follow the decoder's model) reach
them: the simple and the normal filter at levels 0-63 and sharpness 0-7,
1, 2, 4 and 8 partitions, segments with absolute and delta values, filter
deltas, quantiser deltas, the scaling bits.

The committed fixtures (tests/data/textures/make_fixtures.py) equal their
Pillow decodes; truncated and mutated files raise ValueError naming WebP or
decode, never crash (the mutants run in a subprocess); without the native
library a WebP file raises the ValueError that says so."""

import io
import os
import shutil
import struct
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image
from texture_writers import (alph_raw, anmf_chunk, riff_chunk, vp8_frame, vp8x_chunk, webp_bytes,
                             webp_chunks)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io.webp import decode_webp

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
WEBP_FIXTURES = ("mushroom256_lossy.webp", "mushroom256_lossy_alpha.webp",
                 "mushroom256_lossless.webp", "mushroom256_anim.webp", "mushroom1024_q90.webp",
                 "mushroom1024_lossless.webp")
SIZES = ((37, 29), (1, 1), (16, 16), (257, 3))
pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


def _picture(seed: int, w: int, h: int) -> np.ndarray:
    """A seeded RGBA picture with gradients, noise and runs (for the
    predictors and LZ77), a quarter of it transparent and a row band half
    transparent."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.stack([(xx * 7 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256, np.full_like(xx, 255)],
                  axis=-1)
    px = np.clip(px + rng.integers(-30, 30, (h, w, 4)), 0, 255).astype(np.uint8)
    px[:, 1::3] = px[:, ::3][:, :px[:, 1::3].shape[1]]
    px[::3, ::2, 3] = 0
    px[1::4, :, 3] = 128
    return px


def _save(img: Image.Image, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, format="WEBP", **kw)
    return out.getvalue()


def _lossy(q, m, aq=None):
    def make(px):
        if aq is None:
            return _save(Image.fromarray(px[..., :3]), quality=q, method=m)
        return _save(Image.fromarray(px, "RGBA"), quality=q, method=m, alpha_quality=aq)
    return make


def _lossless(m, alpha):
    def make(px):
        img = Image.fromarray(px, "RGBA") if alpha else Image.fromarray(px[..., :3])
        return _save(img, lossless=True, method=m)
    return make


def _palette(n):
    def make(px):
        rng = np.random.default_rng(n)
        colours = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        idx = px[..., 0].astype(np.int64) % n
        return _save(Image.fromarray(colours[idx], "RGBA"), lossless=True, method=4)
    return make


def _animation(px):
    first = Image.fromarray(px, "RGBA")
    second = Image.fromarray(px[::-1, ::-1].copy(), "RGBA")
    return _save(first, save_all=True, append_images=[second], duration=80, allow_mixed=True,
                 quality=70)


VARIANTS = {}
for _q in (0, 50, 100):
    for _m in (0, 6):
        VARIANTS[f"lossy_q{_q}_m{_m}"] = _lossy(_q, _m)
        for _aq in (0, 50, 100):
            VARIANTS[f"lossy_q{_q}_m{_m}_alpha{_aq}"] = _lossy(_q, _m, _aq)
for _m in range(7):
    VARIANTS[f"lossless_m{_m}_rgba"] = _lossless(_m, True)
    VARIANTS[f"lossless_m{_m}_rgb"] = _lossless(_m, False)
for _n in (2, 4, 16):
    VARIANTS[f"palette{_n}"] = _palette(_n)
VARIANTS["animation_mixed"] = _animation


def _both(tmp_path, blob: bytes, name: str = "t.webp"):
    path = tmp_path / name
    path.write_bytes(blob)
    return timage.load_texture_rgba(str(path)), jimage.load_texture_rgba(str(path))


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_pillow_written_webp_equals_jax(tmp_path, name, size):
    w, h = size
    blob = VARIANTS[name](_picture(sum(name.encode()) + w, w, h))
    got, want = _both(tmp_path, blob)
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


FRAMES = [(simple, parts) for simple in (True, False) for parts in range(4)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("simple,parts_log2", FRAMES,
                         ids=[f"{'simple' if s else 'normal'}_{1 << p}parts" for s, p in FRAMES])
def test_vp8_filters_and_partitions_equal_jax(tmp_path, simple, parts_log2, seed):
    """VP8 frames with the simple or the normal loop filter and 1-8 token
    partitions (tests/texture_writers.vp8_frame), each with its own level,
    sharpness, segments and quantiser, at partial-macroblock sizes."""
    k = 4 * seed + parts_log2
    w, h = ((45, 37), (50, 140), (17, 9))[seed]
    frame = vp8_frame(100 * seed + parts_log2 + 10 * simple, w, h, simple, parts_log2,
                      level=(9, 24, 40, 63)[k % 4], sharpness=k % 8, segments=bool(k % 2),
                      q=(4, 10, 40, 127)[(k + seed) % 4])
    got, want = _both(tmp_path, webp_bytes([riff_chunk(b"VP8 ", frame)]))
    assert got.shape == want.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


W, H = 37, 29


def _parts():
    """The chunks of seeded lossy and lossless files of W x H, and their
    alpha plane."""
    px = _picture(7, W, H)
    lossy = webp_chunks(_save(Image.fromarray(px[..., :3]), quality=80))[b"VP8 "]
    lossless = webp_chunks(_save(Image.fromarray(px, "RGBA"), lossless=True))[b"VP8L"]
    return px[..., 3], lossy, lossless


def _no_alpha_bit(vp8l: bytes) -> bytes:
    out = bytearray(vp8l)
    out[4] &= 0xEF  # the header's alpha_is_used bit
    return bytes(out)


def _raw_alpha(filt):
    def make():
        alpha, lossy, _ = _parts()
        return webp_bytes([vp8x_chunk(W, H, 0x10), riff_chunk(b"ALPH", alph_raw(alpha, filt)),
                           riff_chunk(b"VP8 ", lossy)])
    return make


def _anmf_offset(flags):
    def make():
        alpha, lossy, lossless = _parts()
        frame = riff_chunk(b"ALPH", alph_raw(alpha, 3)) + riff_chunk(b"VP8 ", lossy)
        return webp_bytes([vp8x_chunk(64, 50, flags), riff_chunk(b"ANIM", bytes([9, 8, 7, 200, 0, 0])),
                           anmf_chunk(10, 14, W, H, frame),
                           anmf_chunk(0, 0, W, H, riff_chunk(b"VP8L", lossless))])
    return make


def _extra_chunks():
    alpha, lossy, _ = _parts()
    return webp_bytes([vp8x_chunk(W, H, 0x10 | 0x20 | 0x08 | 0x04),
                       riff_chunk(b"ICCP", bytes(range(131))), riff_chunk(b"ODD!", b"xyz"),
                       riff_chunk(b"ALPH", alph_raw(alpha, 2)), riff_chunk(b"VP8 ", lossy),
                       riff_chunk(b"EXIF", b"Exif\0\0MM\0*"), riff_chunk(b"XMP ", b"<x/>"),
                       riff_chunk(b"zzzz", b"q")])


def _flagged(flags, lossless, bit=True, alph=False):
    def make():
        alpha, lossy, vp8l = _parts()
        chunks = [vp8x_chunk(W, H, flags)]
        if alph:
            chunks.append(riff_chunk(b"ALPH", alph_raw(alpha, 1)))
        chunks.append(riff_chunk(b"VP8L", vp8l if bit else _no_alpha_bit(vp8l)) if lossless
                      else riff_chunk(b"VP8 ", lossy))
        return webp_bytes(chunks)
    return make


def _eight_by_eight():
    return _save(Image.new("RGB", (8, 8), (200, 30, 90)))


CONTAINERS = {
    "alph_raw_none": _raw_alpha(0),
    "alph_raw_horizontal": _raw_alpha(1),
    "alph_raw_vertical": _raw_alpha(2),
    "alph_raw_gradient": _raw_alpha(3),
    "anmf_offset_alpha": _anmf_offset(0x12),
    "anmf_offset_no_alpha_flag": _anmf_offset(0x02),
    "iccp_exif_xmp_odd_unknown": _extra_chunks,
    "vp8x_no_flag_vp8l_alpha_bit": _flagged(0, True),
    "vp8x_flag_vp8l_no_alpha_bit": _flagged(0x10, True, bit=False),
    "simple_vp8l_no_alpha_bit": lambda: webp_bytes([riff_chunk(b"VP8L", _no_alpha_bit(
        _parts()[2]))]),
    "vp8x_no_flag_alph_dropped": _flagged(0, False, alph=True),
    "vp8x_flag_no_alph": _flagged(0x10, False),
    "bytes_past_riff_size": lambda: _eight_by_eight() + b"trailing bytes",
    "pillow_8x8": _eight_by_eight,
}


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_assembled_container_equals_jax(tmp_path, name):
    """Containers assembled by hand: each reads as Pillow reads it,
    ``convert("RGBA")``'s alpha decision included."""
    got, want = _both(tmp_path, CONTAINERS[name]())
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_alpha_decision_follows_the_header_not_the_pixels():
    """A VP8L image without its alpha bit reads opaque although its pixels
    are a quarter transparent; the animation without the VP8X alpha flag
    reads its canvas opaque black around the frame."""
    plain = decode_webp(CONTAINERS["simple_vp8l_no_alpha_bit"]())
    assert (plain[..., 3] == 255).all()
    anim = decode_webp(CONTAINERS["anmf_offset_no_alpha_flag"]())
    assert anim.shape == (50, 64, 4)
    assert (anim[:14] == [0, 0, 0, 255]).all() and (anim[..., 3] == 255).all()
    keyed = decode_webp(CONTAINERS["anmf_offset_alpha"]())
    assert (keyed[:14] == 0).all() and (keyed[14:14 + H, 10:10 + W, 3] == 0).any()


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_equals_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each WebP against the 8-bit
    RGBA PNG of its Pillow decode (for the 1024^2 lossless file, the 1024^2
    JPEG fixture's PNG, whose pixels it holds)."""
    png = (os.path.join(os.path.dirname(FIXTURES), "jpeg", "mushroom1024_q90_420.png")
           if name == "mushroom1024_lossless.webp"
           else os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png"))
    got = timage.load_texture_rgba(os.path.join(FIXTURES, name))
    np.testing.assert_array_equal(got, timage.load_texture_rgba(png))
    if name in ("mushroom256_lossy_alpha.webp", "mushroom256_anim.webp"):
        assert (got[..., 3] == 0).mean() == 0.25  # the keyed-out texels


@pytest.mark.parametrize("name", WEBP_FIXTURES)
@pytest.mark.parametrize("keep", [0.2, 0.7])
def test_truncated_webp_raises_value_error(tmp_path, name, keep):
    """A fixture cut short raises ValueError naming WebP, as Pillow refuses
    it."""
    blob = open(os.path.join(FIXTURES, name), "rb").read()
    path = tmp_path / name
    path.write_bytes(blob[:int(len(blob) * keep)])
    with pytest.raises(Exception):
        jimage.load_texture_rgba(str(path))
    with pytest.raises(ValueError, match="WebP"):
        timage.load_texture_rgba(str(path))


MUTANT_SCRIPT = r"""
import sys
import numpy as np
from gaussian_splatterer_tpu_torch.io.webp import decode_webp

rng = np.random.default_rng(20)
counts = {"array": 0, "ValueError": 0}
for path in sys.argv[1:]:
    blob = open(path, "rb").read()
    for trial in range(50):
        b = bytearray(blob)
        kind = trial % 4
        if kind == 0:  # cut anywhere, the RIFF size fixed to the cut
            b = b[:int(rng.integers(12, len(b)))]
            b[4:8] = (len(b) - 8).to_bytes(4, "little")
        elif kind == 1:  # flip bytes past the container's headers
            for at in rng.integers(20, len(b), int(rng.integers(1, 8))):
                b[at] ^= int(rng.integers(1, 256))
        elif kind == 2:  # flip bytes of the headers
            for at in rng.integers(12, min(len(b), 64), int(rng.integers(1, 4))):
                b[at] ^= int(rng.integers(1, 256))
        else:  # a random size for a chunk
            pos = 12
            sizes = []
            while pos + 8 <= len(b):
                sizes.append(pos)
                n = int.from_bytes(b[pos + 4:pos + 8], "little")
                pos += 8 + n + (n & 1)
            at = sizes[int(rng.integers(0, len(sizes)))]
            b[at + 4:at + 8] = int(rng.integers(0, 1 << 32)).to_bytes(4, "little")
        try:
            out = decode_webp(bytes(b))
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 4
            counts["array"] += 1
        except ValueError as exc:
            assert "WebP" in str(exc), exc
            counts["ValueError"] += 1
print(counts)
"""


def test_mutated_webp_gives_value_error_or_image_in_subprocess(tmp_path):
    """~200 seeded mutants of the 256^2 fixtures (truncations, byte flips in
    the data and in the headers, random chunk sizes) through decode_webp in
    a subprocess: each gives ValueError naming WebP or an RGBA array, and
    the process exits 0 (a crash in the C++ fails this test only)."""
    paths = [os.path.join(FIXTURES, n) for n in WEBP_FIXTURES if n.startswith("mushroom256")]
    script = tmp_path / "mutants.py"
    script.write_text(MUTANT_SCRIPT)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script), *paths], capture_output=True, text=True,
                          timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = eval(proc.stdout.strip().splitlines()[-1])  # noqa: S307 (our own dict literal)
    assert counts["array"] + counts["ValueError"] == 50 * len(paths)
    assert counts["ValueError"] > 0


def test_without_the_native_library_webp_names_it(tmp_path, monkeypatch):
    """The decoders have no Python twin: with the library missing a WebP
    file raises ValueError naming the native library; and the library's
    name hashes webp.cpp, so a changed decoder is never a stale build."""
    path = tmp_path / "t.webp"
    path.write_bytes(_eight_by_eight())
    with mock.patch.object(native, "lib", lambda: None):
        with pytest.raises(ValueError, match="WebP: decoding needs the native library"):
            timage.load_texture_rgba(str(path))
    assert native.WEBP_SRC.name == "webp.cpp" and native.WEBP_SRC in native.sources()
    before = native.lib_path()
    changed = tmp_path / "webp.cpp"
    changed.write_bytes(native.WEBP_SRC.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "WEBP_SRC", changed)
    assert native.lib_path() != before


def test_refused_webp_variants_raise():
    """What Pillow refuses raises ValueError naming WebP and the stage: a
    VP8 frame that is not a key frame, a bad VP8L signature, a frame past
    the canvas, an ALPH chunk with reserved bits."""
    alpha, lossy, lossless = _parts()
    inter = bytearray(lossy)
    inter[0] |= 1  # an interframe
    bad_sig = b"\x2e" + lossless[1:]
    past = webp_bytes([vp8x_chunk(40, 40, 0x12), riff_chunk(b"ANIM", bytes(6)),
                       anmf_chunk(8, 20, W, H, riff_chunk(b"VP8L", lossless))])
    reserved = webp_bytes([vp8x_chunk(W, H, 0x10), riff_chunk(b"ALPH", b"\xc0" + bytes(W * H)),
                           riff_chunk(b"VP8 ", lossy)])
    cases = [(webp_bytes([riff_chunk(b"VP8 ", bytes(inter))]), "key frame"),
             (webp_bytes([riff_chunk(b"VP8L", bad_sig)]), "VP8L header"),
             (past, "past the canvas"), (reserved, "ALPH header")]
    for blob, match in cases:
        with pytest.raises(Exception):
            Image.open(io.BytesIO(blob)).convert("RGBA")
        with pytest.raises(ValueError, match=f"WebP.*{match}"):
            decode_webp(blob)
    assert struct.unpack_from("<I", past, 4)[0] == len(past) - 8
