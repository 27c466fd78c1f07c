"""The port's Zstandard decoder (io/zstd.py, its C++ form native/src/zstd.cpp)
and TIFF compression 50000 against the JAX package's reading (Pillow over
libtiff 4.7.1 and libzstd 1.5.7) and against ``zstandard``: frames written
here at levels 1, 3, 19 and 22, with and without checksum and content size,
through the native decoder, the Python twin and ``zstandard``, their blocks,
literal and sequence modes counted; libzstd's limits, each wrapped in a TIFF
strip and held against Pillow; TIFF variants (Pillow's files and the
writer's) byte-equal to the JAX package's load through both decoders; the
two fixtures; 300 seeded single-bit flips of the 256^2 fixture's strips in a
subprocess, each read as Pillow reads it or refused by both; damaged
frames, native against twin, reasons included."""

import hashlib
import io
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
import zstandard
from PIL import Image
from texture_writers import tiff_bytes

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io import zstd

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 37, 29


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


# ---- frames -------------------------------------------------------------------

def _chunks(rng, n: int) -> bytes:
    """Eight 50-byte chunks in a seeded order, each followed by 'q' and one
    of eight bytes: matches over whole chunks, literals of a few symbols
    (one Huffman stream, treeless blocks)."""
    chunks = [rng.integers(0, 256, 50).astype(np.uint8).tobytes() for _ in range(8)]
    out = bytearray()
    while len(out) < n:
        out += chunks[int(rng.integers(8))] + b"q" + bytes([int(rng.integers(8))])
    return bytes(out[:n])


def _hand_frame() -> bytes:
    """A frame no compressor here writes: a raw block, then compressed
    blocks of RLE literals and RLE sequence tables (literal length 5, match
    length 8, offset code 4 with its four bits 0, so offset 13), then offset
    code 0 (the repeat offset 13, carried from the block before), then the
    three tables in repeat mode; each sequence's bits are all zero, so each
    bit stream is its end mark alone or a zero byte before it."""
    rle_seq = bytes([1 << 6 | 1 << 4 | 1 << 2])
    blocks = [(0, b"abcdefgh"),
              (2, bytes([10 << 3 | 1]) + b"z" + bytes([2]) + rle_seq + bytes([5, 4, 5]) + b"\0\1"),
              (2, bytes([5 << 3 | 1]) + b"y" + bytes([1]) + rle_seq + bytes([5, 0, 5]) + b"\1"),
              (2, bytes([5 << 3 | 1]) + b"x" + bytes([1, 0xFC]) + b"\1")]
    out = struct.pack("<I", zstd.MAGIC) + bytes([0, 0])
    for i, (kind, body) in enumerate(blocks):
        size = len(body) if kind != 1 else body[0]
        out += int(size << 3 | kind << 1 | (i == len(blocks) - 1)).to_bytes(3, "little") + body
    return out


def _text(rng, n: int) -> bytes:
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8))
             for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 5))[:n]


def _data(kind: str, n: int, rng) -> bytes:
    if kind == "random":  # raw blocks
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "constant":  # RLE blocks
        return bytes([7]) * n
    if kind == "skewed":  # Huffman literals, few matches
        return np.minimum(rng.exponential(12, n), 255).astype(np.uint8).tobytes()
    if kind == "text":
        return _text(rng, n)
    return _chunks(rng, n)


def _frame(data: bytes, level: int, checksum: bool, size: bool) -> bytes:
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=size)
    if size:
        return c.compress(data)
    obj = c.compressobj()
    return obj.compress(data) + obj.flush()


def _corpus() -> list:
    """(name, frame, content): every kind of data at levels 1, 3, 19 and 22,
    with and without checksum and content size, 300 KiB for the kinds
    whose later blocks reuse the first's tables, and the hand-made frame
    (its content ``zstandard``'s decode)."""
    rng = _rng("zstd corpus")
    out = []
    for kind, n in (("random", 40_000), ("constant", 300_000), ("skewed", 30_000),
                    ("text", 300_000), ("chunks", 300_000)):
        data = _data(kind, n, rng)
        for level in (1, 3, 19, 22):
            for checksum, size in ((False, False), (True, True), (True, False), (False, True)):
                out.append((f"{kind}_l{level}_{'c' if checksum else ''}{'s' if size else ''}",
                            _frame(data, level, checksum, size), data))
    hand = _hand_frame()
    out.append(("hand_rle_literals_and_tables", hand,
                zstandard.ZstdDecompressor().decompressobj().decompress(hand)))
    return out


CORPUS = _corpus()


def _features(frame: bytes) -> set:
    """What a frame's blocks hold: block types, literal types (compressed
    and treeless in one or four streams), and each sequence table's mode,
    with an RLE offset code of 0 or 1 (a repeat offset) marked."""
    fhd = frame[4]
    single = fhd >> 5 & 1
    pos = 5 + (not single) + (0, 1, 2, 4)[fhd & 3] + (single, 2, 4, 8)[fhd >> 6]
    feats = set()
    while True:
        head = int.from_bytes(frame[pos:pos + 3], "little")
        last, kind, size = head & 1, head >> 1 & 3, head >> 3
        pos += 3
        feats.add(("block", ("raw", "rle", "compressed")[kind]))
        if kind == 2:
            b0 = frame[pos]
            lit, code = b0 & 3, b0 >> 2 & 3
            if lit < 2:
                hsize = (1, 2, 1, 3)[code]
                count = int.from_bytes(frame[pos:pos + hsize], "little") >> (3 if hsize == 1 else 4)
                q = pos + hsize + (count if lit == 0 else 1)
                feats.add(("literals", ("raw", "rle")[lit]))
            else:
                lhc = int.from_bytes(frame[pos:pos + 5], "little")
                hsize, csize = ((3, lhc >> 14 & 0x3FF) if code < 2 else (4, lhc >> 18 & 0x3FFF)
                                if code == 2 else (5, lhc >> 22 & 0x3FFFF))
                q = pos + hsize + csize
                feats.add(("literals", ("compressed", "treeless")[lit - 2],
                           "four streams" if code else "one stream"))
            nseq = frame[q]
            q += 1 + (nseq >= 0x80) + (nseq == 0xFF)
            if nseq:
                modes = frame[q]
                q += 1
                for name, mode in (("LL", modes >> 6), ("OF", modes >> 4 & 3),
                                   ("ML", modes >> 2 & 3)):
                    feats.add(("sequences", name,
                               ("predefined", "rle", "compressed", "repeat")[mode]))
                    if mode == 1:
                        if name == "OF" and frame[q] <= 1:
                            feats.add(("repeat offsets",))
                        q += 1
                    elif mode == 2:
                        q += zstd.read_ncount(frame, q, pos + size - q, 52)[2]
        pos += 1 if kind == 1 else size
        if last:
            return feats


def test_corpus_covers_the_format():
    """The frames hold every block type, raw, RLE, compressed and treeless
    literals, one and four Huffman streams, every sequence table mode and
    repeat offsets."""
    feats = set().union(*(_features(f) for _, f, _ in CORPUS))
    assert {("block", k) for k in ("raw", "rle", "compressed")} <= feats
    assert {("literals", "raw"), ("literals", "rle"), ("literals", "compressed", "one stream"),
            ("literals", "compressed", "four streams"), ("literals", "treeless", "one stream"),
            ("literals", "treeless", "four streams")} <= feats
    for name in ("LL", "OF", "ML"):
        assert {("sequences", name, m) for m in ("predefined", "rle", "compressed", "repeat")} \
            <= feats, name
    assert ("repeat offsets",) in feats


@pytest.mark.parametrize("name", [n for n, _, _ in CORPUS])
def test_frame_decodes_as_zstandard(name):
    """Each frame through ``zstandard``, the native decoder and, up to 40
    KB, the Python twin: its content, byte for byte."""
    _, frame, data = next(c for c in CORPUS if c[0] == name)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
    assert native.zstd_decode(frame, len(data)) == data
    if len(data) <= 40_000:
        assert zstd.decode_python(frame, len(data)) == data
    check = zstandard.ZstdCompressor(write_checksum=True).compress(data)[-4:]
    assert zstd.xxh64(data) & 0xFFFFFFFF == struct.unpack("<I", check)[0]


def _outcome(fn, data: bytes, size: int):
    try:
        return fn(data, size)
    except ValueError as exc:
        return f"refused: {exc}"


def test_damaged_frames_native_equals_twin():
    """400 seeded mutants (bit flips, byte flips, cuts, insertions, header
    flips) of the corpus's frames up to 40 KB, read into their content's
    size and into a seeded smaller one: the native decoder gives the
    twin's bytes, or its refusal with the same reason."""
    rng = _rng("damaged frames")
    small = [(f, d) for _, f, d in CORPUS if 0 < len(d) <= 40_000]
    kinds = set()
    for i in range(400):
        frame, data = small[i % len(small)]
        b = bytearray(frame)
        k = i % 5
        if k == 0:
            bit = int(rng.integers(8 * len(b)))
            b[bit >> 3] ^= 1 << (bit & 7)
        elif k == 1:
            for _ in range(int(rng.integers(1, 4))):
                b[int(rng.integers(len(b)))] = int(rng.integers(256))
        elif k == 2:
            b = b[:int(rng.integers(1, len(b)))]
        elif k == 3:
            b[int(rng.integers(min(len(b), 20)))] ^= 1 << int(rng.integers(8))
        else:
            at = int(rng.integers(len(b)))
            b[at:at] = rng.integers(0, 256, int(rng.integers(1, 5))).astype(np.uint8).tobytes()
        size = len(data) if i % 2 else int(rng.integers(1, len(data) + 1))
        want = _outcome(zstd.decode_python, bytes(b), size)
        assert _outcome(native.zstd_decode, bytes(b), size) == want, i
        kinds.add(want.split(" (")[0] if isinstance(want, str) else "bytes")
    assert {"bytes", "refused: Data corruption detected", "refused: Not enough data"} <= kinds


# ---- libzstd's limits, as Pillow meets them in a strip --------------------------

def _grey_tiff(strip: bytes, w: int, h: int) -> bytes:
    """An 8-bit grey TIFF of one Zstandard strip of ``w`` x ``h`` pixels."""
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 50000), (262, 3, 1),
            (273, 4, 8), (277, 3, 1), (278, 4, h), (279, 4, len(strip))]
    entries = [struct.pack("<HHI", t, k, 1) + (struct.pack("<I", v) if k == 4 else
                                                struct.pack("<HH", v, 0)) for t, k, v in tags]
    ifd = struct.pack("<H", len(tags)) + b"".join(entries) + bytes(4)
    return b"II*\0" + struct.pack("<I", 8 + len(strip)) + strip + ifd


_PIXELS = (_text(np.random.default_rng(3), 64 * 48))[:64 * 48]


def _plain(level=9, **kw) -> bytes:
    return _frame(_PIXELS, level, kw.get("checksum", False), kw.get("size", False))


def _set_byte(frame: bytes, at: int, value: int) -> bytes:
    return frame[:at] + bytes([value]) + frame[at + 1:]


def _with_dict_id(frame: bytes, did: int) -> bytes:
    """The frame with a one-byte dictionary ID field."""
    return frame[:4] + bytes([frame[4] | 1]) + frame[5:6] + bytes([did]) + frame[6:]


def _with_checksum(frame: bytes, good: bool) -> bytes:
    """The frame with the checksum flag and its XXH64 (or a wrong one)."""
    check = zstd.xxh64(_PIXELS) & 0xFFFFFFFF ^ (0 if good else 1)
    return frame[:4] + bytes([frame[4] | 4]) + frame[5:] + struct.pack("<I", check)


def _skippable(frame: bytes) -> bytes:
    return struct.pack("<II", 0x184D2A53, 4) + b"skip" + frame


# name -> (strip, its width and height): each against Pillow
LIMITS = {
    "clean": (_plain(), 64, 48),
    "levels_1_and_19": (_plain(1), 64, 48),
    "window_2_27": (_set_byte(_plain(), 5, (27 - 10) << 3), 64, 48),  # the largest libzstd takes
    "window_2_27_and_an_eighth": (_set_byte(_plain(), 5, (27 - 10) << 3 | 1), 64, 48),
    "window_2_28": (_set_byte(_plain(), 5, (28 - 10) << 3), 64, 48),
    "window_2_42": (_set_byte(_plain(), 5, 0xF8), 64, 48),
    "reserved_bit": (_set_byte(_plain(), 4, 0x08), 64, 48),
    "unused_bit": (_set_byte(_plain(), 4, 0x10), 64, 48),
    "dictionary_id_7": (_with_dict_id(_plain(), 7), 64, 48),
    "dictionary_id_0": (_with_dict_id(_plain(), 0), 64, 48),
    "checksum_right": (_with_checksum(_plain(), True), 64, 48),
    "checksum_wrong": (_with_checksum(_plain(), False), 64, 48),
    "checksum_flag_without_checksum": (_set_byte(_plain(), 4, 0x04), 64, 48),
    "content_size": (_plain(size=True), 64, 48),
    "content_size_and_checksum": (_plain(size=True, checksum=True), 64, 48),
    "content_size_past_the_strip": (_plain(size=True), 64, 40),
    "frame_longer_than_the_strip": (_plain(), 64, 40),
    "frame_shorter_than_the_strip": (_plain(), 64, 56),
    "bytes_after_the_frame": (_plain() + b"\x28\xb5\x2f\xfd garbage", 64, 48),
    "second_frame_after": (_plain() + _plain(), 64, 48),
    "skippable_frame_first": (_skippable(_plain()), 64, 48),
    "unknown_magic": (_set_byte(_plain(), 0, 0x29), 64, 48),
    "reserved_block_type": (_set_byte(_plain(), 6, _plain()[6] | 6), 64, 48),
    "cut_in_the_header": (_plain()[:5], 64, 48),
    "cut_in_the_block": (_plain()[:len(_plain()) // 2], 64, 48),
}


@pytest.mark.parametrize("name", list(LIMITS))
def test_limits_as_pillow_meets_them(tmp_path, name):
    """Each of libzstd's rules in a TIFF strip (libtiff's ZSTDDecode over
    Pillow's libzstd): the port reads it to Pillow's bytes or refuses it as
    Pillow does, through the native decoder and the twin."""
    strip, w, h = LIMITS[name]
    path = tmp_path / f"{name}.tif"
    path.write_bytes(_grey_tiff(strip, w, h))
    want = _jax(path)
    for twin in (False, True):
        try:
            with _twin(twin):
                got = timage.load_texture_rgba(str(path))
        except ValueError:
            got = None
        assert (got is None) == (want is None), (twin, want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


class _twin:
    """Hide the native decoder (the twin runs) while active."""

    def __init__(self, on: bool):
        self.on, self.saved = on, native.zstd_decode

    def __enter__(self):
        if self.on:
            native.zstd_decode = lambda data, size: None

    def __exit__(self, *exc):
        native.zstd_decode = self.saved


def _jax(path):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return jimage.load_texture_rgba(str(path))
    except Exception:  # noqa: BLE001 (Pillow raises what its plugin raises)
        return None


# ---- TIFF variants --------------------------------------------------------------

def _runs(rng, shape, high: int = 256) -> np.ndarray:
    s = rng.integers(0, high, shape)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]
    s[::4] = s[0]
    return s


def _pillow(mode, **save):
    def make(rng):
        px = _runs(rng, (H, W, 3)).astype(np.uint8)
        img = Image.fromarray(px)
        if mode == "1":
            img = Image.fromarray(np.cumsum(rng.random((H, W)) < 0.15, axis=1) % 2 == 1)
        elif mode == "F":
            img = Image.fromarray(rng.normal(120, 150, (H, W)).astype(np.float32), "F")
        elif mode == "I;16":
            img = Image.fromarray(_runs(rng, (H, W), 700).astype(np.uint16))
        elif mode == "RGBA":
            img = Image.fromarray(np.dstack([px, _runs(rng, (H, W))]).astype(np.uint8))
        elif mode != "RGB":
            img = img.convert(mode)
        out = io.BytesIO()
        img.save(out, format="TIFF", compression="zstd", **save)
        assert Image.open(io.BytesIO(out.getvalue())).tag_v2[259] == 50000
        return out.getvalue()
    return make


def _tiff(bits, photo, n=1, high=None, float_=False, **kw):
    def make(rng):
        if float_:
            s = rng.normal(100, 160, (H, W, n)).astype(np.float32)
        else:
            s = _runs(rng, (H, W, n), high or (1 << bits))
        return tiff_bytes(s, bits, photo, 50000, sample_format=3 if float_ else 1, **kw)
    return make


CASES = {
    "pillow_rgb": _pillow("RGB"),
    "pillow_rgba_pred2": _pillow("RGBA", tiffinfo={317: 2}),
    "pillow_grey": _pillow("L"),
    "pillow_bilevel": _pillow("1"),
    "pillow_grey16": _pillow("I;16"),
    "pillow_float_pred3": _pillow("F", tiffinfo={317: 3}),
    "pillow_palette": _pillow("P"),
    "pillow_rgb_strips_of_5": _pillow("RGB", tiffinfo={278: 5}),
    "strips_big_endian": _tiff(8, 2, 3, rows_per_strip=7, big_endian=True),
    "tiles_rgba": _tiff(8, 2, 4, extra=(2,), tile=(16, 16)),
    "tiles_big_endian_pred2": _tiff(8, 2, 3, tile=(16, 16), predictor=2, big_endian=True),
    "planar2_strips": _tiff(8, 2, 3, planar=2, rows_per_strip=8),
    "planar2_tiles_pred2": _tiff(8, 2, 3, planar=2, tile=(16, 16), predictor=2),
    "grey16_pred2": _tiff(16, 1, high=700, predictor=2),
    "grey16_big_endian_pred2": _tiff(16, 1, high=700, predictor=2, big_endian=True),
    "rgb16": _tiff(16, 2, 3, rows_per_strip=10),
    "float_pred3": _tiff(32, 1, float_=True, predictor=3),
    "float_pred3_big_endian_tiles": _tiff(32, 1, float_=True, predictor=3, big_endian=True,
                                          tile=(16, 16)),
    "palette4": _tiff(4, 3, colormap=list(range(0, 3 * 16 * 1000, 1000))),
    "palette8_fill2": _tiff(8, 3, colormap=list(range(0, 3 * 256 * 80, 80)), fill_order=2),
    "level_1": _tiff(8, 2, 3, zstd_level=1),
    "level_22": _tiff(8, 2, 3, zstd_level=22),
    "ycbcr_420_strips": _tiff(8, 6, 3, ycbcr_subsampling=(2, 2), rows_per_strip=8),
    "ycbcr_422_tiles": _tiff(8, 6, 3, ycbcr_subsampling=(2, 1), tile=(16, 16)),
    "ycbcr_11_pred2": _tiff(8, 6, 3, ycbcr_subsampling=(1, 1), predictor=2, rows_per_strip=8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_zstd_tiff_equals_jax(tmp_path, name):
    """Every case (37 x 29, seeded from its name), loaded by path through
    the native decoder and through the twin: the JAX package's floats,
    byte for byte."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(CASES[name](_rng(name)))
    want = _jax(path)
    assert want is not None
    for twin in (False, True):
        with _twin(twin):
            np.testing.assert_array_equal(timage.load_texture_rgba(str(path)), want)


@pytest.mark.parametrize("name", ("mushroom256_zstd_pred2.tif", "mushroom1024_zstd.tif"))
def test_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each Zstandard fixture
    equals the JAX package's load and the 8-bit RGBA PNG of its Pillow
    decode; the 1024^2 one's strips are frames of a window larger than a
    strip."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    np.testing.assert_array_equal(got, timage.load_texture_rgba(
        os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")))
    blob = open(path, "rb").read()
    im = Image.open(io.BytesIO(blob))
    assert im.tag_v2[259] == 50000
    off = im.tag_v2[273][0]
    window = 1 << ((blob[off + 5] >> 3) + 10)
    assert window > im.tag_v2[278] * im.width * len(im.getbands())


# ---- the 300-flip sweep -----------------------------------------------------------

SWEEP_SCRIPT = r"""
import hashlib, sys
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.image import load_texture_rgba
assert native.lib() is not None
for path in sys.argv[1:]:
    try:
        print(hashlib.sha256(load_texture_rgba(path).tobytes()).hexdigest())
    except ValueError:
        print("refused")
"""
# seeded flips that disagree with Pillow, by fault (ROADMAP C): none
KNOWN: dict = {}


def test_bit_flips_of_the_fixture_agree_with_pillow(tmp_path):
    """300 seeded single-bit flips inside the strips of
    mushroom256_zstd_pred2.tif, read by the port (the C++ decoder) in one
    subprocess (a crash fails this test only): each is Pillow's decode, or
    refused by both."""
    blob = open(os.path.join(FIXTURES, "mushroom256_zstd_pred2.tif"), "rb").read()
    im = Image.open(io.BytesIO(blob))
    bits = [8 * off + k for off, n in zip(im.tag_v2[273], im.tag_v2[279]) for k in range(8 * n)]
    rng = _rng("zstd flips")
    paths = []
    for i, bit in enumerate(rng.choice(bits, 300, replace=False)):
        b = bytearray(blob)
        b[bit >> 3] ^= 1 << (bit & 7)
        paths.append(tmp_path / f"f{i}.tif")
        paths[-1].write_bytes(bytes(b))
    script = tmp_path / "sweep.py"
    script.write_text(SWEEP_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script), *map(str, paths)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = proc.stdout.split()
    assert len(got) == len(paths)
    clean = hashlib.sha256(timage.load_texture_rgba(
        os.path.join(FIXTURES, "mushroom256_zstd_pred2.tif")).tobytes()).hexdigest()
    outcomes, faults = {"refused": 0, "clean": 0, "other pixels": 0}, {}
    for path, port in zip(paths, got):
        want = _jax(path)
        want = "refused" if want is None else hashlib.sha256(want.tobytes()).hexdigest()
        if want != port:
            faults["new"] = faults.get("new", 0) + 1
        outcomes["refused" if want == "refused" else "clean" if want == clean
                 else "other pixels"] += 1
    assert faults == KNOWN
    assert min(outcomes.values()) > 0, outcomes
