"""The JPEG codings Pillow 12.1 reads through libjpeg-turbo 3.1.3 besides
Huffman-coded DCT (io/jpeg.py over io/jpeg_arith.py and io/jpeg_lossless.py)
against the JAX package's texture loader, which is Pillow's
``Image.open(path).convert("RGBA")``: arithmetic-coded sequential (SOF9) and
progressive (SOF10) JPEG, with and without a DAC segment and restarts, and
lossless JPEG (SOF3) at predictors 1-7 and point transforms 0 and above, on
the writers' files (tests/texture_writers.py; Pillow writes neither), the
committed fixtures, an arithmetic-coded JPEG-in-TIFF and the BLP1 and IPTC
routes; the codings Pillow refuses (SOF11, the differential SOFn, lossless
YCbCr and YCCK, precisions other than 8, an arithmetic-coded scan whose
data run past the 64 KB block Pillow fed the decoder) refused too; the C++
loops equal to their Python twins; 200 seeded mutants in a subprocess, each
equal to Pillow's decode or refused by both; and fault C-8's cut sweep, a
Huffman JPEG cut at every byte of its scan, read or refused as Pillow
reads or refuses it."""

import hashlib
import io
import os
import shutil
import struct
import subprocess
import sys
import warnings
from unittest import mock

import numpy as np
import pytest
from PIL import Image
from texture_writers import (arith_jpeg_bytes, blp_bytes, iptc_bytes, lossless_jpeg_bytes,
                             tiff_bytes)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
W, H = 37, 29
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")
NEW_FIXTURES = ("mushroom256_arith_420.jpg", "mushroom256_arith_progressive.jpg",
                "mushroom256_lossless_p6.jpg", "mushroom256_lossless_grey_p7.jpg",
                "mushroom256_arith.tif")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _pixels(rng, h=H, w=W, n=3) -> np.ndarray:
    """A seeded picture: gradients and noise, as a texture's detail."""
    ramp = np.add.outer(np.arange(h), np.arange(w))[..., None] * rng.integers(1, 6, n)
    return np.clip(ramp % 256 + rng.integers(0, 40, (h, w, n)), 0, 255).astype(np.uint8)


def _pillow(blob: bytes):
    """Pillow's RGBA decode of the bytes, or None where it refuses them."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(blob)).convert("RGBA"))
    except Exception:  # noqa: BLE001 (Pillow raises what its plugin raises)
        return None


def _both(path):
    """(the JAX package's result or None where it raises, the port's or
    None where it raises ValueError, the port's message)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jimage.load_texture_rgba(str(path))
    except Exception:  # noqa: BLE001
        want = None
    try:
        return want, timage.load_texture_rgba(str(path)), ""
    except ValueError as exc:
        return want, None, str(exc)


def _arith(**kw):
    return lambda rng: arith_jpeg_bytes(_pixels(rng), **kw)


def _lossless(predictor, pt=0, n=3, **kw):
    return lambda rng: lossless_jpeg_bytes(_pixels(rng, n=n), predictor, pt, **kw)


def _padded(make, scan_at: int):
    """The file with a COM segment after its SOI that puts the end of its
    (first) SOS segment at offset ``scan_at``, against Pillow's 64 KB
    blocks."""
    def pad(rng):
        blob = make(rng)
        sos = blob.index(b"\xff\xda")
        size = scan_at - (sos + 2 + struct.unpack(">H", blob[sos + 2:sos + 4])[0]) - 4
        return blob[:2] + b"\xff\xfe" + struct.pack(">H", size + 2) + bytes(size) + blob[2:]
    return pad


def _arith_tiff(**kw):
    return lambda rng: tiff_bytes(_pixels(rng).astype(np.int64), 8, 6, compression=7,
                                  rows_per_strip=16, jpeg_encoder=lambda c: arith_jpeg_bytes(
                                      c, jfif=False, **kw))


_420 = [(2, 2), (1, 1), (1, 1)]
_DAC = [(0x00, 0x31), (0x01, 0x20), (0x10, 9), (0x11, 2)]

CASES = {
    "arith_sequential_444": _arith(),
    "arith_sequential_420_dac_restarts": _arith(sampling=_420, dac=_DAC, restart=3),
    "arith_sequential_422": _arith(sampling=[(2, 1), (1, 1), (1, 1)], quality=70),
    "arith_sequential_grey": lambda rng: arith_jpeg_bytes(_pixels(rng, n=1)),
    "arith_sequential_own_tables": _arith(tables=[(3, 7), (15, 0), (9, 9)]),
    "arith_progressive_444": _arith(progressive=True),
    "arith_progressive_420_restarts": _arith(progressive=True, sampling=_420, restart=2),
    "arith_progressive_dac": _arith(progressive=True, dac=_DAC, quality=95),
    "arith_progressive_grey": lambda rng: arith_jpeg_bytes(_pixels(rng, n=1), progressive=True),
    "arith_progressive_own_script": _arith(progressive=True, scans=[
        ((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 9, 0, 1), ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0),
        ((0,), 10, 63, 0, 0), ((0, 1, 2), 0, 0, 2, 1), ((0,), 1, 9, 1, 0),
        ((0, 1, 2), 0, 0, 1, 0)]),
    # the scans begin past Pillow's first 64 KB block: decoded from the second
    "arith_scan_in_the_second_block": _padded(_arith(), 65537),
    **{f"lossless_p{p}": _lossless(p) for p in range(1, 8)},
    **{f"lossless_p{p}_pt2_grey": _lossless(p, 2, n=1) for p in range(1, 8)},
    "lossless_p4_420": _lossless(4, sampling=_420),
    "lossless_p5_pt1_422_restarts": _lossless(5, 1, sampling=[(2, 1), (1, 1), (1, 1)],
                                              restart_rows=4),
    "lossless_p7_restarts": _lossless(7, restart_rows=1),
    "lossless_cmyk": _lossless(2, n=4),
    "lossless_adobe_rgb": _lossless(6, adobe=0),
    "lossless_ids_rgb": _lossless(3, cids=[82, 71, 66]),
    "lossless_p5_separate_scans": _lossless(5, 1, separate=True),
    "lossless_p7_separate_scans_420": _lossless(7, separate=True, sampling=_420),
    "arith_in_tiff": _arith_tiff(),
    "arith_progressive_in_tiff_restarts": _arith_tiff(progressive=True, restart=2),
}


def _relabel(marker: int):
    def make(rng):
        blob = bytearray(arith_jpeg_bytes(_pixels(rng)))
        blob[blob.index(b"\xff\xc9") + 1] = marker
        return bytes(blob)
    return make


# name -> (make, the port's message); Pillow refuses each
REFUSED = {
    **{f"sof{m - 0xC0}": (_relabel(m), f"SOF{m - 0xC0}")
       for m in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF)},
    "lossless_jfif_ycbcr": (_lossless(1, jfif=True), "colour space"),
    "lossless_adobe_ycbcr": (_lossless(1, adobe=1), "colour space"),
    "lossless_ycck": (_lossless(1, n=4, adobe=2), "colour space"),
    # Pillow's SOF handler refuses other precisions and hands the file on
    "lossless_12_bit": (lambda rng: lossless_jpeg_bytes(
        _pixels(rng, n=1).astype(np.int64) * 16, 1, precision=12), "12-bit"),
    "lossless_16_bit": (lambda rng: lossless_jpeg_bytes(
        _pixels(rng, n=1).astype(np.int64) * 256, 1, precision=16), "16-bit"),
    "lossless_restart_not_a_row": (lambda rng: _restart_interval(
        lossless_jpeg_bytes(_pixels(rng), 1, restart_rows=2), 5), "restart interval"),
    "lossless_bad_predictor": (lambda rng: _scan_byte(lossless_jpeg_bytes(_pixels(rng), 1), -3,
                                                      8), "invalid progressive/lossless"),
    # an arithmetic-coded scan whose data cross the end of the 64 KB block
    # it began in: libjpeg's arithmetic decoder cannot suspend
    "arith_scan_across_64k": (_padded(_arith(), 65536 - 300), "cannot suspend"),
    "arith_cut_short": (lambda rng: arith_jpeg_bytes(_pixels(rng))[:-200], "cannot suspend"),
    "lossless_cut_short": (lambda rng: lossless_jpeg_bytes(_pixels(rng), 1)[:-100],
                           "truncated"),
    # one scan a component, the last one lost before the EOI
    "lossless_scan_lost": (lambda rng: _last_scan_lost(lossless_jpeg_bytes(
        _pixels(rng), 2, separate=True)), "no scan decoded"),
    # a multi-scan file must reach its EOI (jpeg_start_decompress reads it
    # whole); here a comment takes the EOI's place
    "arith_progressive_without_eoi": (lambda rng: arith_jpeg_bytes(
        _pixels(rng), progressive=True)[:-2] + b"\xff\xfe\x00\x04ok", "EOI"),
}


def _last_scan_lost(blob: bytes) -> bytes:
    return blob[:blob.rindex(b"\xff\xda")] + b"\xff\xd9"


def _restart_interval(blob: bytes, value: int) -> bytes:
    at = blob.index(b"\xff\xdd")
    return blob[:at + 4] + struct.pack(">H", value) + blob[at + 6:]


def _scan_byte(blob: bytes, offset: int, value: int) -> bytes:
    """The SOS segment's byte at ``offset`` from its end replaced."""
    at = blob.index(b"\xff\xda")
    end = at + 2 + struct.unpack(">H", blob[at + 2:at + 4])[0]
    b = bytearray(blob)
    b[end + offset] = value
    return bytes(b)


@pytest.mark.parametrize("name", list(CASES))
def test_coding_equals_jax(tmp_path, name):
    """Each coding Pillow reads, at 37 x 29 (seeded from its name), loaded
    by path: the port's floats equal the JAX package's, byte for byte."""
    path = tmp_path / ("t.tif" if "tiff" in name else "t.jpg")
    path.write_bytes(CASES[name](_rng(name)))
    want, got, why = _both(path)
    assert want is not None
    assert got is not None, why
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_as_pillow_refuses(tmp_path, name):
    """What Pillow refuses of these codings the port refuses with a
    ValueError naming why."""
    make, match = REFUSED[name]
    path = tmp_path / "t.jpg"
    path.write_bytes(make(_rng(name)))
    want, _, _ = _both(path)
    assert want is None
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_fixtures_equal_their_pillow_decodes(name):
    """The 256^2 fixtures (tests/data/textures/make_fixtures.py's
    ``jpeg_codings``) against their committed Pillow decodes and the JAX
    package's loader."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    want = timage.load_texture_rgba(os.path.join(FIXTURES, name.rsplit(".", 1)[0]
                                                 + ".pillow.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))


def test_blp1_and_iptc_routes(tmp_path):
    """An arithmetic-coded JPEG inside BLP1 (its shared header split off)
    and lossless and arithmetic-coded grey JPEGs inside IPTC records read
    as Pillow reads them."""
    rng = _rng("routes")
    px = _pixels(rng, 32, 40)
    j = arith_jpeg_bytes(px, sampling=_420, restart=2)
    blobs = [blp_bytes(1, 40, 32, j[300:], compression=0, jpeg_header=j[:300]),
             iptc_bytes(40, 32, 1, lossless_jpeg_bytes(px[..., :1], 5, 1), compression=5),
             iptc_bytes(40, 32, 1, arith_jpeg_bytes(px[..., :1], progressive=True),
                        compression=5)]
    for i, blob in enumerate(blobs):
        path = tmp_path / f"r{i}.bin"
        path.write_bytes(blob)
        want, got, why = _both(path)
        assert want is not None and got is not None, why
        np.testing.assert_array_equal(got, want)


@needs_gxx
def test_native_loops_equal_their_twins():
    """The QM decoder and the lossless loops in C++ against their Python
    twins (the library hidden): the same pixels, or the same refusal, on
    every case, fixture and 40 seeded mutants."""
    assert native.lib() is not None
    blobs = [make(_rng(n)) for n, make in CASES.items() if "tiff" not in n and "second" not in n]
    blobs += [open(os.path.join(FIXTURES, n), "rb").read() for n in NEW_FIXTURES[:1]]
    rng = _rng("twins")
    for i in range(40):
        b = bytearray(blobs[i % len(blobs)])
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(len(b) // 4, len(b))] = rng.integers(0, 256)
        blobs.append(bytes(b))

    def run(blob):
        try:
            return timage.decode_texture(blob)
        except ValueError as exc:
            return str(exc)

    native_out = [run(b) for b in blobs]
    with mock.patch.object(native, "lib", lambda: None):
        python_out = [run(b) for b in blobs]
    for a, b in zip(native_out, python_out):
        assert type(a) is type(b)
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


MUTANT_SCRIPT = r"""
import hashlib, sys
import numpy as np
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.image import decode_texture
assert native.lib() is not None
for path in sys.argv[1:]:
    blob = open(path, "rb").read()
    try:
        print(hashlib.sha256(decode_texture(blob).tobytes()).hexdigest())
    except ValueError:
        print("refused")
"""

def _huffman(**save):
    def make(rng):
        out = io.BytesIO()
        Image.fromarray(_pixels(rng)).save(out, format="JPEG", quality=80, **save)
        return out.getvalue()
    return make


# Huffman-coded sources too: their restart resynchronisation, standard
# tables and block smoothing are libjpeg-turbo's as well
HUFFMAN = {"huffman_restarts_420": _huffman(restart_marker_blocks=1, subsampling="4:2:0"),
           "huffman_progressive": _huffman(progressive=True)}
MUTANT_SOURCES = ("arith_sequential_420_dac_restarts", "arith_progressive_444",
                  "arith_progressive_420_restarts", "arith_sequential_grey", "lossless_p1",
                  "lossless_p5_pt1_422_restarts", "lossless_p6_pt2_grey", "lossless_p4_420",
                  "lossless_p7_separate_scans_420",
                  "huffman_restarts_420", "huffman_progressive")
# seeded mutants that disagree with Pillow, by fault (ROADMAP C): none
KNOWN: dict = {}


def _mutant(rng, blob: bytes) -> bytes:
    b = bytearray(blob)
    kind = rng.integers(0, 4)
    if kind == 0:
        return bytes(b[:rng.integers(1, len(b))])
    if kind == 1:
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
    elif kind == 2:
        b[rng.integers(0, min(len(b), 200))] = rng.integers(0, 256)
    else:
        at = rng.integers(0, len(b))
        b[at:at] = rng.integers(0, 256, rng.integers(1, 8)).astype(np.uint8).tobytes()
    return bytes(b)


@needs_gxx
def test_mutants_agree_with_pillow(tmp_path):
    """200 seeded mutants (cuts, byte flips, header flips, insertions) of
    arithmetic-coded and lossless files through the port's native loops,
    all in one subprocess (a crash in the C++ fails this test only): each
    is Pillow's decode, or refused by both."""
    rng = _rng("codings mutants")
    sources = [{**CASES, **HUFFMAN}[n](_rng(n)) for n in MUTANT_SOURCES]
    paths = []
    for i in range(200):
        path = tmp_path / f"m{i}.jpg"
        path.write_bytes(_mutant(rng, sources[i % len(sources)]))
        paths.append(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    script = tmp_path / "mutants.py"
    script.write_text(MUTANT_SCRIPT)
    proc = subprocess.run([sys.executable, str(script), *map(str, paths)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = proc.stdout.split()
    assert len(got) == len(paths)
    faults = {}
    for path, port in zip(paths, got):
        want = _pillow(path.read_bytes())
        want = "refused" if want is None else hashlib.sha256(want.tobytes()).hexdigest()
        if want != port:
            faults["new"] = faults.get("new", 0) + 1
    assert faults == KNOWN


def _baseline(rng, **save) -> bytes:
    out = io.BytesIO()
    Image.fromarray(_pixels(rng, 16, 24)).save(out, format="JPEG", **save)
    return out.getvalue()


@pytest.mark.parametrize("form", ["baseline", "restarts", "grey", "with_trailing_data"])
def test_c8_cut_sweep(form):
    """Fault C-8: a single-scan Huffman JPEG cut at every byte from its
    scan's start to its end, and one followed by bytes that are not a
    marker (so libjpeg-turbo decodes its MCUs in decode_mcu_fast while
    Pillow's 64 KB block holds 512 bytes a block, then in decode_mcu_slow
    with jpeg_fill_bit_buffer's read-ahead to 57 bits): the port reads or
    refuses each cut as Pillow reads or refuses it."""
    rng = _rng(form)
    if form == "grey":
        out = io.BytesIO()
        Image.fromarray(_pixels(rng, 16, 24, 1)[..., 0]).save(out, format="JPEG", quality=85)
        blob = out.getvalue()
    else:
        blob = _baseline(rng, quality=90, **({"restart_marker_blocks": 2}
                                             if form == "restarts" else {}))
    scan = blob.index(b"\xff\xda") + 12
    cuts = range(scan, len(blob) + 1)
    if form == "with_trailing_data":
        blob = blob[:-2] + rng.integers(0, 255, 4000).astype(np.uint8).tobytes()
        cuts = range(len(blob) - 4000 - 20, len(blob) + 1, 31)
    reads = 0
    for cut in cuts:
        want = _pillow(blob[:cut])
        try:
            got = timage.decode_texture(blob[:cut])
        except ValueError:
            got = None
        assert (want is None) == (got is None), cut
        if want is not None:
            reads += 1
            np.testing.assert_array_equal(got, want)
    assert reads > 0


def _scans(blob: bytes) -> list:
    return [i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] == 0xDA]


@pytest.mark.parametrize("form", ["huffman_420", "huffman_444", "huffman_grey", "arith_420",
                                  "arith_444"])
def test_progressive_with_lost_scans_reads_as_pillow(form):
    """A progressive file (37 x 29) whose scans after the k-th are lost
    before its EOI, and one whose k-th scan alone is lost: libjpeg-turbo
    smooths the blocks whose first AC coefficients lack bits
    (jdcoefct.c's decompress_smooth_data, the DC values interpolated where
    no AC bit came), and the port equals Pillow on each (or refuses it
    with Pillow, where the lost part held a scan's Huffman table)."""
    rng = _rng(form)
    px = _pixels(rng, n=1 if "grey" in form else 3)
    if form.startswith("huffman"):
        out = io.BytesIO()
        img = Image.fromarray(px[..., 0] if px.shape[2] == 1 else px)
        img.save(out, format="JPEG", quality=75, progressive=True,
                 **({} if "grey" in form else {"subsampling": form[-3] + ":" + form[-2] + ":"
                                                              + form[-1]}))
        blob = out.getvalue()
    else:
        blob = arith_jpeg_bytes(px, progressive=True,
                                sampling=_420 if form.endswith("420") else None)
    scans = _scans(blob)
    reads = 0
    for k in range(1, len(scans)):
        variants = [blob[:scans[k]] + b"\xff\xd9"]
        if k + 1 < len(scans):
            variants.append(blob[:scans[k]] + blob[scans[k + 1]:])
        for v in variants:
            want = _pillow(v)
            try:
                got = timage.decode_texture(v)
            except ValueError:
                got = None
            assert (want is None) == (got is None), f"scan {k}"
            if want is not None:
                reads += 1
                np.testing.assert_array_equal(got, want, err_msg=f"scan {k}")
    assert reads >= len(scans) - 1


@pytest.mark.parametrize("progressive", [False, True])
def test_missing_huffman_table(progressive):
    """A Huffman-coded file with one DHT segment removed: a sequential
    scan that names table 0 or 1 takes libjpeg-turbo's standard table
    (and decodes garbage, as Pillow does); a progressive one is refused,
    as jdphuff.c refuses it, unless an earlier segment defined it."""
    rng = _rng(f"missing {progressive}")
    out = io.BytesIO()
    Image.fromarray(_pixels(rng)).save(out, format="JPEG", quality=80, progressive=progressive)
    blob = out.getvalue()
    dhts = [i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] == 0xC4]
    refused = 0
    for at in dhts:
        cut = blob[:at] + blob[at + 2 + struct.unpack(">H", blob[at + 2:at + 4])[0]:]
        want = _pillow(cut)
        try:
            got = timage.decode_texture(cut)
        except ValueError:
            got = None
        assert (want is None) == (got is None), at
        if want is None:
            refused += 1
        else:
            np.testing.assert_array_equal(got, want)
    assert (refused > 0) == progressive
