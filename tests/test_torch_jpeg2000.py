"""The port's JPEG 2000 input (io/jpeg2000.py over native/src/j2k.cpp, behind
io/image.load_texture_rgba) against the JAX package's, which is Pillow's
``Image.open(path).convert("RGBA")`` through OpenJPEG 2.5.4: equal bytes,
tolerance 0.

The case matrix, at 37x29 and 64x48: Pillow-written files in modes L, LA,
RGB, RGBA, I;16, CMYK and YCbCr (sYCC), JP2 and raw codestream, reversible
5/3 and irreversible 9/7, the five progressions, precincts and code-block
sizes, tiles with tile and image offsets, several quality layers, signed
components, PLT, a comment, no MCT; codestreams written by libopenjp2 2.5.4
through ctypes (tests/texture_writers.opj_encode) for what Pillow's writer
cannot ask for: every code-block style (BYPASS, RESET, TERMALL, VSC,
PTERM, SEGSYM) alone and together, SOP/EPH, POC (one of them leaving the
top resolution unread), ROI max-shift, sub-sampled components, a precision
a component (so QCC), tile-parts by resolution; marker segments put in by hand (COC, QCC, TLM, PLM, CRG, a
tile-part COM, PPM and PPT rewritten from an SOP/EPH stream, a missing
tile); JP2 boxes written by hand around a codestream (``pclr``/``cmap``
palettes, ``cdef``, ``colr`` with an ICC profile or sYCC, ``res ``, a
"jpx " brand, no ``colr``, ``bpcc``, boxes out of place).

For every raw codestream of the matrix the native planes also equal
libopenjp2's ``opj_decode`` planes, so a fault shows as the codec's or as
Pillow's unpacking.  The committed fixtures equal their Pillow decodes
(their mutants are tests/test_torch_jpeg2000_mutants.py's); ``opens``
turns a file away exactly where Pillow's ``_open`` does.
"""

import io
import os
import shutil
import struct
from unittest import mock

import numpy as np
import pytest
from PIL import Image
from texture_writers import (icns_bytes, j2k_join, j2k_marker, j2k_ppm, j2k_ppt, j2k_segments,
                             jp2_box, jp2_bytes, opj_decode_planes, opj_encode)

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io import jpeg2000
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
J2K_FIXTURES = ("mushroom256_53.jp2", "mushroom256_rpcl.j2k", "mushroom1024_9x7.jp2")
pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")


def _picture(seed: int, w: int = 37, h: int = 29, c: int = 3) -> np.ndarray:
    """Seeded (h, w, c) uint8: gradients, a disc and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = []
    for k in range(c):
        disc = ((x - w * (0.3 + 0.2 * k)) ** 2 + (y - h / 2) ** 2 < (h / 3) ** 2) * 90
        planes.append((x * 255 // max(w - 1, 1) * (k + 1) // 3 + y * 3 + disc
                       + rng.integers(0, 24, (h, w))) % 256)
    return np.stack(planes, -1).astype(np.uint8)


def _pillow(arr, mode=None, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG2000", **opts)
    return buf.getvalue()


def _planes(seed: int, c: int = 3, w: int = 64, h: int = 48):
    pic = _picture(seed, w, h, c).astype(np.int32)
    return [pic[..., k] for k in range(c)]


def _ctypes(seed: int, c: int = 3, **opts) -> bytes:
    return opj_encode(_planes(seed, c), numresolution=opts.pop("numresolution", 3), **opts)


def _sub(seed: int, dx, dy, **opts) -> bytes:
    pic = _picture(seed, 64, 48, len(dx)).astype(np.int32)
    return opj_encode([pic[::dy[k], ::dx[k], k] for k in range(len(dx))], dx=dx, dy=dy,
                      numresolution=3, **opts)


def _in_main(cs: bytes, *segments: bytes) -> bytes:
    main, parts, tail = j2k_segments(cs)
    return j2k_join(main + b"".join(segments), parts, tail)


def _in_tile(cs: bytes, segment: bytes) -> bytes:
    main, parts, tail = j2k_segments(cs)
    return j2k_join(main, [(head + segment, data) for head, data in parts], tail)


def _coc(cs: bytes, compno: int, style_xor: int = 0) -> bytes:
    """A COC restating the COD's SPcod for one component, its code-block
    style toggled by ``style_xor``."""
    main, _, _ = j2k_segments(cs)
    at = main.find(b"\xff\x52")
    spcod = bytearray(main[at + 9:at + 2 + struct.unpack_from(">H", main, at + 2)[0]])
    spcod[3] ^= style_xor
    return _in_main(cs, j2k_marker(0xFF53, bytes([compno, main[at + 4] & 1]) + bytes(spcod)))


def _qcc(cs: bytes, compno: int) -> bytes:
    main, _, _ = j2k_segments(cs)
    at = main.find(b"\xff\x5c")
    sqcd = main[at + 4:at + 2 + struct.unpack_from(">H", main, at + 2)[0]]
    return _in_main(cs, j2k_marker(0xFF5D, bytes([compno]) + sqcd))


def _tlm(cs: bytes) -> bytes:
    _, parts, _ = j2k_segments(cs)
    entries = b"".join(struct.pack(">BI", k, len(h) + 2 + len(d)) for k, (h, d) in enumerate(parts))
    return _in_main(cs, j2k_marker(0xFF55, b"\x00\x50" + entries))


def _poc_only(cs: bytes, entry) -> bytes:
    """The first tile-part's POC replaced by one entry (RSpoc, CSpoc,
    LYEpoc, REpoc, CEpoc, Ppoc), which may leave packets unread."""
    main, parts, tail = j2k_segments(cs)
    head, data = parts[0]
    at = head.find(b"\xff\x5f")
    end = at + 2 + struct.unpack_from(">H", head, at + 2)[0]
    head = head[:at] + j2k_marker(0xFF5F, struct.pack(">BBHBBB", *entry)) + head[end:]
    return j2k_join(main, [(head, data)] + parts[1:], tail)


def _drop_tile(cs: bytes, tile: int) -> bytes:
    main, parts, tail = j2k_segments(cs)
    return j2k_join(main, [p for k, p in enumerate(parts) if k != tile], tail)


def _srgb(n: int) -> bytes:
    return b"\x01\x00\x00" + struct.pack(">I", n)


def _pclr(entries, npc: int = 3) -> bytes:
    return jp2_box(b"pclr", struct.pack(">HB", len(entries), npc) + bytes([7] * npc)
                   + b"".join(bytes(e) for e in entries))


def _cmap(n: int) -> bytes:
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(n)))


def _indices(seed: int, n: int, c: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, n, (29, 37)).astype(np.int32)]
    planes += [rng.integers(0, 256, (29, 37)).astype(np.int32) for _ in range(c - 1)]
    return opj_encode(planes, numresolution=3)


PALETTE = [(10, 20, 30), (200, 100, 0), (5, 5, 5), (0, 255, 0), (9, 9, 200)]
RGB16 = (_picture(7)[..., 0].astype(np.uint16) * 257 + 3).astype(np.uint16)

CASES = {  # name -> () -> file bytes
    # Pillow's writer: modes, both paths, both containers
    "L_53_jp2": lambda: _pillow(_picture(1)[..., 0]),
    "L_97_j2k": lambda: _pillow(_picture(2)[..., 0], irreversible=True, no_jp2=True),
    "LA_53": lambda: _pillow(_picture(3)[..., :2].copy(), "LA"),
    "LA_97_j2k": lambda: _pillow(_picture(4)[..., :2].copy(), "LA", irreversible=True,
                                 no_jp2=True),
    "RGB_53_j2k": lambda: _pillow(_picture(5), no_jp2=True),
    "RGB_97": lambda: _pillow(_picture(6), irreversible=True),
    "RGBA_53": lambda: _pillow(_picture(7, c=4)),
    "RGBA_97_j2k": lambda: _pillow(_picture(8, c=4), irreversible=True, no_jp2=True),
    "I16_53": lambda: _pillow(RGB16),
    "I16_97_j2k": lambda: _pillow(RGB16, irreversible=True, no_jp2=True),
    "CMYK_53": lambda: _pillow(_picture(9, c=4), "CMYK"),
    "CMYK_97": lambda: _pillow(_picture(10, c=4), "CMYK", irreversible=True),
    "YCbCr_sYCC_97": lambda: _pillow(_picture(11), "YCbCr", irreversible=True),
    "YCbCr_sYCC_53": lambda: _pillow(_picture(12), "YCbCr"),
    **{f"{p}_layers_{'97' if irr else '53'}": (
        lambda p=p, irr=irr: _pillow(_picture(13, 64, 48), progression=p, irreversible=irr,
                                     quality_layers=[30, 10, 1], num_resolutions=3,
                                     no_jp2=True))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL") for irr in (False, True)},
    "precincts_cblk_8": lambda: _pillow(_picture(14, 64, 48), precinct_size=(16, 16),
                                        codeblock_size=(8, 8), num_resolutions=3, no_jp2=True),
    "cblk_64x16": lambda: _pillow(_picture(15, 64, 48), codeblock_size=(64, 16),
                                  irreversible=True),
    "tiles_offsets_97": lambda: _pillow(_picture(16, 64, 48), tile_size=(16, 16), offset=(3, 5),
                                        tile_offset=(1, 2), num_resolutions=3, irreversible=True,
                                        no_jp2=True),
    "tiles_offsets_53": lambda: _pillow(_picture(17), tile_size=(20, 12), offset=(7, 1),
                                        tile_offset=(2, 0), num_resolutions=2),
    "signed_53": lambda: _pillow(_picture(18), signed=True),
    "signed_97_L": lambda: _pillow(_picture(19)[..., 0], signed=True, irreversible=True),
    "plt_comment": lambda: _pillow(_picture(20), plt=True, comment="a texture",
                                   quality_layers=[20, 5]),
    "no_mct_97": lambda: _pillow(_picture(21), mct=0, irreversible=True),
    "one_resolution": lambda: _pillow(_picture(22), num_resolutions=1, no_jp2=True),
    "rate_80_97": lambda: _pillow(_picture(23, 64, 48), quality_layers=[80], irreversible=True),
    # libopenjp2 through ctypes: code-block styles, SOP/EPH, POC, ROI
    **{f"style_{m:02x}_{'97' if irr else '53'}": (
        lambda m=m, irr=irr: _ctypes(24 + m, mode=m, irreversible=irr, rates=(20, 5, 1)))
       for m in (0x01, 0x02, 0x08, 0x10, 0x20, 0x1C, 0x3F) for irr in (False, True)},
    "sop_eph_tiles": lambda: _ctypes(40, csty=6, rates=(20, 5, 1), tile=(32, 32)),
    "poc_lrcp_rpcl": lambda: _ctypes(41, pocs=[(0, 0, 2, 2, 3, 0), (0, 0, 3, 3, 3, 2)],
                                     rates=(20, 5, 1)),
    "poc_cprl_97": lambda: _ctypes(42, pocs=[(0, 0, 1, 3, 1, 4), (0, 0, 2, 3, 3, 1)],
                                   rates=(20, 5), irreversible=1),
    "poc_top_resolution_undecoded": lambda: _poc_only(_ctypes(41, pocs=[(0, 0, 1, 3, 3, 0)]),
                                                      (0, 0, 1, 2, 3, 0)),
    "roi_53": lambda: _ctypes(43, roi_compno=0, roi_shift=7),
    "roi_97": lambda: _ctypes(44, roi_compno=1, roi_shift=4, irreversible=1),
    "precincts_pcrl": lambda: _ctypes(45, prc=[(4, 4), (3, 3), (2, 2)], prog_order=3,
                                      rates=(20, 2)),
    "cprl_tiles_origin": lambda: opj_encode(_planes(46, w=37, h=29), numresolution=3,
                                            prog_order=4, tile=(16, 24), origin=(3, 7)),
    "tile_parts_by_resolution": lambda: _ctypes(47, tile=(32, 32), tp_on=b"\x01",
                                                tp_flag=b"R", rates=(10, 1)),
    # sub-sampling, precision and sign
    "sub_122_sYCC_guess": lambda: _sub(48, [1, 2, 2], [1, 2, 2]),
    "sub_122_97": lambda: _sub(49, [1, 2, 2], [1, 2, 2], irreversible=1),
    "sub_112": lambda: _sub(50, [1, 1, 2], [1, 1, 1]),
    "sub_rgba": lambda: _sub(51, [1, 2, 2, 1], [1, 2, 2, 1]),
    "sub_122_jp2_srgb": lambda: jp2_bytes(_sub(52, [1, 2, 2], [1, 2, 2]), 3, 64, 48),
    "sub_tiles": lambda: _sub(53, [1, 2, 2], [1, 2, 2], tile=(16, 16), origin=(3, 1)),
    "prec_12_4_8_qcc": lambda: opj_encode([p * m >> s for p, m, s in zip(_planes(54), (16, 1, 1),
                                                                            (0, 4, 0))],
                                          prec=[12, 4, 8], numresolution=3, irreversible=1),
    "prec_12_L": lambda: opj_encode([_planes(55, 1)[0] * 16], prec=12, numresolution=3),
    "prec_16_L_97": lambda: opj_encode([_planes(56, 1)[0] * 257], prec=16, numresolution=3,
                                       irreversible=1),
    "prec_20_L": lambda: opj_encode([_planes(57, 1)[0] * 4096], prec=20, numresolution=3),
    "prec_3_signed": lambda: opj_encode([(_planes(58, 1)[0] >> 5) - 4], prec=3, sgnd=True,
                                        numresolution=3),
    "prec_12_signed_rgb_97": lambda: opj_encode([p * 16 - 2048 for p in _planes(59)], prec=12,
                                                sgnd=True, numresolution=3, irreversible=1),
    "prec_10_7_LA": lambda: opj_encode([p >> s << t for p, s, t in zip(_planes(60, 2), (0, 1),
                                                                        (2, 0))],
                                       prec=[10, 7], numresolution=3),
    # marker segments by hand
    "coc_restated": lambda: _coc(_ctypes(61), 1),
    "coc_vsc_toggled": lambda: _coc(_ctypes(62, rates=(10, 2)), 2, 0x08),
    "qcc_restated_97": lambda: _qcc(_ctypes(63, irreversible=1), 1),
    "tlm_plm_crg": lambda: _in_main(_tlm(_ctypes(64, tile=(32, 32))), j2k_marker(0xFF57, b"\x00"),
                                    j2k_marker(0xFF63, bytes(12))),
    "tile_part_com": lambda: _in_tile(_ctypes(65, tile=(32, 24)), j2k_marker(0xFF64,
                                                                             b"\x00\x01note")),
    "ppt": lambda: j2k_ppt(_ctypes(66, csty=6, rates=(20, 5, 1), tile=(32, 32))),
    "ppm": lambda: j2k_ppm(_ctypes(67, csty=6, rates=(20, 5, 1), tile=(32, 32))),
    "ppm_split_markers": lambda: j2k_ppm(_ctypes(68, csty=6, rates=(20, 5, 1)), room=40),
    "missing_tile": lambda: _drop_tile(_ctypes(69, tile=(32, 32)), 1),
    "missing_tile_rgba": lambda: _drop_tile(_ctypes(70, 4, tile=(32, 16)), 0),
    # JP2 boxes by hand
    "palette_P": lambda: jp2_bytes(_indices(71, 5), 1, 37, 29, colr=_srgb(16),
                                   extra=_pclr(PALETTE) + _cmap(3)),
    "palette_duplicates": lambda: jp2_bytes(_indices(72, 8), 1, 37, 29, colr=_srgb(16),
                                            extra=_pclr([(1, 2, 3), (4, 5, 6), (1, 2, 3),
                                                         (7, 8, 9), (4, 5, 6)])),
    "palette_rgba": lambda: jp2_bytes(_indices(73, 6), 1, 37, 29, colr=_srgb(16),
                                      extra=_pclr([e + (128,) for e in PALETTE], 4)),
    "palette_one_column": lambda: jp2_bytes(_indices(74, 6), 1, 37, 29, colr=_srgb(16),
                                            extra=_pclr([e[:1] for e in PALETTE], 1)),
    "palette_PA": lambda: jp2_bytes(_indices(75, 5, 2), 2, 37, 29, colr=_srgb(16),
                                    extra=_pclr(PALETTE)),
    "cdef_swapped": lambda: jp2_bytes(_ctypes(76), 3, 64, 48, extra=jp2_box(
        b"cdef", struct.pack(">H", 3) + b"".join(struct.pack(">HHH", k, 0, 3 - k)
                                                 for k in range(3)))),
    "colr_icc": lambda: jp2_bytes(_ctypes(77), 3, 64, 48, colr=b"\x02\x00\x00" + bytes(64)),
    "colr_sycc": lambda: jp2_bytes(_ctypes(78), 3, 64, 48, colr=_srgb(18)),
    "colr_unknown_enum": lambda: jp2_bytes(_ctypes(79), 3, 64, 48, colr=_srgb(99)),
    "no_colr": lambda: jp2_bytes(_ctypes(80), 3, 64, 48, colr=b""),
    "res_box": lambda: jp2_bytes(_ctypes(81), 3, 64, 48, extra=jp2_box(
        b"res ", jp2_box(b"resc", struct.pack(">HHHHbb", 7, 2, 7, 2, 2, 2)))),
    "jpx_brand": lambda: jp2_bytes(_ctypes(82), 3, 64, 48, brand=b"jpx "),
    "bpcc": lambda: jp2_bytes(_ctypes(83), 3, 64, 48, bpc=255,
                              extra=jp2_box(b"bpcc", bytes([7, 7, 7]))),
    "colr_out_of_place": lambda: jp2_bytes(_ctypes(84), 3, 64, 48,
                                           before_header=jp2_box(b"colr", _srgb(17))),
    "unknown_box": lambda: jp2_bytes(_ctypes(85), 3, 64, 48,
                                     before_header=jp2_box(b"xml ", b"<a/>")),
}

REFUSED = {  # name -> bytes Pillow refuses
    "colr_grey_for_rgb": lambda: jp2_bytes(_ctypes(90), 3, 64, 48, colr=_srgb(17)),
    "colr_esycc": lambda: jp2_bytes(_ctypes(91), 3, 64, 48, colr=_srgb(24)),
    "ihdr_size": lambda: jp2_bytes(_ctypes(92), 3, 63, 48),
    "ihdr_components": lambda: jp2_bytes(_ctypes(93), 1, 64, 48),
    "palette_grey_space": lambda: jp2_bytes(_indices(94, 5), 1, 37, 29,
                                            extra=_pclr(PALETTE)),
    "sub_sampled_L": lambda: opj_encode([_planes(95, 1)[0][::2, ::2]], dx=[2], dy=[2],
                                        numresolution=3),
    "no_eoc": lambda: _ctypes(96)[:-2],
    "eph_missing": lambda: _drop_eph(_ctypes(97, csty=6, rates=(10, 1))),
    "truncated": lambda: _ctypes(98)[:-40],
}


def _drop_eph(cs: bytes) -> bytes:
    at = cs.find(b"\xff\x92")
    return cs[:at] + cs[at + 2:]


def _write(tmp_path, name: str, blob: bytes) -> str:
    path = tmp_path / (name + (".jp2" if blob[:4] != jpeg2000.J2K_MAGIC else ".j2k"))
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("name", list(CASES))
def test_case_equals_pillow(tmp_path, name):
    """(a) Each form reads as JPEG 2000, equal to the JAX package's load
    (Pillow's decode), tolerance 0."""
    blob = CASES[name]()
    fmt, _ = timage.read_texture(blob)
    assert fmt == "JPEG2000"
    path = _write(tmp_path, name, blob)
    np.testing.assert_array_equal(timage.load_texture_rgba(path), jimage.load_texture_rgba(path))


def _codestream(blob: bytes) -> bytes:
    return blob if blob[:4] == jpeg2000.J2K_MAGIC else blob[blob.find(b"jp2c") + 4:]


def _native_planes(cs: bytes):
    """native.j2k_decode's tiles placed into whole-image planes, as
    opj_decode hands them over (a tile never decoded stays 0)."""
    info, tiles = native.j2k_decode(cs, 0)
    out = []
    for k, (dx, dy, _, _) in enumerate(info["comps"]):
        cx0, cy0 = -(-info["x0"] // dx), -(-info["y0"] // dy)
        plane = np.zeros((-(-info["y1"] // dy) - cy0, -(-info["x1"] // dx) - cx0), np.int32)
        for (_, tx0, ty0, _, _), planes in tiles:
            x, y = -(-tx0 // dx) - cx0, -(-ty0 // dy) - cy0
            plane[y:y + planes[k].shape[0], x:x + planes[k].shape[1]] = planes[k]
        out.append(plane)
    return out


CODESTREAMS = [n for n in CASES if not n.startswith(("palette", "cdef", "colr", "no_colr",
                                                     "res_", "jpx", "bpcc", "unknown",
                                                     "sub_122_jp2", "missing"))]


@pytest.mark.parametrize("name", CODESTREAMS)
def test_native_planes_equal_opj_decode(name):
    """(b) The codec alone: the native planes equal libopenjp2 2.5.4's
    opj_decode planes exactly, on the 5/3 and the 9/7 path."""
    cs = _codestream(CASES[name]())
    want = opj_decode_planes(cs)
    assert want is not None
    got = _native_planes(cs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_matrix_reaches_its_markers():
    """The hand-made and ctypes forms hold what their names say."""
    def has(name, code):
        return struct.pack(">H", code) in _codestream(CASES[name]())
    assert has("poc_lrcp_rpcl", 0xFF5F) and has("roi_53", 0xFF5E)
    assert has("prec_12_4_8_qcc", 0xFF5D) and has("coc_restated", 0xFF53)
    assert has("ppt", 0xFF61) and not has("ppt", 0xFF60) and has("ppm", 0xFF60)
    assert has("sop_eph_tiles", 0xFF91) and has("sop_eph_tiles", 0xFF92)
    assert has("tlm_plm_crg", 0xFF55) and has("plt_comment", 0xFF58)
    _, parts, _ = j2k_segments(_codestream(CASES["tile_parts_by_resolution"]()))
    assert len(parts) > 4
    source = _ctypes(67, csty=6, rates=(20, 5, 1), tile=(32, 32))  # the stream "ppm" rewrites
    np.testing.assert_array_equal(_native_planes(CASES["ppm"]()), _native_planes(source))


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_where_pillow_refuses(tmp_path, name):
    """What Pillow refuses raises ValueError naming JPEG 2000."""
    path = _write(tmp_path, name, REFUSED[name]())
    with pytest.raises(Exception):
        jimage.load_texture_rgba(path)
    with pytest.raises(ValueError, match="JPEG 2000"):
        timage.load_texture_rgba(path)


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_fixture_equals_its_pillow_decode(name):
    """(c) tests/data/textures (make_fixtures.py): each fixture against the
    RGBA PNG of its Pillow decode and the JAX package's load."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    png = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, timage.load_texture_rgba(png))
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))


def _siz(csiz: int = 3, xsiz: int = 8, xosiz: int = 0) -> bytes:
    return (b"\xff\x4f\xff\x51" + struct.pack(">HHIIIIIIIIH", 38 + 3 * csiz, 0, xsiz, 8, xosiz, 0,
                                              8, 8, 0, 0, csiz) + b"\x07\x01\x01" * csiz)


OPENS = {  # name -> bytes whose _open Pillow runs
    "siz_cut": b"\xff\x4f\xff\x51\x00\x29\x00\x00",
    "csiz_5": _siz(5),
    "csiz_0": _siz(0),
    "zero_width": _siz(3, 8, 8),
    "negative_width": _siz(3, 8, 9),
    "comment_cut": _siz(1) + b"\xff\x52",
    "comment_marker_cut": _siz(1) + b"\xff",
    "jp2_no_jp2h": jpeg2000.JP2_MAGIC,
    "jp2_ftyp_only": jpeg2000.JP2_MAGIC + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 "),
    "jp2h_without_ihdr": jpeg2000.JP2_MAGIC + jp2_box(b"jp2h", jp2_box(b"colr", _srgb(16))),
    "jp2h_box_too_long": jpeg2000.JP2_MAGIC + struct.pack(">I", 500) + b"jp2h" + bytes(30),
    "ihdr_five_components": jpeg2000.JP2_MAGIC + jp2_box(b"jp2h", jp2_box(
        b"ihdr", struct.pack(">IIHBBBB", 8, 8, 5, 7, 7, 0, 0))),
    "ihdr_short": jpeg2000.JP2_MAGIC + jp2_box(b"jp2h", jp2_box(b"ihdr", bytes(6))),
    "pclr_cut": jpeg2000.JP2_MAGIC + jp2_box(b"jp2h", jp2_box(
        b"ihdr", struct.pack(">IIHBBBB", 8, 8, 1, 7, 7, 0, 0)) + jp2_box(b"pclr", b"\x00\x09\x03")),
    "xl_box": jpeg2000.JP2_MAGIC + struct.pack(">I4sQ", 1, b"jp2h", 16 + 22) + jp2_box(
        b"ihdr", struct.pack(">IIHBBBB", 8, 8, 3, 7, 7, 0, 0)),
    "short_signature": b"\x0d\x0a\x87\x0a" + bytes(40),
}


@pytest.mark.parametrize("name", list(OPENS))
def test_opens_falls_through_where_pillow_does(name):
    """(e) ``opens`` turns a file away (NotThisFormat) exactly where
    Pillow's ``_open`` raises one of the errors on which Image.open tries
    its next plugin, refuses it where ``_open`` raises another error, and
    takes it where ``_open`` does."""
    Image.init()  # the plugins in Image.ID's order first: importing one alone would lead it
    from PIL import Jpeg2KImagePlugin

    blob = OPENS[name]
    try:
        Jpeg2KImagePlugin.Jpeg2KImageFile(io.BytesIO(blob))
        want = "opens"
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error):
        want = "falls through"
    except Exception:  # noqa: BLE001 (any other error refuses the file)
        want = "refused"
    try:
        jpeg2000.opens(blob)
        got = "opens"
    except NotThisFormat:
        got = "falls through"
    except ValueError:
        got = "refused"
    assert got == want


def test_icns_jpeg2000_elements():
    """An ICNS icon's JPEG 2000 element (a JP2 file or a raw codestream)
    reads as Pillow's IcnsImagePlugin reads it; one that starts with the
    short signature 0D 0A 87 0A is refused by both."""
    pic = _picture(99, 32, 32, 4)
    for blob in (_pillow(pic), _pillow(pic, irreversible=True, no_jp2=True)):
        icns = icns_bytes([(b"ic11", blob)])
        with Image.open(io.BytesIO(icns)) as im:
            want = np.asarray(im.convert("RGBA"))
        np.testing.assert_array_equal(timage.decode_texture(icns), want)
    short = icns_bytes([(b"ic11", b"\x0d\x0a\x87\x0a" + _pillow(pic)[12:])])
    with pytest.raises(Exception):
        Image.open(io.BytesIO(short)).load()
    with pytest.raises(ValueError):
        timage.decode_texture(short)


def test_without_the_native_library_jpeg2000_names_it(tmp_path, monkeypatch):
    """The codestream decoder has no Python twin: without the library a
    JPEG 2000 file raises ValueError naming the native library; the
    library's name hashes j2k.cpp and its flags, which forbid contracting
    a multiply and an add (the 9/7 path rounds after each)."""
    path = _write(tmp_path, "t", CASES["RGB_97"]())
    with mock.patch.object(native, "lib", lambda: None):
        with pytest.raises(ValueError, match="JPEG 2000.*native library"):
            timage.load_texture_rgba(path)
    assert native.J2K_SRC in native.sources() and "-ffp-contract=off" in native.CXX_FLAGS
    before = native.lib_path()
    changed = tmp_path / "j2k.cpp"
    changed.write_bytes(native.J2K_SRC.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "J2K_SRC", changed)
    assert native.lib_path() != before


def test_forms_still_refused_name_themselves():
    """ROADMAP A-6c-2b: HTJ2K code-blocks and the MCC, CAP and CPF marker
    segments raise ValueError naming them."""
    cs = _ctypes(100)
    main, parts, tail = j2k_segments(cs)
    at = main.find(b"\xff\x52")
    ht = bytearray(main)
    ht[at + 12] |= 0x40  # SPcod's code-block style
    with pytest.raises(ValueError, match="HT"):
        jpeg2000.decode_jpeg2000(j2k_join(bytes(ht), parts, tail))
    for code in (0xFF75, 0xFF50):
        with pytest.raises(ValueError, match="MCC, CAP or CPF"):
            jpeg2000.decode_jpeg2000(_in_main(cs, j2k_marker(code, b"\x00\x00\x00\x00")))
