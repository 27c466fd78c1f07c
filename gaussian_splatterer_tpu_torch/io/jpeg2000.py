"""JPEG 2000 decoding for textures on hosts without Pillow.

``decode_jpeg2000(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1 with
OpenJPEG 2.5.4), for every JPEG 2000 file Pillow reads: a JP2 file (its box
signature) and a raw codestream (``FF 4F FF 51``), reversible 5/3 or
irreversible 9/7.  ``opens`` is Pillow's ``Jpeg2KImageFile._open``, which
picks the mode; this module walks the JP2 boxes as OpenJPEG's ``jp2.c``
does, the codestream decoder runs in the native library
(native/src/j2k.cpp: every marker segment of Part 1, the five progressions
and POC, precincts, layers, SOP/EPH, PPM/PPT, every code-block style, ROI,
tiles and offsets), and the tiles are unpacked as Pillow's
``Jpeg2KDecode.c`` unpacks them.

Pillow drives OpenJPEG tile by tile, so ``jp2.c``'s colour handling of
``opj_decode`` never runs: a palette (``pclr``) stays as indices, which
Pillow's own ``pclr`` reading turns into a ``P`` or ``PA`` image through
``ImagePalette.getcolor`` (duplicate entries fold, a palette of four
columns takes four bytes an entry; an index past the palette reads
opaque black); ``cmap``,
``cdef``, an ICC profile and ``res `` are read for their checks only.
Pillow's quirks kept:

  * a sample becomes a byte by a shift of ``8 - prec`` (16 for ``I;16``),
    left without replicating bits, right with rounding, after an offset of
    half the range for a signed component, and wraps to its low byte;
  * the colour space is the ``colr`` box's enumeration (sRGB, grey, sYCC,
    e-sYCC, which no unpacker takes, CMYK, where the CMYK mode also needs
    four components); without one (a raw codestream, no ``colr``, an ICC
    profile, another enumeration) it is grey for one or two components,
    sRGB for three or four, or sYCC when the first sub-sampled component
    is the second or the third;
  * sYCC goes through Pillow's YCbCr -> RGB (io/rawmode.py);
  * sub-sampled components are read at Pillow's layout (``w / dx`` by
    ``h / dy`` samples a tile, rounded down), which skews a tile whose
    size the factor does not divide, as Pillow's does;
  * a tile the stream never decodes stays black (transparent for modes
    with alpha), as Pillow's new image is;
  * the mode is the header's (``ihdr`` or SIZ), so a file whose
    codestream holds other components than its header says is refused or
    read through the unpacker Pillow picks for that pair.

Where Pillow refuses a file this module raises ValueError naming JPEG
2000: a codestream OpenJPEG fails (a truncated or damaged stream, a marker
out of place, a segment longer than its tile-part, an unknown progression,
more than 30 bit-planes), a JP2 box OpenJPEG or Pillow rejects, more than
four components, a colour space or sub-sampling no unpacker takes, more
pixels than Pillow's decompression-bomb limit.  A header that ends early
turns the file away (``NotThisFormat``) where Pillow's ``_open`` does.

Refused where Pillow reads (ROADMAP A-6c-2b): HTJ2K code-blocks and the
Part 2 marker segments MCC, CAP and CPF (MCT, MCO and CBD are read as
OpenJPEG reads them), a component whose tiles code different numbers of
resolutions past the one a POC decoded, and sizes past the decoder's
limits (2^28 samples a tile-component, 2^22 code-blocks a tile, 2^27
packet slots, 2^16 segments a code-block).

The decoder needs the native library: without ``g++`` (``native.lib()`` is
None) a JPEG 2000 file raises ValueError saying so.  There is no Python
twin of it; the plain reference is Pillow's decode through OpenJPEG
(tests/test_torch_jpeg2000.py).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.pillow_open import NotThisFormat, check_size, falls_through
from gaussian_splatterer_tpu_torch.io.rawmode import to_rgba, ycbcr_to_rgb

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's OPJ_COLOR_SPACE (an enumeration not listed leaves it unspecified)
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components, takes
# sub-sampling) -> unpacker
UNPACKERS = (
    ("L", GRAY, 1, False, "gray_l"), ("P", SRGB, 1, False, "gray_l"),
    ("PA", SRGB, 2, False, "graya_la"), ("I;16", GRAY, 1, False, "gray_i"),
    ("I;16B", GRAY, 1, False, "gray_i"), ("LA", GRAY, 2, False, "graya_la"),
    ("RGB", GRAY, 1, False, "gray_rgb"), ("RGB", GRAY, 2, False, "gray_rgb"),
    ("RGB", SRGB, 3, True, "srgb_rgb"), ("RGB", SYCC, 3, True, "sycc_rgb"),
    ("RGB", SRGB, 4, True, "srgb_rgb"), ("RGB", SYCC, 4, True, "sycc_rgb"),
    ("RGBA", GRAY, 1, False, "gray_rgb"), ("RGBA", GRAY, 2, False, "graya_la"),
    ("RGBA", SRGB, 3, True, "srgb_rgb"), ("RGBA", SYCC, 3, True, "sycc_rgb"),
    ("RGBA", SRGB, 4, True, "srgba_rgba"), ("RGBA", SYCC, 4, True, "sycca_rgba"),
    ("CMYK", CMYK, 4, True, "srgba_rgba"),
)


def accept(prefix: bytes) -> bool:
    return prefix.startswith((J2K_MAGIC, JP2_MAGIC))


# ---- Pillow's Jpeg2KImageFile._open ---------------------------------------------

class _BoxReader:
    """PIL.Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, fp, length: int = -1):
        self.fp, self.has_length, self.length = fp, length >= 0, length
        self.remaining_in_box = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining_in_box >= 0:
            return n <= self.remaining_in_box
        return True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got {len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= n
        return data

    def read_fields(self, fmt: str):
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        return _BoxReader(io.BytesIO(self._read_bytes(size)), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek(self.remaining_in_box, io.SEEK_CUR)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


def _i16be(b: bytes) -> int:
    return struct.unpack_from(">H", b)[0]


def _parse_codestream(fp):
    hdr = fp.read(2)
    lsiz = _i16be(hdr)
    siz = hdr + fp.read(lsiz - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _palette(npc: int, entries) -> tuple[str, bytes]:
    """ImagePalette.getcolor over the entries: (mode, palette bytes)."""
    mode = "RGBA" if npc == 4 else "RGB"
    stride = len(mode)
    colors: dict = {}
    pal = bytearray()
    for color in entries:
        if mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        index = len(pal) // stride
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors[color] = index
        if index * stride < len(pal):
            pal = pal[:index * stride] + bytes(color) + pal[index * stride + stride:]
        else:
            pal += bytes(color)
    return mode, bytes(pal)


def _parse_jp2_header(fp):
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read_fields(">4s")
    if header is None:
        raise AssertionError("no jp2h box")
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = ("L", "LA", "RGB", "RGBA")[nc - 1]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            depth = max((*header.read_fields(">" + "B" * npc), 0))
            if depth <= 8:
                palette = _palette(npc, [header.read_fields(">" + "B" * npc) for _ in range(ne)])
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = _i16be(fp.read(2))
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, io.SEEK_CUR)


def _open(blob: bytes):
    fp = io.BytesIO(blob)
    sig = fp.read(4)
    palette = None
    if sig == J2K_MAGIC:
        codec = "j2k"
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
    else:
        sig += fp.read(8)
        if sig != JP2_MAGIC:
            raise SyntaxError("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = _i16be(fp.read(2))
            fp.seek(length - 2, io.SEEK_CUR)
            _parse_comment(fp)
    if size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return codec, size, mode, palette


def opens(blob: bytes):
    """Pillow's ``_open`` checks: (codec, (w, h), mode, palette); a file
    it turns away raises NotThisFormat, one it refuses ValueError."""
    return falls_through(_open, blob)


# ---- OpenJPEG's jp2.c box walk --------------------------------------------------

SIGNATURE, FILE_TYPE, HEADER, CODESTREAM = 1, 2, 4, 8


class _Jp2:
    def __init__(self):
        self.state = 0
        self.ihdr = None  # (w, h, nc, bpc)
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None  # number of channels
        self.cmap = self.cdef = False

    def _ihdr(self, d: bytes) -> None:
        if self.ihdr is not None:
            return
        if len(d) != 14:
            raise ValueError("Bad image header box (bad size)")
        h, w, nc, bpc = struct.unpack_from(">IIHB", d)
        if (nc - 1) & 0xFFFFFFFF >= 16384:
            raise ValueError("Invalid number of components (ihdr)")
        self.ihdr = (w, h, nc, bpc)

    def _colr(self, d: bytes) -> None:
        if len(d) < 3:
            raise ValueError("Bad COLR header box (bad size)")
        if self.has_colr:
            return
        meth = d[0]
        if meth == 1:
            if len(d) < 7:
                raise ValueError("Bad COLR header box (bad size)")
            self.enumcs = struct.unpack_from(">I", d, 3)[0]
            self.has_colr = True
        elif meth == 2:
            self.has_colr = True

    def _pclr(self, d: bytes) -> None:
        if self.pclr is not None or len(d) < 3:
            raise ValueError("Invalid PCLR box")
        ne, nch = struct.unpack_from(">HB", d)
        if ne == 0 or ne > 1024 or nch == 0 or len(d) < 3 + nch:
            raise ValueError("Invalid PCLR box")
        at = 3 + nch
        for _ in range(ne):
            for i in range(nch):
                at += min(((d[3 + i] & 0x7F) + 1 + 7) >> 3, 4)
                if len(d) < at:
                    raise ValueError("Invalid PCLR box (entries past the box)")
        self.pclr = nch

    def _cmap(self, d: bytes) -> None:
        if self.pclr is None:
            raise ValueError("Need to read a PCLR box before the CMAP box.")
        if self.cmap:
            raise ValueError("Only one CMAP box is allowed.")
        if len(d) < self.pclr * 4:
            raise ValueError("Insufficient data for CMAP box.")
        self.cmap = True

    def _cdef(self, d: bytes) -> None:
        if self.cdef or len(d) < 2:
            raise ValueError("Invalid CDEF box")
        n = struct.unpack_from(">H", d)[0]
        if n == 0 or len(d) < 2 + n * 6:
            raise ValueError("Invalid CDEF box")
        self.cdef = True

    def _bpcc(self, d: bytes) -> None:
        if self.ihdr is None or len(d) != self.ihdr[2]:
            raise ValueError("Bad BPCC header box (bad size)")

    IMG = {b"ihdr": "_ihdr", b"colr": "_colr", b"pclr": "_pclr", b"cmap": "_cmap",
           b"cdef": "_cdef", b"bpcc": "_bpcc"}

    def _jp2h(self, d: bytes) -> None:
        if not self.state & FILE_TYPE:
            raise ValueError("The  box must be the first box in the file.")
        at, has_ihdr = 0, False
        while at < len(d):
            left = len(d) - at
            if left < 8:
                raise ValueError("Cannot handle box of less than 8 bytes")
            length, kind = struct.unpack_from(">I4s", d, at)
            hdr = 8
            if length == 1:
                if left < 16:
                    raise ValueError("Cannot handle XL box of less than 16 bytes")
                hi, length = struct.unpack_from(">II", d, at + 8)
                if hi:
                    raise ValueError("Cannot handle box sizes higher than 2^32")
                hdr = 16
            if length == 0:
                raise ValueError("Cannot handle box of undefined sizes")
            if length < hdr or length > left:
                raise ValueError("Stream error while reading JP2 Header box")
            if kind in self.IMG:
                getattr(self, self.IMG[kind])(d[at + hdr:at + length])
            has_ihdr |= kind == b"ihdr"
            at += length
        if not has_ihdr:
            raise ValueError("Stream error while reading JP2 Header box: no 'ihdr' box.")
        self.state |= HEADER

    def walk(self, blob: bytes, pos: int) -> int:
        """opj_jp2_read_header_procedure from ``pos``: the position after
        a ``jp2c`` box header, or -1 when the boxes end without one."""
        n = len(blob)
        while n - pos >= 8:
            length, kind = struct.unpack_from(">I4s", blob, pos)
            hdr = 8
            if length == 0:
                length = n - pos
            elif length == 1:
                if n - pos < 16:
                    return -1
                hi, length = struct.unpack_from(">II", blob, pos + 8)
                if hi:
                    return -1
                hdr = 16
            if kind == b"jp2c":
                if self.state & HEADER:
                    self.state |= CODESTREAM
                    return pos + hdr
                raise ValueError("bad placed jpeg codestream")
            if length < hdr:
                raise ValueError("invalid box size")
            size, body = length - hdr, pos + hdr
            handler = {b"jP  ": self._jp, b"ftyp": self._ftyp, b"jp2h": self._jp2h}.get(kind)
            if handler is None and kind in self.IMG:
                if not self.state & HEADER:  # ignored before jp2h
                    if body + size > n:
                        raise ValueError("Problem with skipping JPEG2000 box, stream error")
                    pos = body + size
                    continue
                handler = getattr(self, self.IMG[kind])
            if handler is not None:
                if size > n - body:
                    raise ValueError("Invalid box size for a JP2 box")
                handler(blob[body:body + size])
            else:
                if not self.state & SIGNATURE:
                    raise ValueError("Malformed JP2 file format: first box must be JPEG 2000 "
                                     "signature box")
                if not self.state & FILE_TYPE:
                    raise ValueError("Malformed JP2 file format: second box must be file type box")
                if size > n - body:
                    if self.state & CODESTREAM and n - body > 0:
                        return -1
                    raise ValueError("Problem with skipping JPEG2000 box, stream error")
            pos = body + size
        return -1

    def _jp(self, d: bytes) -> None:
        if self.state != 0:
            raise ValueError("The signature box must be the first box in the file.")
        if d != b"\x0d\x0a\x87\x0a":
            raise ValueError("Error with JP signature Box")
        self.state |= SIGNATURE

    def _ftyp(self, d: bytes) -> None:
        if self.state != SIGNATURE:
            raise ValueError("The ftyp box must be the second box in the file.")
        if len(d) < 8 or (len(d) - 8) & 3:
            raise ValueError("Error with FTYP signature Box size")
        self.state |= FILE_TYPE


# ---- Pillow's unpackers (Jpeg2KDecode.c) ---------------------------------------

def _word_bytes(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _shift(v: np.ndarray, prec: int, sgnd: bool, target: int) -> np.ndarray:
    """j2ku_shift(offset + word, target - prec) in unsigned 32 bits."""
    shift = target - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    word = v.astype(np.int64) & ((1 << (8 * _word_bytes(prec))) - 1)
    x = (word + offset) & 0xFFFFFFFF
    return (x >> -shift) if shift < 0 else ((x << shift) & 0xFFFFFFFF)


def _tile_buffer(planes, info) -> bytes:
    """The buffer opj_decode_tile_data fills: each component's plane in
    turn, at 1, 2 or 4 bytes a sample (little-endian)."""
    out = []
    for plane, (_, _, prec, _) in zip(planes, info):
        size = _word_bytes(prec)
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[size]
        out.append((plane.astype(np.int64) & ((1 << (8 * size)) - 1)).astype(dt).tobytes())
    return b"".join(out)


def _words(buf: bytes, at: int, size: int, index: np.ndarray) -> np.ndarray:
    """The ``size``-byte little-endian words at ``at + size * index``."""
    pos = at + size * index.astype(np.int64)
    raw = np.frombuffer(buf, np.uint8)
    pad = np.concatenate([raw, np.zeros(8, np.uint8)])  # Pillow's buffer is at least this long
    v = np.zeros(index.shape, np.int64)
    for k in range(size):
        v |= pad[np.minimum(pos + k, pad.size - 1)].astype(np.int64) << (8 * k)
    return v


def _unpack_tile(kind: str, x0: int, y0: int, info, tile, planes, out: np.ndarray) -> None:
    """Place one decoded tile into ``out`` (the image's bands, uint8, or
    uint16 for I;16) as Pillow's unpacker reads opj_decode_tile_data's
    buffer."""
    _, tx0, ty0, tx1, ty1 = tile
    w, h = tx1 - tx0, ty1 - ty0
    region = out[ty0 - y0:ty1 - y0, tx0 - x0:tx1 - x0]
    buf = _tile_buffer(planes, info)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]

    def band(n: int, at: int, target: int = 8):
        dx, dy, prec, sgnd = info[n]
        size = _word_bytes(prec)
        cw = w // dx
        word = _words(buf, at, size, (ys // dy) * cw + xs // dx)
        return _shift(word, prec, sgnd, target), at + size * cw * (h // dy)

    if kind == "gray_i":
        region[...] = band(0, 0, 16)[0] & 0xFFFF
        return
    g, at = band(0, 0)
    g = (g & 0xFF).astype(np.uint8)
    if kind == "gray_l":
        region[...] = g
        return
    if kind in ("gray_rgb", "graya_la"):
        region[..., 0] = region[..., 1] = region[..., 2] = g
        region[..., 3] = (band(1, at)[0] & 0xFF) if kind == "graya_la" else 255
        return
    nb = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    region[..., 0] = g
    for n in range(1, nb):
        v, at = band(n, at)
        region[..., n] = v & 0xFF
    if nb == 3:
        region[..., 3] = 255
    if kind in ("sycc_rgb", "sycca_rgba"):
        region[..., :3] = ycbcr_to_rgb(region[..., :3])


def decode_jpeg2000(blob: bytes) -> np.ndarray:
    """JPEG 2000 bytes (a JP2 file or a raw codestream) -> (H, W, 4) uint8
    RGBA, row 0 the top of the picture."""
    codec, (w, h), mode, palette = opens(blob)
    check_size("JPEG 2000", w, h)
    start, ihdr = 0, (0, 0)
    jp2 = None
    try:
        if codec == "jp2":
            jp2 = _Jp2()
            start = jp2.walk(blob, 0)
            if start < 0:
                raise ValueError("no codestream box")
            ihdr = jp2.ihdr[:2]
        if native.lib() is None:
            raise ValueError("the native library is not built (no g++), and the JPEG 2000 "
                             "decoder has no Python twin")
        info, tiles = native.j2k_decode(blob, start, *ihdr)
        if jp2 is not None:
            jp2.walk(blob, info["end"])
    except ValueError as exc:
        raise ValueError(f"JPEG 2000: {exc}") from None
    comps = info["comps"]
    nc = len(comps)
    space = ENUMCS.get(jp2.enumcs, UNSPECIFIED) if codec == "jp2" else UNSPECIFIED
    if nc < 1 or nc > 4:
        raise ValueError("JPEG 2000: a colour space Pillow does not unpack (broken data stream)")
    sub = next((n for n, c in enumerate(comps) if c[0] != 1 or c[1] != 1), -1)
    if space == UNSPECIFIED:
        space = GRAY if nc <= 2 else (SYCC if sub in (1, 2) else SRGB)
    kind = next((k for m, s, n, takes, k in UNPACKERS
                 if s == space and n == nc and (sub == -1 or takes) and m == mode), None)
    if kind is None:
        raise ValueError(f"JPEG 2000: no unpacker for mode {mode} from {nc} components "
                         f"(broken data stream)")
    x0, y0 = info["x0"], info["y0"]
    bands = 1 if mode in ("L", "P", "I;16", "I;16B") else 4
    dtype = np.uint16 if mode.startswith("I;16") else np.uint8
    out = np.zeros((h, w) if bands == 1 else (h, w, 4), dtype)
    for tile, planes in tiles:
        _, tx0, ty0, tx1, ty1 = tile
        if (tx0 < x0 or ty0 < y0 or tx1 - x0 > w or ty1 - y0 > h or tx0 > tx1 or ty0 > ty1):
            raise ValueError("JPEG 2000: a tile outside the image (broken data stream)")
        _unpack_tile(kind, x0, y0, comps, tile, planes, out)
    if mode in ("P", "PA"):
        pmode, data = palette
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        step = 4 if pmode == "RGBA" else 3
        entries = np.frombuffer(data[:len(data) // step * step], np.uint8).reshape(-1, step)
        pal[:len(entries), :step] = entries[:256]
        if mode == "P":
            return to_rgba("P", out, pal if step == 4 else pal[:, :3])
        return to_rgba("PA", np.stack([out[..., 0], out[..., 3]], axis=-1), pal)
    if mode in ("LA",):
        return to_rgba("LA", np.stack([out[..., 0], out[..., 3]], axis=-1))
    if mode in ("RGB",):
        return to_rgba("RGB", out[..., :3])
    return to_rgba({"I;16B": "I;16"}.get(mode, mode), out)
