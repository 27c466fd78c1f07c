"""JPEG decoding in Python and numpy, for textures on hosts without Pillow.

``decode_jpeg(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte: libjpeg's
default decode, which is

  * the ``islow`` integer inverse DCT (libjpeg's jidctint.c), as
    libjpeg-turbo's SIMD form saturates and clamps it;
  * "fancy" (triangle-filter) upsampling of h2v1, h1v2 and h2v2 chroma,
    box replication otherwise (jdsample.c), the picture's edges replicated;
  * the integer YCbCr -> RGB tables (jdcolor.c).

Coverage: 8-bit Huffman-coded JPEG, baseline (SOF0), extended sequential
(SOF1) and progressive (SOF2: spectral selection and successive
approximation); one component (grey, copied into R, G and B) or three
(YCbCr, or RGB as stored when an Adobe APP14 marker says transform 0, or
component ids 'R', 'G', 'B') or four (CMYK, stored inverted as Photoshop
and Pillow write it, with an Adobe APP14 marker of transform 0 or without
one; YCCK, an APP14 marker of any other transform), converted to RGB as
Pillow converts CMYK (``cmyk_to_rgb``); any integral sampling factors;
restart intervals, byte stuffing and sizes that are not whole MCUs; a
file that ends inside a scan's data, with no marker after them, is
refused, as Pillow refuses it ("image file is truncated": libjpeg reads
ahead and finds no more data; fault C-8 where its read-ahead was met); as
libjpeg, bytes before a marker are skipped, a marker libjpeg does not know
(JPG, DHP, EXP, JPGn, the reserved ones, a second SOI) is refused, a bad Huffman code takes 17
bits and reads as symbol 0, a coefficient past the band goes to the last
one, and once a restart segment's data runs out the MCUs after it are left
as they are (zero, mid-grey, in a sequential scan).
Arithmetic coding (SOF9-SOF15), lossless (SOF3), hierarchical (SOF5-SOF7)
and 12-bit samples raise ValueError.

Entropy decoding runs in Python over table lookups (a 16-bit peek into a
65,536-entry table per Huffman table); dequantisation, the IDCT,
upsampling and colour conversion are vectorised numpy on int64.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag index -> natural (row-major) index within a block (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential "
    "sequential (SOF13)", 0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


# the markers with a length field that libjpeg reads or refuses by name
# (the SOFn it does not read); SOI, RSTn, TEM and EOI have no length
_KNOWN_MARKERS = frozenset([*range(0xC0, 0xD0), 0xDA, 0xDB, 0xDC, 0xDD, *range(0xE0, 0xF0),
                            0xFE]) - {0xC8}


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None  # natural-order int64 (64,), latched at its first scan


def _huffman_lut(counts, symbols) -> list:
    """65,536 entries indexed by the next 16 bits of the stream:
    (code length << 8) | symbol; where no code starts, libjpeg's reading of
    a bad code (17 bits taken, symbol 0)."""
    lut = np.full(1 << 16, 17 << 8, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(blob: bytes, pos: int) -> tuple[list, int]:
    """The entropy-coded data from ``pos``: its restart segments with the
    byte stuffing removed, and the offset of the marker that ends it."""
    segs, start = [], pos
    while True:
        i = blob.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(blob):
            segs.append(blob[start:])
            end = len(blob)
            break
        nxt = blob[i + 1]
        if nxt == 0x00:
            pos = i + 2
        elif nxt == 0xFF:  # fill bytes before a marker
            pos = i + 1
        elif 0xD0 <= nxt <= 0xD7:  # RSTn
            segs.append(blob[start:i])
            start = pos = i + 2
        else:
            segs.append(blob[start:i])
            end = i
            break
    return [s.rstrip(b"\xff").replace(b"\xff\x00", b"\xff") for s in segs], end


def _i16(v: int) -> int:
    """libjpeg's JCOEF, a 16-bit coefficient."""
    return (v + 0x8000 & 0xFFFF) - 0x8000


def _words(seg: bytes) -> list:
    """words[i]: the 32 bits of the segment starting at byte i (zeros past
    its end, as libjpeg feeds zeros once the data runs out, enough for an
    MCU of ten blocks of bad codes)."""
    b = np.frombuffer(seg + bytes(4096), np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


# -- entropy decoding of one restart segment: mcus is [[(component, block base)]],
# limit the segment's bits --

def _seq(words, mcus, limit, tabs, ncomp):
    p, pred = 0, [0] * ncomp
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            coefs, dc, ac = tabs[ci]
            e = dc[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e >> 8
            s = e & 255
            if s:
                v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[ci] += v
            coefs[base] = _i16(pred[ci])  # JCOEF
            k = 1
            while k < 64:
                e = ac[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                rs = e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    coefs[base + min(k, 63)] = v  # jpeg_natural_order's extra entries
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


def _dc_first(words, mcus, limit, tabs, ncomp, al):
    p, pred = 0, [0] * ncomp
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            coefs, dc, _ = tabs[ci]
            e = dc[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e >> 8
            s = e & 255
            if s:
                v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[ci] += v
            coefs[base] = _i16(pred[ci] << al)


def _dc_refine(words, mcus, limit, tabs, al):
    p, p1 = 0, 1 << al
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            if (words[p >> 3] >> (31 - (p & 7))) & 1:
                tabs[ci][0][base] |= p1
            p += 1


def _ac_first(words, mcus, limit, tabs, ss, se, al):
    p = eobrun = 0
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            if eobrun:
                eobrun -= 1
                continue
            coefs, _, ac = tabs[ci]
            k = ss
            while k <= se:
                e = ac[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                rs = e & 255
                s, r = rs & 15, rs >> 4
                if s:
                    k += r
                    v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    coefs[base + min(k, 63)] = _i16(v << al)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (words[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break


def _ac_refine(words, mcus, limit, tabs, ss, se, al):
    """libjpeg's decode_mcu_AC_refine, statement for statement."""
    p = eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            coefs, _, ac = tabs[ci]
            k = ss
            if not eobrun:
                while k <= se:
                    e = ac[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    rs = e & 255
                    s, r = rs & 15, rs >> 4
                    if s:  # a newly nonzero coefficient: its size is always 1
                        s = p1 if (words[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (words[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                            p += r
                        break
                    # pass over the nonzero coefficients (each takes a correction
                    # bit) and r zero ones
                    while k <= se:
                        c = coefs[base + k]
                        if c:
                            if (words[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                coefs[base + k] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k <= se:
                        coefs[base + k] = s
                    k += 1
            if eobrun:
                while k <= se:  # correction bits for the rest of the band
                    c = coefs[base + k]
                    if c:
                        if (words[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coefs[base + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1


# -- the islow IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) --

_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
            f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(d, shift0: int):
    """One pass of the islow butterfly over d[0..7] (int64 arrays); the
    eight outputs before their descale.  ``shift0`` is CONST_BITS: the
    even part's DC and 4 terms are scaled up by it."""
    f = _FIX
    z1 = (d[2] + d[6]) * f["f0541"]
    tmp2 = z1 + d[6] * -f["f1847"]
    tmp3 = z1 + d[2] * f["f0765"]
    tmp0 = (d[0] + d[4]) << shift0
    tmp1 = (d[0] - d[4]) << shift0
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(N, 64) dequantised natural-order int64 coefficients -> (N, 8, 8)
    uint8 samples, as libjpeg-turbo's SIMD jpeg_idct_islow computes them
    for Pillow: the dequantised values kept to 16 bits, the first pass's
    output saturated to 16 bits, the samples +128 and clamped to [0, 255]
    (the same as jidctint.c's range limit within [-512, 511])."""
    blk = ((coefs + 0x8000 & 0xFFFF) - 0x8000).reshape(-1, 8, 8)
    cols = _idct_1d([blk[:, k, :] for k in range(8)], 13)  # pass 1 down the columns
    ws = np.stack([np.clip(_descale(c, 13 - 2), -32768, 32767) for c in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13)  # pass 2 along the rows
    out = np.stack([_descale(r, 13 + 2 + 3) for r in rows], axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- upsampling (jdsample.c) and colour conversion (jdcolor.c) --

def _edge(a: np.ndarray, axis: int):
    """(previous, next) neighbours along ``axis``, the edges replicated."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    n = a.shape[axis]
    prev = np.concatenate([first, np.take(a, range(n - 1), axis=axis)], axis=axis)
    nxt = np.concatenate([np.take(a, range(1, n), axis=axis), last], axis=axis)
    return prev, nxt


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's (h, w) samples expanded by (fv, fh): fancy for h2v1,
    h1v2 and h2v2 (h2 only from a width of 3), box replication otherwise."""
    a = plane.astype(np.int64)
    w = a.shape[1]
    if (fh, fv) == (2, 1) and w > 2:
        left, right = _edge(a, 1)
        return _interleave((3 * a + left + 1) >> 2, (3 * a + right + 2) >> 2, 1)
    if (fh, fv) == (1, 2):
        up, down = _edge(a, 0)
        return _interleave((3 * a + up + 1) >> 2, (3 * a + down + 2) >> 2, 0)
    if (fh, fv) == (2, 2) and w > 2:
        up, down = _edge(a, 0)
        rows = []
        for near in (3 * a + up, 3 * a + down):  # the upper, then the lower output row
            left, right = _edge(near, 1)
            rows.append(_interleave((3 * near + left + 8) >> 4, (3 * near + right + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(a, fv, axis=0), fh, axis=1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda c: int(c * (1 << 16) + 0.5)  # noqa: E731  (libjpeg's FIX)
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ycc_rgb_convert on int arrays of [0, 255] -> (..., 3) uint8."""
    y, cb, cr = (np.asarray(c, np.int64) for c in (y, cb, cr))
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def cmyk_to_rgb(planes, ycck: bool) -> np.ndarray:
    """Four decoded planes -> (..., 3) uint8 as Pillow gives a CMYK JPEG in
    RGB.  libjpeg hands Pillow CMYK: the planes as stored, or for YCCK
    (255 - R, 255 - G, 255 - B) of the first three as YCbCr (ycc_to_rgb)
    and K as stored; Pillow reads them inverted (its ``CMYK;I``, the Adobe
    convention) and converts each channel as ``nk - nk * c / 255`` with nk
    = 255 - K, in its rounded integer form."""
    c = (255 - ycc_to_rgb(*planes[:3]).astype(np.int64) if ycck
         else np.stack(planes[:3], axis=-1).astype(np.int64))
    nk = np.asarray(planes[3], np.int64)[..., None]  # 255 - (255 - K) as Pillow holds it
    t = (255 - c) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# -- markers --

def decode_jpeg(blob: bytes, cmyk: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture.
    ``cmyk`` reads four components as CMYK even where an Adobe marker
    says YCCK (libjpeg's colour space set to CMYK, as Pillow's BLP plugin
    sets it).  A variant this module does not read, or a malformed file,
    raises ValueError."""
    try:
        frame, comps, coefs, jfif, adobe, transform, unterminated = _decode(blob)
        if unterminated:  # Pillow's suspending source reads ahead, finds no more data
            raise ValueError("corrupt JPEG data: the data end inside a scan (image file is "
                             "truncated)")
        if cmyk and len(comps) == 4:
            transform = 0
        return _reconstruct(frame, comps, coefs, jfif, adobe, transform)
    except (IndexError, KeyError, TypeError, struct.error) as exc:
        # a stream that ends early, a table or component it never defined
        raise ValueError(f"corrupt JPEG data ({type(exc).__name__}: {exc})") from None


def decode_jpeg_stream(stream: bytes, tables: bytes = b"", ycc: bool = False
                       ) -> tuple[np.ndarray, list]:
    """One JPEG stream as libtiff hands a TIFF strip or tile to libjpeg ->
    ((H, W, C) uint8 samples of its C components, upsampled as libjpeg
    upsamples them, [(h, v) sampling factors of each component]).
    ``tables`` is a tables-only stream (TIFF's ``JPEGTables``) read first,
    whose DQT and DHT tables the stream's own replace; ``ycc`` asks for
    libjpeg's YCbCr -> RGB of three components (libtiff's
    ``JPEGCOLORMODE_RGB``), else the components come as stored, whatever
    the stream's JFIF or Adobe markers say."""
    try:
        init = _decode(tables, tables_only=True, eoi_fill=True) if tables else None
        frame, comps, coefs, *_ = _decode(stream, init, eoi_fill=True)
        planes = _planes(frame, comps, coefs)
    except (IndexError, KeyError, TypeError, struct.error) as exc:
        raise ValueError(f"corrupt JPEG data ({type(exc).__name__}: {exc})") from None
    if ycc:
        if len(planes) != 3:
            raise ValueError(f"JPEG YCbCr -> RGB of {len(planes)} components")
        out = ycc_to_rgb(*planes)
    else:
        out = np.stack(planes, axis=-1).astype(np.uint8)
    return out, [(c.h, c.v) for c in comps]


def _decode(blob: bytes, init=None, tables_only: bool = False, eoi_fill: bool = False):
    """The marker loop: (frame, components, coefficients, JFIF, Adobe,
    Adobe transform, whether the last scan's data run to the blob's end
    with no marker after them); with ``tables_only`` the (quantisation, DC, AC)
    tables a tables-only stream defines, which ``init`` passes to a
    stream that uses them.  A marker segment longer than the blob reads
    on into fake EOI markers (FF D9) with ``eoi_fill``, as libtiff's data
    source feeds libjpeg, and refuses the file otherwise (Pillow's source
    suspends and finds no more data).  Segment lengths are held to
    libjpeg's rules (jdmarker.c): SOF and SOS exactly their components'
    bytes, DRI 4, DQT and DHT exactly their tables'; a DQT table cut short
    keeps 1 in its missing entries."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, dc_luts, ac_luts = (dict(t) for t in init) if init else ({}, {}, {})
    comps: list[_Component] = []
    frame = None  # (height, width, progressive)
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    unterminated = False  # the last scan's data run to the end of the blob
    coefs: list[list] = []
    pos = 2
    while pos < len(blob):
        if blob[pos] != 0xFF:  # bytes before a marker, which libjpeg skips
            pos += 1
            continue
        marker = blob[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # no length field
            continue
        if marker not in _KNOWN_MARKERS:  # libjpeg's read_markers refuses the rest
            raise ValueError(f"corrupt JPEG data: marker 0x{marker:02x} libjpeg does not know")
        (length,) = struct.unpack(">H", blob[pos:pos + 2])
        if length < 2:
            raise ValueError("corrupt JPEG data: a marker length below 2")
        seg = blob[pos + 2:pos + length]
        if len(seg) < length - 2:
            if not eoi_fill:
                raise ValueError("corrupt JPEG data: a marker segment past the end of the data "
                                 "(image file is truncated)")
            seg = (seg + b"\xff\xd9" * (length // 2))[:length - 2]
        pos += length
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe, adobe_transform = True, seg[11]
        elif marker == 0xDB:  # DQT (get_dqt)
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if tq >= 4:
                    raise ValueError(f"corrupt JPEG data: DQT table index {tq}")
                left = len(seg) - i - 1
                n = min(64, left >> 1 if pq else left)
                q = np.ones(64, np.int64)
                q[:n] = np.frombuffer(seg, ">u2" if pq else "u1", n, i + 1)
                table = np.empty(64, np.int64)
                table[NATURAL_ORDER] = q
                qtables[tq] = table
                i += 1 + (2 * n if pq else n)
        elif marker == 0xC4:  # DHT (get_dht)
            i, left = 0, len(seg)
            while left > 16:
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                left -= 17
                if total > 256 or total > left:
                    raise ValueError("corrupt JPEG data: bogus Huffman table definition")
                lut = _huffman_lut(counts, seg[i + 17:i + 17 + total])
                (ac_luts if tc else dc_luts)[th] = lut
                i += 17 + total
                left -= total
            if left:
                raise ValueError("corrupt JPEG data: bogus marker length (DHT)")
        elif marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
            name = f"SOF{marker - 0xC0}"
            if len(seg) != 6 + 3 * nf:
                raise ValueError(f"corrupt JPEG data: bogus marker length ({name})")
            if precision != 8:
                raise ValueError(f"JPEG with {precision}-bit samples ({name}) is not supported")
            if nf not in (1, 3, 4):
                raise ValueError(f"JPEG with {nf} components ({name}) is not supported")
            if height == 0 or width == 0:
                raise ValueError(f"JPEG with an empty frame ({name}: {width}x{height})")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                 seg[8 + 3 * i]) for i in range(nf)]
            frame = (height, width, marker == 0xC2)
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcusx, mcusy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise ValueError(f"JPEG with fractional sampling factors ({name}) is "
                                     "not supported")
                c.w, c.hgt = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.bw, c.bh = -(-c.w // 8), -(-c.hgt // 8)
                c.bw_pad, c.bh_pad = mcusx * c.h, mcusy * c.v
            coefs = [[0] * (64 * c.bw_pad * c.bh_pad) for c in comps]
            mcus = (mcusx, mcusy)
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{_UNSUPPORTED_SOF[marker]} JPEG is not supported")
        elif marker == 0xDD:  # DRI
            if length != 4:
                raise ValueError("corrupt JPEG data: bogus marker length (DRI)")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDC:
            raise ValueError("JPEG with a DNL marker is not supported")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("corrupt JPEG data: SOS before SOF")
            ns = seg[0]
            if length != 2 * ns + 6 or not 1 <= ns <= 4:
                raise ValueError("corrupt JPEG data: bogus marker length (SOS)")
            by_id = {c.cid: i for i, c in enumerate(comps)}
            sel = [(by_id[seg[1 + 2 * i]], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                   for i in range(ns)]
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            tabs = {}
            for ci, td, ta in sel:
                c = comps[ci]
                if c.qtable is None:
                    c.qtable = qtables[c.tq]
                tabs[ci] = (coefs[ci], dc_luts.get(td), ac_luts.get(ta))
            units = _scan_units(comps, [ci for ci, _, _ in sel], mcus)
            segs, pos = _segments(blob, pos)
            unterminated = pos >= len(blob)
            step = max(restart or len(units), 1)  # MCUs a restart segment
            for j in range(0, len(units), step):
                seg = segs[j // step] if j // step < len(segs) else b""
                words, limit, chunk = _words(seg), 8 * len(seg), units[j:j + step]
                if not frame[2]:
                    _seq(words, chunk, limit, tabs, len(comps))
                elif ss == 0:
                    (_dc_refine(words, chunk, limit, tabs, al) if ah
                     else _dc_first(words, chunk, limit, tabs, len(comps), al))
                elif ah:
                    _ac_refine(words, chunk, limit, tabs, ss, se, al)
                else:
                    _ac_first(words, chunk, limit, tabs, ss, se, al)
    if tables_only:
        return qtables, dc_luts, ac_luts
    if frame is None:
        raise ValueError("corrupt JPEG data: no frame (SOF marker)")
    return frame, comps, coefs, jfif, adobe, adobe_transform, unterminated


def _scan_units(comps, scan, mcus) -> list:
    """Per MCU of a scan, its (component, block base) pairs in order; a
    scan of one component walks that component's own blocks."""
    if len(scan) == 1:
        c = comps[scan[0]]
        ci = scan[0]
        return [[(ci, 64 * (by * c.bw_pad + bx))] for by in range(c.bh) for bx in range(c.bw)]
    mcusx, mcusy = mcus
    out = []
    for my in range(mcusy):
        for mx in range(mcusx):
            out.append([(ci, 64 * ((my * comps[ci].v + v) * comps[ci].bw_pad
                                   + mx * comps[ci].h + h))
                        for ci in scan for v in range(comps[ci].v) for h in range(comps[ci].h)])
    return out


def _planes(frame, comps, coefs) -> list:
    """Each component's samples after the IDCT and upsampling, (H, W) int64."""
    height, width, _ = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c, zz in zip(comps, coefs):
        q = c.qtable if c.qtable is not None else np.zeros(64, np.int64)
        zz = np.asarray(zz, np.int64).reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, NATURAL_ORDER] = zz
        blocks = idct_islow(nat * q).reshape(c.bh_pad, c.bw_pad, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh_pad * 8, c.bw_pad * 8)
        plane = _upsample(plane[:c.hgt, :c.w], hmax // c.h, vmax // c.v)
        planes.append(plane[:height, :width])
    return planes


def _reconstruct(frame, comps, coefs, jfif, adobe, adobe_transform) -> np.ndarray:
    height, width, _ = frame
    planes = _planes(frame, comps, coefs)
    rgba = np.full((height, width, 4), 255, np.uint8)
    if len(comps) == 1:
        rgba[..., :3] = planes[0][..., None].astype(np.uint8)
        return rgba
    if len(comps) == 4:
        rgba[..., :3] = cmyk_to_rgb(planes, ycck=adobe and adobe_transform != 0)
        return rgba
    if jfif:
        rgb_stored = False
    elif adobe:
        rgb_stored = adobe_transform == 0
    else:
        rgb_stored = [c.cid for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb_stored:
        rgba[..., :3] = np.stack(planes, axis=-1).astype(np.uint8)
    else:
        rgba[..., :3] = ycc_to_rgb(*planes)
    return rgba
