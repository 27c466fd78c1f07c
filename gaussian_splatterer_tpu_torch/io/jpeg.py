"""JPEG decoding in Python and numpy, for textures on hosts without Pillow.

``decode_jpeg(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte: libjpeg-turbo
3.1's default decode, which is

  * the ``islow`` integer inverse DCT (libjpeg's jidctint.c) as its SIMD
    form computes it: dequantised values kept to 16 bits, the sums d0 + d4,
    d0 - d4, d7 + d3 and d5 + d1 taken in 16 bits, the first pass
    saturated to 16 bits or, for a block whose coefficient rows 1-7 are
    zero, row 0 shifted in 16 bits, the samples clamped;
  * "fancy" (triangle-filter) upsampling of h2v1, h1v2 and h2v2 chroma,
    box replication otherwise (jdsample.c), the picture's edges replicated;
  * the integer YCbCr -> RGB tables (jdcolor.c);
  * block smoothing of a progressive image that lacks some of its first
    nine AC coefficients' bits (jdcoefct.c's decompress_smooth_data, which
    runs when scans were lost before the EOI).

Coverage: 8-bit JPEG in every coding libjpeg-turbo decodes: Huffman-coded
baseline (SOF0), extended sequential (SOF1) and progressive (SOF2: spectral
selection and successive approximation); arithmetic-coded sequential (SOF9)
and progressive (SOF10), with a DAC segment's conditioning or libjpeg's
defaults (io/jpeg_arith.py); lossless (SOF3: predictors 1-7, any point
transform, io/jpeg_lossless.py), whose samples are upsampled by
replication and never colour-converted.  One component (grey, copied into
R, G and B) or three (YCbCr, or RGB as stored when an Adobe APP14 marker
says transform 0, or component ids 'R', 'G', 'B', or a lossless file
without a JFIF or Adobe marker) or four (CMYK, stored inverted as Photoshop
and Pillow write it, with an Adobe APP14 marker of transform 0 or without
one; YCCK, an APP14 marker of any other transform), converted to RGB as
Pillow converts CMYK (``cmyk_to_rgb``); sampling factors 1-4, integral,
at most 10 blocks an MCU; restart intervals (read_restart_marker's
resynchronisation for the arithmetic and lossless codings), byte stuffing
and sizes that are not whole MCUs.

As Pillow feeds it: ``decode_jpeg`` reads the file as Pillow's suspending
data source gives it to libjpeg, in blocks of 64 KB:

  * a single-scan file is read once its last MCU is decoded (what
    follows may end anywhere, but libjpeg's errors in it still refuse
    the file); its Huffman decoder reads ahead (decode_mcu_fast while the
    buffer holds 512 bytes a block, else jpeg_fill_bit_buffer's 57 bits)
    and a file whose scan data end, with no marker after them, before that
    read-ahead is met is refused ("image file is truncated"; fault C-8);
  * a multi-scan file (progressive, or scans of fewer components than the
    frame) is refused unless libjpeg reaches its EOI;
  * an arithmetic-coded scan cannot suspend: one whose data run past the
    end of the file, or of the 64 KB block its SOS was read in, is refused;
  * before the first scan, Pillow's own parser refuses what its handlers
    refuse (a TEM marker, a DQT table cut short, a JFIF or Adobe segment
    too short for its version).

As libjpeg, bytes before a marker are skipped, a marker libjpeg does not
know (JPG, DHP, EXP, JPGn, the reserved ones, a second SOI) is refused, a
bad Huffman code takes 17 bits and reads as symbol 0, a coefficient past
the band goes to the last one, once a restart segment's data runs out the
MCUs after it are left as they are (zero, mid-grey, in a sequential scan),
and segment lengths are held to jdmarker.c's rules, also on a segment cut
short after a single scan.  libjpeg-turbo refuses the differential codings
(SOF5-SOF7, SOF13-SOF15) and arithmetic-coded lossless (SOF11), and Pillow
hands on precisions other than 8 to its other plugins, which refuse them;
these raise ValueError, as does lossless JPEG whose colour space libjpeg
would convert (YCbCr, YCCK), which libjpeg-turbo refuses in lossless mode.

Huffman entropy decoding runs in Python over table lookups (a 16-bit peek
into a 65,536-entry table per Huffman table); the arithmetic and lossless
decoders' loops run in C++ with Python twins; dequantisation, the IDCT,
upsampling and colour conversion are vectorised numpy on int64.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import jpeg_arith, jpeg_lossless

# zigzag index -> natural (row-major) index within a block (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

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

def _seq(words, mcus, limit, tabs, ncomp) -> int:
    """A sequential scan's interval -> the bits it took, past ``limit``
    where its data ran out (the progressive procedures below return the
    same)."""
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
    return p


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
    return p


def _dc_refine(words, mcus, limit, tabs, al):
    p, p1 = 0, 1 << al
    for mcu in mcus:
        if p > limit:  # libjpeg leaves the MCUs after its data ran out
            break
        for ci, base in mcu:
            if (words[p >> 3] >> (31 - (p & 7))) & 1:
                tabs[ci][0][base] |= p1
            p += 1
    return p


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
    return p


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
                    if s:  # at jpeg_natural_order[k], whose extra entries are 63
                        coefs[base + min(k, 63)] = s
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
    return p


# -- the islow IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) --

_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
            f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _w16(x):
    """A 16-bit lane's wrap-around (SIMD paddw/psubw)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _idct_1d(d, shift0: int):
    """One pass of the islow butterfly over d[0..7] (int64 arrays); the
    eight outputs before their descale.  ``shift0`` is CONST_BITS: the
    even part's DC and 4 terms are scaled up by it.  As libjpeg-turbo's
    SIMD form (jidctint-sse2/avx2), the sums d0 + d4, d0 - d4, d7 + d3 and
    d5 + d1 are taken in 16 bits and wrap; its other sums and products
    fit its 32-bit lanes, so they are exact here too."""
    f = _FIX
    z1 = (d[2] + d[6]) * f["f0541"]
    tmp2 = z1 + d[6] * -f["f1847"]
    tmp3 = z1 + d[2] * f["f0765"]
    tmp0 = _w16(d[0] + d[4]) << shift0
    tmp1 = _w16(d[0] - d[4]) << shift0
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _w16(t0 + t2), _w16(t1 + t3)
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


def idct_islow(coefs: np.ndarray, row0_only=None) -> np.ndarray:
    """(N, 64) dequantised natural-order int64 coefficients -> (N, 8, 8)
    uint8 samples, as libjpeg-turbo's SIMD jpeg_idct_islow computes them
    for Pillow: the dequantised values kept to 16 bits, the first pass's
    output saturated to 16 bits, the samples +128 and clamped to [0, 255]
    (the same as jidctint.c's range limit within [-512, 511]).  Where
    ``row0_only`` (N,) says a block's coefficient rows 1-7 are all zero,
    the first pass is its shortcut: the dequantised row 0 shifted left by
    PASS1_BITS in 16 bits, wrapping, down every column."""
    blk = ((coefs + 0x8000 & 0xFFFF) - 0x8000).reshape(-1, 8, 8)
    cols = _idct_1d([blk[:, k, :] for k in range(8)], 13)  # pass 1 down the columns
    ws = np.stack([np.clip(_descale(c, 13 - 2), -32768, 32767) for c in cols], axis=1)
    if row0_only is not None and row0_only.any():
        ws[row0_only] = _w16(blk[row0_only, :1, :] << 2)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13)  # pass 2 along the rows
    out = np.stack([_descale(r, 13 + 2 + 3) for r in rows], axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- block smoothing (jdcoefct.c's decompress_smooth_data) --

def _kernel(rows: str) -> np.ndarray:
    return np.array([[int(v) for v in r.split()] for r in rows.split(";")], np.int64)


# (zigzag index, natural index, the 5x5 weights of the DC values around a
# block with DC interpolation, and without it); the estimate is
# Q00 * sum(weights * DC) / (Q_k << 8), rounded half away from zero
_SMOOTH = [
    (1, 1, _kernel("-1 -1 0 1 1;-3 13 0 -13 3;-3 38 0 -38 3;-3 13 0 -13 3;-1 -1 0 1 1"),
     _kernel("0 0 0 0 0;0 0 0 0 0;-7 50 0 -50 7;0 0 0 0 0;0 0 0 0 0")),
    (2, 8, _kernel("-1 -3 -3 -3 -1;-1 13 38 13 -1;0 0 0 0 0;1 -13 -38 -13 1;1 3 3 3 1"),
     _kernel("0 0 -7 0 0;0 0 50 0 0;0 0 0 0 0;0 0 -50 0 0;0 0 7 0 0")),
    (3, 16, _kernel("0 0 1 0 0;0 2 7 2 0;0 -5 -14 -5 0;0 2 7 2 0;0 0 1 0 0"),
     _kernel("0 0 -1 0 0;0 0 13 0 0;0 0 -24 0 0;0 0 13 0 0;0 0 -1 0 0")),
    (4, 9, _kernel("-1 0 0 0 1;0 9 0 -9 0;0 0 0 0 0;0 -9 0 9 0;1 0 0 0 -1"),
     _kernel("0 -1 0 1 0;-1 10 0 -10 1;0 0 0 0 0;1 -10 0 10 -1;0 1 0 -1 0")),
    (5, 2, _kernel("0 0 0 0 0;0 2 -5 2 0;1 7 -14 7 1;0 2 -5 2 0;0 0 0 0 0"),
     _kernel("0 0 0 0 0;0 0 0 0 0;-1 13 -24 13 -1;0 0 0 0 0;0 0 0 0 0")),
    (6, 3, _kernel("0 0 0 0 0;0 1 0 -1 0;0 2 0 -2 0;0 1 0 -1 0;0 0 0 0 0"), None),
    (7, 10, _kernel("0 0 0 0 0;0 1 -3 1 0;0 0 0 0 0;0 -1 3 -1 0;0 0 0 0 0"), None),
    (8, 17, _kernel("0 0 0 0 0;0 1 0 -1 0;0 -3 0 3 0;0 1 0 -1 0;0 0 0 0 0"), None),
    (9, 24, _kernel("0 0 0 0 0;0 1 2 1 0;0 0 0 0 0;0 -1 -2 -1 0;0 0 0 0 0"), None),
]
_SMOOTH_DC = _kernel("-2 -6 -8 -6 -2;-6 6 42 6 -6;-8 42 152 42 -8;-6 6 42 6 -6;"
                     "-2 -6 -8 -6 -2")


def smoothing_applies(comps, coef_bits) -> bool:
    """jdcoefct.c's smoothing_ok for a progressive image: every component
    has a quantisation table and some DC bits, its first ten quantisation
    values are nonzero, and some component still lacks bits of one of its
    first nine AC coefficients."""
    useful = False
    for c, bits in zip(comps, coef_bits):
        if c.qtable is None or bits[0] < 0:
            return False
        if not c.qtable[[0, 1, 8, 16, 9, 2, 3, 10, 17, 24]].all():
            return False
        useful = useful or any(bits[1:10])
    return useful


def smooth_blocks(nat: np.ndarray, c, bits, imcu_rows: int) -> np.ndarray:
    """(bh_pad * bw_pad, 64) natural-order coefficients of one component ->
    the copy its IDCT takes under block smoothing: each of the first nine
    AC coefficients that is still zero and not known to its last bit is
    estimated from the DC values of the 5x5 blocks around it (edge columns
    repeated, rows as jdcoefct.c picks them), at most 2**Al - 1 in magnitude once
    Al bits are known; where no AC bit of the first nine is known at all,
    the DC is interpolated too."""
    out = nat.copy()
    grid = nat.reshape(c.bh_pad, c.bw_pad, 64)
    dc = np.pad(grid[:, :c.bw, 0], ((0, 0), (2, 2)), mode="edge")
    # the block rows above and below: jdcoefct.c counts a row as
    # output_iMCU_row * block_rows + block_row of block_rows *
    # total_iMCU_rows, block_rows the iMCU row's real rows, so a partial
    # last iMCU row repeats its neighbours and the row before it reaches
    # a padding row
    r = np.arange(c.bh)
    imcu, br = r // c.v, r % c.v
    last = (c.bh - 1) // c.v
    rows_in = np.where(imcu < last, c.v, c.bh - last * c.v)
    at, span = imcu * rows_in + br, rows_in * imcu_rows
    prev = np.where(at > 0, r - 1, r)
    prev2 = np.where(at > 1, r - 2, prev)
    nxt = np.where(at < span - 1, r + 1, r)
    nxt2 = np.where(at < span - 2, r + 2, nxt)
    rows = dc[np.stack([prev2, prev, r, nxt, nxt2], axis=1)]  # (bh, 5, bw + 4)
    win = np.lib.stride_tricks.sliding_window_view(rows, 5, axis=2).transpose(0, 2, 1, 3)
    view = out.reshape(c.bh_pad, c.bw_pad, 64)[:c.bh, :c.bw]
    change_dc = all(b == -1 for b in bits[1:10])
    q00 = int(c.qtable[0])
    for zz, pos, with_dc, without in _SMOOTH:
        al = bits[zz]
        kernel = with_dc if change_dc else without
        if al == 0 or kernel is None:
            continue
        q = int(c.qtable[pos])
        num = q00 * np.einsum("abij,ij->ab", win, kernel)
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        zero = view[..., pos] == 0
        view[..., pos] = np.where(zero, _w16(pred), view[..., pos])
    if change_dc:
        num = q00 * np.einsum("abij,ij->ab", win, _SMOOTH_DC)
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        view[..., 0] = _w16(np.where(num >= 0, pred, -pred))
    return out


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


# -- the data sources: Pillow's suspending one, libtiff's --

BLOCK = 65536  # Pillow's ImageFile.MAXBLOCK: the decoder is fed the file in blocks of it
MIN_GET_BITS = 57  # jdhuff.h on 64-bit hosts: the Huffman bit buffer fills to this depth
BUFSIZE = 512  # jdhuff.c: bytes a block in the buffer for decode_mcu_fast
_STUFFED = re.compile(rb"\xff+\x00")
# SOFn libjpeg-turbo refuses (JERR_SOF_UNSUPPORTED, or JERR_ARITH_NOTIMPL for SOF11)
_UNSUPPORTED_SOF = {
    0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}

# jstdhuff.c: the tables libjpeg-turbo takes for a Huffman-coded DCT scan
# that names table 0 or 1 of a class the file never defined (T.81 K.3)
_STD_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
        "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5"
        "f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a1624"
        "34e125f11718191a262728292a35363738393a434445464748494a535455565758595a63646566"
        "6768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aa"
        "b2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
        "f5f6f7f8f9fa")),
}


def _derived_table(key, luts, defs, dc_max: int, standard: bool) -> None:
    """jpeg_make_d_derived_tbl for table ``key`` = (class, index) of a scan:
    where the file never defined it, libjpeg-turbo's standard table for
    index 0 or 1 (``standard``: a sequential Huffman-coded scan) or an
    error; then its
    checks: a code that fits its lengths with no all-ones code, DC symbols
    at most ``dc_max``."""
    if key not in defs:
        if not standard or key not in _STD_HUFFMAN:
            raise ValueError(f"corrupt JPEG data: Huffman table 0x{key[0] << 4 | key[1]:02x} was "
                             "not defined")
        defs[key] = _STD_HUFFMAN[key]
        luts[key[0]][key[1]] = _huffman_lut(*_STD_HUFFMAN[key])
    counts, symbols = defs[key]
    code = 0
    for length, n in enumerate(counts, 1):
        code += n
        if n and code >= 1 << length:
            raise ValueError("corrupt JPEG data: bogus Huffman table definition")
        code <<= 1
    if key[0] == 0 and any(sym > dc_max for sym in symbols):
        raise ValueError("corrupt JPEG data: bogus Huffman table definition")


def _next_marker(data: bytes, pos: int, stop: int):
    """libjpeg's next_marker from ``pos``: (the marker, the position after
    it), or (None, stop) where the data run out first."""
    while True:
        i = data.find(b"\xff", pos, stop)
        if i < 0:
            return None, stop
        j = i + 1
        while j < stop and data[j] == 0xFF:
            j += 1
        if j >= stop:
            return None, stop
        if data[j]:
            return data[j], j + 1
        pos = j + 1


def _read_restart(data: bytes, pos: int, marker: int, want: int, stop: int):
    """libjpeg's read_restart_marker and jpeg_resync_to_restart: ->
    (position, the marker left unread (0 where it was taken, so the next
    interval reads data), whether the data sufficed)."""
    if not marker:
        marker, pos = _next_marker(data, pos, stop)
        if marker is None:
            return pos, 0, False
    if marker == 0xD0 + want:
        return pos, 0, True
    while True:
        if marker < 0xC0:
            action = 2  # not a marker: scan on
        elif not 0xD0 <= marker <= 0xD7 or marker - 0xD0 in ((want + 1) & 7, (want + 2) & 7):
            action = 3  # leave it for an empty interval
        elif marker - 0xD0 in ((want - 1) & 7, (want - 2) & 7):
            action = 2
        else:
            action = 1  # take it and go on
        if action == 1:
            return pos, 0, True
        if action == 3:
            return pos, marker, True
        marker, pos = _next_marker(data, pos, stop)
        if marker is None:
            return pos, 0, False


def _entropy_data(data: bytes, pos: int, stop: int):
    """From ``pos``: (the data bytes up to the next marker as libjpeg's
    Huffman reader takes them, FF 00 and FFs before a 00 one FF byte; the
    position where they end; whether a marker ends them)."""
    i = pos
    while True:
        j = data.find(b"\xff", i, stop)
        if j < 0:
            end, marked = stop, False
            break
        k = j + 1
        while k < stop and data[k] == 0xFF:
            k += 1
        if k >= stop:  # FFs at the end: the reader takes them and suspends
            end, marked = j, False
            break
        if data[k]:
            end, marked = j, True
            break
        i = k + 1
    return _STUFFED.sub(b"\xff", data[pos:end]), end, marked


def _raw_ends(raw: bytes) -> list:
    """For each data byte of ``raw`` (no marker in it), the offset after it
    and its stuffing."""
    ends, i, n = [], 0, len(raw)
    while i < n:
        if raw[i] == 0xFF:
            while i < n and raw[i] == 0xFF:
                i += 1
        i += 1
        ends.append(i)
    return ends


def _huffman_suspends(words, limit, units, tabs, raw_ends, start, file_len, first_call,
                      fast: bool) -> bool:
    """Whether libjpeg-turbo's Huffman decoder, fed as Pillow feeds it,
    suspends before the last MCU of ``units`` when the data (``limit``
    bits, from file offset ``start``) end the file without a marker:
    decode_mcu_fast where the buffer holds BUFSIZE bytes a block at an
    MCU's start (``fast``: no restart interval), refilling 6 bytes at a
    time at 16 bits or fewer; else decode_mcu_slow, whose
    jpeg_fill_bit_buffer fills to MIN_GET_BITS and suspends where the
    buffer runs out; a suspended MCU is decoded again from its start with
    the next block, and one at the end of the file is Pillow's "image file
    is truncated"."""
    def raw_at(bits):  # the file offset of the reader's next byte
        n = bits >> 3
        return start + (raw_ends[n - 1] if n else 0)

    call = first_call
    buf_end = min(file_len, BLOCK * call)
    p = r = 0
    for mcu in units:
        p0, r0 = p, r
        while True:
            quick = fast and buf_end - raw_at(r) >= BUFSIZE * len(mcu)
            suspended = False
            for ci, _ in mcu:
                _, dc, ac = tabs[ci]
                lut, k = dc, 0
                while k < 64:
                    e = lut[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    n, sym = e >> 8, e & 255
                    s = sym if k == 0 else sym & 15
                    # (refill point of the fast path, bits wanted, bits taken)
                    steps = [(True, 8, 0)] + ([(False, 9, 9)] + [(False, 1, 1)] * (n - 9)
                                              if n > 8 else [(False, 0, n)])
                    if s:
                        steps.append((True, s, s))
                    for refill, need, take in steps:
                        if quick:
                            if refill and r - p <= 16:
                                r += 48
                        elif r - p < need:
                            r = (p + MIN_GET_BITS + 7) & ~7
                            if (r >> 3) > len(raw_ends) or raw_at(r) > buf_end:
                                suspended = True
                                break
                        p += take
                    if suspended:
                        break
                    if k == 0:
                        lut, k = ac, 1
                    elif s:
                        k += (sym >> 4) + 1
                    elif sym == 0xF0:
                        k += 16
                    else:
                        break
                if suspended:
                    break
            if not suspended:
                break
            if buf_end >= file_len:
                return True
            call += 1
            buf_end = min(file_len, BLOCK * call)
            p, r = p0, r0
    return False


# -- markers --

def decode_jpeg(blob: bytes, cmyk: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture, as
    Pillow reads the file: fed to libjpeg-turbo in blocks of 64 KB by a
    source that suspends where the data run out (see the module's
    docstring for what that refuses).  ``cmyk`` reads four components as
    CMYK even where an Adobe marker says YCCK (libjpeg's colour space set
    to CMYK, as Pillow's BLP plugin sets it).  A variant this module does
    not read, or a file Pillow refuses, raises ValueError."""
    try:
        frame, comps, coefs, jfif, adobe, transform = _decode(blob)
        if cmyk and len(comps) == 4:
            transform = 0
        return _reconstruct(frame, comps, coefs, jfif, adobe, transform)
    except (IndexError, KeyError, TypeError, struct.error) as exc:
        # a stream that ends early, a table or component it never defined
        raise ValueError(f"corrupt JPEG data ({type(exc).__name__}: {exc})") from None


def decode_jpeg_stream(stream: bytes, tables: bytes = b"", ycc: bool = False,
                       state: dict | None = None) -> tuple[np.ndarray, list]:
    """One JPEG stream as libtiff hands a TIFF strip or tile to libjpeg ->
    ((H, W, C) uint8 samples of its C components, upsampled as libjpeg
    upsamples them, [(h, v) sampling factors of each component]).
    ``tables`` is a tables-only stream (TIFF's ``JPEGTables``) read first,
    whose DQT and DHT tables the stream's own replace; ``ycc`` asks for
    libjpeg's YCbCr -> RGB of three components (libtiff's
    ``JPEGCOLORMODE_RGB``), else the components come as stored, whatever
    the stream's JFIF or Adobe markers say.  libtiff hands over the whole
    strip and then fake EOI markers, so nothing suspends.  ``state``, a dict
    the strips and tiles of one file share, carries the tables from one
    to the next: libtiff decodes them all with one decompressor, which
    keeps a table a strip defined for the strips after it."""
    try:
        if state is not None and "tables" in state:
            init = state["tables"]
        else:
            init = _decode(tables, tables_only=True, eoi_fill=True) if tables else None
        keep: list = []
        frame, comps, coefs, *_ = _decode(stream, init, eoi_fill=True, keep=keep)
        if state is not None:
            state["tables"] = keep[0]
        planes = _planes(frame, comps, coefs)
    except (IndexError, KeyError, TypeError, struct.error) as exc:
        raise ValueError(f"corrupt JPEG data ({type(exc).__name__}: {exc})") from None
    if ycc:
        if len(planes) != 3:
            raise ValueError(f"JPEG YCbCr -> RGB of {len(planes)} components")
        if frame.lossless:
            raise ValueError("lossless JPEG with YCbCr -> RGB (libjpeg converts no colour "
                             "space in lossless mode)")
        out = ycc_to_rgb(*planes)
    else:
        out = np.stack(planes, axis=-1).astype(np.uint8)
    return out, [(c.h, c.v) for c in comps]


_CODINGS = {0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
            0xC3: "lossless", 0xC9: "arithmetic-coded sequential",
            0xCA: "arithmetic-coded progressive"}


class _Frame:
    def __init__(self, marker: int, height: int, width: int):
        self.height, self.width = height, width
        self.progressive = marker in (0xC2, 0xCA)
        self.arith = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        self.name = (f"{_CODINGS[marker]} (SOF{marker - 0xC0})")


def _truncated(what: str) -> ValueError:
    return ValueError(f"corrupt JPEG data: {what} (image file is truncated)")


def _pillow_open_checks(marker: int, seg: bytes) -> None:
    """What Pillow's JpegImagePlugin ``_open`` refuses in a segment before
    the first scan (its handlers' SyntaxError, IndexError or struct.error,
    on which Pillow tries its other plugins): a DQT table cut short, a JFIF
    or Adobe segment too short for its version field, a Photoshop resource
    whose name runs past the segment."""
    bad = False
    if marker == 0xDB:
        i = 0
        while i < len(seg):
            n = 1 + (128 if seg[i] >> 4 else 64)
            bad = bad or len(seg) - i < n
            i += n
    elif marker in (0xE0, 0xEE):
        bad = seg.startswith(b"JFIF" if marker == 0xE0 else b"Adobe") and len(seg) < 7
    elif marker == 0xED and seg.startswith(b"Photoshop 3.0\x00"):
        i = 14
        while seg[i:i + 4] == b"8BIM":
            i += 4
            if i + 2 > len(seg):  # its i16 fails: struct.error ends the loop
                break
            i += 2
            if i >= len(seg):  # the name's length: IndexError
                bad = True
                break
            i += 1 + seg[i]
            i += i & 1
            if i + 4 > len(seg):
                break
            i += 4 + int.from_bytes(seg[i:i + 4], "big")
            i += i & 1
    if bad:
        raise ValueError(f"JPEG segment 0x{marker:02x} Pillow's parser refuses")


def _partial_checks(marker: int, rest: bytes, comps, frame) -> None:
    """A marker segment cut short after a single scan, where libjpeg
    suspends once its bytes run out: the checks jdmarker.c makes on the
    bytes it has read by then (a second SOF at once; a DRI's or SOS's
    length; an SOS's component ids; each DQT, DHT and DAC table header as
    it arrives)."""
    if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA) and frame is not None:
        raise ValueError("corrupt JPEG data: a second frame")
    if len(rest) < 2:
        return
    length = rest[0] << 8 | rest[1]
    body = rest[2:length]
    if marker == 0xDD and length != 4:
        raise ValueError("corrupt JPEG data: bogus marker length (DRI)")
    if marker == 0xDA and body:
        n = body[0]
        if length != 2 * n + 6 or not 1 <= n <= 4:
            raise ValueError("corrupt JPEG data: bogus marker length (SOS)")
        ids = {c.cid for c in comps}
        if any(cid not in ids for cid in body[1:1 + 2 * n:2]):
            raise ValueError("corrupt JPEG data: a scan of a component the frame lacks")
    if marker == 0xDB:
        i = 0
        while i < len(body):
            if body[i] & 15 >= 4:
                raise ValueError(f"corrupt JPEG data: DQT table index {body[i] & 15}")
            i += 1 + (128 if body[i] >> 4 else 64)
    if marker == 0xC4:
        i, left = 0, length - 2
        while left > 16 and i + 17 <= len(body):
            total = sum(body[i + 1:i + 17])
            left -= 17
            if total > 256 or total > left:
                raise ValueError("corrupt JPEG data: bogus Huffman table definition")
            if i + 17 + total <= len(body) and (body[i] >> 4 > 1 or body[i] & 15 >= 4):
                raise ValueError(f"corrupt JPEG data: DHT table index 0x{body[i]:02x}")
            i += 17 + total
            left -= total
    if marker == 0xCC:
        for index, val in zip(body[::2], body[1::2]):
            if index >= 32 or (index < 16 and val & 15 > val >> 4):
                raise ValueError("corrupt JPEG data: bogus DAC entry")


def _check_progression(frame: _Frame, ns: int, ss: int, se: int, ah: int, al: int) -> None:
    """jdphuff.c's and jdarith.c's checks of a progressive scan
    (JERR_BAD_PROGRESSION), and jdlossls.c's of a lossless one."""
    if frame.lossless:
        bad = not 1 <= ss <= 7 or se or ah or al >= 8
    elif frame.progressive:
        bad = ((se != 0) if ss == 0 else (se < ss or se > 63 or ns != 1)) or (
            ah and al != ah - 1) or al > 13
    else:
        return
    if bad:
        raise ValueError(f"corrupt {frame.name} JPEG data: invalid progressive/lossless "
                         f"parameters Ss={ss} Se={se} Ah={ah} Al={al}")


def _decode(blob: bytes, init=None, tables_only: bool = False, eoi_fill: bool = False,
            keep: list | None = None):
    """The marker loop: (frame, components, coefficients or lossless
    samples, JFIF, Adobe, Adobe transform); with ``tables_only`` the
    (quantisation, DC, AC, Huffman definitions) tables a tables-only
    stream defines, which ``init`` passes to a stream that uses them
    (``keep`` receives those a stream leaves).  ``eoi_fill`` reads as
    libtiff's data source feeds libjpeg: the stream, then fake EOI markers
    (FF D9); without it, as Pillow's source feeds it (``BLOCK``s, and
    suspension where the data run out: a file that ends before a
    multi-scan image's EOI, or inside a single scan where libjpeg's
    Huffman read-ahead or arithmetic decoder wants more, or before its
    scan, is refused; one that ends after a single scan's data is read).
    Segment lengths are held to libjpeg's rules (jdmarker.c): SOF and SOS
    exactly their components' bytes, DRI 4, DQT and DHT exactly their
    tables', DAC whole pairs; a DQT table cut short keeps 1 in its missing
    entries, but under ``eoi_fill`` takes 64 entries from the bytes after
    it, as libjpeg-turbo does, and is refused.  Under ``eoi_fill`` a stream
    without a scan is refused (a tables-only stream with one), and once a
    single scan is decoded what the markers after it would refuse is
    ignored: libtiff ignores jpeg_finish_decompress's failure."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, dc_luts, ac_luts, defs = ((dict(t) for t in init) if init else
                                        ({}, {}, {}, {}))  # defs: (class, index) -> DHT
    comps: list[_Component] = []
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    cond = np.array([[0] * 16, [1] * 16, [5] * 16], np.int64)  # DAC: L, U, Kx of each table
    coefs: list = []
    data = blob + b"\xff\xd9" if eoi_fill else blob
    scans, multi, single_done = 0, False, False
    pos = 2
    try:
        while pos < len(blob):
            if blob[pos] != 0xFF:  # bytes before a marker, which libjpeg skips
                pos += 1
                continue
            if pos + 1 >= len(blob):
                if eoi_fill or single_done:
                    break
                raise _truncated("the data end inside a marker")
            marker = blob[pos + 1]
            if marker in (0xFF, 0x00):  # fill byte; FF 00, which next_marker discards
                pos += 1 if marker == 0xFF else 2
                continue
            pos += 2
            if marker == 0xD9:  # EOI
                break
            if marker == 0x01 and not scans and not eoi_fill:  # Pillow's _open: "no marker found"
                raise ValueError("JPEG with a TEM marker before its scan (Pillow's parser knows "
                                 "no such marker)")
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # no length field
                continue
            if marker not in _KNOWN_MARKERS:  # libjpeg's read_markers refuses the rest
                raise ValueError(f"corrupt JPEG data: marker 0x{marker:02x} libjpeg does not know")
            if marker in _UNSUPPORTED_SOF:  # refused before its length is read
                raise ValueError(f"{_UNSUPPORTED_SOF[marker]} JPEG is not supported (libjpeg-turbo "
                                 "refuses it)")
            if pos + 2 > len(blob) and not eoi_fill:
                if single_done:
                    _partial_checks(marker, blob[pos:], comps, frame)
                    break
                raise _truncated("a marker segment past the end of the data")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            if length < 2:
                raise ValueError("corrupt JPEG data: a marker length below 2")
            seg_at = pos + 2
            seg = blob[seg_at:pos + length]
            if len(seg) < length - 2:
                if single_done:  # Pillow has every line; libjpeg suspends in the trailer
                    _partial_checks(marker, blob[pos:], comps, frame)
                    break
                if not eoi_fill:
                    raise _truncated("a marker segment past the end of the data")
                seg = (seg + b"\xff\xd9" * (length // 2))[:length - 2]
            pos += length
            if not scans and not eoi_fill:
                _pillow_open_checks(marker, seg)
            if marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:  # examine_app0
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
                    if eoi_fill:  # libjpeg-turbo reads all 64 entries, past the segment
                        # if need be (libtiff's fake EOI markers after the data), and
                        # then refuses the length they overran
                        size = 128 if pq else 64
                        raw = (data[seg_at + i + 1:seg_at + i + 1 + size]
                               + b"\xff\xd9" * 64)[:size]
                        q[:] = np.frombuffer(raw, ">u2" if pq else "u1", 64)
                        n = 64 if size <= left else n
                    else:
                        q[:n] = np.frombuffer(seg, ">u2" if pq else "u1", n, i + 1)
                    table = np.empty(64, np.int64)
                    table[NATURAL_ORDER] = q
                    qtables[tq] = table
                    if n < 64:
                        if eoi_fill:
                            raise ValueError("corrupt JPEG data: bogus marker length (DQT)")
                    i += 1 + (2 * n if pq else n)
            elif marker == 0xC4:  # DHT (get_dht)
                i, left = 0, len(seg)
                while left > 16:
                    tc, th = seg[i] >> 4, seg[i] & 15
                    if tc > 1 or th >= 4:  # jdmarker.c: JERR_DHT_INDEX
                        raise ValueError(f"corrupt JPEG data: DHT table index 0x{seg[i]:02x}")
                    counts = seg[i + 1:i + 17]
                    total = sum(counts)
                    left -= 17
                    if total > 256 or total > left:
                        raise ValueError("corrupt JPEG data: bogus Huffman table definition")
                    symbols = seg[i + 17:i + 17 + total]
                    (ac_luts if tc else dc_luts)[th] = _huffman_lut(counts, symbols)
                    defs[tc, th] = (list(counts), bytes(symbols))
                    i += 17 + total
                    left -= total
                if left:
                    raise ValueError("corrupt JPEG data: bogus marker length (DHT)")
            elif marker == 0xCC:  # DAC (get_dac)
                if len(seg) % 2:
                    raise ValueError("corrupt JPEG data: bogus marker length (DAC)")
                for index, val in zip(seg[::2], seg[1::2]):
                    if index >= 32:
                        raise ValueError(f"corrupt JPEG data: DAC table index {index}")
                    if index >= 16:
                        cond[2, index - 16] = val
                    else:
                        cond[0, index], cond[1, index] = val & 15, val >> 4
                        if val & 15 > val >> 4:
                            raise ValueError(f"corrupt JPEG data: DAC value 0x{val:02x}")
            elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
                precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
                name = f"SOF{marker - 0xC0}"
                if frame is not None:
                    raise ValueError(f"corrupt JPEG data: a second frame ({name})")
                if len(seg) != 6 + 3 * nf:
                    raise ValueError(f"corrupt JPEG data: bogus marker length ({name})")
                if precision != 8:  # Pillow's SOF handler: "cannot handle N-bit layers"
                    raise ValueError(f"JPEG with {precision}-bit samples ({name}) is not supported")
                if nf not in (1, 3, 4):
                    raise ValueError(f"JPEG with {nf} components ({name}) is not supported")
                if height == 0 or width == 0:
                    raise ValueError(f"JPEG with an empty frame ({name}: {width}x{height})")
                comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                     seg[8 + 3 * i]) for i in range(nf)]
                frame = _Frame(marker, height, width)
                frame.scanned = set()  # the components a lossless scan decoded
                # Al of each coefficient's last scan
                frame.coef_bits = [[-1] * 64 for _ in range(nf)]
                unit = 1 if frame.lossless else 8  # a lossless data unit is one sample
                for c in comps:
                    if not (1 <= c.h <= 4 and 1 <= c.v <= 4):  # jdinput.c's initial_setup
                        raise ValueError(f"corrupt JPEG data: bogus sampling factors ({name})")
                hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
                mcusx, mcusy = -(-width // (unit * hmax)), -(-height // (unit * vmax))
                for c in comps:
                    if hmax % c.h or vmax % c.v:
                        raise ValueError(f"JPEG with fractional sampling factors ({name}) is "
                                         "not supported")
                    c.w, c.hgt = -(-width * c.h // hmax), -(-height * c.v // vmax)
                    c.bw, c.bh = -(-c.w // unit), -(-c.hgt // unit)
                    c.bw_pad, c.bh_pad = mcusx * c.h, mcusy * c.v
                mcus = (mcusx, mcusy)
                if frame.lossless:
                    coefs = [np.zeros((c.hgt, c.w), np.int64) for c in comps]
                elif frame.arith:
                    sizes = [64 * c.bw_pad * c.bh_pad for c in comps]
                    frame.offsets = np.cumsum([0] + sizes)
                    frame.flat = np.zeros(frame.offsets[-1], np.int16)
                    coefs = [frame.flat[o:o + n] for o, n in zip(frame.offsets, sizes)]
                else:
                    coefs = [[0] * (64 * c.bw_pad * c.bh_pad) for c in comps]
            elif marker == 0xDD:  # DRI
                if length != 4:
                    raise ValueError("corrupt JPEG data: bogus marker length (DRI)")
                (restart,) = struct.unpack(">H", seg[:2])
            elif marker == 0xDA:  # SOS
                if tables_only:  # libtiff: "Bogus JPEGTables field"
                    raise ValueError("a JPEGTables stream with a scan")
                if frame is None:
                    raise ValueError("corrupt JPEG data: SOS before SOF")
                if single_done:  # jdinput.c: a second scan in a single-scan file
                    raise ValueError("corrupt JPEG data: a second scan where EOI was expected")
                ns = seg[0]
                if length != 2 * ns + 6 or not 1 <= ns <= 4:
                    raise ValueError("corrupt JPEG data: bogus marker length (SOS)")
                by_id = {c.cid: i for i, c in enumerate(comps)}
                sel = [(by_id[seg[1 + 2 * i]], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                       for i in range(ns)]
                ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
                ah, al = ahal >> 4, ahal & 15
                if ns > 1 and sum(comps[ci].h * comps[ci].v for ci, _, _ in sel) > 10:
                    raise ValueError("corrupt JPEG data: more than 10 blocks in an MCU (libjpeg's "
                                     "D_MAX_BLOCKS_IN_MCU)")
                scans += 1
                if scans == 1:
                    multi = frame.progressive or ns < len(comps)
                _check_progression(frame, ns, ss, se, ah, al)
                if frame.progressive:
                    for ci, _, _ in sel:
                        frame.coef_bits[ci][ss:se + 1] = [al] * (se - ss + 1)
                sos_end = pos
                if frame.lossless:
                    frame.scanned.update(ci for ci, _, _ in sel)
                    pos, done = _lossless_scan(data, pos, eoi_fill, frame, comps, coefs, sel,
                                               restart, mcus, ss, al, (dc_luts, ac_luts), defs)
                elif frame.arith:
                    pos = _arith_scan(data, pos, len(data) if eoi_fill else
                                      min(len(blob), BLOCK * max(1, -(-sos_end // BLOCK))),
                                      frame, comps, qtables, sel, restart, mcus, ss, se, ah,
                                      al, cond)
                    done = True
                else:
                    pos, done = _huffman_scan(data, pos, eoi_fill, multi, sos_end, comps, coefs,
                                              qtables, (dc_luts, ac_luts), defs, sel, restart,
                                              mcus, frame.progressive, ss, se, ah, al)
                if not done:
                    raise _truncated("the data end inside a scan, where libjpeg's read-ahead "
                                     "wants more")
                single_done = not multi
        else:
            if not eoi_fill and multi:  # jpeg_start_decompress reads a multi-scan file to its EOI
                raise _truncated("a multi-scan file without its EOI marker")
    except (ValueError, IndexError, KeyError, struct.error):
        # libtiff ignores what jpeg_finish_decompress refuses: once a single
        # scan's last line is out, the markers after it cannot fail a strip
        if not (eoi_fill and single_done):
            raise
    if tables_only:
        return qtables, dc_luts, ac_luts, defs
    if frame is None:
        raise ValueError("corrupt JPEG data: no frame (SOF marker)")
    if not scans:  # libjpeg's JERR_NO_IMAGE, as libtiff's jpeg_read_header meets it
        raise ValueError("corrupt JPEG data: no scan (SOS marker)")
    if frame.lossless and scans and len(frame.scanned) < len(comps):
        raise ValueError("lossless JPEG with a component no scan decoded (libjpeg-turbo "
                         "refuses it)")
    if keep is not None:  # the tables the decompressor holds at the end
        keep.append((qtables, dc_luts, ac_luts, defs))
    return frame, comps, coefs, jfif, adobe, adobe_transform


def _huffman_scan(data, pos, eoi_fill, multi, sos_end, comps, coefs, qtables, luts, defs,
                  sel, restart, mcus, progressive, ss, se, ah, al):
    """A Huffman-coded DCT scan, its restart intervals read as
    read_restart_marker reads them -> (the position of the marker after
    it, whether Pillow's source lets libjpeg finish it)."""
    tabs = {}
    for ci, td, ta in sel:
        c = comps[ci]
        if c.qtable is None:
            c.qtable = qtables[c.tq]
        # the tables start_pass derives: both in a sequential scan, DC in a
        # first DC scan, AC in an AC scan
        keys = ([(0, td), (1, ta)] if not progressive else [] if ss == 0 and ah
                else [(0, td)] if ss == 0 else [(1, ta)])
        for key in keys:  # jdhuff.c takes the standard tables, jdphuff.c does not
            _derived_table(key, luts, defs, 15, standard=not progressive)
        tabs[ci] = (coefs[ci], luts[0].get(td), luts[1].get(ta))
    units = _scan_units(comps, [ci for ci, _, _ in sel], mcus)
    step = max(restart or len(units), 1)  # MCUs a restart interval
    stop = len(data)
    marker = want = 0
    flag = False  # libjpeg's insufficient_data: the interval's data ran out
    seg_end, start, marked = pos, pos, False
    for j in range(0, len(units), step):
        if j:
            pos, marker, ok = _read_restart(data, seg_end, marker, want, stop)
            want = (want + 1) & 7
            if not ok:  # read_restart_marker waits for a marker past the end
                return stop, False
            if not marker:
                flag = False
        if marker:  # an interval left against a marker: no data
            seg, seg_end, marked = b"", pos, True
        else:
            seg, seg_end, marked = _entropy_data(data, pos, stop)
        start = pos
        if flag:  # still out of data: its MCUs are skipped
            continue
        words, limit, chunk = _words(seg), 8 * len(seg), units[j:j + step]
        if not progressive:
            p = _seq(words, chunk, limit, tabs, len(comps))
        elif ss == 0:
            p = (_dc_refine(words, chunk, limit, tabs, al) if ah
                 else _dc_first(words, chunk, limit, tabs, len(comps), al))
        elif ah:
            p = _ac_refine(words, chunk, limit, tabs, ss, se, al)
        else:
            p = _ac_first(words, chunk, limit, tabs, ss, se, al)
        flag = p > limit
    end = pos - 2 if marker else seg_end
    if eoi_fill or multi or marked:
        return end, True
    # a single scan whose last interval's data end the file without a
    # marker: does libjpeg's read-ahead want bytes past them before the
    # last MCU?
    last = (len(units) - 1) // step * step
    raw, _, _ = _entropy_data(data, start, stop)
    ends = _raw_ends(data[start:stop])
    if restart:  # the slow path only, which Pillow's blocks do not change
        call, fast = 1 << 40, False
    else:
        call, fast = max(1, -(-sos_end // BLOCK)), True
    return end, not _huffman_suspends(_words(raw), 8 * len(raw), units[last:], tabs, ends,
                                      start, stop, call, fast)


def _arith_scan(data, pos, stop, frame, comps, qtables, sel, restart, mcus, ss, se, ah, al,
                cond) -> int:
    """An arithmetic-coded scan, its restart intervals read as
    read_restart_marker reads them -> the position of the marker after it.
    Data needed at or past ``stop`` refuse the file."""
    for ci, _, _ in sel:
        c = comps[ci]
        if c.qtable is None:
            c.qtable = qtables[c.tq]
    scan = [ci for ci, _, _ in sel]
    units, slots = _unit_table(comps, scan, mcus, frame.offsets)
    dc_tbl = np.array([td for _, td, _ in sel], np.int32)
    ac_tbl = np.array([ta for _, _, ta in sel], np.int32)
    if not frame.progressive:
        kind = jpeg_arith.SEQUENTIAL
    elif ss == 0:
        kind = jpeg_arith.DC_REFINE if ah else jpeg_arith.DC_FIRST
    else:
        kind = jpeg_arith.AC_REFINE if ah else jpeg_arith.AC_FIRST
    step = max(restart or len(units), 1)
    marker, want = 0, 0
    decoder = jpeg_arith.ScanDecoder(data, kind, ss, se, al, units, slots, dc_tbl, ac_tbl, cond,
                                     frame.flat)
    for j in range(0, len(units), step):
        if j:
            pos, marker, ok = _read_restart(data, pos, marker, want, stop)
            want = (want + 1) & 7
            if not ok:
                raise _truncated("arithmetic-coded data that run past the data libjpeg was "
                                 "handed (it cannot suspend)")
        pos, marker, status = decoder.segment(pos, stop, marker, j, step)
        if status:
            raise _truncated("arithmetic-coded data that run past the data libjpeg was "
                             "handed (it cannot suspend)")
    if marker:  # the marker the decoder met is the next one the marker reader reads
        return pos - 2
    return pos


def _lossless_scan(data, pos, eoi_fill, frame, comps, samples, sel, restart, mcus, psv, pt,
                   luts, defs):
    """A lossless scan into each of its components' samples -> (the
    position of the marker after it, whether Pillow's source lets libjpeg
    finish it)."""
    scan = [ci for ci, _, _ in sel]
    dc_luts = luts[0]
    for _, td, _ in sel:  # jdlhuff.c takes no standard table; categories up to 16
        _derived_table((0, td), luts, defs, 16, standard=False)
    if len(scan) > 1:
        per_row, rows = mcus
        layout = [(ci, v, h) for ci in scan for v in range(comps[ci].v)
                  for h in range(comps[ci].h)]
    else:
        c = comps[scan[0]]
        per_row, rows = c.w, c.hgt
        layout = [(scan[0], 0, 0)]
    if restart % per_row:
        raise ValueError(f"corrupt JPEG data: restart interval {restart} is not a multiple of "
                         f"the {per_row} MCUs of an MCU row")
    step = restart // per_row or rows
    luts = np.array([dc_luts[next(td for ci2, td, _ in sel if ci2 == ci)]
                     for ci, _, _ in layout], np.int32)
    tabsel = np.arange(len(layout), dtype=np.int32)
    diffs = np.zeros((rows, per_row, len(layout)), np.int32)
    reset = np.zeros(rows, bool)  # MCU rows at which the predictors restart
    marker, want, flag, done = 0, 0, False, True
    stop = len(data)
    for j in range(0, rows, step):
        n = min(step, rows - j)
        reset[j] = True
        if j:
            pos, marker, ok = _read_restart(data, pos, marker, want, stop)
            want = (want + 1) & 7
            if not ok:
                return pos, False
            if not marker:
                flag = False
        if marker:  # an interval left against a marker: no data
            seg, end, marked = b"", pos, True
        else:
            seg, end, marked = _entropy_data(data, pos, stop)
        got, out_from, flag, suspends = jpeg_lossless.decode_diffs(
            seg, marked or eoi_fill, flag, n, per_row, tabsel, luts)
        if suspends:
            return end, False
        diffs[j:j + n] = got
        reset[j + out_from:j + n] = True  # zero rows that restart the predictors
        if not marker:
            pos = end
    if marker:
        pos -= 2
    initial = 1 << (8 - pt - 1)
    for ci in scan:
        c = comps[ci]
        cols = [b for b, (k, _, _) in enumerate(layout) if k == ci]
        if len(scan) > 1:
            d = diffs[:, :, cols].reshape(rows, per_row, c.v, c.h).transpose(0, 2, 1, 3)
            d = d.reshape(rows * c.v, per_row * c.h)
            first = np.repeat(reset, c.v) & (np.arange(rows * c.v) % c.v == 0)
        else:
            d = diffs[:, :, 0]
            imcu = np.zeros(-(-rows // c.v), bool)
            np.logical_or.at(imcu, np.arange(rows) // c.v, reset)
            first = np.repeat(imcu, c.v)[:rows] & (np.arange(rows) % c.v == 0)
        d, first = d[:c.hgt, :c.w], first[:c.hgt]
        samples[ci][:] = (jpeg_lossless.undifference(d, first, psv, initial) << pt) & 0xFF
    return pos, done


def _unit_table(comps, scan, mcus, offsets) -> tuple[np.ndarray, np.ndarray]:
    """A scan's MCUs: (MCUs, blocks) offsets of each MCU's blocks into the
    flat coefficients whose components start at ``offsets``, in MCU order
    for several components and over the component's own blocks (not the
    MCU padding) for one; and (blocks,) the scan component of each."""
    if len(scan) == 1:
        c = comps[scan[0]]
        base = np.add.outer(np.arange(c.bh) * c.bw_pad, np.arange(c.bw)).reshape(-1, 1)
        return offsets[scan[0]] + 64 * base, np.zeros(1, np.int32)
    mcusx, mcusy = mcus
    parts, slots = [], []
    for k, ci in enumerate(scan):
        c = comps[ci]
        rows = np.arange(mcusy)[:, None, None, None] * c.v + np.arange(c.v)[None, None, :, None]
        cols = np.arange(mcusx)[None, :, None, None] * c.h + np.arange(c.h)[None, None, None, :]
        parts.append((offsets[ci] + 64 * (rows * c.bw_pad + cols)).reshape(mcusy * mcusx, -1))
        slots += [k] * (c.v * c.h)
    return np.concatenate(parts, axis=1), np.array(slots, np.int32)


def _scan_units(comps, scan, mcus) -> list:
    """Per MCU of a scan, its (component, block base) pairs in order (the
    Huffman decoders' form of ``_unit_table``)."""
    table, slots = _unit_table(comps, scan, mcus, np.zeros(len(comps), np.int64))
    owners = [scan[k] for k in slots.tolist()]
    return [list(zip(owners, row)) for row in table.tolist()]


def _planes(frame, comps, coefs) -> list:
    """Each component's samples after the IDCT (or the lossless samples)
    and upsampling, (H, W) int64: fancy upsampling where jdsample.c takes
    it, replication in lossless mode (whose one-sample data units
    jdsample.c never upsamples fancily)."""
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    smooth = frame.progressive and smoothing_applies(comps, frame.coef_bits)
    planes = []
    for c, zz in zip(comps, coefs):
        if frame.lossless:
            plane = np.repeat(np.repeat(zz, vmax // c.v, axis=0), hmax // c.h, axis=1)
        else:
            q = c.qtable if c.qtable is not None else np.zeros(64, np.int64)
            zz = np.asarray(zz, np.int64).reshape(-1, 64)
            nat = np.empty_like(zz)
            nat[:, NATURAL_ORDER] = zz
            if smooth:
                nat = smooth_blocks(nat, c, frame.coef_bits[len(planes)],
                                    -(-frame.height // (8 * vmax)))
            blocks = idct_islow(nat * q, ~nat[:, 8:].any(axis=1)).reshape(c.bh_pad, c.bw_pad,
                                                                           8, 8)
            plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh_pad * 8, c.bw_pad * 8)
            plane = _upsample(plane[:c.hgt, :c.w], hmax // c.h, vmax // c.v)
        planes.append(plane[:frame.height, :frame.width])
    return planes


def _reconstruct(frame, comps, coefs, jfif, adobe, adobe_transform) -> np.ndarray:
    """libjpeg's colour space guess (jdapimin.c's default_decompress_parms)
    and conversion to Pillow's RGB."""
    if jfif:
        rgb_stored = False
    elif adobe:
        rgb_stored = adobe_transform == 0
    else:  # component ids 'R', 'G', 'B', or a lossless file without either marker
        rgb_stored = frame.lossless or [c.cid for c in comps] == [82, 71, 66]
    ycck = len(comps) == 4 and adobe and adobe_transform != 0
    if frame.lossless and (ycck or (len(comps) == 3 and not rgb_stored)):
        raise ValueError("lossless JPEG whose colour space libjpeg would convert (it converts "
                         "none in lossless mode)")
    planes = _planes(frame, comps, coefs)
    rgba = np.full((frame.height, frame.width, 4), 255, np.uint8)
    if len(comps) == 1:
        rgba[..., :3] = planes[0][..., None].astype(np.uint8)
        return rgba
    if len(comps) == 4:
        rgba[..., :3] = cmyk_to_rgb(planes, ycck=ycck)
        return rgba
    if rgb_stored:
        rgba[..., :3] = np.stack(planes, axis=-1).astype(np.uint8)
    else:
        rgba[..., :3] = ycc_to_rgb(*planes)
    return rgba
