"""Arithmetic-coded JPEG entropy decoding (SOF9, SOF10), as libjpeg-turbo's
jdarith.c decodes it for Pillow.

``ScanDecoder`` decodes one restart interval of one scan at a time into
the coefficient array (the C++ loop, or its twin ``decode_segment_python``):
the QM decoder of T.81 Annex D (``arith_decode``, with libjpeg's table
``jpeg_aritab``), the DC and AC statistics areas of each
conditioning table (64 and 256 bins, zeroed at the interval's start) with
their conditioning (a DAC segment's L, U and Kx, libjpeg's 0, 1 and 5
without one), and the five MCU procedures: sequential (``decode_mcu``,
coefficients 1-63 whatever the scan's Se), and the progressive DC first,
AC first, DC refine and AC refine.  As jdarith.c:

  * the decoder reads the scan's bytes with their stuffing; a marker it
    meets is kept (the interval's caller reads it as the restart marker)
    and zero bytes are fed from there on;
  * it cannot suspend: a byte it needs past the end of the data it was
    handed (``stop``) refuses the file (libjpeg's JERR_CANT_SUSPEND,
    which Pillow's suspending data source meets at the end of each 64 KB
    block it feeds; io/jpeg.py passes that bound);
  * a magnitude of 2**15 or more, or a run past coefficient 63 (the
    scan's Se in an AC scan), is libjpeg's "bad arithmetic code": the
    block's coefficients decoded so far stay, and the rest of the
    interval decodes nothing (``ct = -1``);
  * coefficients are JCOEF: 16 bits, wrapped.

The bin loop runs in C++ (``native/src/jpeg.cpp``, the parsers' library);
``decode_segment_python`` is its plain twin, which runs where the library
is missing and which the tests hold the C++ to.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch import native

# jpeg_aritab (jaricom.c): Qe << 16 | next index after an MPS << 8 | MPS
# switch << 7 | next index after an LPS; 113 is the fixed probability 0.5
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
)

# the MCU procedures
SEQUENTIAL, DC_FIRST, AC_FIRST, DC_REFINE, AC_REFINE = range(5)
# statuses
OK, CANT_SUSPEND = 0, 1


class _CantSuspend(Exception):
    pass


def decode_segment_python(data: bytes, pos: int, stop: int, marker: int, kind: int, ss: int,
                          se: int, al: int, units: np.ndarray, slots: np.ndarray,
                          dc_tbl: np.ndarray, ac_tbl: np.ndarray, cond: np.ndarray,
                          coef: np.ndarray) -> tuple[int, int, int]:
    """One restart interval: ``units`` (MCUs, blocks) the offsets into the
    int16 ``coef`` of each MCU's blocks in zigzag order, ``slots`` (blocks,)
    the scan component of each, ``dc_tbl``/``ac_tbl`` each scan
    component's conditioning table, ``cond`` (3, 16) each table's L, U and
    Kx; the data read from ``pos`` up to ``stop``, ``marker`` a marker the
    decoder already met (zeros are fed).  -> (the position after the last
    byte read, the marker met or 0, OK or CANT_SUSPEND)."""
    st_dc = [bytearray(64) for _ in range(16)]
    st_ac = [bytearray(256) for _ in range(16)]
    fixed = bytearray([113])
    nslots = len(dc_tbl)
    last, ctx = [0] * nslots, [0] * nslots
    dcl, dcu, ack = (list(map(int, r)) for r in cond)
    dct, act = list(map(int, dc_tbl)), list(map(int, ac_tbl))
    tab = ARITAB
    s = {"c": 0, "a": 0, "ct": -16, "pos": pos, "marker": marker}
    out = coef

    def byte():
        p = s["pos"]
        if p >= stop:
            raise _CantSuspend
        s["pos"] = p + 1
        return data[p]

    def decode(st, i):
        c, a, ct = s["c"], s["a"], s["ct"]
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if s["marker"]:
                    d = 0
                else:
                    d = byte()
                    if d == 0xFF:
                        d = byte()
                        while d == 0xFF:
                            d = byte()
                        if d == 0:
                            d = 0xFF
                        else:
                            s["marker"], d = d, 0
                c = (c << 8) | d
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        s["c"], s["a"], s["ct"] = c, a, ct
        return sv >> 7

    def wrap(v):
        return (v + 0x8000 & 0xFFFF) - 0x8000

    def dc_diff(k):
        """Figures F.19-F.24 for scan component ``k``: the DC difference,
        or None on a bad code."""
        t = dct[k]
        st = st_dc[t]
        i = ctx[k]
        if not decode(st, i):
            ctx[k] = 0
            return 0
        sign = decode(st, i + 1)
        i += 2 + sign
        m = decode(st, i)
        if m:
            i = 20
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        if m < (1 << dcl[t]) >> 1:
            ctx[k] = 0
        elif m > (1 << dcu[t]) >> 1:
            ctx[k] = 12 + sign * 4
        else:
            ctx[k] = 4 + sign * 4
        v = m
        i += 14
        m >>= 1
        while m:
            if decode(st, i):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_value(st, i, k, t):
        """The sign and magnitude of a nonzero AC coefficient at ``k``
        (bin ``i`` its S0), or None on a bad code."""
        sign = decode(fixed, 0)
        i += 2
        m = decode(st, i)
        if m and decode(st, i):
            m <<= 1
            i = 189 if k <= ack[t] else 217
            while decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        v = m
        i += 14
        m >>= 1
        while m:
            if decode(st, i):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    try:
        for mcu in units.tolist():
            if kind == DC_REFINE:
                for base in mcu:
                    if decode(fixed, 0):
                        out[base] = wrap(int(out[base]) | 1 << al)
                continue
            bad = False
            for b, base in enumerate(mcu):
                k = int(slots[b])
                if kind in (SEQUENTIAL, DC_FIRST):
                    v = dc_diff(k)
                    if v is None:
                        bad = True
                        break
                    last[k] = (last[k] + v) & 0xFFFF
                    out[base] = wrap(last[k] << al if kind == DC_FIRST else last[k])
                    if kind == DC_FIRST:
                        continue
                t = act[k]
                st = st_ac[t]
                if kind == AC_REFINE:
                    kex = se
                    while kex > 0 and not out[base + kex]:
                        kex -= 1
                    p1 = 1 << al
                    j = ss
                    while j <= se:
                        i = 3 * (j - 1)
                        if j > kex and decode(st, i):
                            break
                        while True:
                            c = int(out[base + j])
                            if c:
                                if decode(st, i + 2):
                                    out[base + j] = wrap(c - p1 if c < 0 else c + p1)
                                break
                            if decode(st, i + 1):
                                out[base + j] = wrap(-p1 if decode(fixed, 0) else p1)
                                break
                            i += 3
                            j += 1
                            if j > se:
                                bad = True
                                break
                        if bad:
                            break
                        j += 1
                    if bad:
                        break
                    continue
                lo, hi = (1, 63) if kind == SEQUENTIAL else (ss, se)
                j = lo
                while j <= hi:
                    i = 3 * (j - 1)
                    if decode(st, i):  # end of block
                        break
                    while not decode(st, i + 1):
                        i += 3
                        j += 1
                        if j > hi:
                            bad = True
                            break
                    if bad:
                        break
                    v = ac_value(st, i, j, t)
                    if v is None:
                        bad = True
                        break
                    out[base + j] = wrap(v << al if kind == AC_FIRST else v)
                    j += 1
                if bad:
                    break
            if bad:  # "bad arithmetic code": the interval decodes nothing more
                break
    except _CantSuspend:
        return s["pos"], s["marker"], CANT_SUSPEND
    return s["pos"], s["marker"], OK


class ScanDecoder:
    """The restart intervals of one scan, decoded into ``coef``: by the C++
    loop where the library loads (its arrays prepared once), else by
    ``decode_segment_python``."""

    def __init__(self, data: bytes, kind: int, ss: int, se: int, al: int, units: np.ndarray,
                 slots: np.ndarray, dc_tbl: np.ndarray, ac_tbl: np.ndarray, cond: np.ndarray,
                 coef: np.ndarray):
        self.data, self.scan = data, (kind, ss, se, al)
        self.arrays = (units, slots, dc_tbl, ac_tbl, cond, coef)
        self.native = native.jpeg_arith_prepare(data, units, slots, dc_tbl, ac_tbl, cond, coef)

    def segment(self, pos: int, stop: int, marker: int, first: int,
                count: int) -> tuple[int, int, int]:
        """MCUs ``first`` to ``first + count`` from ``pos`` -> (the position
        after the last byte read, the marker met or 0, OK or
        CANT_SUSPEND)."""
        if self.native is not None:
            return native.jpeg_arith_run(self.native, pos, stop, marker, *self.scan, first, count)
        units, *rest = self.arrays
        return decode_segment_python(self.data, pos, stop, marker, *self.scan,
                                     units[first:first + count], *rest)
