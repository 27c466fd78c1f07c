"""Lossless JPEG (SOF3) decoding, as libjpeg-turbo 3's jdlhuff.c, jddiffct.c
and jdlossls.c decode it for Pillow.

A scan is read in MCU rows (``decode_diffs``): each sample's difference is
a Huffman-coded magnitude category s (0-16) and s bits (none for 16, whose
difference is 32768), the bit reader libjpeg's (jdhuff.h): a code that
matches no entry takes 17 bits and reads as category 0; once the data of a
restart interval run out at a marker, the rest of that MCU row decodes
from zero bits and each later MCU row of the interval is all zero
differences and restarts the predictors, so it comes out at the centre
value (jdlhuff.c's ``insufficient_data``).  ``undifference`` then rebuilds
each component's samples (T.81 H.1.2.1): the first row of the scan, of
each restart interval and of each such zeroed row predicts its first
sample from 2**(P - Pt - 1) and the rest from the left; other rows predict
their first sample from above and the rest by the scan's predictor 1-7;
sums are modulo 2**16, and the output sample is the low 8 bits of the
value shifted left by the point transform Pt.

The per-sample loops run in C++ (``native/src/jpeg.cpp``);
``decode_diffs_python`` and ``undifference_python`` are their plain twins.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch import native

MIN_GET_BITS = 57  # libjpeg-turbo's bit buffer on 64-bit hosts fills to this depth


def _words(seg: bytes) -> list:
    b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def decode_diffs_python(seg: bytes, terminated: bool, flag: bool, rows: int, per_row: int,
                        tabsel: np.ndarray, luts: np.ndarray
                        ) -> tuple[np.ndarray, int, bool, bool]:
    """One restart interval: ``rows`` MCU rows of ``per_row`` MCUs, sample
    b of an MCU coded with ``luts[tabsel[b]]`` (65,536 entries of code
    length << 8 | category, the next 16 bits their index), from ``seg``,
    the interval's data with the byte stuffing removed; ``terminated``
    when a marker follows them, ``flag`` libjpeg's out-of-data flag at
    the interval's start.  -> ((rows, per_row, bpm) int32 differences,
    the first MCU row whose call began out of data (``rows`` if none), the
    flag at the interval's end, whether libjpeg's read-ahead suspends:
    data that end without a marker where its bit buffer wants more, which
    Pillow's source meets at the end of the file)."""
    bpm = len(tabsel)
    out = np.zeros((rows, per_row, bpm), np.int32)
    words = _words(seg)
    limit = 8 * len(seg)
    sel = [luts[t].tolist() for t in tabsel] if rows else []
    p = r = 0
    for row in range(rows):
        if flag:
            return out, row, True, False
        vals = []
        for _ in range(per_row):
            for b in range(bpm):
                e = sel[b][(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                n, s = e >> 8, e & 255
                if not terminated:
                    # the fills of HUFF_DECODE, jpeg_huff_decode and
                    # CHECK_BIT_BUFFER, each to MIN_GET_BITS
                    for need, take in ((8, 0),) + (((9, 9),) + ((1, 1),) * (n - 9) if n > 8
                                                   else ((0, n),)):
                        if r - p < need:
                            if limit - p < MIN_GET_BITS:
                                return out, rows, flag, True
                            r = (p + MIN_GET_BITS + 7) & ~7
                        p += take
                    if s and s != 16 and r - p < s:
                        if limit - p < MIN_GET_BITS:
                            return out, rows, flag, True
                        r = (p + MIN_GET_BITS + 7) & ~7
                else:
                    p += n
                if s == 16:
                    v = 32768
                elif s:
                    v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                else:
                    v = 0
                vals.append(v)
        out[row] = np.asarray(vals, np.int32).reshape(per_row, bpm)
        if p > limit:
            flag = True
    return out, rows, flag, False


def decode_diffs(seg, terminated, flag, rows, per_row, tabsel, luts):
    """``decode_diffs_python``'s result from the C++ loop, or from the twin
    where the library is missing."""
    got = native.jpeg_lossless_diffs(seg, terminated, flag, rows, per_row, tabsel, luts)
    if got is None:
        return decode_diffs_python(seg, terminated, flag, rows, per_row, tabsel, luts)
    return got


def undifference_python(diffs: np.ndarray, first: np.ndarray, predictor: int,
                        initial: int) -> np.ndarray:
    """(R, W) differences of one component -> its (R, W) 16-bit values:
    row y takes the first-row rule where ``first[y]`` (the first sample
    from ``initial``, the rest from the left), else the first sample from
    above and the rest by ``predictor`` (jdlossls.c's UNDIFFERENCE
    macros)."""
    d = diffs.astype(np.int64)
    out = np.zeros_like(d)
    rows, w = d.shape
    for y in range(rows):
        row = d[y]
        if first[y] or y == 0:
            x = np.cumsum(row)
            x += initial
            out[y] = x & 0xFFFF
            continue
        b = out[y - 1]
        c = np.concatenate([[0], b[:-1]])
        if predictor in (1, 4, 5):
            extra = (np.zeros(w, np.int64) if predictor == 1 else b - c if predictor == 4
                     else (b - c) >> 1)
            extra[0] = b[0]
            out[y] = np.cumsum(row + extra) & 0xFFFF
        elif predictor in (2, 3):
            pred = b if predictor == 2 else c
            pred = pred.copy()
            pred[0] = b[0]
            out[y] = (row + pred) & 0xFFFF
        else:
            a = (row[0] + b[0]) & 0xFFFF
            out[y, 0] = a
            for i in range(1, w):
                p = b[i] + ((a - c[i]) >> 1) if predictor == 6 else (a + b[i]) >> 1
                a = (row[i] + p) & 0xFFFF
                out[y, i] = a
    return out


def undifference(diffs: np.ndarray, first: np.ndarray, predictor: int,
                 initial: int) -> np.ndarray:
    """``undifference_python``'s result from the C++ loop, or from the twin
    where the library is missing."""
    got = native.jpeg_undifference(diffs, first, predictor, initial)
    return undifference_python(diffs, first, predictor, initial) if got is None else got
