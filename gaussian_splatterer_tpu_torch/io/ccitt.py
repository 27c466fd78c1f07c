"""CCITT fax decoding for TIFF (io/tiff.py): compression 2 (modified
Huffman), 3 (Group 3, one- or two-dimensional) and 4 (Group 4), as libtiff
decodes them for Pillow, recovery from bad code words included.

``decode_fax(data, state, rows, lsb_first)`` runs the native loop
(``native/src/codecs.cpp``) when the native library is built, else
``decode_fax_python``, its plain twin: both give the same rows and the same
status for every input, broken ones included.

The decoder is libtiff's state machine (tif_fax3.c): runs of alternating
white and black pixels, white first, decoded by table lookups over a bit
accumulator read from the low bit (``lsb_first`` is ``FillOrder`` 2, else
each byte is reversed first); each row is cleaned up so its runs sum to the
width (a short row padded white, a long one cut), then filled into the row
with white as 0 and black as 1.  Group 3 finds an EOL (eleven zeros, then
zero fill, then a 1) before each row, and a two-dimensional file's tag bit
after it; modified Huffman rows start on a byte; Group 4 codes every row
against the one above (all white before the first) and ends a strip at an
EOFB.  A bad code word ends the row where it stands (the rest white);
running out of data, or more runs than libtiff's run arrays hold, fails the
strip, except that a Group 4 strip with at least one whole row stops there
and keeps the rows after it from the buffer (``FaxState.buffer``, Pillow's
strip buffer, reused from strip to strip).  The run arrays also persist
from strip to strip, as libtiff's do.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatterer_tpu_torch import native

OK, FAILED, UNKNOWN = 1, -1, 0
_M32 = 0xFFFFFFFF

# T.4's codes as (run, code bits): terminating and make-up, white and black,
# and the extended make-up codes both colours share
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 "
               "000000011110 000000011111").split()

# the states of libtiff's tables (tif_fax3.h)
(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB,
 S_MAKEUP, S_EOL) = range(13)


def _table(size: int, codes) -> np.ndarray:
    """(state, width, param) for every ``size``-bit lookup, the first bit
    of the stream in the low bit of the index (mkg3states.c's FillTable)."""
    t = np.zeros((1 << size, 3), np.int64)
    for bits, state, param in codes:
        w = len(bits)
        low = sum(int(c) << i for i, c in enumerate(bits))
        t[low::1 << w] = (state, w, param)
    return t


def _tables():
    main = [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0), ("011", S_VR, 1),
            ("000011", S_VR, 2), ("0000011", S_VR, 3), ("010", S_VL, 1), ("000010", S_VL, 2),
            ("0000010", S_VL, 3), ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)]
    ext = [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
    eol = [("0" * 11, S_EOL, 0)]
    white = ([(c, S_TERMW, i) for i, c in enumerate(_WHITE_TERM)]
             + [(c, S_MAKEUPW, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP)] + ext + eol)
    black = ([(c, S_TERMB, i) for i, c in enumerate(_BLACK_TERM)]
             + [(c, S_MAKEUPB, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP)] + ext + eol)
    return _table(7, main), _table(12, white), _table(13, black)


MAIN, WHITE, BLACK = _tables()
_NATIVE = {}


def native_table(name: str) -> np.ndarray:
    """The table ``name`` ("main", "white", "black") as contiguous int32
    (state, width, param) triples, for the native loop."""
    if name not in _NATIVE:
        _NATIVE[name] = np.ascontiguousarray({"main": MAIN, "white": WHITE,
                                              "black": BLACK}[name], np.int32)
    return _NATIVE[name]
_MAIN, _WHITE, _BLACK = (t.tolist() for t in (MAIN, WHITE, BLACK))
_BITREV = [int(f"{b:08b}"[::-1], 2) for b in range(256)]


class FaxState:
    """What persists from strip to strip of one image: the run arrays and
    the row buffer.  ``comp`` is the TIFF compression (2, 3 or 4) and
    ``t4`` the ``T4Options`` (bit 0: two-dimensional Group 3)."""

    def __init__(self, width: int, comp: int, t4: int = 0):
        self.width, self.comp = width, comp
        self.two_d = comp == 4 or (comp == 3 and bool(t4 & 1))
        # libtiff's nruns, the runs a row may hold
        self.nruns = -(-(width + 1) // 32) * 32 * (2 if self.two_d else 1)
        self.runs = np.zeros(2 * self.nruns + 4, np.uint32)
        self.buffer = np.zeros((0, -(-width // 8)), np.uint8)
        self.written = 0  # buffer rows an earlier strip wrote

    def rows(self, n: int) -> np.ndarray:
        """The buffer grown to ``n`` rows (new rows zero), as the decoder's
        output."""
        if self.buffer.shape[0] < n:
            grown = np.zeros((n, self.buffer.shape[1]), np.uint8)
            grown[:self.buffer.shape[0]] = self.buffer
            self.buffer = grown
        return self.buffer


class _Fail(Exception):
    pass


class _EOF(Exception):
    pass


def _i32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v & 0x80000000 else v


class _Decoder:
    """One strip's decode, statement for statement as tif_fax3.c."""

    def __init__(self, data: bytes, st: FaxState, lsb_first: bool):
        self.data, self.cp, self.ep = data, 0, len(data)
        self.bitmap = list(range(256)) if lsb_first else _BITREV
        self.acc = self.avail = 0
        self.runs, self.nruns, self.lastx = st.runs, st.nruns, st.width
        self.eolcnt = 0

    # -- the bit accumulator --
    def need8(self, n):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _EOF
                self.avail = n
            else:
                self.acc |= self.bitmap[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8

    def need16(self, n):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _EOF
                self.avail = n
            else:
                self.acc |= self.bitmap[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
                if self.avail < n:
                    if self.cp >= self.ep:
                        self.avail = n
                    else:
                        self.acc |= self.bitmap[self.data[self.cp]] << self.avail
                        self.cp += 1
                        self.avail += 8

    def get(self, n):
        return self.acc & ((1 << n) - 1)

    def clr(self, n):
        self.avail -= n
        self.acc >>= n

    def lookup(self, table, width, wide):
        (self.need16 if wide else self.need8)(width)
        ent = table[self.acc & ((1 << width) - 1)]
        self.clr(ent[1])
        return ent

    # -- runs --
    def setvalue(self, x):
        if self.pa >= self.thisrun + self.nruns:
            raise _Fail
        self.runs[self.pa] = (self.run + x) & _M32
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run = 0

    def cleanup(self):
        if self.run:
            self.setvalue(0)
        lastx = self.lastx
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _i32(self.a0 - int(self.runs[self.pa]))
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def sync_eol(self):
        if self.eolcnt == 0:
            while True:
                self.need16(11)
                if self.get(11) == 0:
                    break
                self.clr(1)
        while True:
            self.need8(8)
            if self.get(8):
                break
            self.clr(8)
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def _colour(self, table, width, term):
        """One run of a colour: make-up codes then a terminating code;
        False at an EOL or a bad code word."""
        while True:
            state, _, param = self.lookup(table, width, True)
            if state == term:
                self.setvalue(param)
                return True
            if state in (S_MAKEUPW, S_MAKEUPB, S_MAKEUP) and state != (
                    S_MAKEUPB if term == S_TERMW else S_MAKEUPW):
                self.a0 = _i32(self.a0 + param)
                self.run = _i32(self.run + param)
                continue
            if state == S_EOL:
                self.eolcnt = 1
            return False

    def expand1d(self) -> bool:
        """EXPAND1D: True at the row's end, False at premature EOF (after
        the cleanup)."""
        try:
            while True:
                if not self._colour(_WHITE, 12, S_TERMW) or self.a0 >= self.lastx:
                    break
                if not self._colour(_BLACK, 13, S_TERMB) or self.a0 >= self.lastx:
                    break
                if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                    self.pa -= 2
        except _EOF:
            self.cleanup()
            return False
        self.cleanup()
        return True

    def check_b1(self):
        if self.pa != self.thisrun:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.refruns + self.nruns:
                    raise _Fail
                self.b1 = _i32(self.b1 + int(self.runs[self.pb]) + int(self.runs[self.pb + 1]))
                self.pb += 2

    def next_b(self):
        if self.pb >= self.refruns + self.nruns:
            raise _Fail
        self.b1 = _i32(self.b1 + int(self.runs[self.pb]))
        self.pb += 1

    def expand2d(self) -> bool:
        """EXPAND2D: True at the row's end, False at premature EOF (after
        the cleanup)."""
        lastx = self.lastx
        try:
            while self.a0 < lastx:
                if self.pa >= self.thisrun + self.nruns:
                    raise _Fail
                state, _, param = self.lookup(_MAIN, 7, False)
                if state == S_PASS:
                    self.check_b1()
                    self.next_b()
                    self.run = _i32(self.run + self.b1 - self.a0)
                    self.a0 = self.b1
                    self.next_b()
                elif state == S_HORIZ:
                    first, second = ((_BLACK, 13, S_TERMB), (_WHITE, 12, S_TERMW)) if (
                        (self.pa - self.thisrun) & 1) else ((_WHITE, 12, S_TERMW),
                                                            (_BLACK, 13, S_TERMB))
                    if not self._colour(*first) or not self._colour(*second):
                        self.eolcnt = 0  # a bad code word, not an EOL, in this mode
                        break
                    self.check_b1()
                elif state == S_V0:
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0)
                    self.next_b()
                elif state == S_VR:
                    self.check_b1()
                    self.setvalue(self.b1 - self.a0 + param)
                    self.next_b()
                elif state == S_VL:
                    self.check_b1()
                    if self.b1 < _i32(self.a0 + param):
                        break
                    self.setvalue(self.b1 - self.a0 - param)
                    if self.pb == 0:  # before libtiff's run arrays
                        raise _Fail
                    self.pb -= 1
                    self.b1 = _i32(self.b1 - int(self.runs[self.pb]))
                elif state == S_EXT:
                    self.runs[self.pa] = (lastx - self.a0) & _M32
                    self.pa += 1
                    break
                elif state == S_EOL:
                    self.runs[self.pa] = (lastx - self.a0) & _M32
                    self.pa += 1
                    self.need8(4)
                    self.clr(4)
                    self.eolcnt = 1
                    break
                else:
                    break
            else:
                if self.run:
                    if self.run + self.a0 < lastx:  # expect a final V0
                        self.need8(1)
                        if not self.get(1):
                            self.cleanup()
                            return True
                        self.clr(1)
                    self.setvalue(0)
        except _EOF:
            self.cleanup()
            return False
        self.cleanup()
        return True

    def fill(self, row: np.ndarray):
        """_TIFFFax3fillruns: white runs clear bits, black runs set them;
        runs past the width are cut in the run array."""
        runs, lastx, erun = self.runs, self.lastx, self.pa
        if (erun - self.thisrun) & 1:  # the caller's pa stays where it was
            runs[erun] = 0
            erun += 1
        bits = np.unpackbits(row)
        x = 0
        for k in range(self.thisrun, erun, 2):
            for j, v in ((k, 0), (k + 1, 1)):
                run = int(runs[j])
                if x + run > lastx or run > lastx:
                    run = lastx - x
                    runs[j] = run & _M32
                if run:
                    bits[x:x + run] = v
                    x += run
        row[:] = np.packbits(bits)[:row.size]

    # -- the strip decoders --
    def start_row(self):
        self.a0 = self.run = 0
        self.pa = self.thisrun

    def decode(self, st: FaxState, out: np.ndarray) -> int:
        """The strip's status; ``end``, the rows it wrote."""
        rows = self.end = out.shape[0]
        self.thisrun, self.refruns = 0, self.nruns
        if st.two_d:
            self.runs[self.refruns] = self.lastx
            self.runs[self.refruns + 1] = 0
        try:
            for line in range(rows):
                self.start_row()
                if st.comp != 4:
                    if st.comp == 3:
                        try:  # the EOL, and a two-dimensional file's tag bit
                            self.sync_eol()
                            if st.two_d:
                                self.need8(1)
                                one_d = self.get(1)
                                self.clr(1)
                        except _EOF:
                            self.cleanup()
                            self.fill(out[line])
                            return UNKNOWN
                    if st.two_d:
                        self.pb = self.refruns
                        self.b1 = _i32(int(self.runs[self.pb]))
                        self.pb += 1
                    whole = self.expand1d() if not st.two_d or one_d else self.expand2d()
                    self.fill(out[line])
                    if not whole:  # Pillow stops at a Group 3 strip's end of data
                        return FAILED if st.comp == 2 else UNKNOWN
                    if st.comp == 2:
                        self.clr(self.avail & 7)  # each row starts on a byte
                    if st.two_d:
                        if self.pa < self.thisrun + self.nruns:
                            self.setvalue(0)
                        self.thisrun, self.refruns = self.refruns, self.thisrun
                    continue
                self.pb = self.refruns
                self.b1 = _i32(int(self.runs[self.pb]))
                self.pb += 1
                if not self.expand2d() or self.eolcnt:  # Group 4's end: EOFB or no data
                    try:
                        self.need16(13)
                    except _EOF:
                        pass
                    self.clr(13)
                    self.fill(out[line])
                    self.end = line + 1
                    return OK if line else FAILED
                self.fill(out[line])
                self.setvalue(0)
                self.thisrun, self.refruns = self.refruns, self.thisrun
        except _Fail:
            return FAILED
        return OK


def decode_fax_python(data: bytes, st: FaxState, rows: int, lsb_first: bool
                      ) -> tuple[np.ndarray, int, int]:
    """One strip or tile into st's buffer -> ((rows, row bytes) uint8, bit 1
    black; status ``OK`` or ``FAILED``; the rows written, fewer than
    ``rows`` where a Group 4 strip ends early)."""
    out = st.rows(rows)[:rows]
    dec = _Decoder(data, st, lsb_first)
    status = dec.decode(st, out)
    return out, status, dec.end


def finish(st: FaxState, rows: int, status: int, end: int) -> int:
    """The status of a strip, ``UNKNOWN`` where its rows after an early end
    come from buffer rows no strip wrote (Pillow's uninitialised memory)."""
    if status == OK and end < rows and rows > st.written:
        return UNKNOWN
    if status == OK:
        st.written = max(st.written, end)
    return status


def decode_fax(data: bytes, st: FaxState, rows: int, lsb_first: bool) -> np.ndarray:
    """``decode_fax_python``'s rows, from the native loop where the library
    is built; a strip libtiff fails, or one whose rows would be Pillow's
    uninitialised memory, raises ValueError."""
    got = native.fax_decode(data, st, rows, lsb_first)
    out, status, end = got if got is not None else decode_fax_python(data, st, rows, lsb_first)
    status = finish(st, rows, status, end)
    if status == UNKNOWN:
        raise ValueError("unsupported TIFF (CCITT data that ends early, where Pillow leaves "
                         "the rows after it uninitialised; fault C-5)")
    if status != OK:
        raise ValueError("corrupt TIFF CCITT data (a bad code word, too many runs, or data "
                         "that ends early)")
    return out.copy()
