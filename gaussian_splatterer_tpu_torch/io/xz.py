"""An xz (LZMA2) decoder that gives the bytes liblzma writes before it meets
damage, for io/tiff.py's LZMA strips.

libtiff's LZMADecode asks liblzma for a whole strip in one ``lzma_code``
call and keeps the strip when the output buffer is full, even where that
call reports "Corrupt input data": liblzma writes each byte as it decodes
it and checks some damage only afterwards (a range coder that does not end
at zero where an LZMA2 chunk ends, a match cut by the chunk's end, a chunk
that used more input than its header says, the block's check).  Python's
``lzma`` drops the output of a call that raises, so io/tiff.py decodes a
strip with ``lzma`` and, where it raises, runs this decoder for the bytes
liblzma wrote.

``decode_until_error`` reads one xz stream: its header (magic, flags and
their CRC32), the first block's header (its CRC32, an LZMA2 filter, after
a delta filter as libtiff chains them, the dictionary size) and the
block's LZMA2 chunks (control bytes, dictionary and state resets,
properties, uncompressed chunks; the LZMA range coder with its literal,
match and rep states, as xz's lzma_decoder.c), then undoes the delta
filter on what LZMA2 wrote.  It stops where liblzma reports an error or runs out of
input, or at ``size`` bytes, and returns what was written by then.  What
follows the block's data cannot change a strip that is already full.

The decoder runs in C++ (``native/src/xz.cpp``); ``decode_until_error_python``
is its plain twin.
"""

from __future__ import annotations

import zlib

from gaussian_splatterer_tpu_torch import native

MAGIC = b"\xfd7zXZ\x00"


class _Stop(Exception):
    """liblzma stops: an error, or no more input."""


class _Range:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos
        if pos + 5 > len(data):
            raise _Stop
        if data[pos]:  # rc_read_init: the first byte is always 0
            raise _Stop
        self.code = int.from_bytes(data[pos + 1:pos + 5], "big")
        self.range = 0xFFFFFFFF
        self.pos = pos + 5

    def _normalize(self):
        if self.range < 1 << 24:
            if self.pos >= len(self.data):
                raise _Stop
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self.data[self.pos]) & 0xFFFFFFFF
            self.pos += 1

    def bit(self, probs: list, i: int) -> int:
        self._normalize()
        p = probs[i]
        bound = (self.range >> 11) * p
        if self.code < bound:
            self.range = bound
            probs[i] = p + ((2048 - p) >> 5)
            return 0
        self.range -= bound
        self.code -= bound
        probs[i] = p - (p >> 5)
        return 1

    def tree(self, probs: list, base: int, bits: int) -> int:
        m = 1
        for _ in range(bits):
            m = (m << 1) | self.bit(probs, base + m)
        return m - (1 << bits)

    def reverse(self, probs: list, base: int, bits: int) -> int:
        m, sym = 1, 0
        for i in range(bits):
            b = self.bit(probs, base + m)
            m = (m << 1) | b
            sym |= b << i
        return sym

    def direct(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            self._normalize()
            self.range >>= 1
            b = 1 if self.code >= self.range else 0
            if b:
                self.code -= self.range
            v = (v << 1) | b
        return v


class _Lzma:
    """The LZMA state of an LZMA2 stream: probabilities, reps, state."""

    def __init__(self, props: int):
        self.lc, self.lp, self.pb = props % 9, (props // 9) % 5, props // 45
        n = 0x300 << (self.lc + self.lp)
        self.literal = [1024] * n
        self.is_match = [1024] * (12 << 4)
        self.is_rep, self.is_rep0, self.is_rep1, self.is_rep2 = ([1024] * 12 for _ in range(4))
        self.is_rep0_long = [1024] * (12 << 4)
        self.dist_slot = [1024] * (4 << 6)
        self.dist_special = [1024] * 115
        self.align = [1024] * 16
        self.match_len = _Len()
        self.rep_len = _Len()
        self.state = 0
        self.reps = [0, 0, 0, 0]


class _Len:
    def __init__(self):
        self.choice = [1024, 1024]
        self.low = [1024] * (16 << 3)
        self.mid = [1024] * (16 << 3)
        self.high = [1024] * 256

    def decode(self, rc: _Range, pos_state: int) -> int:
        if not rc.bit(self.choice, 0):
            return 2 + rc.tree(self.low, pos_state << 3, 3)
        if not rc.bit(self.choice, 1):
            return 10 + rc.tree(self.mid, pos_state << 3, 3)
        return 18 + rc.tree(self.high, 0, 8)


def _dict_size(b: int) -> int:
    """The LZMA2 filter's dictionary size byte -> liblzma's dictionary
    (at least 4 KiB, a multiple of 16)."""
    if b > 40:
        raise _Stop
    size = 0xFFFFFFFF if b == 40 else (2 | (b & 1)) << (b // 2 + 11)
    return max(4096, (size + 15) & ~15)


def _vli(data: bytes, pos: int, end: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= end or shift > 56:
            raise _Stop
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            if b == 0 and shift > 7:
                raise _Stop
            return v, pos


def _block_header(data: bytes, pos: int) -> tuple[int, int, int]:
    """The xz stream header and first block header -> (the LZMA2 data's
    offset, its dictionary size, the distance of a delta filter before it
    or 0: libtiff's chain)."""
    if data[:6] != MAGIC or len(data) < 12:
        raise _Stop
    if data[6] or data[7] > 15 or zlib.crc32(data[6:8]) != int.from_bytes(data[8:12], "little"):
        raise _Stop
    pos = 12
    if pos >= len(data) or data[pos] == 0:  # no block: an index
        raise _Stop
    size = (data[pos] + 1) * 4
    end = pos + size
    if end > len(data) or zlib.crc32(data[pos:end - 4]) != int.from_bytes(data[end - 4:end],
                                                                             "little"):
        raise _Stop
    flags = data[pos + 1]
    if flags & 0x3C or flags & 3 > 1:  # reserved bits; LZMA2, or delta and LZMA2
        raise _Stop
    p = pos + 2
    if flags & 0x40:
        _, p = _vli(data, p, end - 4)
    if flags & 0x80:
        _, p = _vli(data, p, end - 4)
    delta = 0
    for k in range((flags & 3) + 1):
        fid, p = _vli(data, p, end - 4)
        psize, p = _vli(data, p, end - 4)
        if psize != 1 or p + 1 > end - 4 or fid != (0x21 if k == flags & 3 else 0x03):
            raise _Stop
        if fid == 0x03:
            delta = data[p] + 1
        else:
            dsize = _dict_size(data[p])
        p += 1
    if any(data[p:end - 4]):
        raise _Stop
    return end, dsize, delta


def decode_until_error_python(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes of the xz stream ``data``, or fewer: those
    liblzma writes before it reports an error or runs out of input."""
    out = bytearray()
    delta = 0
    try:
        pos, dsize, delta = _block_header(data, 0)
        _lzma2(data, pos, dsize, size, out)
    except _Stop:
        pass
    if delta:  # liblzma's delta filter decodes whatever LZMA2 wrote
        for i in range(delta, len(out)):
            out[i] = (out[i] + out[i - delta]) & 0xFF
    return bytes(out[:size])


def _lzma2(data: bytes, pos: int, dsize: int, size: int, out: bytearray) -> None:
    need_dict_reset, need_props = True, True
    lz = None
    start = 0  # the output offset of the last dictionary reset
    while len(out) < size:
        if pos >= len(data):
            raise _Stop
        control = data[pos]
        pos += 1
        if control == 0:
            raise _Stop  # the stream's end, short of the strip
        if control >= 0xE0 or control == 1:
            need_props = need_dict_reset = True
        elif need_dict_reset:
            raise _Stop
        if need_dict_reset:
            need_dict_reset = False
            start = len(out)
        if control >= 0x80:
            if pos + 4 > len(data):
                raise _Stop
            unpacked = ((control & 0x1F) << 16 | data[pos] << 8 | data[pos + 1]) + 1
            packed = (data[pos + 2] << 8 | data[pos + 3]) + 1
            pos += 4
            if control >= 0xC0:
                if pos >= len(data):
                    raise _Stop
                props = data[pos]
                pos += 1
                if props > 224 or props % 9 + (props // 9) % 5 > 4:
                    raise _Stop
                lz = _Lzma(props)
                need_props = False
            elif need_props:
                raise _Stop
            elif control >= 0xA0:
                lz = _Lzma(lz.lc + 9 * lz.lp + 45 * lz.pb)
            used = _lzma_chunk(lz, data, pos, unpacked, size, dsize, start, out)
            if used is None:  # the strip filled inside the chunk
                return
            if used != packed:  # more input than the chunk header says, or less
                raise _Stop
            pos += packed
        else:
            if control > 2:
                raise _Stop
            if pos + 2 > len(data):
                raise _Stop
            n = (data[pos] << 8 | data[pos + 1]) + 1
            pos += 2
            chunk = data[pos:pos + n]
            out += chunk[:size - len(out)]
            if len(chunk) < n:
                raise _Stop
            pos += n


def _lzma_chunk(lz: _Lzma, data: bytes, pos: int, unpacked: int, size: int, dsize: int,
                start: int, out: bytearray):
    """One LZMA chunk into ``out`` -> the input bytes it used, or None
    where ``out`` reached ``size`` first."""
    rc = _Range(data, pos)
    limit = min(len(out) + unpacked, size)
    end = len(out) + unpacked
    pb_mask, lp_mask = (1 << lz.pb) - 1, (1 << lz.lp) - 1
    lc = lz.lc
    reps = lz.reps
    while len(out) < limit:
        n = len(out)
        pos_state = (n - start) & pb_mask
        state = lz.state
        if not rc.bit(lz.is_match, (state << 4) + pos_state):
            prev = out[n - 1] if n > start else 0
            base = 0x300 * ((((n - start) & lp_mask) << lc) + (prev >> (8 - lc)))
            if state < 7:
                sym = 1
                while sym < 0x100:
                    sym = (sym << 1) | rc.bit(lz.literal, base + sym)
            else:
                match = out[n - reps[0] - 1]
                sym, offset = 1, 0x100
                while sym < 0x100:
                    match <<= 1
                    mbit = match & offset
                    b = rc.bit(lz.literal, base + offset + mbit + sym)
                    sym = (sym << 1) | b
                    offset &= mbit if b else ~mbit
            out.append(sym & 0xFF)
            lz.state = 0 if state < 4 else state - 3 if state < 10 else state - 6
            continue
        full = min(n - start, dsize)
        if not rc.bit(lz.is_rep, state):
            lz.state = 7 if state < 7 else 10
            length = lz.match_len.decode(rc, pos_state)
            slot = rc.tree(lz.dist_slot, min(length - 2, 3) << 6, 6)
            if slot < 4:
                dist = slot
            else:
                bits = (slot >> 1) - 1
                dist = (2 | (slot & 1)) << bits
                if slot < 14:
                    dist += rc.reverse(lz.dist_special, dist - slot - 1, bits)
                else:
                    dist += rc.direct(bits - 4) << 4
                    dist += rc.reverse(lz.align, 0, 4)
            reps[3], reps[2], reps[1] = reps[2], reps[1], reps[0]
            reps[0] = dist & 0xFFFFFFFF
            if reps[0] == 0xFFFFFFFF or reps[0] >= full:  # end marker, or past the dictionary
                raise _Stop
        else:
            if full == 0:
                raise _Stop
            if not rc.bit(lz.is_rep0, state):
                if not rc.bit(lz.is_rep0_long, (state << 4) + pos_state):
                    lz.state = 9 if state < 7 else 11
                    out.append(out[n - reps[0] - 1])
                    continue
            else:
                if not rc.bit(lz.is_rep1, state):
                    dist = reps[1]
                else:
                    if not rc.bit(lz.is_rep2, state):
                        dist = reps[2]
                    else:
                        dist = reps[3]
                        reps[3] = reps[2]
                    reps[2] = reps[1]
                reps[1] = reps[0]
                reps[0] = dist
            lz.state = 8 if state < 7 else 11
            length = lz.rep_len.decode(rc, pos_state)
        src = n - reps[0] - 1
        take = min(length, limit - n)
        for i in range(take):
            out.append(out[src + i])
        if take < length and len(out) >= size:
            return None
        if take < length:  # a match cut by the chunk's end
            raise _Stop
    if len(out) >= size and len(out) < end:
        return None
    if rc.code:  # the range coder must end at zero
        if len(out) >= size:
            return None
        raise _Stop
    return rc.pos - pos


def decode_until_error(data: bytes, size: int) -> bytes:
    """``decode_until_error_python``'s bytes from the C++ decoder, or from
    the twin where the library is missing."""
    got = native.xz_until_error(data, size)
    return decode_until_error_python(data, size) if got is None else got
