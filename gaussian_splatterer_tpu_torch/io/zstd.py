"""Zstandard (RFC 8878) frames as libtiff's ZSTDDecode reads them through
libzstd 1.5.7, for io/tiff.py's compression 50000.

libtiff hands a whole strip or tile to one ``ZSTD_decompressStream`` loop
whose output buffer is the strip's size, and stops at the end of the first
frame, when the output is full, or when the input is spent.  Any error is a
refusal, and so is output shorter than the strip ("Not enough data at
scanline"); libtiff keeps no partial strip.  What follows the frame is never
read.  ``decode(data, size)`` gives the strip's ``size`` bytes or raises
ValueError with libzstd's reason.

The decoder follows libzstd's streaming decoder, not only the RFC, where
damaged input shows the difference:

  * frames: the magic (a skippable frame ends the loop with no output),
    the frame header descriptor and its reserved bit, the window
    descriptor, the dictionary ID (any but 0 is refused: libtiff loads no
    dictionary), the single-segment flag and the content size; a window
    above ``ZSTD_WINDOWLOG_LIMIT_DEFAULT`` (2^27 + 1 bytes) is refused as
    "Frame requires too much memory"; a frame whose content size is known
    and fits the strip, and whose blocks are all there, is decoded in one
    pass as libzstd does (no per-block size check on raw and RLE blocks);
  * blocks: raw (streamed as its bytes arrive), RLE, compressed and the
    reserved type; a block above ``Block_Maximum_Size`` (128 KiB, or the
    window where that is smaller) is refused; libzstd decodes each block
    whole into its own buffer, then copies what fits into the strip, and
    goes on to the next block only while the strip has room after it, so a
    block that would be read after the strip is full cannot fail it;
  * the XXH64 checksum, checked when the frame's end is reached;
  * literals: raw, RLE, Huffman-compressed and treeless (repeat), in one
    or four streams with the jump table, weights given directly or
    FSE-coded (with libzstd's workspace limit on their table), the last
    weight implied; libzstd's one-symbol decoder reads a stream to its
    exact last bit, its two-symbol decoder (HUF_selectDecoder's choice for
    four streams) ends a stream on an entry of two symbols for its last
    one, and its fast four-stream loops (a table log of 11 or less, every
    stream 8 bytes or more) check no stream's end at all, only that no
    loop read a byte before its stream's first: each is followed;
  * sequences: literal-length, offset and match-length codes in the
    predefined, RLE, FSE-compressed and repeat modes, the tables kept
    across blocks, the three repeat offsets with the rule for a literal
    length of 0; an offset past what the frame has written, or a literal
    or a match past its buffer, is corruption;
  * the memory libzstd decodes into: its ring buffer of the window and two
    blocks (a match before a wrap reads the older segment through it, as
    libzstd's extDict does), and a block's literals of more than 64 KiB
    kept partly at the end of the block's own room, where the block's
    output can overwrite them.

Where libzstd reads past the output it has written (a damaged offset that
reaches beyond the window into ring memory its wild copies overran) this
decoder reads what the ring held before; libtiff's strips never exceed
their window, so no TIFF reaches that.

The decoder runs in C++ (``native/src/zstd.cpp``); ``decode_python`` is its
plain twin.
"""

from __future__ import annotations

from gaussian_splatterer_tpu_torch import native

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50
_BLOCK_MAX = 128 << 10
_WINDOW_LIMIT = (1 << 27) + 1  # ZSTD_MAXWINDOWSIZE_DEFAULT
_LIT_EXTRA = 1 << 16  # ZSTD_LITBUFFEREXTRASIZE
_WILD = 32  # WILDCOPY_OVERLENGTH
_UNKNOWN = -1  # no content size

CORRUPT = "Data corruption detected"
TOO_SMALL = "Destination buffer is too small"
SRC_SIZE = "Src size is incorrect"

# RFC 8878 3.1.1.3.2.1: the codes' baselines and extra bits
_LL_BASE = (*range(16), 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 0x80, 0x100, 0x200, 0x400,
            0x800, 0x1000, 0x2000, 0x4000, 0x8000, 0x10000)
_LL_BITS = (0,) * 16 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
_ML_BASE = (*range(3, 35), 35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203,
            0x403, 0x803, 0x1003, 0x2003, 0x4003, 0x8003, 0x10003)
_ML_BITS = (0,) * 32 + (1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
_OF_BASE = (0, 1, 1, 5, 0xD, 0x1D, 0x3D, 0x7D, 0xFD, 0x1FD, 0x3FD, 0x7FD, 0xFFD, 0x1FFD, 0x3FFD,
            0x7FFD, 0xFFFD, 0x1FFFD, 0x3FFFD, 0x7FFFD, 0xFFFFD, 0x1FFFFD, 0x3FFFFD, 0x7FFFFD,
            0xFFFFFD, 0x1FFFFFD, 0x3FFFFFD, 0x7FFFFFD, 0xFFFFFFD, 0x1FFFFFFD, 0x3FFFFFFD,
            0x7FFFFFFD)
_OF_BITS = tuple(range(32))
# (the predefined distribution, its log, the largest code, the largest log)
_LL_NORM = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1,
            1, 1, 1, -1, -1, -1, -1)
_ML_NORM = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
_OF_NORM = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5
_KINDS = ((_LL_BASE, _LL_BITS, _LL_NORM, 6, 35, 9), (_OF_BASE, _OF_BITS, _OF_NORM, 5, 31, 8),
          (_ML_BASE, _ML_BITS, _ML_NORM, 6, 52, 9))


class ZstdError(ValueError):
    """libzstd (or libtiff) refuses the strip; ``kept`` is what libtiff's
    buffer holds then before its zeros: nothing after an error of libzstd
    (its output position is not moved), what was flushed where the input
    ran out."""

    def __init__(self, reason: str, kept: bytes = b""):
        super().__init__(reason)
        self.kept = kept


def _fail(reason: str, kept: bytes = b""):
    raise ZstdError(reason, kept)


def _highbit(v: int) -> int:
    return v.bit_length() - 1


# ---- XXH64 ---------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _round(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for lane in v:
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = ((_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1) + _P4) \
            & _M64
        p += 8
    if p + 4 <= n:
        h = ((_rotl(h ^ ((int.from_bytes(data[p:p + 4], "little") * _P1) & _M64), 23) * _P2)
             + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((data[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


# ---- bit streams ---------------------------------------------------------

class _Backward:
    """A backward bit stream (FSE, Huffman, sequences): read from its last
    bit toward its first, past the end-mark bit of its last byte; bits past
    its first read as zeros.  ``used`` counts the bits read."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start:
            _fail(SRC_SIZE)
        last = data[end - 1]
        if not last:
            _fail(CORRUPT)  # no end mark
        self.data, self.start = data, start
        self.total = 8 * (end - start - 1) + _highbit(last)
        self.used = 0

    def read(self, n: int) -> int:
        if not n:
            return 0
        lo = self.total - self.used - n  # the lowest bit read, from the stream's first
        self.used += n
        if lo + n <= 0:
            return 0
        if lo < 0:
            shift, n, lo = -lo, n + lo, 0
        else:
            shift = 0
        a, b = self.start + (lo >> 3), self.start + ((lo + n + 7) >> 3)
        v = int.from_bytes(self.data[a:b], "little") >> (lo & 7)
        return (v & ((1 << n) - 1)) << shift

    def overflow(self) -> bool:
        return self.used > self.total

    def done(self) -> bool:
        return self.used == self.total


def _le32(buf, at: int) -> int:
    return int.from_bytes(buf[at:at + 4], "little")


def read_ncount(src: bytes, start: int, size: int, max_symbol: int):
    """FSE_readNCount over ``src[start:start + size]``: (normalised counts,
    table log, bytes read), as libzstd reads them, its clamps at the
    buffer's end included; ZstdError where it fails."""
    if size < 8:
        buf = bytes(src[start:start + size]) + bytes(8 - size)
        norm, log, used = read_ncount(buf, 0, 8, max_symbol)
        if used > size:
            _fail(CORRUPT)
        return norm, log, used
    buf, ip, iend = src, start, start + size
    max_sv1 = max_symbol + 1
    norm = [0] * max_sv1
    stream = _le32(buf, ip)
    nb = (stream & 0xF) + 5
    if nb > 15:
        _fail("tableLog requires too much memory : unsupported")
    log = nb
    stream >>= 4
    count_bits = 4
    remaining = (1 << nb) + 1
    threshold = 1 << nb
    nb += 1
    charnum, previous0 = 0, False

    def advance(ip, count_bits):
        if ip <= iend - 7 or ip + (count_bits >> 3) <= iend - 4:
            return ip + (count_bits >> 3), count_bits & 7
        return iend - 4, (count_bits - 8 * (iend - 4 - ip)) & 31

    while True:
        if previous0:
            inv = (~stream | 0x80000000) & 0xFFFFFFFF
            repeats = ((inv & -inv).bit_length() - 1) >> 1
            while repeats >= 12:
                charnum += 36
                if ip <= iend - 7:
                    ip += 3
                else:
                    count_bits = (count_bits - 8 * (iend - 7 - ip)) & 31
                    ip = iend - 4
                stream = _le32(buf, ip) >> count_bits
                inv = (~stream | 0x80000000) & 0xFFFFFFFF
                repeats = ((inv & -inv).bit_length() - 1) >> 1
            charnum += 3 * repeats
            stream >>= 2 * repeats
            count_bits += 2 * repeats
            charnum += stream & 3
            count_bits += 2
            if charnum >= max_sv1:
                break
            ip, count_bits = advance(ip, count_bits)
            stream = _le32(buf, ip) >> count_bits
        mx = (2 * threshold - 1) - remaining
        if (stream & (threshold - 1)) < mx:
            count = stream & (threshold - 1)
            count_bits += nb - 1
        else:
            count = stream & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            count_bits += nb
        count -= 1
        remaining -= count if count >= 0 else 1
        norm[charnum] = count
        charnum += 1
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = _highbit(remaining) + 1
            threshold = 1 << (nb - 1)
        if charnum >= max_sv1:
            break
        ip, count_bits = advance(ip, count_bits)
        stream = _le32(buf, ip) >> count_bits
    if remaining != 1:
        _fail(CORRUPT)
    if charnum > max_sv1:
        _fail("Unsupported max Symbol Value : too small")
    if count_bits > 32:
        _fail(CORRUPT)
    return norm[:charnum], log, ip + ((count_bits + 7) >> 3) - start


def fse_table(norm, log: int) -> list:
    """The FSE decoding table of normalised counts: per state (symbol,
    bits to read, base of the next state)."""
    size = 1 << log
    high = size - 1
    symbols = [0] * size
    nxt = list(norm)
    for s, n in enumerate(norm):
        if n == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, n in enumerate(norm):
        for _ in range(max(n, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    table = []
    for s in symbols:
        state = nxt[s]
        nxt[s] += 1
        bits = log - _highbit(state)
        table.append((s, bits, (state << bits) - size))
    return table


def _seq_table(norm, log: int, kind: int) -> list:
    base, bits = _KINDS[kind][:2]
    return [(base[s], bits[s], nb, nxt) for s, nb, nxt in fse_table(norm, log)], log


_DEFAULT = [_seq_table(k[2], k[3], i) for i, k in enumerate(_KINDS)]


# ---- Huffman literals ----------------------------------------------------

def _fse_weights(src: bytes, start: int, size: int) -> list:
    """FSE_decompress_wksp of the Huffman weights (at most 255, log at most
    6, within libzstd's workspace)."""
    norm, log, used = read_ncount(src, start, size, 255)
    if log > 6:
        _fail("tableLog requires too much memory : unsupported")
    msv = len(norm) - 1
    # FSE_DECOMPRESS_WKSP_SIZE(log, msv) against HUF_READ_STATS_WORKSPACE (6, 11)
    need = (1 + (1 << log)) + 1 + -(-(2 * (msv + 1) + (1 << log) + 8) // 4) + 128 + 1
    if need > 219:
        _fail("tableLog requires too much memory : unsupported")
    table = fse_table(norm, log)
    bits = _Backward(src, start + used, start + size)
    s1, s2 = bits.read(log), bits.read(log)
    if bits.overflow():
        _fail(CORRUPT)
    out, states = [], [s1, s2]
    i = 0
    while True:
        if len(out) > 253:
            _fail(TOO_SMALL)
        sym, nb, base = table[states[i]]
        out.append(sym)
        states[i] = base + bits.read(nb)
        if bits.overflow():
            out.append(table[states[1 - i]][0])
            return out
        i = 1 - i


def huffman_table(src: bytes, start: int, size: int):
    """HUF_readStats and the table: ((code length, symbol) per value of the
    next ``log`` bits, log, bytes read)."""
    if size < 1:
        _fail(SRC_SIZE)
    head = src[start]
    if head >= 128:
        n = head - 127
        used = (n + 1) // 2
        if used + 1 > size:
            _fail(SRC_SIZE)
        if n >= 256:
            _fail(CORRUPT)
        weights = []
        for k in range(used):
            b = src[start + 1 + k]
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        used = head
        if used + 1 > size:
            _fail(SRC_SIZE)
        weights = _fse_weights(src, start + 1, used)
    total = 0
    for w in weights:
        if w > 12:
            _fail(CORRUPT)
        total += (1 << w) >> 1
    if total == 0:
        _fail(CORRUPT)
    log = _highbit(total) + 1
    if log > 12:
        _fail(CORRUPT)
    rest = (1 << log) - total
    if rest & (rest - 1):
        _fail(CORRUPT)  # the last weight must make a power of two
    weights.append(_highbit(rest) + 1)
    if weights.count(1) < 2 or weights.count(1) & 1:
        _fail(CORRUPT)
    # the codes: from weight 1 (the longest) up, symbols in order in each
    table = [None] * (1 << log)
    at = 0
    for w in range(1, log + 1):
        span = (1 << w) >> 1
        for s, sw in enumerate(weights):
            if sw == w:
                table[at:at + span] = [(log + 1 - w, s)] * span
                at += span
    return table, log, used + 1


# HUF_selectDecoder's timings: (table, per 256 symbols) of the one-symbol
# and the two-symbol decoder, by the quantised ratio of input to output
_ALGO_TIME = ((0, 0, 1, 1), (0, 0, 1, 1), (150, 216, 381, 119), (170, 205, 514, 112),
              (177, 199, 539, 110), (197, 194, 644, 107), (221, 192, 735, 107),
              (256, 189, 881, 106), (359, 188, 1167, 109), (582, 187, 1570, 114),
              (688, 187, 1712, 122), (825, 186, 1965, 136), (976, 185, 2131, 150),
              (1180, 186, 2070, 175), (1377, 185, 1731, 202), (1412, 185, 1695, 202))


def two_symbol_decoder(count: int, csize: int) -> bool:
    """HUF_selectDecoder: True where libzstd takes its two-symbol decoder
    for four streams of ``count`` literals from ``csize`` bytes."""
    q = 15 if csize >= count else csize * 16 // count
    t0, d0, t1, d1 = _ALGO_TIME[q]
    d = count >> 8
    one, two = t0 + d0 * d, t1 + d1 * d
    return two + (two >> 5) < one


class Huffman:
    """A literals table: the codes, and how libzstd decodes with them (the
    one-symbol decoder, or the two-symbol one with its lookup of ``target``
    bits, which reads a stream's last symbol by the table's entry of two)."""

    def __init__(self, table: list, log: int, two: bool):
        self.table, self.log, self.two = table, log, two
        self.target = 11 if log <= 11 else 12

    def pair(self, v: int):
        """The two-symbol entry of ``target`` bits: (bits it reads, first
        symbol, two symbols or one, second symbol)."""
        t, log, target = self.table, self.log, self.target
        nb1, s1 = t[v >> (target - log)]
        nb2, s2 = t[(v << nb1 >> (target - log)) & ((1 << log) - 1)]
        if nb1 + nb2 <= target:
            return nb1 + nb2, s1, True, s2
        return nb1, s1, False, 0


def _huffman_stream(src: bytes, start: int, end: int, huf: Huffman, n: int,
                    out: bytearray) -> None:
    """``n`` symbols of one stream by libzstd's careful decoders, which read
    it to its last bit (the two-symbol one with its rule for the last
    symbol: an entry of two symbols read for the last one ends the stream)."""
    total = _Backward(src, start, end).total
    table, log = huf.table, huf.log
    used, mask = 0, (1 << log) - 1
    last = n - 1 if huf.two and n else n
    for _ in range(last):
        lo = total - used - log  # the lowest bit of the next ``log``
        if lo >= 0:
            a = start + (lo >> 3)
            v = (int.from_bytes(src[a:a + 3], "little") >> (lo & 7)) & mask
        else:  # past the stream's first bit: zeros
            v = (int.from_bytes(src[start:start + 3], "little") << -lo) & mask if lo > -log else 0
        nb, s = table[v]
        used += nb
        out.append(s)
    if last < n:  # HUF_decodeLastSymbolX2
        target = huf.target
        if used < total:
            lo = total - used - target
            whole = int.from_bytes(src[start:end], "little")
            v = (whole >> lo if lo >= 0 else whole << -lo) & ((1 << target) - 1)
            bits, s, two = huf.pair(v)[:3]
            out.append(s)
            used = min(used + bits, total) if two else used + bits
        elif used == total:  # the container is spent: its top bits are read again
            head = int.from_bytes(src[start:min(end, start + 8)], "little")
            bits, s, two = huf.pair(head >> (64 - target))[:3]
            out.append(s)
            if not two:
                used += bits
    if used != total:
        _fail(CORRUPT)


_UNFINISHED, _END_OF_BUFFER, _COMPLETED, _OVERFLOW = range(4)


class _BitD:
    """libzstd's BIT_DStream_t, as its fast Huffman decoders hand each
    stream on for its last symbols: a 64-bit container read backward from
    ``ptr`` down to ``start`` (the four streams' jump table), its consumed
    bits counted, with its reload rules (and what it reads once spent)."""

    def __init__(self, src: bytes, start: int, ptr: int, consumed: int):
        self.src, self.start, self.ptr, self.consumed = src, start, ptr, consumed
        self.limit = start + 8
        self.container = int.from_bytes(src[ptr:ptr + 8], "little")

    def reload(self) -> int:
        if self.consumed > 64:
            return _OVERFLOW
        if self.ptr >= self.limit:
            self.ptr -= self.consumed >> 3
            self.consumed &= 7
        elif self.ptr == self.start:
            return _END_OF_BUFFER if self.consumed < 64 else _COMPLETED
        else:
            nb, status = self.consumed >> 3, _UNFINISHED
            if self.ptr - nb < self.start:
                nb, status = self.ptr - self.start, _END_OF_BUFFER
            self.ptr -= nb
            self.consumed -= 8 * nb
            self.container = int.from_bytes(self.src[self.ptr:self.ptr + 8], "little")
            return status
        self.container = int.from_bytes(self.src[self.ptr:self.ptr + 8], "little")
        return _UNFINISHED

    def look(self, n: int) -> int:
        return ((self.container << (self.consumed & 63)) & _M64) >> ((64 - n) & 63)


def _stream_x1(bd: _BitD, huf: Huffman, out: bytearray, p: int, end: int) -> None:
    """HUF_decodeStreamX1 at an 11-bit lookup (no check of its end)."""
    table, shift = huf.table, 11 - huf.log

    def one(p):
        nb, s = table[bd.look(11) >> shift]
        bd.consumed += nb
        out[p] = s

    if end - p > 3:
        while bd.reload() == _UNFINISHED and p < end - 3:
            for k in range(4):
                one(p + k)
            p += 4
    else:
        bd.reload()
    while p < end:
        one(p)
        p += 1


def _stream_x2(bd: _BitD, huf: Huffman, out: bytearray, p: int, end: int) -> None:
    """HUF_decodeStreamX2 at an 11-bit lookup (no check of its end)."""
    def two(p):
        bits, s1, double, s2 = huf.pair(bd.look(11))
        out[p], out[p + 1] = s1, s2 if double else 0
        bd.consumed += bits
        return p + 1 + double

    if end - p >= 8:
        while True:
            status = bd.reload()
            if not (status == _UNFINISHED and p < end - 9):
                break
            for _ in range(5):
                p = two(p)
    else:
        bd.reload()
    if end - p >= 2:
        while True:
            status = bd.reload()
            if not (status == _UNFINISHED and p <= end - 2):
                break
            p = two(p)
        while p <= end - 2:
            p = two(p)
    if p < end:  # HUF_decodeLastSymbolX2
        bits, s1, double, _ = huf.pair(bd.look(11))
        out[p] = s1
        if not double:
            bd.consumed += bits
        elif bd.consumed < 64:
            bd.consumed = min(bd.consumed + bits, 64)


def _fast_four(src: bytes, start: int, size: int, count: int, huf: Huffman, lens: list):
    """HUF_decompress4X{1,2}_usingDTable_internal_fast over the four streams
    (libzstd's fast loop, then each stream's last symbols): it does not
    check that a stream ends where its bits do, only that the loop did not
    read a byte past a stream's first.  None where libzstd does not take
    it."""
    seg = (count + 3) // 4
    if huf.log > 11 or min(lens) < 8 or 3 * seg >= count:
        return None
    first = [start + 6]
    for ln in lens[:3]:
        first.append(first[-1] + ln)
    ends = first[1:] + [start + size]
    ip = [e - 8 for e in ends]
    op = [0, seg, 2 * seg, 3 * seg]
    oend = [seg, 2 * seg, 3 * seg, count]
    bits = []
    for e in ends:
        last = src[e - 1]
        bits.append(((int.from_bytes(src[e - 8:e], "little") | 1)
                     << (8 - _highbit(last) if last else 0)) & _M64)
    out = bytearray(count + 1)
    table, shift, two = huf.table, 11 - huf.log, huf.two
    while True:
        if two:
            iters = (ip[0] - start) // 7
            for k in range(4):
                iters = min(iters, (oend[k] - op[k]) // 10)
        else:
            iters = min((count - op[3]) // 5, (ip[0] - start) // 7)
        olimit = op[3] + 5 * iters
        if op[3] == olimit or any(ip[k] < ip[k - 1] for k in (1, 2, 3)):
            break
        while True:
            for k in range(4):
                b, o = bits[k], op[k]
                for _ in range(5):
                    if two:
                        nb, s1, double, s2 = huf.pair(b >> 53)
                        out[o] = s1
                        if double:
                            out[o + 1] = s2
                        o += 1 + double
                    else:
                        nb, s1 = table[(b >> 53) >> shift]
                        out[o] = s1
                        o += 1
                    b = (b << nb) & _M64
                ctz = (b & -b).bit_length() - 1
                ip[k] -= ctz >> 3
                bits[k] = ((int.from_bytes(src[ip[k]:ip[k] + 8], "little") | 1) << (ctz & 7)) \
                    & _M64
                op[k] = o
            if op[3] >= olimit:
                break
    for k in range(4):
        if op[k] > oend[k] or ip[k] < first[k] - 8:
            _fail(CORRUPT)
        b = bits[k]
        bd = _BitD(src, start, ip[k], (b & -b).bit_length() - 1)
        (_stream_x2 if two else _stream_x1)(bd, huf, out, op[k], oend[k])
    return out[:count]


def huffman_literals(src: bytes, start: int, size: int, count: int, four: bool, huf: Huffman):
    """``count`` literals of one or four Huffman streams."""
    out = bytearray()
    if not four:
        _huffman_stream(src, start, start + size, huf, count, out)
        return out
    if size < 10 or count < 6:
        _fail(CORRUPT)
    lens = [int.from_bytes(src[start + 2 * i:start + 2 * i + 2], "little") for i in range(3)]
    lens.append(size - (sum(lens) + 6))
    if lens[3] < 0:
        _fail(CORRUPT)
    fast = _fast_four(src, start, size, count, huf, lens)
    if fast is not None:
        return fast
    at = start + 6
    for ln in lens:
        if ln < 1:
            _fail(SRC_SIZE)
        if not src[at + ln - 1]:
            _fail(CORRUPT)
        at += ln
    seg, at = (count + 3) // 4, start + 6
    for i, ln in enumerate(lens):
        _huffman_stream(src, at, at + ln, huf, seg if i < 3 else count - 3 * seg, out)
        at += ln
    return out


# ---- the frame -----------------------------------------------------------

class _Frame:
    """One frame's decoding state (ZSTD_DCtx and ZSTD_DStream)."""

    def __init__(self, data: bytes, size: int):
        self.data, self.size = data, size
        self.out = bytearray()  # what has reached libtiff's buffer
        self.reps = [1, 4, 8]
        self.huf = None  # the Huffman table of the last compressed literals
        self.tables = [None, None, None]  # the sequence tables in use
        self.fse_entropy = False
        self.extra = bytearray(_LIT_EXTRA)  # litExtraBuffer

    # -- header --
    def header(self):
        d = self.data
        n = len(d)
        if n < 5:
            head = bytes(d[:4]) + MAGIC.to_bytes(4, "little")[n:]
            if int.from_bytes(head[:4], "little") != MAGIC and (
                    int.from_bytes(bytes(d[:4]) + _SKIPPABLE.to_bytes(4, "little")[n:],
                                   "little") & 0xFFFFFFF0) != _SKIPPABLE:
                _fail("Unknown frame descriptor")
            _fail("Not enough data")
        magic = int.from_bytes(d[:4], "little")
        if magic != MAGIC:
            if (magic & 0xFFFFFFF0) == _SKIPPABLE:
                _fail("Not enough data (a skippable frame ends the loop)")
            if 0xFD2FB525 <= magic <= 0xFD2FB527:
                _fail("Unsupported frame (legacy format)")
            _fail("Unknown frame descriptor")
        fhd = d[4]
        single, checksum = fhd >> 5 & 1, fhd >> 2 & 1
        did_size = (0, 1, 2, 4)[fhd & 3]
        fcs_size = (single, 2, 4, 8)[fhd >> 6]
        hsize = 5 + (not single) + did_size + fcs_size
        if n < hsize:
            if fhd & 8:
                _fail("Unsupported frame parameter")
            _fail("Not enough data")
        if fhd & 8:
            _fail("Unsupported frame parameter")
        pos, window = 5, 0
        if not single:
            wd = d[pos]
            pos += 1
            wlog = (wd >> 3) + 10
            if wlog > 31:
                _fail("Frame requires too much memory for decoding")
            window = 1 << wlog
            window += (window >> 3) * (wd & 7)
        dict_id = int.from_bytes(d[pos:pos + did_size], "little")
        pos += did_size
        fcs = _UNKNOWN
        if fcs_size:
            fcs = int.from_bytes(d[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
            pos += fcs_size
        if single:
            window = fcs
        self.checksum, self.fcs = checksum, fcs
        self.block_max = min(window, _BLOCK_MAX)
        self.window = window
        self.dict_id = dict_id
        return pos

    def run(self) -> bytes:
        pos = self.header()
        if self.fcs != _UNKNOWN and self.size >= self.fcs and self._whole(pos):
            return self.single_pass(pos)
        if self.dict_id:
            _fail("Dictionary mismatch")
        window = max(self.window, 1 << 10)
        if window > _WINDOW_LIMIT:
            _fail("Frame requires too much memory for decoding")
        block = min(window, _BLOCK_MAX, self.block_max)
        ring = window + 2 * block + 2 * _WILD
        self.ring = ring if self.fcs == _UNKNOWN else min(self.fcs, ring)
        return self.streaming(pos)

    def _whole(self, pos: int) -> bool:
        """ZSTD_findFrameCompressedSize: every block header and block, and
        the checksum, inside the input."""
        d, n = self.data, len(self.data)
        while True:
            if n - pos < 3:
                return False
            head = int.from_bytes(d[pos:pos + 3], "little")
            kind = head >> 1 & 3
            if kind == 3:
                return False
            csize = 1 if kind == 1 else head >> 3
            if 3 + csize > n - pos:
                return False
            pos += 3 + csize
            if head & 1:
                break
        return not self.checksum or n - pos >= 4

    # -- the two drivers --
    def single_pass(self, pos: int) -> bytes:
        """ZSTD_decompressFrame into libtiff's buffer: the frame must
        fill it exactly."""
        if self.dict_id:
            _fail("Dictionary mismatch")
        d = self.data
        self.mem = bytearray()
        self.seg_start, self.ext, op = 0, None, 0
        while True:
            head = int.from_bytes(d[pos:pos + 3], "little")
            last, kind, csize = head & 1, head >> 1 & 3, head >> 3
            pos += 3
            cap = self.size - op
            if kind == 2:
                if csize > self.block_max:
                    _fail(SRC_SIZE)
                op += self.block(pos, pos + csize, op, cap, streaming=False)
            else:
                if csize > cap:
                    _fail(TOO_SMALL)
                self._put(op, d[pos:pos + csize] if kind == 0 else bytes([d[pos]]) * csize)
                op += csize
            pos += 1 if kind == 1 else csize
            if last:
                break
        if op != self.fcs:
            _fail(CORRUPT)
        if self.checksum and (xxh64(bytes(self.mem[:op])) & 0xFFFFFFFF) != _le32(d, pos):
            _fail("Restored data doesn't match checksum")
        if op < self.size:
            _fail(f"Not enough data (short {self.size - op} bytes)", bytes(self.mem[:op]))
        return bytes(self.mem[:op])

    def streaming(self, pos: int) -> bytes:
        """ZSTD_decompressStream's loop over the blocks, into its ring
        buffer, with libtiff's stops."""
        d, n = self.data, len(self.data)
        self.mem = bytearray()
        start = 0  # outStart: where the next block is decoded in the ring
        # the ring's segments: the current one starts at seg_start; the
        # previous one (extDict) is mem[ext[0]:ext[1]]
        self.seg_start, self.ext, prev_end = 0, None, 0
        decoded, hasher = 0, bytearray() if self.checksum else None
        while True:
            if n - pos < 3:
                break  # the input is spent
            head = int.from_bytes(d[pos:pos + 3], "little")
            last, kind = head & 1, head >> 1 & 3
            if kind == 3:
                _fail(CORRUPT)
            csize = 1 if kind == 1 else head >> 3
            if csize > self.block_max:
                _fail(CORRUPT)  # Block Size Exceeds Maximum
            pos += 3
            if start != prev_end:  # ZSTD_checkContinuity: a new segment
                self.ext = (self.seg_start, prev_end)
                self.seg_start = prev_end = start
            if csize == 0:
                if last:
                    return self._end(pos, hasher)
                continue
            cap = self.ring - start
            if kind == 0:  # raw: copied as its bytes arrive
                take = min(csize, n - pos)
                if take < 1:
                    break
                if take > cap:
                    _fail(TOO_SMALL)
                self._put(start, d[pos:pos + take])
                pos += take
                got = take
                if take < csize:
                    full = self._flush(start, got)
                    break
            elif n - pos < csize:
                break  # the block is not all there
            elif kind == 1:
                if head >> 3 > cap:
                    _fail(TOO_SMALL)
                got = head >> 3
                self._put(start, bytes([d[pos]]) * got)
                pos += 1
            else:
                got = self.block(pos, pos + csize, start, cap, streaming=True)
                pos += csize
            if got > self.block_max:
                _fail(CORRUPT)  # Decompressed Block Size Exceeds Maximum
            decoded += got
            if hasher is not None:
                hasher += self.mem[start:start + got]
            prev_end = start + got
            if last and self.fcs != _UNKNOWN and decoded != self.fcs:
                _fail(CORRUPT)
            if got:
                full = self._flush(start, got)
                start += got
                if full:
                    break
                wraps = self.fcs == _UNKNOWN or self.ring < self.fcs
                if wraps and start + self.block_max > self.ring:
                    start = 0  # the ring starts again
            if last:
                return self._end(pos, hasher)
        return self._result()

    def _end(self, pos, hasher):
        """The frame's last block is done: its checksum, if the input holds
        it, then the end of libtiff's loop."""
        if self.checksum:
            if len(self.data) - pos < 4:
                return self._result()
            if (xxh64(bytes(hasher)) & 0xFFFFFFFF) != _le32(self.data, pos):
                _fail("Restored data doesn't match checksum")
        return self._result()

    def _result(self) -> bytes:
        if len(self.out) < self.size:
            _fail(f"Not enough data (short {self.size - len(self.out)} bytes)", bytes(self.out))
        return bytes(self.out[:self.size])

    def _flush(self, start: int, got: int) -> bool:
        """Copy a block's output to libtiff's buffer; True when it did not
        all fit (the loop ends there)."""
        room = self.size - len(self.out)
        self.out += self.mem[start:start + min(got, room)]
        return got > room

    def _put(self, at: int, data) -> None:
        mem = self.mem
        if len(mem) < at + len(data):
            mem.extend(bytes(at + len(data) - len(mem)))
        mem[at:at + len(data)] = data

    # -- a compressed block --
    def block(self, pos: int, end: int, dst: int, cap: int, streaming: bool) -> int:
        """ZSTD_decompressBlock_internal: decode a compressed block into the
        memory at ``dst`` with ``cap`` bytes of room -> its size."""
        if end - pos > self.block_max:
            _fail(SRC_SIZE)
        pos += self.literals(pos, end, dst, cap, streaming)
        nseq, pos = self.seq_headers(pos, end)
        return self.sequences(pos, end, nseq, dst, cap)

    def _lit_place(self, dst: int, cap: int, count: int, streaming: bool, split_now: bool):
        """ZSTD_allocateLiteralsBuffer -> where the literals live: "dst" (the
        block's room, beyond its largest output), "extra", or "split"."""
        if not streaming and cap > self.block_max + _WILD + count + _WILD:
            self.lit_where, self.lit_at = "dst", dst + self.block_max + _WILD
        elif count <= _LIT_EXTRA:
            self.lit_where = "extra"
        else:
            e = min(self.block_max, cap)
            self.lit_where = "split"
            self.lit_at = dst + e - count + (_LIT_EXTRA - _WILD if split_now else 0)

    def _lit_store(self, lits: bytes, dst: int, cap: int, split_now: bool) -> None:
        """Lay the literals where libzstd keeps them."""
        count = len(lits)
        if self.lit_where == "extra":
            self.extra[:count] = lits
            self.lits = ("extra", 0, count)
        elif self.lit_where == "dst":
            self._put(self.lit_at, lits)
            self.lits = ("mem", self.lit_at, self.lit_at + count)
        else:
            e = min(self.block_max, cap)
            if not split_now:  # Huffman decoded into the block's end, then moved
                self._put(dst + e - count, lits)
                self.extra[:] = lits[count - _LIT_EXTRA:]
                at = dst + e - count + _LIT_EXTRA - _WILD
                self._put(at, lits[:count - _LIT_EXTRA])
            else:
                at = self.lit_at
                self._put(at, lits[:count - _LIT_EXTRA])
                self.extra[:] = lits[count - _LIT_EXTRA:]
            self.lits = ("split", at, at + count - _LIT_EXTRA)

    def literals(self, pos: int, end: int, dst: int, cap: int, streaming: bool) -> int:
        """ZSTD_decodeLiteralsBlock -> the bytes of the literals section."""
        d = self.data
        size = end - pos
        if size < 2:
            _fail(CORRUPT)
        b0 = d[pos]
        kind, code = b0 & 3, b0 >> 2 & 3
        expect = min(self.block_max, cap)
        if kind >= 2:  # Huffman-compressed, or treeless (the last table again)
            if kind == 3 and self.huf is None:
                _fail("Dictionary is corrupted")
            if size < 5:
                _fail(CORRUPT)
            lhc = _le32(d, pos)
            if code < 2:
                hsize, count, csize = 3, lhc >> 4 & 0x3FF, lhc >> 14 & 0x3FF
            elif code == 2:
                hsize, count, csize = 4, lhc >> 4 & 0x3FFF, lhc >> 18
            else:
                hsize, count, csize = 5, lhc >> 4 & 0x3FFFF, (lhc >> 22) + (d[pos + 4] << 10)
            four = code != 0
            if count > self.block_max:
                _fail(CORRUPT)
            if four and count < 6:
                _fail("Header of Literals' block doesn't respect format specification")
            if csize + hsize > size:
                _fail(CORRUPT)
            if expect < count:
                _fail(TOO_SMALL)
            self._lit_place(dst, cap, count, streaming, False)
            at, section = pos + hsize, hsize + csize
            if kind == 2:
                table, log, used = huffman_table(d, at, csize)
                if used >= csize:
                    _fail(CORRUPT)
                # one stream: the one-symbol decoder; four: as HUF_selectDecoder picks
                self.huf = Huffman(table, log, four and two_symbol_decoder(count, csize))
                at, csize = at + used, csize - used
            lits = huffman_literals(d, at, csize, count, four, self.huf)
            self._lit_store(bytes(lits), dst, cap, False)
            return section
        if code == 1:
            if kind == 1 and size < 3:
                _fail(CORRUPT)
            hsize, count = 2, (d[pos] | d[pos + 1] << 8) >> 4
        elif code == 3:
            if size < 3 + kind:
                _fail(CORRUPT)
            hsize, count = 3, int.from_bytes(d[pos:pos + 3], "little") >> 4
        else:
            hsize, count = 1, b0 >> 3
        if count > self.block_max:
            _fail(CORRUPT)
        if expect < count:
            _fail(TOO_SMALL)
        self._lit_place(dst, cap, count, streaming, True)
        if kind == 0:  # raw
            if hsize + count + _WILD > size:
                if count + hsize > size:
                    _fail(CORRUPT)
                self._lit_store(bytes(d[pos + hsize:pos + hsize + count]), dst, cap, True)
            else:  # read in place from the block
                self.lits = ("src", pos + hsize, pos + hsize + count)
            return hsize + count
        self._lit_store(bytes([d[pos + hsize]]) * count, dst, cap, True)
        return hsize + 1

    # -- sequences --
    def seq_headers(self, pos: int, end: int):
        """ZSTD_decodeSeqHeaders -> (number of sequences, where the bit
        stream starts)."""
        d = self.data
        if end - pos < 1:
            _fail(SRC_SIZE)
        nseq = d[pos]
        pos += 1
        if nseq > 0x7F:
            if nseq == 0xFF:
                if pos + 2 > end:
                    _fail(SRC_SIZE)
                nseq = (d[pos] | d[pos + 1] << 8) + 0x7F00
                pos += 2
            else:
                if pos >= end:
                    _fail(SRC_SIZE)
                nseq = ((nseq - 0x80) << 8) + d[pos]
                pos += 1
        if nseq == 0:
            if pos != end:
                _fail(CORRUPT)
            return 0, pos
        if pos + 1 > end:
            _fail(SRC_SIZE)
        modes = d[pos]
        if modes & 3:
            _fail(CORRUPT)
        pos += 1
        for kind, mode in ((0, modes >> 6), (1, modes >> 4 & 3), (2, modes >> 2 & 3)):
            base, bits, _, _, max_code, max_log = _KINDS[kind]
            if mode == 0:
                self.tables[kind] = _DEFAULT[kind]
            elif mode == 1:
                if pos >= end:
                    _fail(CORRUPT)
                s = d[pos]
                if s > max_code:
                    _fail(CORRUPT)
                self.tables[kind] = ([(base[s], bits[s], 0, 0)], 0)
                pos += 1
            elif mode == 2:
                try:
                    norm, log, used = read_ncount(d, pos, end - pos, max_code)
                except ZstdError:
                    _fail(CORRUPT)
                if log > max_log:
                    _fail(CORRUPT)
                self.tables[kind] = _seq_table(norm, log, kind)
                pos += used
            elif not self.fse_entropy:
                _fail(CORRUPT)
        return nseq, pos

    def sequences(self, pos: int, end: int, nseq: int, dst: int, cap: int) -> int:
        """ZSTD_decompressSequences(_SplitLitBuffer): run the sequences and
        the last literals into the memory at ``dst`` -> the block's size."""
        mem = self.mem
        where, lp, lend = self.lits
        if where == "src":
            lsrc = self.data
        elif where == "extra":
            lsrc = self.extra
        else:
            lsrc = mem
        split = where == "split"
        oend = dst + cap
        if where == "mem":
            oend = self.lit_at  # literals kept in the block's room after its output
        op = dst
        if len(mem) < oend:
            mem.extend(bytes(oend - len(mem)))
        seg = self.seg_start
        ext_len = self.ext[1] - self.ext[0] if self.ext else 0

        def match(op, off, ml):
            if off > op - seg:
                if off > op - seg + ext_len:
                    _fail(CORRUPT)
                m = self.ext[1] - (off - (op - seg))
                if m + ml <= self.ext[1]:
                    mem[op:op + ml] = mem[m:m + ml]
                    return
                k = self.ext[1] - m
                mem[op:op + k] = mem[m:m + k]
                op += k
                ml -= k
                src = seg
            else:
                src = op - off
            if off >= ml or src + ml <= op:
                mem[op:op + ml] = mem[src:src + ml]
            else:
                for i in range(ml):
                    mem[op + i] = mem[src + i]

        if nseq:
            self.fse_entropy = True
            reps = list(self.reps)
            bits = _Backward(self.data, pos, end)
            (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = self.tables
            ll_s, of_s, ml_s = bits.read(ll_log), bits.read(of_log), bits.read(ml_log)
            in_dst_part = split
            for k in range(nseq, 0, -1):
                ll_base, ll_bits, ll_nb, ll_next = ll_t[ll_s]
                of_base, of_bits, of_nb, of_next = of_t[of_s]
                ml_base, ml_bits, ml_nb, ml_next = ml_t[ml_s]
                if of_bits > 1:
                    off = of_base + bits.read(of_bits)
                    reps = [off, reps[0], reps[1]]
                else:
                    ll0 = ll_base == 0
                    if of_bits == 0:
                        off = reps[ll0]
                        reps[1] = reps[not ll0]
                        reps[0] = off
                    else:
                        idx = of_base + ll0 + bits.read(1)
                        t = reps[0] - 1 if idx == 3 else reps[idx]
                        t = t or (1 << 64) - 1  # 0 is corruption
                        if idx != 1:
                            reps[2] = reps[1]
                        reps[1] = reps[0]
                        reps[0] = off = t
                ml = ml_base + bits.read(ml_bits)
                ll = ll_base + bits.read(ll_bits)
                if k > 1:
                    ll_s = ll_next + bits.read(ll_nb)
                    ml_s = ml_next + bits.read(ml_nb)
                    of_s = of_next + bits.read(of_nb)
                if in_dst_part:
                    if lp + ll > lend:  # the literals run into the extra buffer
                        left = lend - lp
                        if left:
                            if left > oend - op:
                                _fail(TOO_SMALL)
                            for i in range(left):
                                mem[op + i] = mem[lp + i]
                            ll -= left
                            op += left
                        in_dst_part, lsrc, lp, lend = False, self.extra, 0, _LIT_EXTRA
                    else:
                        if op + ll + ml > lp + ll - _WILD:  # the careful path
                            if ll + ml > oend - op:
                                _fail(TOO_SMALL)
                            if lp < op < lp + ll:
                                _fail(TOO_SMALL)  # output caught up with the literals
                            for i in range(ll):
                                mem[op + i] = mem[lp + i]
                        else:
                            mem[op:op + ll] = mem[lp:lp + ll]
                        lp += ll
                        op += ll
                        match(op, off, ml)
                        op += ml
                        continue
                if ll + ml > oend - op:
                    _fail(TOO_SMALL)
                if ll > lend - lp:
                    _fail(CORRUPT)
                mem[op:op + ll] = lsrc[lp:lp + ll]
                lp += ll
                op += ll
                match(op, off, ml)
                op += ml
            if not bits.done():
                _fail(CORRUPT)
            self.reps = reps
            if split and in_dst_part:
                left = lend - lp
                if left > oend - op:
                    _fail(TOO_SMALL)
                mem[op:op + left] = mem[lp:lp + left]
                op += left
                lsrc, lp, lend = self.extra, 0, _LIT_EXTRA
        elif split:
            left = lend - lp
            if left > oend - op:
                _fail(TOO_SMALL)
            mem[op:op + left] = mem[lp:lp + left]
            op += left
            lsrc, lp, lend = self.extra, 0, _LIT_EXTRA
        left = lend - lp
        if left > oend - op:
            _fail(TOO_SMALL)
        mem[op:op + left] = lsrc[lp:lp + left]
        op += left
        return op - dst


def decode_python(data: bytes, size: int) -> bytes:
    """libtiff's ZSTDDecode of one strip or tile: its ``size`` bytes, or
    ZstdError (a ValueError) with libzstd's or libtiff's reason."""
    return _Frame(bytes(data), size).run()


def decode(data: bytes, size: int) -> bytes:
    """``decode_python``'s bytes from the C++ decoder, or from the twin
    where the library is missing."""
    try:
        got = native.zstd_decode(data, size)
    except ValueError as exc:
        raise ZstdError(str(exc), exc.kept) from None
    return decode_python(data, size) if got is None else got


def decode_kept(data: bytes, size: int) -> bytes:
    """What libtiff's buffer holds after ZSTDDecode, before the zeros it
    writes past a failure: the strip, or ``ZstdError.kept``."""
    try:
        return decode(data, size)
    except ZstdError as exc:
        return exc.kept
