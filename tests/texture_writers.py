"""Small PNG, TGA, BMP, TIFF, DDS, GIF, PNM, WebP, PSD, SGI, PCX, ICO and
CUR writers for the texture tests and their fixtures
(tests/test_torch_textures.py, tests/test_torch_formats.py,
tests/test_torch_stb_formats.py, tests/test_torch_pillow_readers.py,
tests/data/textures/make_fixtures.py): the variants Pillow does not write (Adam7, 2- and 4-bit grey, 16-bit RGB and
RGBA, keys at 16 bits, 16-bit TGA, colour maps with a first entry, grey
with a map; BMP RLE, bitfields and the other headers; TIFF tiles, planes,
predictor 2, associated alpha, palettes, big-endian; DDS BC4, BC5S and BC7
headers; GIF local tables and offset frames; plain PNM and odd maxvals;
WebP containers assembled by hand: VP8X, ALPH, ANMF, extra chunks; VP8
frames with chosen headers and random bits; PSD, which Pillow does not
write at all, raw or PackBits; SGI at 16 bits and run-length encoded; PCX
in one or two 1-bit planes, four 1-bit planes and a 4-bit plane, with a
chosen stride; ICO with bitmap entries and their AND masks; CUR; Pillow's
PNM extensions P0CMYK and Py*; of the last 19 Pillow readers, BLP2's DXT
blocks and BLP1's JPEG, FTEX, ICNS's run lengths, XPM, GBR, SUN, MSP
version 2, IM headers, FLI chunks, FITS with a gzip tile, McIdas, PIXAR,
IMT, XVThumb, PCD and IPTC; arithmetic-coded and lossless JPEG, which
Pillow reads and does not write), with ``zlib`` and ``struct``."""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(s: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) uint8 rows, sub-byte samples
    packed from the high bits."""
    h = s.shape[0]
    v = s.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return v.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    per = 8 // depth
    v = np.pad(v, ((0, 0), (0, -v.shape[1] % per))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (v << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, first: int | None) -> bytes:
    """Raw rows -> filtered rows: row y with filter type (first + y) % 5,
    or type 0 throughout where ``first`` is None."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = 0 if first is None else (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def png_bytes(samples: np.ndarray, depth: int, ctype: int, interlace: bool = False,
              plte=None, trns=None, filters: bool = True) -> bytes:
    """(H, W, C) integer samples at ``depth`` -> PNG bytes.  ``plte`` and
    ``trns`` are the chunks' bytes; with ``filters`` the rows cycle
    through the five filter types, else all take type 0."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, i if filters else None)
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += png_chunk(b"PLTE", bytes(plte))
    if trns is not None:
        out += png_chunk(b"tRNS", bytes(trns))
    return out + png_chunk(b"IDAT", zlib.compress(raw, 9)) + png_chunk(b"IEND", b"")


def _rle_row(px: np.ndarray) -> bytes:
    """(n, nb) pixels of one row -> TGA run-length packets: runs of two or
    more equal pixels as run packets, the rest as literals."""
    out, i, n = bytearray(), 0, len(px)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and (px[j] == px[i]).all():
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += px[i].tobytes()
        else:
            while j < n and j - i < 128 and not (j + 1 < n and (px[j] == px[j + 1]).all()):
                j += 1
            out.append(j - i - 1)
            out += px[i:j].tobytes()
        i = j
    return bytes(out)


def tga_bytes(pixels: np.ndarray, img_type: int, depth: int, desc: int = 0x20,
              cmap: bytes | None = None, cmap_bits: int = 0, cmap_first: int = 0,
              id_field: bytes = b"", width: int | None = None) -> bytes:
    """(H, W, nb) bytes of each pixel as stored, rows in file order -> TGA
    bytes; the run-length types (9, 10, 11) code each row on its own.
    ``width`` is the picture's width where it is not W (1-bit rows)."""
    h, w, nb = pixels.shape
    px = pixels.astype(np.uint8)
    n_map = 0 if cmap is None else len(cmap) // ((cmap_bits + 7) // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(cmap is not None), img_type,
                       cmap_first, n_map, cmap_bits, 0, 0, width or w, h, depth, desc)
    data = (b"".join(_rle_row(px[y]) for y in range(h)) if img_type & 8
            else px.tobytes())
    return head + id_field + (cmap or b"") + data


def bmp_rows(samples: np.ndarray, bits: int) -> bytes:
    """(h, w) indices or (h, w, nb) bytes of each pixel, rows in file order
    -> the pixel data of a BMP, each row padded to 4 bytes."""
    h = samples.shape[0]
    if samples.ndim == 3:
        rows = samples.reshape(h, -1).astype(np.uint8)
    else:
        rows = _pack(samples[..., None], bits) if bits < 8 else samples.astype(np.uint8)
    return np.pad(rows, ((0, 0), (0, -rows.shape[1] % 4))).tobytes()


def bmp_bytes(data: bytes, w: int, h: int, bits: int, header: int = 40, compression: int = 0,
              palette: bytes = b"", masks=None, colours: int = 0, dib: bool = False) -> bytes:
    """A BMP (or, with ``dib``, a DIB without the 14-byte file header) of
    ``data`` as stored; a negative ``h`` is top-down.  ``palette`` is its
    entries as stored (3 bytes each after a 12-byte header, else 4);
    ``masks`` go into a header that holds them (52 bytes or more) or after
    a 40-byte one."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h & 0xFFFF, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bits, compression, len(data),
                           2835, 2835, colours, 0)
        held = list(masks or ())[:4 if header >= 56 else 3] if header >= 52 else []
        info += struct.pack(f"<{len(held)}I", *held)
        info += bytes(header - len(info))
        if header == 40 and masks is not None:
            info += struct.pack("<3I", *masks[:3])
    body = info + palette
    if dib:
        return body + data
    return b"BM" + struct.pack("<IHHI", 14 + len(body) + len(data), 0, 0, 14 + len(body)) \
        + body + data


def lzw_bytes(data: bytes, min_bits: int = 8, tiff: bool = True, clear_every: int = 0,
              end: bool = True) -> bytes:
    """``data`` (values below ``2 ** min_bits``) -> LZW codes in TIFF's form
    (from the high bit, the width growing one code early) or GIF's (from
    the low bit); a clear code first, and again after ``clear_every``
    codes (0: only when the table is near full), the end code last where
    ``end``."""
    clear = 1 << min_bits
    codes = []  # (code, width)
    state = {"j": 0}

    def emit(code):
        dec_next = min(4096, clear + 2 + max(0, state["j"] - 1))
        codes.append((code, min(12, (dec_next + 1 if tiff else dec_next).bit_length())))
        state["j"] = 0 if code == clear else state["j"] + 1

    def reset():
        emit(clear)
        return {bytes([i]): i for i in range(clear)}, clear + 2

    table, nxt = reset()
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if nxt >= 4000 or (clear_every and state["j"] >= clear_every):
            table, nxt = reset()
        else:
            table[wc], nxt = nxt, nxt + 1
        w = bytes([byte])
    if w:
        emit(table[w])
    if end:
        emit(clear + 1)
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        if tiff:
            acc, nbits = (acc << width) | code, nbits + width
            while nbits >= 8:
                nbits -= 8
                out.append((acc >> nbits) & 0xFF)
        else:
            acc, nbits = acc | (code << nbits), nbits + width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc, nbits = acc >> 8, nbits - 8
    if nbits:
        out.append(((acc << (8 - nbits)) if tiff else acc) & 0xFF)
    return bytes(out)


def packbits_bytes(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_chunk(s: np.ndarray, bits: int, big_endian: bool, predictor: int) -> bytes:
    """(h, w, S) samples of one strip or tile -> its bytes, rows packed to
    whole bytes, with the horizontal predictor where ``predictor`` is 2 and
    libtiff's floating-point one (byte planes, the most significant first,
    then byte differences S apart) where it is 3."""
    s = s.astype(np.int64)
    h, w, n = s.shape
    if predictor == 2:
        s = s.copy()
        s[:, 1:] = (s[:, 1:] - s[:, :-1]) % (1 << bits)
    if predictor == 3:
        v = s.reshape(h, w * n)
        planes = np.stack([(v >> (8 * (3 - k))) & 0xFF for k in range(4)], axis=1)
        row = planes.reshape(h, 4 * w * n)
        diff = row.copy()
        diff[:, n:] = (row[:, n:] - row[:, :-n]) % 256
        return diff.astype(np.uint8).tobytes()
    if bits in (16, 32):
        dt = {16: "u2", 32: "u4"}[bits]
        return s.reshape(h, -1).astype((">" if big_endian else "<") + dt).tobytes()
    if bits == 12:
        v = s.reshape(h, -1)
        if v.shape[1] % 2:
            v = np.concatenate([v, np.zeros((h, 1), np.int64)], axis=1)
        a, b = v[:, 0::2], v[:, 1::2]
        trip = np.stack([a >> 4, (a & 15) << 4 | b >> 8, b & 0xFF], axis=-1).reshape(h, -1)
        return trip[:, :-(-w * n * 12 // 8)].astype(np.uint8).tobytes()
    return _pack(s, bits).tobytes()


_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def jpeg_chunks(chunk: np.ndarray, photometric: int, quality: int = 90, subsampling: int = 0
                ) -> tuple[bytes, bytes]:
    """(h, w, S) uint8 samples -> (the tables of Pillow's JPEG of them, its
    abbreviated stream without them), as libtiff stores a strip or tile and
    its ``JPEGTables``: grey for S 1, YCbCr with ``subsampling`` (Pillow's
    0 4:4:4, 1 4:2:2, 2 4:2:0) for photometric 6, RGB as stored for 2
    (YCbCr where subsampled)."""
    import io

    from PIL import Image

    img = Image.fromarray(chunk[..., 0] if chunk.shape[2] == 1 else chunk)
    out = io.BytesIO()
    img.save(out, format="JPEG", quality=quality, subsampling=subsampling,
             keep_rgb=photometric == 2 and subsampling == 0)
    blob = out.getvalue()
    tables, stream, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while blob[pos + 1] != 0xDA:
        size = struct.unpack(">H", blob[pos + 2:pos + 4])[0]
        seg = blob[pos:pos + 2 + size]
        (tables if blob[pos + 1] in (0xDB, 0xC4) else stream).extend(seg)
        pos += 2 + size
    return bytes(tables + b"\xff\xd9"), bytes(stream + blob[pos:])


def ycbcr_blocks(s: np.ndarray, sub: tuple, predictor: int = 1) -> bytes:
    """(h, w, 3) Y, Cb, Cr samples of one strip or tile -> libtiff's
    subsampled layout: block rows of ``sub`` = (h, v) blocks, each its h x v
    Y samples row by row, then the Cb and Cr of its top-left pixel; the
    edge blocks filled by repeating the last row and column.  With
    ``predictor`` 2, libtiff's horizontal differencing over rows of
    TIFFScanlineSize bytes, 3 apart."""
    hs, vs = sub
    rows, cols = -(-s.shape[0] // vs) * vs, -(-s.shape[1] // hs) * hs
    s = np.pad(s.astype(np.uint8), ((0, rows - s.shape[0]), (0, cols - s.shape[1]), (0, 0)),
               mode="edge")
    y = s[..., 0].reshape(rows // vs, vs, cols // hs, hs).transpose(0, 2, 1, 3)
    blocks = np.concatenate([y.reshape(rows // vs, cols // hs, hs * vs),
                             s[::vs, ::hs, 1:]], axis=-1)
    raw = blocks.astype(np.int64).reshape(-1)
    if predictor == 2:
        row = (cols // hs) * (hs * vs + 2) // vs
        r = raw.reshape(-1, row // 3, 3)
        r[:, 1:] = (r[:, 1:] - r[:, :-1]) % 256
        raw = r.reshape(-1)
    return raw.astype(np.uint8).tobytes()


def _zstd_frame(data: bytes, level: int) -> bytes:
    """A Zstandard frame of ``data`` as libtiff's ZSTDEncode streams it: no
    content size, no checksum."""
    import zstandard

    c = zstandard.ZstdCompressor(level=level, write_content_size=False)
    obj = c.compressobj()
    return obj.compress(data) + obj.flush()


def tiff_bytes(samples: np.ndarray, bits: int, photometric: int, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile=None, rows_per_strip=None,
               extra=None, colormap=None, big_endian: bool = False, tags=None,
               big_tiff: bool = False, fill_order: int = 1, sample_format: int = 1,
               jpeg_subsampling: int = 0, pad: bytes = b"", jpeg_encoder=None,
               ycbcr_subsampling=None, zstd_level: int = 9) -> bytes:
    """(H, W, S) samples -> a TIFF of one image: strips of
    ``rows_per_strip`` rows or ``tile`` (width, height) tiles (padded with
    zeros at the edges), planar configuration ``planar``, compression 1,
    5 (LZW), 7 (JPEG: each strip or tile Pillow's JPEG of it, the tables in
    ``JPEGTables``), 8 or 32946 (Deflate), 32773 (PackBits), 34925
    (LZMA, an xz stream) or 50000 (Zstandard: a frame of the ``zstandard``
    module at ``zstd_level``, without content size or checksum as libtiff
    writes it), ``extra`` the ExtraSamples values, ``colormap``
    the 3 * 2**bits ColorMap values; 1 to 32 bits a sample (float32
    samples stored as their bits with ``sample_format`` 3); ``fill_order``
    2 reverses every data byte's bits, as libtiff writes it; ``pad`` follows
    the data; a BigTIFF where ``big_tiff``; ``tags`` overrides or adds IFD
    entries as {tag: (type, values)}, or drops one as {tag: None};
    ``jpeg_encoder`` (the (h, w, S) uint8 strip or tile -> a whole JPEG
    stream) writes the JPEG strips instead of Pillow, without JPEGTables;
    ``ycbcr_subsampling`` (h, v) writes Y, Cb, Cr samples in libtiff's
    subsampled blocks (``ycbcr_blocks``) with their ``YCbCrSubsampling``.
    CIELab (photometric 8) samples are written as given: L*, then a* and
    b* as two's-complement bytes.  ``tags`` values of type 5 or 10
    (RATIONAL) are numerator, denominator pairs."""
    if samples.dtype == np.float32:
        samples = samples.view(np.uint32)
    h, w, n_s = samples.shape
    planes = [samples[..., k:k + 1] for k in range(n_s)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), np.int64)
            padded[:h, :w] = plane
            chunks += [padded[y:y + th, x:x + tw] for y in range(0, h, th)
                       for x in range(0, w, tw)]
        else:
            rps = rows_per_strip or h
            chunks += [plane[y:y + rps] for y in range(0, h, rps)]
    jpeg_tables = b""
    if compression == 7 and jpeg_encoder is not None:
        datas = [jpeg_encoder(c.astype(np.uint8)) for c in chunks]
    elif compression == 7:
        datas = []
        for c in chunks:
            jpeg_tables, stream = jpeg_chunks(c.astype(np.uint8), photometric,
                                              subsampling=jpeg_subsampling)
            datas.append(stream)
    else:
        encode = {1: lambda b: b, 5: lzw_bytes, 8: zlib.compress, 32946: zlib.compress,
                  32773: packbits_bytes,
                  34925: lambda b: lzma.compress(b, format=lzma.FORMAT_XZ),
                  50000: lambda b: _zstd_frame(b, zstd_level)}[compression]
        datas = [encode(ycbcr_blocks(c, ycbcr_subsampling, predictor) if ycbcr_subsampling
                        else _tiff_chunk(c, bits, big_endian, predictor)) for c in chunks]
    if fill_order == 2 and compression != 7:  # libtiff's JPEG codec ignores it
        datas = [d.translate(_REVERSED) for d in datas]
    e = ">" if big_endian else "<"
    magic = (b"MM\x00\x2b" if big_endian else b"II\x2b\x00") if big_tiff else (
        b"MM\x00\x2a" if big_endian else b"II\x2a\x00")
    head = struct.pack(e + "HHQ", 8, 0, 0) if big_tiff else bytes(4)
    body = bytearray(magic + head)
    offsets = []
    for d in datas:
        offsets.append(len(body))
        body += d + bytes(len(d) % 2)
    body += pad
    long = 16 if big_tiff else 4
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * n_s), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [n_s]), 284: (3, [planar]),
               (324 if tile else 273): (long, offsets),
               (325 if tile else 279): (long, [len(d) for d in datas])}
    if tile:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        entries[278] = (4, [rows_per_strip or h])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if sample_format != 1:
        entries[339] = (3, [sample_format] * n_s)
    if jpeg_tables:
        entries[347] = (7, list(jpeg_tables))
    if compression == 7 and photometric == 6:
        entries[530] = (3, [[1, 1], [2, 1], [2, 2]][jpeg_subsampling])
    if ycbcr_subsampling:
        entries[530] = (3, list(ycbcr_subsampling))
    for tag, entry in (tags or {}).items():  # None drops the tag
        if entry is None:
            entries.pop(tag, None)
        else:
            entries[tag] = entry
    code = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 8: "h", 9: "i", 10: "i", 16: "Q"}
    field, entry_fmt = (8, "HHQ") if big_tiff else (4, "HHI")
    ifd_at = len(body)
    ifd = bytearray(struct.pack(e + ("Q" if big_tiff else "H"), len(entries)))
    tail = bytearray()
    tail_at = ifd_at + len(ifd) + (field + 12 if big_tiff else 12) * len(entries) + field
    for tag in sorted(entries):
        kind, values = entries[tag]
        raw = struct.pack(e + code[kind] * len(values), *values)
        if len(raw) <= field:
            value = raw + bytes(field - len(raw))
        else:
            value = struct.pack(e + ("Q" if big_tiff else "I"), tail_at + len(tail))
            tail += raw + bytes(len(raw) % 2)
        count = len(values) // 2 if kind in (5, 10) else len(values)
        ifd += struct.pack(e + entry_fmt, tag, kind, count) + value
    ifd += bytes(field)
    if big_tiff:
        body[8:16] = struct.pack(e + "Q", ifd_at)
    else:
        body[4:8] = struct.pack(e + "I", ifd_at)
    return bytes(body + ifd + tail)


def dds_bytes(data: bytes, w: int, h: int, fourcc: bytes = b"", dxgi: int | None = None,
              flags: int = 0x4, bitcount: int = 0, masks=(0, 0, 0, 0)) -> bytes:
    """A DDS of ``data`` as stored under a 124-byte header: a FourCC (with
    ``flags`` 0x4), a DX10 header of DXGI format ``dxgi``, or the pixel
    format ``flags``, ``bitcount`` and ``masks`` of uncompressed data."""
    if dxgi is not None:
        fourcc = b"DX10"
    pf = struct.pack("<II4sI4I", 32, flags, fourcc.ljust(4, b"\0"), bitcount, *masks)
    head = struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1) + bytes(44) + pf + bytes(20)
    dx10 = struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return b"DDS " + head + dx10 + data


def _gif_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_bytes(frames, size, palette: bytes | None = None, min_bits: int = 8,
              version: bytes = b"GIF89a", extensions: bytes = b"") -> bytes:
    """A GIF of ``size`` (w, h) with an optional global ``palette`` and
    ``frames``: dicts of ``idx`` (h, w) indices, ``at`` (x, y), ``palette``
    (a local table), ``interlace``, ``transparency`` (a Graphic Control
    Extension's index), ``clear_every`` (LZW clear codes); ``extensions``
    go before the first frame."""
    def table_bits(p):
        return max(1, (len(p) // 3 - 1).bit_length()) - 1

    out = bytearray(version + struct.pack("<HH", *size))
    if palette is not None:
        out += bytes([0x80 | table_bits(palette), 0, 0]) + palette
    else:
        out += b"\0\0\0"
    out += extensions
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        fh, fw = idx.shape
        if f.get("transparency") is not None:
            out += b"!\xf9\x04" + bytes([1, 0, 0, f["transparency"]]) + b"\0"
        flags = 0x40 if f.get("interlace") else 0
        local = f.get("palette")
        if local is not None:
            flags |= 0x80 | table_bits(local)
        out += b"," + struct.pack("<4HB", *f.get("at", (0, 0)), fw, fh, flags)
        out += local or b""
        rows = idx
        if f.get("interlace"):
            rows = idx[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                       np.arange(2, fh, 4), np.arange(1, fh, 2)])]
        out += bytes([min_bits]) + _gif_blocks(
            lzw_bytes(rows.tobytes(), min_bits, False, f.get("clear_every", 0)))
    return bytes(out + b";")


def pnm_bytes(samples: np.ndarray, magic: bytes, maxval: int = 255, comment: bytes = b"",
              line: int = 17) -> bytes:
    """(H, W) or (H, W, 3) samples -> PNM ``magic`` (P1-P6), plain values
    ``line`` to a line, ``comment`` as a header comment line."""
    h, w = samples.shape[:2]
    head = magic + b"\n" + (b"# " + comment + b"\n" if comment else b"") + b"%d %d\n" % (w, h)
    if magic not in (b"P1", b"P4"):
        head += b"%d\n" % maxval
    v = samples.reshape(h, -1).astype(np.int64)
    if magic == b"P4":
        return head + np.packbits(v.astype(np.uint8), axis=1).tobytes()
    if magic in (b"P5", b"P6"):
        return head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    flat = [str(x).encode() for x in v.ravel().tolist()]
    return head + b"\n".join(b" ".join(flat[i:i + line]) for i in range(0, len(flat), line)) + b"\n"


def riff_chunk(fourcc: bytes, payload: bytes, size: int | None = None) -> bytes:
    """A RIFF chunk: its tag, its little-endian size (``size`` to state
    another), the payload and a pad byte when the payload is odd."""
    stated = len(payload) if size is None else size
    return fourcc + struct.pack("<I", stated) + payload + b"\0" * (len(payload) & 1)


def webp_bytes(chunks) -> bytes:
    """A WebP file of the given chunks."""
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(blob: bytes) -> dict[bytes, bytes]:
    """The payloads of a (still) WebP file's chunks by tag."""
    out, pos = {}, 12
    while pos + 8 <= len(blob):
        size = struct.unpack_from("<I", blob, pos + 4)[0]
        out[blob[pos:pos + 4]] = blob[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


def vp8x_chunk(w: int, h: int, flags: int) -> bytes:
    """``VP8X``: the flags, three reserved bytes, the canvas size minus one
    in 24 bits each."""
    return riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def anmf_chunk(x: int, y: int, w: int, h: int, frame: bytes, duration: int = 100,
               bits: int = 0) -> bytes:
    """``ANMF``: the offset halved and the size minus one in 24 bits each,
    the duration, the blend and dispose bits, then the frame's chunks."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, duration))
    return riff_chunk(b"ANMF", head + bytes([bits]) + frame)


def alph_raw(alpha: np.ndarray, filt: int) -> bytes:
    """An uncompressed ``ALPH`` payload of the (h, w) plane under filter
    ``filt`` (0 none, 1 horizontal, 2 vertical, 3 gradient)."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]  # the first row predicts from the left for every filter
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return bytes([filt << 2]) + ((a - pred) & 0xFF).astype(np.uint8).tobytes()


class BoolWriter:
    """VP8's boolean encoder (RFC 6386, section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self) -> None:
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int = 128) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int) -> None:
        for i in reversed(range(n)):
            self.put((v >> i) & 1)

    def signed(self, v: int, n: int) -> None:
        self.value(abs(v), n)
        self.put(int(v < 0))

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7) << (8 * (c >> 3))) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_frame(seed: int, w: int, h: int, simple: bool, parts_log2: int, level: int,
              sharpness: int, segments: bool, q: int) -> bytes:
    """A VP8 key frame whose header fields up to the entropy-refresh bit
    are the given ones (the loop filter's type, level and sharpness, the
    token partitions, segments with their quantisers and filter levels, the
    filter deltas, the quantiser deltas, the scaling bits) and whose rest
    is seeded random bits: the coefficient-probability updates, the skip
    probability, the modes and the tokens then follow the decoder's model,
    as an encoder's would.  For the paths Pillow cannot ask libwebp for."""
    rng = np.random.default_rng(seed)
    bw = BoolWriter()
    bw.put(0)
    bw.put(int(rng.integers(0, 2)))  # colour space, clamping type
    bw.put(int(segments))
    if segments:
        bw.put(1)
        bw.put(1)  # update the map and the data
        bw.put(int(rng.integers(0, 2)))  # absolute values or deltas
        for bits, span in ((7, 8), (7, 8), (7, 8), (7, 8), (6, 10), (6, 10), (6, 10), (6, 10)):
            bw.put(1)
            bw.signed(int(rng.integers(-span, span + 1)), bits)
        for _ in range(3):
            bw.put(1)
            bw.value(int(rng.integers(1, 256)), 8)
    bw.put(int(simple))
    bw.value(level, 6)
    bw.value(sharpness, 3)
    bw.put(1)
    bw.put(1)  # filter deltas, updated
    for _ in range(8):
        bw.put(1)
        bw.signed(int(rng.integers(-15, 16)), 6)
    bw.value(parts_log2, 2)
    bw.value(q, 7)
    for _ in range(5):
        bw.put(1)
        bw.signed(int(rng.integers(-3, 4)), 4)
    bw.put(0)  # refresh_entropy_probs
    mbs = ((w + 15) // 16) * ((h + 15) // 16)
    for bit in rng.integers(0, 2, 2000 + 60 * mbs):
        bw.put(int(bit))
    first = bw.flush()
    n = 1 << parts_log2
    parts = [rng.integers(0, 256, 80 * mbs // n + 200).astype(np.uint8) for _ in range(n)]
    for part in parts:  # a first byte of 255 is no arithmetic code (the value past the range)
        part[0] %= 255
    parts = [part.tobytes() for part in parts]
    tag = len(first) << 5 | 1 << 4  # a shown key frame, profile 0
    scale = [int(s) << 14 for s in rng.integers(0, 4, 2)]  # ignored by the decoder
    return (tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
            + struct.pack("<HH", w | scale[0], h | scale[1]) + first
            + b"".join(len(p).to_bytes(3, "little") for p in parts[:-1]) + b"".join(parts))


def psd_bytes(planes: np.ndarray, mode: int, bits: int = 8, rle: bool = False,
              colour_data: bytes = b"", resources: bytes = b"", layers: bytes = b"",
              channels: int | None = None, compression: int | None = None) -> bytes:
    """(C, H, W) planes as stored (1-bit planes: (C, H, ceil(W / 8)) bytes,
    with ``width`` taken from ``planes.shape`` otherwise) -> a PSD of
    colour ``mode`` (0 bitmap, 1 grey, 2 indexed, 3 RGB, 4 CMYK, 7
    multichannel, 8 duotone, 9 LAB): raw, or PackBits with each row coded
    on its own and the per-row byte counts first.  ``colour_data``,
    ``resources`` and ``layers`` fill the three sections before the image
    data."""
    c, h, row = planes.shape
    w = row * 8 if bits == 1 else row
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits, mode)
    body = b"".join(struct.pack(">I", len(x)) + x for x in (colour_data, resources, layers))
    px = planes.astype(np.uint8)
    if rle:
        rows = [packbits_bytes(px[i, y].tobytes()) for i in range(c) for y in range(h)]
        data = struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)
    else:
        data = px.tobytes()
    return head + body + struct.pack(">H", int(rle) if compression is None else compression) \
        + data


def psd_resource(rid: int, data: bytes, name: bytes = b"") -> bytes:
    """One image resource block: '8BIM', its id, its Pascal name (padded to
    even) and its data (padded to even)."""
    pascal = bytes([len(name)]) + name
    pascal += bytes(len(pascal) % 2)
    return b"8BIM" + struct.pack(">H", rid) + pascal + struct.pack(">I", len(data)) + data \
        + bytes(len(data) % 2)


def sgi_rle_row(v: bytes, bpc: int) -> bytes:
    """One SGI channel row of samples (``bpc`` bytes each) -> run-length
    packets (repeats of 3 or more, literals of the rest, at most 127 a
    packet) and the zero count that ends the row."""
    px = [v[i:i + bpc] for i in range(0, len(v), bpc)]
    out, i, n = bytearray(), 0, len(px)
    zero = bytes(bpc)

    def count(k: int) -> bytes:
        return k.to_bytes(bpc, "big")

    while i < n:
        j = i
        while j < n and j - i < 127 and px[j] == px[i]:
            j += 1
        if j - i >= 3:
            out += count(j - i) + px[i]
            i = j
            continue
        j = i + 1
        while j < n and j - i < 127 and not (j + 2 < n and px[j] == px[j + 1] == px[j + 2]):
            j += 1
        out += count(0x80 | (j - i)) + b"".join(px[i:j])
        i = j
    return bytes(out) + zero


def sgi_bytes(samples: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int | None = None,
              compression: int | None = None) -> bytes:
    """(H, W, Z) samples, row 0 the top -> an SGI image (rows stored
    bottom-up, one plane a channel, big-endian 16-bit samples at ``bpc``
    2): verbatim, or run-length encoded with the offset and length tables
    after the 512-byte header."""
    h, w, z = samples.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, int(rle) if compression is None else compression, bpc,
                       dim, w, h, z)
    head += bytes(512 - len(head))
    planes = samples[::-1].transpose(2, 0, 1).astype(">u2" if bpc == 2 else np.uint8)
    if not rle:
        return head + planes.tobytes()
    rows = [sgi_rle_row(planes[c, y].tobytes(), bpc) for c in range(z) for y in range(h)]
    starts, at = [], 512 + 8 * z * h
    for r in rows:
        starts.append(at)
        at += len(r)
    # the tables are indexed row + channel * height, as the rows above
    return head + struct.pack(f">{len(rows)}I", *starts) \
        + struct.pack(f">{len(rows)}I", *map(len, rows)) + b"".join(rows)


def pcx_rle(data: bytes) -> bytes:
    """PCX run-length coding: runs of 2 or more equal bytes (at most 63),
    and every byte of 0xC0 or more, as run packets; the rest as is."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 63 and data[j] == data[i]:
            j += 1
        if j - i >= 2 or data[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), data[i]])
        else:
            out.append(data[i])
        i = j
    return bytes(out)


def pcx_bytes(lines: np.ndarray, w: int, bits: int, planes: int, version: int = 5,
              palette16: bytes = bytes(48), palette256: bytes | None = None,
              stride: int | None = None, origin: tuple[int, int] = (0, 0),
              by_line: bool = True) -> bytes:
    """(H, planes * stride) line bytes as decoded -> a PCX of ``bits`` a
    pixel in ``planes`` planes; ``stride`` is the header's bytes a line
    (the line's own by default), ``palette256`` the 768 bytes after a
    0x0C at the end.  Each line is coded on its own (``by_line``), or the
    whole image as one stream, so runs cross lines."""
    h = lines.shape[0]
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + w - 1, y0 + h - 1, 72,
                       72) + palette16 + bytes([0, planes]) \
        + struct.pack("<HH", lines.shape[1] // planes if stride is None else stride, 1)
    head += bytes(128 - len(head))
    px = lines.astype(np.uint8)
    data = (b"".join(pcx_rle(px[y].tobytes()) for y in range(h)) if by_line
            else pcx_rle(px.tobytes()))
    return head + data + (b"\x0c" + palette256 if palette256 is not None else b"")


def icon_dir(entries, kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) directory and images: ``entries`` of
    (width byte, height byte, colours, planes or hotspot x, bits or hotspot
    y, image bytes); the images follow the directory in order."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    at = 6 + 16 * len(entries)
    for w, h, colours, a, b, data in entries:
        out += struct.pack("<BBBBHHII", w, h, colours, 0, a, b, len(data), at)
        at += len(data)
    return out + b"".join(data for *_, data in entries)


def icon_bitmap(colour: np.ndarray, bits: int, mask: np.ndarray | None = None,
                palette: bytes = b"", header: int = 40) -> bytes:
    """An icon's DIB: (H, W) indices or grey at 1, 4 or 8 bits, or (H, W,
    3 or 4) BGR(A) bytes at 24 or 32 bits, row 0 the top, and the AND
    mask's (H, W) bits (1: transparent), rows bottom-up and padded to 32
    bits; the header states twice the height."""
    h, w = colour.shape[:2]
    data = bmp_rows(colour[::-1].astype(np.int64), bits)
    if mask is not None:
        stride = (w + 31) // 32 * 4
        m = np.packbits(mask[::-1].astype(np.uint8), axis=1)
        data += np.pad(m, ((0, 0), (0, stride - m.shape[1]))).tobytes()
    return bmp_bytes(data, w, 2 * h, bits, header, palette=palette, dib=True)


def pnm_ext_bytes(samples: np.ndarray, magic: bytes, maxval: int = 255) -> bytes:
    """(H, W, C) samples -> Pillow's PNM extensions (P0CMYK, PyP, PyRGBA,
    PyCMYK), raw, one or two bytes a sample."""
    h, w = samples.shape[:2]
    head = magic + b"\n%d %d\n%d\n" % (w, h, maxval)
    return head + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# -- the formats of io/blp.py ... io/xvthumb.py that Pillow does not write --

def dxt_block(rgba: np.ndarray, kind: str) -> bytes:
    """One 4 x 4 block of (16, 4) uint8 RGBA as DXT1, DXT3 or DXT5: the
    colour end points are the darkest and the brightest texel in 5:6:5,
    each texel the nearer of the four codes (c0 > c1, the four-colour
    mode); DXT5's alpha end points are 255 and 0 (codes 0 and 1, so a
    texel of alpha 0 or 255 keeps it), the others the nearest of the eight
    codes; DXT1 punches no texel out."""
    px = rgba.astype(np.int64)
    c565 = (px[:, 0] >> 3) << 11 | (px[:, 1] >> 2) << 5 | px[:, 2] >> 3
    lum = px[:, :3].sum(axis=1)
    c0, c1 = int(c565[lum.argmax()]), int(c565[lum.argmin()])
    if c0 <= c1:
        c0, c1 = max(c0, c1, 1), min(c0, c1, max(c0, c1, 1) - 1)
    ends = np.array([[(c >> 11) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3] for c in (c0, c1)])
    codes = np.array([ends[0], ends[1], (2 * ends[0] + ends[1]) // 3, (ends[0] + 2 * ends[1]) // 3])
    idx = ((px[:, None, :3] - codes[None]) ** 2).sum(axis=2).argmin(axis=1)
    colour = struct.pack("<HHI", c0, c1, int((idx << (2 * np.arange(16))).sum()))
    if kind == "dxt1":
        return colour
    if kind == "dxt3":
        nib = px[:, 3] >> 4
        return bytes(int(nib[2 * i] | nib[2 * i + 1] << 4) for i in range(8)) + colour
    levels = np.array([255, 0] + [((7 - k) * 255 + k * 0) // 7 for k in range(1, 7)])
    acode = np.abs(px[:, 3:4] - levels[None]).argmin(axis=1)
    bits = int((acode << (3 * np.arange(16))).sum())
    return bytes([255, 0]) + bits.to_bytes(6, "little") + colour


def dxt_bytes(rgba: np.ndarray, kind: str) -> bytes:
    """(H, W, 4) uint8, sides multiples of 4 -> the blocks row by row."""
    h, w, _ = rgba.shape
    blocks = rgba.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    return b"".join(dxt_block(b, kind) for b in blocks)


def blp_bytes(version: int, w: int, h: int, mipmap: bytes, compression: int = 1,
              encoding: int = 1, alpha: int = 0, alpha_encoding: int = 0,
              palette: bytes = b"", jpeg_header: bytes = b"") -> bytes:
    """BLP1 (compression 0: JPEG, whose ``jpeg_header`` is the shared
    header; 1: palette indices, encoding 4 or 5) or BLP2 (encoding 1:
    palette, 2: DXT), the one mipmap after the palette."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0,
                                     w, h)
    extra = (struct.pack("<I", len(jpeg_header)) + jpeg_header if compression == 0 and
             version == 1 else palette.ljust(1024, b"\0"))
    start = len(head) + 128 + len(extra)
    offsets = struct.pack("<16I", start, *([0] * 15))
    lengths = struct.pack("<16I", len(mipmap), *([0] * 15))
    return head + offsets + lengths + extra + mipmap


def ftex_bytes(w: int, h: int, fmt: int, data: bytes) -> bytes:
    return (b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(data)) + data)


def icns_rle(channel: bytes) -> bytes:
    """One channel in ICNS's PackBits-like run-length code."""
    out, i, n = bytearray(), 0, len(channel)
    while i < n:
        j = i
        while j < n and j - i < 130 and channel[j] == channel[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, channel[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and channel[j] == channel[j + 1]
                                              == channel[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + channel[i:j]
        i = j
    return bytes(out)


def icns_bytes(elements) -> bytes:
    """[(kind, payload)] -> an icns file."""
    body = b"".join(k + struct.pack(">I", 8 + len(p)) + p for k, p in elements)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(rgb: np.ndarray, rle: bool = True) -> bytes:
    if not rle:
        return rgb.astype(np.uint8).tobytes()
    return b"".join(icns_rle(rgb[..., c].astype(np.uint8).tobytes()) for c in range(3))


def xpm_bytes(indices: np.ndarray, colours: list, cpp: int = 1, none_key: bool = False,
              comment: bool = True) -> bytes:
    """indices (H, W) into ``colours`` [(r, g, b)] -> XPM 3 text, keys of
    ``cpp`` characters; ``none_key`` adds a ``c None`` colour first."""
    h, w = indices.shape
    alphabet = [bytes([c]) for c in range(35, 127) if c not in (34, 92)]
    keys = []
    for i in range(len(colours) + 1):
        k, v = b"", i
        for _ in range(cpp):
            k, v = k + alphabet[v % len(alphabet)], v // len(alphabet)
        keys.append(k)
    lines = [b"/* XPM */", b"static char *t[] = {",
             b'"%d %d %d %d",' % (w, h, len(colours) + none_key, cpp)]
    if none_key:
        lines.append(b'"' + keys[-1] + b' c None",')
    lines += [b'"' + keys[i] + b' c #%02x%02x%02x",' % tuple(c) for i, c in enumerate(colours)]
    if comment:
        lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[v] for v in row) + b'",' for row in indices]
    return b"\n".join(lines) + b"\n};\n"


def gbr_bytes(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else pixels.shape[2]
    extra = b"GIMP" + struct.pack(">I", 25) if version == 2 else b""
    head = struct.pack(">5I", 20 + len(extra) + len(comment), version, w, h, depth)
    return head + extra + comment + pixels.astype(np.uint8).tobytes()


def sun_rle(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3 or data[i] == 0x80:
            out += bytes([0x80, j - i - 1, data[i]]) if j - i > 1 or data[i] != 0x80 \
                else b"\x80\x00"
            i = j
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_bytes(rows: bytes, w: int, h: int, depth: int, file_type: int = 1,
              colour_map: bytes = b"") -> bytes:
    """Rows already laid out (padded for raw types) -> a Sun raster."""
    data = sun_rle(rows) if file_type == 2 else rows
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), file_type,
                       1 if colour_map else 0, len(colour_map)) + colour_map + data


def msp_rle_row(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0, j - i, row[i]])
            i = j
        else:
            j = min(n, i + 127)
            out += bytes([j - i]) + row[i:j]
            i = j
    return bytes(out)


def msp_bytes(bits: np.ndarray, version: int = 2) -> bytes:
    """(H, W) 0/1 -> MSP version 1 (raw) or 2 (run-length rows, a row of
    all ones written as length 0)."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    head = list(struct.unpack("<2H", b"DanM" if version == 1 else b"LinS")) + [w, h] + [0] * 12
    check = 0
    for v in head:
        check ^= v
    head[12] = check  # any word will do: the XOR of all 16 must be 0
    header = struct.pack("<16H", *head)
    if version == 1:
        return header + rows.tobytes()
    packed = [b"" if not (r ^ 0xFF).any() and w % 8 == 0 else msp_rle_row(r.tobytes())
              for r in rows]
    return header + struct.pack(f"<{h}H", *map(len, packed)) + b"".join(packed)


def im_bytes(image_type: bytes, w: int, h: int, data: bytes, lut: bytes = b"",
             extra: bytes = b"") -> bytes:
    head = b"Image type: " + image_type + b"\r\nName: t\r\nImage size (x*y): %d*%d\r\n" % (w, h)
    head += extra + (b"Lut: 1\r\n" if lut else b"")
    return head.ljust(512, b"\0")[:511] + b"\x1a" + lut + data


def fli_chunk(kind: int, payload: bytes) -> bytes:
    if len(payload) % 2:
        payload += b"\0"
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_bytes(w: int, h: int, chunks, magic: int = 0xAF12) -> bytes:
    body = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, 1, w, h, 8, 0, 5)
    return bytes(head) + frame


def fli_colour(palette: np.ndarray, six_bit: bool = False) -> bytes:
    p = (palette >> 2) if six_bit else palette
    return fli_chunk(11 if six_bit else 4,
                     struct.pack("<HBB", 1, 0, 0) + p.astype(np.uint8).tobytes())


def fli_brun(img: np.ndarray) -> bytes:
    out = bytearray()
    for row in img:
        out.append(0)
        x, w = 0, len(row)
        while x < w:
            j = x
            while j < w and j - x < 127 and row[j] == row[x]:
                j += 1
            if j - x >= 2:
                out += bytes([j - x, row[x]])
            else:
                j = min(w, x + 127)
                out += bytes([256 - (j - x)]) + row[x:j].astype(np.uint8).tobytes()
            x = j
    return fli_chunk(15, bytes(out))


def fli_lc(img: np.ndarray, y0: int) -> bytes:
    """Rows from ``y0``: each row one skip and literal packets of 100."""
    out = bytearray(struct.pack("<HH", y0, img.shape[0]))
    for row in img:
        packs = [row[i:i + 100] for i in range(0, len(row), 100)]
        out.append(len(packs))
        for p in packs:
            out += bytes([0, len(p)]) + p.astype(np.uint8).tobytes()
    return fli_chunk(12, bytes(out))


def fli_ss2(img: np.ndarray) -> bytes:
    """Word-delta lines, even width: a run packet then literal words."""
    out = bytearray(struct.pack("<H", img.shape[0]))
    for row in img:
        words = row.astype(np.uint8).tobytes()
        out += struct.pack("<H", 2)
        out += bytes([0, 256 - 1]) + words[:2]
        out += bytes([0, (len(words) - 2) // 2]) + words[2:]
    return fli_chunk(7, bytes(out))


def fits_bytes(samples: np.ndarray, bitpix: int, cards: list | None = None,
               gzip_tile: bool = False) -> bytes:
    """(H, W) samples, stored as FITS stores them (big-endian, rows from
    the bottom) with the header cards; ``gzip_tile`` writes a tile-
    compressed BINTABLE extension holding the pixels in 4-byte words."""
    import gzip as _gzip

    h, w = samples.shape

    def card(k, v):
        return (k.ljust(8) + "= " + str(v).rjust(20)).ljust(80).encode()

    def header(cs):
        out = b"".join(card(k, v) if v is not None else k.ljust(80).encode() for k, v in cs)
        out += b"END".ljust(80)
        return out.ljust(-(-len(out) // 2880) * 2880, b" ")

    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if not gzip_tile:
        cs = [("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", 2), ("NAXIS1", w), ("NAXIS2", h)]
        data = samples[::-1].astype(dt).tobytes()
        return header(cs + (cards or [])) + data.ljust(-(-len(data) // 2880) * 2880, b"\0")
    primary = header([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)])
    words = samples[::-1].astype(">i4").tobytes()
    stream = _gzip.compress(words)
    cs = [("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 8),
          ("NAXIS2", 1), ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", bitpix),
          ("ZNAXIS", 2), ("ZNAXIS1", w), ("ZNAXIS2", h)]
    return primary + header(cs + (cards or [])) + bytes(8) + stream


def mcidas_bytes(samples: np.ndarray, size: int, prefix: int = 0) -> bytes:
    h, w = samples.shape
    words = [0] * 64
    words[1], words[8], words[9], words[10], words[13], words[14] = 4, h, w, size, 1, prefix
    words[33] = 256
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[size]
    rows = np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(h, w * size)
    data = np.concatenate([np.zeros((h, prefix), np.uint8), rows], axis=1)
    return struct.pack(">64i", *words) + data.tobytes()


def pixar_bytes(rgb: np.ndarray) -> bytes:
    h, w, _ = rgb.shape
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def imt_bytes(grey: np.ndarray, comment: bytes = b"* an IM Tools image") -> bytes:
    h, w = grey.shape
    head = comment + b"\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h)
    return head + grey.astype(np.uint8).tobytes()


def xvthumb_bytes(indices: np.ndarray) -> bytes:
    h, w = indices.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#BUILTIN:STOP\n%d %d 255\n" % (w, h)
            + indices.astype(np.uint8).tobytes())


def pcd_bytes(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, orientation: int = 0) -> bytes:
    """(512, 768) luma and (256, 384) chroma -> a PCD of the base image
    only, what Pillow reads."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    d = np.zeros((256, 3 * 768), np.uint8)
    d[:, :2 * 768] = y.reshape(256, 2 * 768)
    d[:, 1536:1920] = cb
    d[:, 1920:] = cr
    return bytes(head) + d.tobytes()


def iptc_field(record: int, tag: int, data: bytes) -> bytes:
    if len(data) < 0x8000:
        return struct.pack(">BBBH", 0x1C, record, tag, len(data)) + data
    return struct.pack(">BBBHI", 0x1C, record, tag, 0x8004, len(data)) + data


def iptc_bytes(w: int, h: int, layers: int, data: bytes, compression: int = 1,
               band: int | None = None, chunk: int = 30000) -> bytes:
    fields = [iptc_field(2, 0, b"\0\x04"), iptc_field(3, 20, struct.pack(">H", w)),
              iptc_field(3, 30, struct.pack(">H", h)),
              iptc_field(3, 60, bytes([layers, 0 if layers == 1 else 1])),
              iptc_field(3, 120, bytes([compression]))]
    if band is not None:
        fields.append(iptc_field(3, 65, bytes([band])))
    fields += [iptc_field(8, 10, data[i:i + chunk]) for i in range(0, len(data), chunk)]
    return b"".join(fields) + bytes(5)


# -- arithmetic-coded and lossless JPEG (Pillow writes neither) --

# libjpeg's jpeg_aritab (jaricom.c, Table D.2 of T.81): Qe << 16 | next index
# after an MPS << 8 | switch << 7 | next index after an LPS; entry 113 is the
# fixed probability 0.5
ARITAB = [
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
]

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_STD_Q = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99,
              99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99, *[99] * 32]))


class QMEncoder:
    """libjpeg's arithmetic encoder (jcarith.c: arith_encode, finish_pass)
    over statistics bins held in bytearrays."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, v):
        self.out.append(v)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _flush_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            for _ in range(self.sc):
                self._emit(0xFF)
                self._emit(0)
            self.sc = 0

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _jfif() -> bytes:
    return _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _planes(pixels: np.ndarray, sampling, ycc: bool) -> list:
    """(H, W, C) uint8 -> each component's samples (YCbCr where ``ycc``),
    box-averaged down by its sampling factors, as float64 planes of
    ceil(W * h / hmax) x ceil(H * v / vmax)."""
    px = pixels.astype(np.float64)
    if ycc:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        px = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                       -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                       0.5 * r - 0.418688 * g - 0.081312 * b + 128], axis=-1)
    h, w = px.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    out = []
    for c, (sh, sv) in enumerate(sampling):
        fx, fy = hmax // sh, vmax // sv
        cw, ch = -(-w * sh // hmax), -(-h * sv // vmax)
        p = np.pad(px[..., c], ((0, ch * fy - h), (0, cw * fx - w)), mode="edge")
        out.append(p.reshape(ch, fy, cw, fx).mean(axis=(1, 3)))
    return out


def dct_blocks(pixels: np.ndarray, sampling, quality: int = 85, ycc: bool = True):
    """(H, W, C) uint8 -> ([each component's quantised coefficients, (rows
    of MCU blocks, columns, 64) int64 in zigzag order, the picture's edge
    replicated into the padding], [its quantisation table in zigzag
    order]), a float forward DCT of the samples less 128."""
    h, w = pixels.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    blocks, tables = [], []
    for c, plane in enumerate(_planes(pixels, sampling, ycc)):
        sh, sv = sampling[c]
        rows, cols = my * sv * 8, mx * sh * 8
        p = np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")
        t = p.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3) - 128
        f = np.einsum("ux,abxy,vy->abuv", d, t, d).reshape(rows // 8, cols // 8, 64)
        q = np.clip((_STD_Q[min(c, 1)] * scale + 50) // 100, 1, 255)
        blocks.append(np.rint(f / q)[..., ZIGZAG].astype(np.int64))
        tables.append(q[ZIGZAG].astype(np.int64))
    return blocks, tables


def _mcus(blocks, sampling, comps, own_shapes):
    """The (component, block row, block column) of each block of each MCU
    of a scan over ``comps``: MCU order for several components, the
    component's own (block rows, columns) ``own_shapes`` (not the MCU
    padding) for one."""
    if len(comps) == 1:
        c = comps[0]
        bh, bw = own_shapes[c]
        return [[(c, y, x)] for y in range(bh) for x in range(bw)]
    my, mx = blocks[comps[0]].shape[0] // sampling[comps[0]][1], \
        blocks[comps[0]].shape[1] // sampling[comps[0]][0]
    return [[(c, y * sampling[c][1] + v, x * sampling[c][0] + u) for c in comps
             for v in range(sampling[c][1]) for u in range(sampling[c][0])]
            for y in range(my) for x in range(mx)]


# libjpeg's jpeg_simple_progression for YCbCr (and its grey form):
# (components, Ss, Se, Ah, Al)
PROGRESSION_3 = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0)]
PROGRESSION_1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                 ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def _arith_scan(blocks, sampling, comp_shapes, comps, ss, se, ah, al, progressive, restart,
                dc_l, dc_u, ac_k, tbl) -> bytes:
    """One scan's entropy-coded data, jcarith.c's encode_mcu (sequential)
    or its four progressive procedures, with RSTn every ``restart`` MCUs."""
    enc = QMEncoder()
    fixed = bytearray([113])
    state = {}

    def reset():
        # the statistics areas are the conditioning tables', shared by the
        # components that name one
        state["dc"] = {tbl[c][0]: bytearray(64) for c in comps}
        state["ac"] = {tbl[c][1]: bytearray(256) for c in comps}
        state["last"] = {c: 0 for c in comps}
        state["ctx"] = {c: 0 for c in comps}

    def dc_diff(c, v):
        t = tbl[c][0]
        st, i = state["dc"][t], state["ctx"][c]
        if v == 0:
            enc.encode(st, i, 0)
            state["ctx"][c] = 0
            return
        enc.encode(st, i, 1)
        if v > 0:
            enc.encode(st, i + 1, 0)
            i += 2
            state["ctx"][c] = 4
        else:
            v = -v
            enc.encode(st, i + 1, 1)
            i += 3
            state["ctx"][c] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(st, i, 1)
            m, v2, i = 1, v, 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
        enc.encode(st, i, 0)
        if m < (1 << dc_l[t]) >> 1:
            state["ctx"][c] = 0
        elif m > (1 << dc_u[t]) >> 1:
            state["ctx"][c] += 8
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def ac_value(st, i, v, k, t):
        """The sign is coded by the caller; the magnitude category and
        bits of |v| here, from the SN/SP bin ``i``."""
        m = 0
        v -= 1
        if v:
            enc.encode(st, i, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= ac_k[t] else 217
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
        enc.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & v else 0)
            m >>= 1

    def shifted(x, s):
        return x >> s if x >= 0 else -((-x) >> s)

    reset()
    units = _mcus(blocks, sampling, comps, comp_shapes)
    out = bytearray()
    for n, mcu in enumerate(units):
        if restart and n and n % restart == 0:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            enc.out = bytearray()
            enc.reset()
            reset()
        for c, y, x in mcu:
            blk = blocks[c][y, x]
            if not progressive or (ss == 0 and ah == 0):
                dcv = blk[0] >> al if progressive else blk[0]
                dc_diff(c, dcv - state["last"][c])
                state["last"][c] = dcv
            elif ss == 0:
                enc.encode(fixed, 0, (blk[0] >> al) & 1)
            if progressive and ss == 0:
                continue
            t = tbl[c][1]
            st = state["ac"][t]
            lo, hi = (1, 63) if not progressive else (ss, se)
            vals = [shifted(int(blk[k]), al) for k in range(64)]
            ke = hi
            while ke > 0 and not vals[ke]:
                ke -= 1
            if progressive and ah:
                prev = [shifted(int(blk[k]), ah) for k in range(64)]
                kex = ke
                while kex > 0 and not prev[kex]:
                    kex -= 1
            k = lo
            while k <= ke:
                i = 3 * (k - 1)
                if not (progressive and ah) or k > kex:
                    enc.encode(st, i, 0)
                while True:
                    v = vals[k]
                    if v:
                        a = abs(v)
                        if progressive and ah and a >> 1:
                            enc.encode(st, i + 2, a & 1)
                        else:
                            enc.encode(st, i + 1, 1)
                            enc.encode(fixed, 0, 0 if v > 0 else 1)
                            if not (progressive and ah):
                                ac_value(st, i + 2, a, k, t)
                        break
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                k += 1
            if k <= hi:
                enc.encode(st, 3 * (k - 1), 1)
    enc.finish()
    return bytes(out + enc.out)


def arith_jpeg_bytes(pixels: np.ndarray, sampling=None, quality: int = 85,
                     progressive: bool = False, restart: int = 0, dac=None, jfif: bool = True,
                     scans=None, tables=None, ycc: bool = True) -> bytes:
    """(H, W, C) uint8, C 1 or 3 -> an arithmetic-coded JPEG (SOF9, or SOF10
    with ``progressive``) as libjpeg's jcarith.c writes one: YCbCr of RGB
    (``ycc``), each component's (h, v) ``sampling``, a DRI of ``restart``
    MCUs, a DAC segment of ``dac`` ((table class << 4 | index, value)
    pairs) whose conditioning the coder then uses, ``scans`` the
    progression (libjpeg's simple progression by default), ``tables``
    each component's (DC, AC) conditioning table indices."""
    nc = pixels.shape[2]
    sampling = sampling or [(1, 1)] * nc
    blocks, qt = dct_blocks(pixels, sampling, quality, ycc and nc == 3)
    h, w = pixels.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    shapes = [(-(-(-(-h * sv // vmax)) // 8), -(-(-(-w * sh // hmax)) // 8))
              for sh, sv in sampling]
    tbl = tables or [(0, 0)] + [(1, 1)] * (nc - 1)
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for index, value in dac or ():
        if index >> 4:
            ac_k[index & 15] = value
        else:
            dc_l[index & 15], dc_u[index & 15] = value & 15, value >> 4
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _jfif()
    for i in range(min(nc, 2)):
        out += _segment(0xDB, bytes([i]) + bytes(qt[i].tolist()))
    out += _segment(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([i + 1, sampling[i][0] << 4 | sampling[i][1], min(i, 1)]) for i in range(nc)))
    if dac:
        out += _segment(0xCC, b"".join(bytes(p) for p in dac))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        scans = [(tuple(range(nc)), 0, 63, 0, 0)]
    elif scans is None:
        scans = PROGRESSION_3 if nc == 3 else PROGRESSION_1
    for comps, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, tbl[c][0] << 4 | tbl[c][1]]) for c in comps) + bytes([ss, se,
                                                                                  ah << 4 | al]))
        out += _arith_scan(blocks, sampling, shapes, list(comps), ss, se, ah, al, progressive,
                           restart, dc_l, dc_u, ac_k, tbl)
    return bytes(out + b"\xff\xd9")


def _huffman_table(freq) -> tuple[list, list]:
    """(counts by code length 1-16, symbols in code order) of a Huffman
    code for the symbols of ``freq`` (symbol -> count), at most 16 bits,
    never all ones (libjpeg's reserved code point)."""
    import heapq

    syms = sorted(s for s, f in freq.items() if f) or [0]
    heap = [(freq.get(s, 0) or 1, i, [s]) for i, s in enumerate(syms + [256])]
    heapq.heapify(heap)
    depth = {s: 0 for s in syms + [256]}
    n = len(heap)
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, n, a + b))
        n += 1
    counts = [0] * 33
    for s in syms + [256]:
        counts[max(depth[s], 1)] += 1
    for i in range(32, 16, -1):  # libjpeg's jpeg_gen_optimal_table limit to 16 bits
        while counts[i] > 0:
            j = i - 2
            while counts[j] == 0:
                j -= 1
            counts[i] -= 2
            counts[i - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
    i = 16
    while counts[i] == 0:
        i -= 1
    counts[i] -= 1  # the reserved symbol 256 takes the longest code
    order = sorted(syms, key=lambda s: (depth[s], s))
    return counts[1:17], order


def lossless_jpeg_bytes(samples: np.ndarray, predictor: int, pt: int = 0, sampling=None,
                        restart_rows: int = 0, jfif: bool = False, adobe=None,
                        cids=None, precision: int = 8, separate: bool = False) -> bytes:
    """(H, W, C) integer samples (C 1, 3 or 4, below 2**precision) -> a
    lossless JPEG (SOF3) as libjpeg-turbo's jclossls.c and jclhuff.c write
    one: each component's samples (already at its (h, v) ``sampling``,
    ceil(W h / hmax) x ceil(H v / vmax), taken from the top left) shifted
    right by the point transform ``pt``, the differences from
    ``predictor`` 1-7 (the first row from its left neighbour, the first
    sample from 2**(precision - pt - 1), the first column from above) in
    one interleaved scan of optimal Huffman tables, a DRI of
    ``restart_rows`` MCU rows (the predictor restarts as on the first
    row); an APP0 JFIF with ``jfif``, an APP14 Adobe of transform
    ``adobe``, component ids ``cids`` (1, 2, ... by default); with
    ``separate`` one scan a component, its samples in raster order."""
    h, w, nc = samples.shape
    sampling = sampling or [(1, 1)] * nc
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // hmax), -(-h // vmax)
    restart = restart_rows * mx
    diffs = []
    for c, (sh, sv) in enumerate(sampling):
        cw, ch = -(-w * sh // hmax), -(-h * sv // vmax)
        x = samples[:ch, :cw, c].astype(np.int64) >> pt
        d = np.zeros((my * sv, mx * sh), np.int64)
        for r in range(ch):
            first = restart_rows and r % (restart_rows * sv) == 0 or r == 0
            for col in range(cw):
                if first:
                    p = (1 << (precision - pt - 1)) if col == 0 else x[r, col - 1]
                elif col == 0:
                    p = x[r - 1, 0]
                else:
                    ra, rb, rc = x[r, col - 1], x[r - 1, col], x[r - 1, col - 1]
                    p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                         (ra + rb) >> 1)[predictor - 1]
                d[r, col] = ((x[r, col] - p + 0x8000) & 0xFFFF) - 0x8000
        diffs.append(d)
    if separate:  # a scan a component, its own samples (an MCU a sample)
        assert not restart, "one restart interval cannot fit every component's rows"
        scans = [([c], [(c, int(v)) for v in diffs[c][:-(-h * sv // vmax),
                                                     :-(-w * sh // hmax)].ravel()])
                 for c, (sh, sv) in enumerate(sampling)]
    else:
        seq = []  # (component, difference) in stream order
        for y in range(my):
            for xx in range(mx):
                for c, (sh, sv) in enumerate(sampling):
                    for v in range(sv):
                        for u in range(sh):
                            seq.append((c, int(diffs[c][y * sv + v, xx * sh + u])))
        scans = [(list(range(nc)), seq)]
    tables = [0] + [1] * (nc - 1) if nc == 3 else list(range(nc)) if nc <= 2 else [0] * nc
    freq = [{}, {}]
    for c, d in (item for _, seq in scans for item in seq):
        s = abs(d).bit_length()
        freq[tables[c]][s] = freq[tables[c]].get(s, 0) + 1
    codes = []
    dht = b""
    for t in sorted(set(tables)):
        counts, order = _huffman_table(freq[t])
        code, k, table = 0, 0, {}
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                table[order[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        codes.append(table)
        dht += bytes([t]) + bytes(counts) + bytes(order)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _jfif()
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    cids = cids or list(range(1, nc + 1))
    out += _segment(0xC3, struct.pack(">BHHB", precision, h, w, nc) + b"".join(
        bytes([cids[i], sampling[i][0] << 4 | sampling[i][1], 0]) for i in range(nc)))
    out += _segment(0xC4, dht)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for comps, seq in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([cids[i], tables[i] << 4]) for i in comps) + bytes([predictor, 0, pt]))
        per_mcu = sum(sampling[i][0] * sampling[i][1] for i in comps) if len(comps) > 1 else 1
        out += _lossless_data(seq, codes, tables, restart * per_mcu)
    return bytes(out + b"\xff\xd9")


def _lossless_data(seq, codes, tables, every: int) -> bytes:
    """A lossless scan's Huffman-coded differences, RSTn after every
    ``every`` of them."""
    acc, nbits, data = 0, 0, bytearray()

    def flush_bytes(final=False):
        nonlocal acc, nbits
        if final and nbits % 8:
            pad = 8 - nbits % 8
            acc, nbits = acc << pad | ((1 << pad) - 1), nbits + pad
        while nbits >= 8:
            b = (acc >> (nbits - 8)) & 0xFF
            data.append(b)
            if b == 0xFF:
                data.append(0)
            nbits -= 8
        acc &= (1 << nbits) - 1

    for n, (c, d) in enumerate(seq):
        if every and n and n % every == 0:
            flush_bytes(final=True)
            data += bytes([0xFF, 0xD0 + (n // every - 1) % 8])
        s = abs(d).bit_length()
        code, length = codes[sorted(set(tables)).index(tables[c])][s]
        acc, nbits = acc << length | code, nbits + length
        if s:
            acc, nbits = acc << s | ((d if d >= 0 else d - 1) & ((1 << s) - 1)), nbits + s
        flush_bytes()
    flush_bytes(final=True)
    return bytes(data)


# ---- JPEG 2000: OpenJPEG 2.5.4 through ctypes, JP2 boxes, PPM/PPT ------------------
#
# Pillow's wheel bundles the libopenjp2 it decodes with.  Its encoder writes
# what Pillow's writer cannot ask for (code-block styles, SOP/EPH, POC, ROI,
# sub-sampling, per-component precision), and its opj_decode gives the
# planes the port's codestream decoder is held to.  opj_cparameters_t and
# opj_image_t are laid out from openjpeg.h 2.5; ``_opj_check_layout`` holds
# the layout against opj_set_default_encoder_parameters' defaults.

def _openjp2():
    import ctypes
    import glob
    import os

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))
    if not found:
        raise FileNotFoundError("Pillow's bundled libopenjp2 is not there")
    lib = ctypes.CDLL(found[0])
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_create_decompress.restype = vp
    lib.opj_create_compress.restype = vp
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for name, n in (("opj_setup_decoder", 2), ("opj_read_header", 3), ("opj_decode", 3),
                    ("opj_end_decompress", 2), ("opj_setup_encoder", 3), ("opj_start_compress", 3),
                    ("opj_encode", 2), ("opj_end_compress", 2), ("opj_destroy_codec", 1),
                    ("opj_stream_destroy", 1), ("opj_image_destroy", 1),
                    ("opj_set_default_decoder_parameters", 1),
                    ("opj_set_default_encoder_parameters", 1)):
        getattr(lib, name).argtypes = [vp] * n
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [u32, vp, ctypes.c_int]
    return lib


def _opj_structs():
    import ctypes

    c_int, u32 = ctypes.c_int, ctypes.c_uint32

    class Comp(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                        "resno_decoded", "factor")] + [
            ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]

    class Image(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
            ("color_space", c_int), ("comps", ctypes.POINTER(Comp)), ("icc", ctypes.c_void_p),
            ("icc_len", u32)]

    class Poc(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1",
                                        "layno0", "precno0", "precno1")] + [
            ("prg1", c_int), ("prg", c_int), ("progorder", ctypes.c_char * 5), ("tile", u32)] + [
            (n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")] + [
            (n, u32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
                               "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
                               "comp_t", "prc_t", "tx0_t", "ty0_t")]

    class CParams(ctypes.Structure):
        _fields_ = [
            ("tile_size_on", c_int), ("cp_tx0", c_int), ("cp_ty0", c_int), ("cp_tdx", c_int),
            ("cp_tdy", c_int), ("cp_disto_alloc", c_int), ("cp_fixed_alloc", c_int),
            ("cp_fixed_quality", c_int), ("cp_matrice", ctypes.c_void_p),
            ("cp_comment", ctypes.c_char_p), ("csty", c_int), ("prog_order", c_int),
            ("POC", Poc * 32), ("numpocs", u32), ("tcp_numlayers", c_int),
            ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100),
            ("numresolution", c_int), ("cblockw_init", c_int), ("cblockh_init", c_int),
            ("mode", c_int), ("irreversible", c_int), ("roi_compno", c_int), ("roi_shift", c_int),
            ("res_spec", c_int), ("prcw_init", c_int * 33), ("prch_init", c_int * 33),
            ("infile", ctypes.c_char * 4096), ("outfile", ctypes.c_char * 4096),
            ("index_on", c_int), ("index", ctypes.c_char * 4096), ("image_offset_x0", c_int),
            ("image_offset_y0", c_int), ("subsampling_dx", c_int), ("subsampling_dy", c_int),
            ("decod_format", c_int), ("cod_format", c_int), ("jpwl_epc_on", c_int),
            ("jpwl_hprot_MH", c_int), ("jpwl_hprot_TPH_tileno", c_int * 16),
            ("jpwl_hprot_TPH", c_int * 16), ("jpwl_pprot_tileno", c_int * 16),
            ("jpwl_pprot_packno", c_int * 16), ("jpwl_pprot", c_int * 16),
            ("jpwl_sens_size", c_int), ("jpwl_sens_addr", c_int), ("jpwl_sens_range", c_int),
            ("jpwl_sens_MH", c_int), ("jpwl_sens_TPH_tileno", c_int * 16),
            ("jpwl_sens_TPH", c_int * 16), ("cp_cinema", c_int), ("max_comp_size", c_int),
            ("cp_rsiz", c_int), ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
            ("tcp_mct", ctypes.c_char), ("jpip_on", c_int), ("mct_data", ctypes.c_void_p),
            ("max_cs_size", c_int), ("rsiz", ctypes.c_uint16)]

    class CmptParm(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    return Comp, Image, Poc, CParams, CmptParm


def _opj_check_layout(lib, CParams) -> None:
    import ctypes

    p = CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx,
           p.subsampling_dy, p.decod_format, p.cod_format, p.prog_order, p.tp_on)
    if got != (6, 64, 64, -1, 1, 1, -1, -1, 0, b"\0"):
        raise RuntimeError(f"opj_cparameters_t laid out wrong: defaults read as {got}")


def opj_encode(planes, prec=8, sgnd: bool = False, dx=None, dy=None, origin=(0, 0),
               rates=(0,), pocs=(), prc=(), tile=None, **fields) -> bytes:
    """A raw codestream written by libopenjp2 2.5.4: ``planes`` (h, w) int
    arrays at their components' sizes; ``dx``/``dy`` each component's
    sub-sampling; ``origin`` the image offset; ``rates`` the layers'
    compression ratios (0: lossless); ``pocs`` POC entries (resno0,
    compno0, layno1, resno1, compno1, progression); ``prc`` the
    precincts' (log2 w, log2 h) from the highest resolution down; ``tile``
    the tile size; other keywords set opj_cparameters_t fields (``mode``
    for the code-block styles, ``csty`` 2 for SOP and 4 for EPH,
    ``irreversible``, ``roi_compno``/``roi_shift``, ``numresolution``,
    ``prog_order``, ``cblockw_init``/``cblockh_init``)."""
    import ctypes
    import os
    import tempfile

    lib = _openjp2()
    _, Image, _, CParams, CmptParm = _opj_structs()
    _opj_check_layout(lib, CParams)
    p = CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers, p.cp_disto_alloc = len(rates), 1
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    for i, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        q = p.POC[i]
        q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = r0, c0, l1, r1, c1
        q.prg1, q.tile = prg, 1
    p.numpocs = len(pocs)
    if prc:
        p.csty |= 1
        p.res_spec = len(prc)
        for i, (w, h) in enumerate(prc):
            p.prcw_init[i], p.prch_init[i] = 1 << w, 1 << h
    if tile is not None:
        p.tile_size_on, (p.cp_tdx, p.cp_tdy) = 1, tile
    for k, v in fields.items():
        setattr(p, k, v)
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    parms = (CmptParm * n)()
    for i, a in enumerate(planes):
        c = parms[i]
        c.dx, c.dy, c.w, c.h = dx[i], dy[i], a.shape[1], a.shape[0]
        c.x0, c.y0 = -(-origin[0] // dx[i]), -(-origin[1] // dy[i])
        c.prec = prec[i] if isinstance(prec, (list, tuple)) else prec
        c.sgnd = int(sgnd)
    img = ctypes.cast(lib.opj_image_create(n, parms, 1 if n >= 3 else 2), ctypes.POINTER(Image))
    im = img.contents
    im.x0, im.y0 = origin
    im.x1, im.y1 = origin[0] + planes[0].shape[1] * dx[0], origin[1] + planes[0].shape[0] * dy[0]
    for i, a in enumerate(planes):
        samples = np.ascontiguousarray(a, np.int32)  # held while memmove reads it
        ctypes.memmove(im.comps[i].data, samples.ctypes.data, samples.size * 4)
    codec = lib.opj_create_compress(0)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, ctypes.byref(p), img):
            raise ValueError("opj_setup_encoder refused the parameters")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise ValueError("libopenjp2 failed to encode")
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.unlink(path)


def opj_decode_planes(codestream: bytes):
    """libopenjp2 2.5.4's opj_decode of a raw codestream: a list of (h, w)
    int32 planes, or None where it fails the stream."""
    import ctypes
    import os
    import tempfile

    lib = _openjp2()
    _, Image, _, _, _ = _opj_structs()
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.write(fd, codestream)
    os.close(fd)
    codec = lib.opj_create_decompress(0)
    params = ctypes.create_string_buffer(1 << 14)
    lib.opj_set_default_decoder_parameters(params)
    lib.opj_setup_decoder(codec, params)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
    img = ctypes.POINTER(Image)()
    try:
        if not (lib.opj_read_header(stream, codec, ctypes.byref(img))
                and lib.opj_decode(codec, stream, img) and lib.opj_end_decompress(codec, stream)):
            return None
        im = img.contents
        return [np.ctypeslib.as_array(im.comps[c].data, (im.comps[c].h, im.comps[c].w)).copy()
                for c in range(im.numcomps)]
    finally:
        if img:
            lib.opj_image_destroy(img)
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        os.unlink(path)


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_bytes(codestream: bytes, nc: int, w: int, h: int, bpc: int = 7, colr: bytes | None = None,
              extra: bytes = b"", brand: bytes = b"jp2 ", before_header: bytes = b"") -> bytes:
    """A JP2 file around a raw codestream: ``colr`` the colour box's
    payload (None: enumerated sRGB for 3 or 4 components, else grey;
    b"": no colour box), ``extra`` more boxes inside ``jp2h`` after it,
    ``before_header`` boxes between ``ftyp`` and ``jp2h``."""
    if colr is None:
        colr = b"\x01\x00\x00" + struct.pack(">I", 16 if nc >= 3 else 17)
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    header = ihdr + (jp2_box(b"colr", colr) if colr else b"") + extra
    return (jp2_box(b"jP  ", b"\x0d\x0a\x87\x0a") + jp2_box(b"ftyp", brand + b"\0\0\0\0" + brand)
            + before_header + jp2_box(b"jp2h", header) + jp2_box(b"jp2c", codestream))


def j2k_segments(cs: bytes):
    """A raw codestream's main header, then its tile-parts as (SOT and
    header markers, SOD data), then what follows the last (EOC)."""
    pos = 2
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        pos += 2 + struct.unpack_from(">H", cs, pos + 2)[0]
    main, parts = cs[:pos], []
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        part = cs[pos:pos + psot]
        sod = 12
        while struct.unpack_from(">H", part, sod)[0] != 0xFF93:
            sod += 2 + struct.unpack_from(">H", part, sod + 2)[0]
        parts.append((part[:sod], part[sod + 2:]))
        pos += psot
    return main, parts, cs[pos:]


def j2k_join(main: bytes, parts, tail: bytes = b"\xff\xd9") -> bytes:
    out = [main]
    for head, data in parts:
        psot = len(head) + 2 + len(data)
        out.append(head[:6] + struct.pack(">I", psot) + head[10:] + b"\xff\x93" + data)
    out.append(tail)
    return b"".join(out)


def j2k_marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">HH", code, 2 + len(payload)) + payload


def _packets(data: bytes):
    """A tile-part's packets, each (SOP, header ending in EPH, body), by
    their SOP markers (a stream written with SOP and EPH)."""
    starts = []
    i = data.find(b"\xff\x91")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\xff\x91", i + 6)
    if not starts or starts[0] != 0:
        raise ValueError("the tile-part does not start with an SOP marker")
    out = []
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else len(data)
        eph = data.find(b"\xff\x92", s + 6, e)
        if eph < 0:
            raise ValueError("a packet without its EPH marker")
        out.append((data[s:s + 6], data[s + 6:eph + 2], data[eph + 2:e]))
    return out


def _split(code: int, stream: bytes, z_first: int = 0, room: int = 60000) -> bytes:
    return b"".join(j2k_marker(code, bytes([z_first + k]) + stream[i:i + room])
                    for k, i in enumerate(range(0, max(len(stream), 1), room)))


def j2k_ppt(cs: bytes) -> bytes:
    """Move every packet header (with its EPH) of an SOP/EPH stream into
    PPT markers of its tile-part; the SOPs stay with the bodies."""
    main, parts, tail = j2k_segments(cs)
    out = []
    for head, data in parts:
        pk = _packets(data)
        out.append((head + _split(0xFF61, b"".join(h for _, h, _ in pk)),
                    b"".join(s + b for s, _, b in pk)))
    return j2k_join(main, out, tail)


def j2k_ppm(cs: bytes, room: int = 60000) -> bytes:
    """Move every packet header of an SOP/EPH stream into PPM markers of
    the main header, each tile-part's headers after its Nppm."""
    main, parts, tail = j2k_segments(cs)
    stream, out = b"", []
    for head, data in parts:
        pk = _packets(data)
        hdrs = b"".join(h for _, h, _ in pk)
        stream += struct.pack(">I", len(hdrs)) + hdrs
        out.append((head, b"".join(s + b for s, _, b in pk)))
    return j2k_join(main + _split(0xFF60, stream, room=room), out, tail)
