"""TIFF decoding with ``zlib``, ``lzma`` and numpy, for textures on hosts
without Pillow.

``decode_tiff(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12, which
hands compressed files to libtiff and reads uncompressed ones itself).

Coverage: the first image (IFD 0) of a classic TIFF, little- or big-endian,
or a little-endian BigTIFF (Pillow reads a big-endian one's header as a
classic TIFF's); strips or tiles; ``PlanarConfiguration`` 1 and 2; ``FillOrder``
1 and 2; compression none (1), CCITT modified Huffman (2), CCITT Group 3
(3, one- or two-dimensional by ``T4Options``) and Group 4 (4), decoded by
io/ccitt.py, LZW (5, decoded by io/lzw.py), JPEG (7, each strip or tile one
stream over io/jpeg.py's ``decode_jpeg_stream`` with the ``JPEGTables``),
Deflate (8, 32946), PackBits (32773), LZMA (34925, an xz stream) and
Zstandard (50000, a frame a strip or tile, decoded by io/zstd.py);
predictor 1, 2 at 8, 16 and 32 bits, and 3 (floating point); the layouts of
Pillow's ``OPEN_INFO``: ``Photometric`` 0 and 1 (1, 2, 4, 8 and 16 bits,
grey and alpha at 8; signed 8-bit; 12-bit, little-endian only; signed
16-bit; unsigned 32-bit, little-endian only; signed 32-bit; 32-bit
floating point), 2 (RGB at 8 and 16 bits with ``ExtraSamples`` 0, 1 or 2,
or none), 3 (palette at 1, 2, 4 and 8 bits, and an 8-bit palette index with
an unused or an alpha sample), 5 (CMYK at 8 bits, with up to two unused
samples), 6 (YCbCr: through libjpeg's YCbCr -> RGB in a JPEG file, read
raw as Pillow reads it when uncompressed, and through libtiff's RGBA
interface under LZW, Deflate, PackBits, LZMA or Zstandard, io/tiff_rgba.py)
and 8 (CIELab at 8 bits, through io/lab.py's littleCMS transform).

Pillow's conversion is kept with its quirks:

  * 16-bit and 12-bit grey is clipped at 255, not scaled (35,485 reads as
    255), and white-is-zero 16-bit grey is not inverted; signed and 32-bit
    integer grey is clipped to [0, 255]; floating-point grey is truncated
    toward zero and clipped (-3.7 -> 0, 300.6 -> 255, 13.5 -> 13, NaN ->
    0), white-is-zero not inverted; signed 8-bit grey reads its bytes
    (-1 -> 255);
  * a compressed big-endian file of signed 16-bit, signed 32-bit or float
    samples reads each sample byte-swapped (libtiff hands Pillow native
    order, which Pillow reads with the file's);
  * 16-bit RGB and RGBA keep each sample's high byte;
  * associated alpha (``ExtraSamples`` 1) is un-premultiplied as
    ``min(255, c * 255 // a)``, 0 where alpha is 0;
  * a fourth sample without ``ExtraSamples`` is alpha;
  * the palette is the ``ColorMap`` values // 256;
  * CMYK converts as Pillow's ``cmyk2rgb`` (io/jpeg.py's ``cmyk_to_rgb``);
  * ``FillOrder`` 2 reverses the bits of each data byte, before any
    decompression (libtiff), for the layouts whose ``OPEN_INFO`` key holds
    it; an uncompressed plane of ``PlanarConfiguration`` 2 is not reversed,
    and uncompressed white-is-zero 8-bit grey and 1-, 2- and 4-bit palettes
    are refused (Pillow has no such raw mode);
  * PackBits, JPEG, CCITT and uncompressed files ignore the predictor;
  * uncompressed YCbCr is read as Pillow's ``RGBX`` raw mode: four bytes a
    pixel, the fourth dropped and no colour conversion, whatever the
    subsampling, so a file without those bytes is refused as truncated;
  * a JPEG strip or tile is its own stream: chroma is upsampled inside it,
    an edge tile is decoded whole and cropped, a last strip's stream may be
    taller than the strip; photometric 6 goes through YCbCr -> RGB, 1 and 2
    as stored; the stream's sampling factors must be ``YCbCrSubsampling``'s
    (1, 1 but for YCbCr), and FillOrder does not apply;
  * a Group 4 strip that ends early (an EOFB or the end of its data after
    at least one row) keeps the rows after it from the strip before, as
    Pillow's reused buffer does (zeros in the first strip);
  * an orientation of 2-8 flips or turns the image as Pillow's
    ``exif_transpose`` does after decoding it at the size the file gives
    (5-8 swap its axes);
  * the directory is read up to the first entry, or the first tag's
    values, that runs past the end of the file;
  * an uncompressed file reads every strip or tile offset it lists (the
    regions of those it lacks stay zero in Pillow's mode), those
    past the image's last one again from the top, in the order of the
    offsets (so the largest of several offsets of one strip wins); with
    ``PlanarConfiguration`` 2 each plane is read with the band's letter of
    Pillow's raw mode: 8-bit samples (1-bit for bilevel, 32-bit for ``I``
    and ``F``) whatever the file's depth, and white-is-zero grey not
    inverted;
  * a compressed file with ``PlanarConfiguration`` 2 loses the alpha plane
    of grey or palette with alpha (alpha 0), and un-premultiplies RGB by a
    fourth plane that ``ExtraSamples`` does not name;
  * CIELab's a* and b* are stored signed and Pillow's LAB unpacker flips
    their sign bit, and sets alpha 255; in ``PlanarConfiguration`` 2 its
    band unpackers copy the planes as stored and leave alpha 0;
  * compressed YCbCr is libtiff's RGBA conversion (io/tiff_rgba.py): each
    strip, or row of tiles, read into a buffer libtiff zeroes, a strip it
    cannot read or decode reads as what its codec wrote, then zeros (under
    Zstandard nothing after an error of libzstd, what it flushed where the
    data ran out: io/zstd.decode_kept); where Pillow's mode has one sample
    its unpacker takes the first bytes of each row of libtiff's RGBA raster;
  * a compressed file's layout is libtiff's reading of the directory
    (``_Libtiff``): the first entry of a tag, the strip and tile arrays
    read up to the image's count and padded with zeros, byte counts
    estimated where they are missing, ``YCbCrSubsampling`` from the first
    JPEG strip's SOF where the tag cannot be fetched, and refused where
    libtiff refuses a tag (the dimensions, SamplesPerPixel, Compression,
    PlanarConfiguration, RowsPerStrip, ExtraSamples, BitsPerSample,
    SampleFormat) or Pillow's decoder finds libtiff's strips wider than
    its mode;
  * a JPEG strip's markers after its scan cannot fail it (libtiff ignores
    ``jpeg_finish_decompress``'s result); a stream smaller than its strip
    or tile is read where it covers the image, and refused where it does
    not (fault C-9: Pillow shows its buffer's earlier, uninitialised
    bytes there).

Where Pillow or libtiff refuses a file, and for the variants not listed
above, this module raises ValueError naming TIFF and the variant:
old-style JPEG, WebP, LogLuv and the other compressions, YCbCr
subsamplings libtiff's RGBA interface has no routine for, ICCLab, ITULab
and the other photometric interpretations, the layouts ``OPEN_INFO`` lacks
(big-endian 12-bit and unsigned 32-bit grey, float RGB, 16-bit LAB, ...),
planar strips with unused samples (Pillow's decoder refuses them) and
planar palette tiles with one (Pillow's PX unpacker reads two bytes a
pixel from the one-byte plane, past libtiff's tile buffer), a palette
without its ColorMap (Pillow's ``_setup`` raises KeyError and no plugin
reads the file), with more than 256 entries ("invalid palette size") or,
below 8 bits in a compressed file, with one libtiff does not take (it
refuses the directory), entries of an UNDEFINED type where Pillow's mode
wants integers, a strip whose RowsPerStrip times a row's bytes passes
INT_MAX (Pillow's decoder), predictor 3 on integer samples, predictor 2
below 8 bits or at 12, a JPEG stream whose size, components or sampling
factors libtiff refuses, 12-bit JPEG, old-style LZW, a Zstandard frame
libzstd refuses or that ends short of its strip, data that ends early.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch.io import tiff_rgba, xz, zstd
from gaussian_splatterer_tpu_torch.io.bmp import raw_rows, unpack_bits
from gaussian_splatterer_tpu_torch.io.ccitt import FaxState, decode_fax
from gaussian_splatterer_tpu_torch.io.jpeg import cmyk_to_rgb, decode_jpeg_stream
from gaussian_splatterer_tpu_torch.io.lab import lab_to_rgb
from gaussian_splatterer_tpu_torch.io.lzw import OK, decode_lzw
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size

_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                 32946: "Deflate", 34676: "SGI LogLuv", 34677: "SGI LogLuv24",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_READ = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000)
# the integer field types: BYTE, SHORT, LONG, SBYTE, UNDEFINED (JPEGTables'
# bytes), SSHORT, SLONG, IFD, LONG8, SLONG8, IFD8
_TYPE_CODE = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q",
              17: "q", 18: "Q"}
_AB = np.array([0, 1, 1], np.uint8)  # the a* and b* samples of a CIELab pixel
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def _modes() -> dict:
    """Pillow's OPEN_INFO for the variants read here: (big-endian,
    photometric, sample format, fill order, bits per sample, extra samples)
    -> (kind, Pillow's raw mode); kinds "1", "L", "1I" and "LI" (white is
    zero), "I16", "I" (signed or 32-bit integers), "F", "LA", "RGB",
    "RGBA", "RGBa" (associated alpha), "P", "PA", "CMYK"."""
    both = {}
    for photo, inv in ((0, "I"), (1, "")):
        both[(photo, (1,), 1, (1,), ())] = ("1" + inv, "1;" + inv if inv else "1")
        both[(photo, (1,), 2, (1,), ())] = ("1" + inv, f"1;{inv}R")
        for b in (2, 4):
            both[(photo, (1,), 1, (b,), ())] = ("L" + inv, f"L;{b}{inv}")
            both[(photo, (1,), 2, (b,), ())] = ("L" + inv, f"L;{b}{inv}R")
        both[(photo, (1,), 1, (8,), ())] = ("L" + inv, "L;I" if inv else "L")
        both[(photo, (1,), 2, (8,), ())] = ("L" + inv, f"L;{inv}R")
    both[(1, (2,), 1, (8,), ())] = ("L", "L")
    both[(1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    both[(6, (1,), 1, (8,), ())] = ("L", "L")
    both[(6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGBX")
    both[(8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")
    both[(2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
    for b in (1, 2, 4, 8):
        both[(3, (1,), 1, (b,), ())] = ("P", "P" if b == 8 else f"P;{b}")
        both[(3, (1,), 2, (b,), ())] = ("P", "P;R" if b == 8 else f"P;{b}R")
    both[(3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    both[(3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    for tail in ((), (0,), (0, 0)):
        both[(5, (1,), 1, (8,) * (4 + len(tail)), tail)] = ("CMYK", "CMYK" + "X" * len(tail))
    both[(2, (1,), 1, (8,) * 4, (999,))] = ("RGBA", "RGBA")
    for tail, kind, raw in (((0, 0), "RGB", "RGBXX"), ((0, 0, 0), "RGB", "RGBXXX"),
                            ((1, 0), "RGBa", "RGBaX"), ((1, 0, 0), "RGBa", "RGBaXX"),
                            ((2, 0), "RGBA", "RGBAX"), ((2, 0, 0), "RGBA", "RGBAXX")):
        both[(2, (1,), 1, (8,) * (3 + len(tail)), tail)] = (kind, raw)
    modes = {}
    for big, order in ((False, "L"), (True, "B")):
        for key, value in both.items():
            modes[(big,) + key] = value
        for b, suffix in ((8, ""), (16, ";16" + order)):
            modes[(big, 2, (1,), 1, (b,) * 3, ())] = ("RGB", "RGB" + suffix)
            for extra, kind, raw in (((), "RGBA", "RGBA"), ((0,), "RGB", "RGBX"),
                                     ((1,), "RGBa", "RGBa"), ((2,), "RGBA", "RGBA")):
                modes[(big, 2, (1,), 1, (b,) * 4, extra)] = (kind, raw + suffix)
        modes[(big, 1, (1,), 1, (16,), ())] = ("I16", "I;16B" if big else "I;16")
        modes[(big, 1, (2,), 1, (16,), ())] = ("I", "I;16BS" if big else "I;16S")
        modes[(big, 1, (2,), 1, (32,), ())] = ("I", "I;32BS" if big else "I;32S")
        for photo in (0, 1):
            modes[(big, photo, (3,), 1, (32,), ())] = ("F", "F;32BF" if big else "F;32F")
    modes[(False, 0, (1,), 1, (16,), ())] = ("I16", "I;16")
    modes[(False, 1, (1,), 1, (12,), ())] = ("I16", "I;12")
    modes[(False, 1, (1,), 2, (16,), ())] = ("I16", "I;16R")
    modes[(False, 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    return modes


_MODES = _modes()


def _ints(v):
    """A tag's values as a tuple, but Pillow's bytes of an UNDEFINED entry
    kept as bytes (no mode of Pillow's matches them)."""
    return v if isinstance(v, bytes) else tuple(v)


def _header(blob: bytes) -> tuple[str, bool, int]:
    """(byte order, BigTIFF, offset of IFD 0), as Pillow reads them: it
    tells a BigTIFF by its third byte, so a big-endian one reads as a
    classic TIFF whose IFD offset is bytes 4-8."""
    if blob[:4] in (b"II\x2a\x00", b"MM\x00\x2a", b"MM\x00\x2b") and len(blob) >= 8:
        e = ">" if blob[:2] == b"MM" else "<"
        return e, False, struct.unpack_from(e + "I", blob, 4)[0]
    if blob[:4] == b"II\x2b\x00" and len(blob) >= 16:
        return "<", True, struct.unpack_from("<Q", blob, 8)[0]
    raise ValueError("not a TIFF file")


# the sizes of the field types libtiff reads, and of those Pillow loads (it
# skips the others: in a classic TIFF and a BigTIFF alike, SLONG8 and IFD8,
# fault C-13)
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
              16: 8, 17: 8, 18: 8}
_PILLOW_TYPE_SIZE = {k: v for k, v in _TYPE_SIZE.items() if k not in (17, 18)}


def _ifd(blob: bytes, e: str, pos: int, bigtiff: bool, skip: bool = False) -> dict:
    """The IFD at ``pos`` -> {tag: tuple of ints} for the integer tags, as
    Pillow loads it: it stops at an entry, or at the values of a tag, that
    runs past the end of the file, and keeps the tags before; with
    ``skip``, as libtiff reads the layout of a compressed file, such a tag
    is passed over."""
    count_fmt, entry, field = ("Q", 20, 8) if bigtiff else ("H", 12, 4)
    head = struct.calcsize(count_fmt)
    if len(blob) < pos + head:
        raise ValueError("TIFF directory past the end of the file (truncated file)")
    n = struct.unpack_from(e + count_fmt, blob, pos)[0]
    tags = {}
    for i in range(n):
        at = pos + head + entry * i
        if len(blob) < at + entry:
            break
        tag, kind = struct.unpack_from(e + "HH", blob, at)
        count = struct.unpack_from(e + ("Q" if bigtiff else "I"), blob, at + 4)[0]
        if kind not in _PILLOW_TYPE_SIZE:
            continue
        size = _PILLOW_TYPE_SIZE[kind] * count
        at += entry - field
        if size > field:
            at = struct.unpack_from(e + ("Q" if bigtiff else "I"), blob, at)[0]
            if len(blob) < at + size:
                if skip:
                    continue
                break
        if kind == 7 and skip and tag != 347:
            continue  # libtiff takes UNDEFINED for none of the integer tags read here
        if kind in _TYPE_CODE and count:
            v = struct.unpack_from(f"{e}{count}{_TYPE_CODE[kind]}", blob, at)
            # Pillow keeps UNDEFINED as bytes, which match no integer (fault C-15)
            tags[tag] = bytes(v) if kind == 7 and not skip else v
    return tags


# the integer types libtiff's TIFFReadDirEntry* take for an integer tag:
# BYTE, SHORT, LONG, SBYTE, SSHORT, SLONG, LONG8, SLONG8
_LIBTIFF_INT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}
_U16, _U32 = 0xFFFF, 0xFFFFFFFF


class _Libtiff:
    """IFD 0 as libtiff 4.7's TIFFReadDirectory reads it for a compressed
    file (Pillow hands those to libtiff): each tag's first entry; the tags
    it fetches without recovery (SamplesPerPixel, Compression, the
    dimensions, PlanarConfiguration, RowsPerStrip, ExtraSamples,
    BitsPerSample, SampleFormat, Min/MaxSampleValue), whose wrong type,
    count or value refuses the file; the strip or tile offsets and byte
    counts read up to the number the image has and padded with zeros
    (TIFFFetchStripThing), the byte counts estimated where they are
    missing from a one-strip image (EstimateStripByteCounts)."""

    def __init__(self, blob: bytes, e: str, pos: int, bigtiff: bool):
        self.blob, self.e, self.bigtiff = blob, e, bigtiff
        count_fmt, entry = ("Q", 20) if bigtiff else ("H", 12)
        head = struct.calcsize(count_fmt)
        n = struct.unpack_from(e + count_fmt, blob, pos)[0]
        self.kinds = []  # every entry's type, for the estimate of byte counts
        self.ents = {}  # tag -> (type, count, position of the value field, entry index)
        for i in range(n):
            at = pos + head + entry * i
            tag, kind = struct.unpack_from(e + "HH", blob, at)
            count = struct.unpack_from(e + ("Q" if bigtiff else "I"), blob, at + 4)[0]
            self.kinds.append((kind, count))
            self.ents.setdefault(tag, (kind, count, at + entry - (8 if bigtiff else 4), i))
        self.spp = self.one(277, _U16, 1)
        if self.spp == 0:
            raise ValueError("TIFF with SamplesPerPixel 0 (libtiff refuses it)")
        self.per_sample(259)
        for tag in (256, 257, 32997, 322, 323, 32998):
            self.one(tag, _U32)
        if self.one(284, _U16, 1) not in (1, 2):
            raise ValueError("TIFF with a PlanarConfiguration libtiff refuses")
        if self.one(278, _U32) == 0:
            raise ValueError("TIFF with RowsPerStrip 0 (libtiff refuses it)")
        if 338 in self.ents:
            extra = self.values(338)
            if len(extra) > self.spp or any(v > 2 for v in extra):
                raise ValueError("TIFF with ExtraSamples libtiff refuses")
        for tag in (258, 339, 280, 281):
            v = self.per_sample(tag)
            if tag == 339 and v is not None and not 1 <= v <= 6:
                raise ValueError(f"TIFF with SampleFormat {v} (libtiff refuses it)")
            if tag == 258:
                self.bits = 1 if v is None else v

    def fill_order(self) -> int:
        """FillOrder as libtiff sets it: the tag's value where it reads as
        one value of 1 or 2, else 1 (libtiff passes the tag over)."""
        try:
            v = self.one(266, _U16, 1)
        except ValueError:
            return 1
        return v if v in (1, 2) else 1

    def palette_refused(self) -> bool:
        """libtiff's TIFFReadDirectory refuses a palette image of fewer than
        8 bits whose ColorMap it does not take ("missing required Colormap"):
        one that is absent, comes before BitsPerSample in the directory, or
        holds other than 3 << bits values of 16 bits."""
        try:
            photometric = self.one(262, _U16)
        except ValueError:
            return False
        if photometric != 3 or self.bits >= 8:
            return False
        if 320 not in self.ents or 258 not in self.ents or self.ents[258][3] > self.ents[320][3]:
            return True
        if self.ents[320][1] != 3 << self.bits:
            return True
        try:
            return max(self.values(320)) > _U16
        except ValueError:
            return True

    def values(self, tag: int, limit: int | None = None) -> tuple:
        """The tag's values as TIFFReadDirEntry*Array reads them (at most
        ``limit``); ValueError where the read fails."""
        kind, count, at, _ = self.ents[tag]
        if kind not in _LIBTIFF_INT:
            raise ValueError(f"TIFF tag {tag} of type {kind} (libtiff: incompatible type)")
        size = _TYPE_SIZE[kind]
        n = count if limit is None else min(count, limit)
        if size * count > (8 if self.bigtiff else 4):
            at = struct.unpack_from(self.e + ("Q" if self.bigtiff else "I"), self.blob, at)[0]
        if at + size * n > len(self.blob):
            raise ValueError(f"TIFF tag {tag}'s values past the end of the file (libtiff "
                             "cannot read them)")
        v = struct.unpack_from(f"{self.e}{n}{_LIBTIFF_INT[kind]}", self.blob, at)
        if any(x < 0 for x in v):
            raise ValueError(f"TIFF tag {tag} with a negative value (libtiff refuses it)")
        return v

    def one(self, tag: int, top: int, default=None):
        """A tag of one value (TIFFReadDirEntryShort or Long)."""
        if tag not in self.ents:
            return default
        if self.ents[tag][1] != 1:
            raise ValueError(f"TIFF tag {tag} of {self.ents[tag][1]} values (libtiff refuses "
                             "it)")
        (v,) = self.values(tag)
        if v > top:
            raise ValueError(f"TIFF tag {tag} of value {v} (libtiff refuses it)")
        return v

    def per_sample(self, tag: int):
        """A tag of one value, or of one a sample, all the same."""
        if tag not in self.ents or self.ents[tag][1] == 1:
            return self.one(tag, _U16)
        if self.ents[tag][1] < self.spp:
            raise ValueError(f"TIFF tag {tag} of fewer values than samples (libtiff refuses "
                             "it)")
        v = self.values(tag)
        if max(v) > _U16 or len(set(v[:self.spp])) > 1:
            raise ValueError(f"TIFF tag {tag} of different values a sample (libtiff cannot "
                             "handle them)")
        return v[0]

    def strips(self, n: int, tiled: bool, planar: int) -> tuple[list, list]:
        """(offsets, byte counts) of the image's ``n`` strips or tiles."""
        def last(*tags):  # StripOffsets and TileOffsets fill one slot: the later entry's
            got = [t for t in tags if t in self.ents]
            return max(got, key=lambda t: self.ents[t][3]) if got else None

        def read(tag):
            v = list(self.values(tag, n))
            return v + [0] * (n - len(v))

        offsets_tag, counts_tag = last(273, 324), last(279, 325)
        if offsets_tag is None:
            raise ValueError("TIFF without strip or tile offsets (unknown data organization)")
        offsets = read(offsets_tag)
        if counts_tag is None:
            if (planar == 1 and n > 1) or (planar == 2 and n != self.spp):
                raise ValueError("TIFF without the byte counts of its strips or tiles")
            return offsets, self._estimate(offsets, planar)
        counts = read(counts_tag)
        if n == 1 and not tiled and offsets[0] and not counts[0]:
            counts = self._estimate(offsets, planar)
        return offsets, counts

    def _estimate(self, offsets: list, planar: int) -> list:
        """EstimateStripByteCounts of a compressed file: the file's bytes
        less the header, the directory and the values it points to, and the
        last strip cut at the end of the file."""
        space = (16 + 8 + 20 * len(self.kinds) + 8 if self.bigtiff else
                 8 + 2 + 12 * len(self.kinds) + 4)
        for kind, count in self.kinds:
            if kind not in _TYPE_SIZE:
                raise ValueError(f"TIFF entry of unknown type {kind} (libtiff cannot size it)")
            size = _TYPE_SIZE[kind] * count
            space += size if size > (8 if self.bigtiff else 4) else 0
        size = len(self.blob)
        space = size if size < space else size - space
        if planar == 2:
            space //= self.spp
        counts = [space] * len(offsets)
        if offsets[-1] + counts[-1] > size:
            counts[-1] = 0 if offsets[-1] >= size else size - offsets[-1]
        return counts

    def floats(self, tag: int, n: int, default: tuple) -> tuple:
        """A float tag of ``n`` values (YCbCrCoefficients,
        ReferenceBlackWhite) as TIFFReadDirEntryFloatArray reads it: a
        RATIONAL as float numerator over float denominator (0 where that
        is 0); ``default`` where the tag is absent or libtiff passes it
        over."""
        if tag not in self.ents or self.ents[tag][1] != n:
            return default
        kind, count, at, _ = self.ents[tag]
        codes = {**_LIBTIFF_INT, 5: "I", 10: "i", 11: "f", 12: "d"}
        if kind not in codes:
            return default
        size = _TYPE_SIZE[kind]
        if size * count > (8 if self.bigtiff else 4):
            at = struct.unpack_from(self.e + ("Q" if self.bigtiff else "I"), self.blob, at)[0]
        k = 2 * n if kind in (5, 10) else n
        if at + size * n > len(self.blob):
            return default
        v = np.array(struct.unpack_from(f"{self.e}{k}{codes[kind]}", self.blob, at), np.float64)
        if kind in (5, 10):
            num, den = v[0::2].astype(np.float32), v[1::2].astype(np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.where(den == 0, np.float32(0), num / np.where(den == 0, 1, den))
        return tuple(float(np.float32(x)) for x in v)

    def ycbcr_subsampling(self, jpeg: bool, offsets: list, counts: list) -> tuple:
        """YCbCrSubsampling as libtiff holds it: the tag where it fetches it
        (two values), else for JPEG the first strip's SOF factors
        (JPEGFixupTagsSubsampling), else (2, 2)."""
        if 530 in self.ents and self.ents[530][1] == 2:
            try:
                v = self.values(530)
                if max(v) <= _U16:
                    return v
            except ValueError:
                pass
        if jpeg and offsets:
            got = _sof_sampling(self.blob[offsets[0]:offsets[0] + counts[0]], self.spp)
            if got:
                return got
        return (2, 2)


def _sof_sampling(data: bytes, spp: int):
    """JPEGFixupTagsSubsamplingSec: the luma sampling factors of the first
    SOF in a strip's bytes, where its other components are 1x1 and the
    factors are 1, 2 or 4; None where it finds none."""
    pos = 0
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            return None
        m = data[pos]
        pos += 1
        if m == 0xD8:
            continue
        if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
            if pos + 2 > len(data):
                return None
            n = data[pos] << 8 | data[pos + 1]
            if n < 2:
                return None
            pos += n
            continue
        if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            return None
        if pos + 2 > len(data) or (data[pos] << 8 | data[pos + 1]) != 8 + 3 * spp:
            return None
        at = pos + 9
        if at >= len(data):
            return None
        ph, pv = data[at] >> 4, data[at] & 15
        for o in range(1, spp):
            if at + 3 * o >= len(data):
                return None
            if data[at + 3 * o] != 0x11:
                return None
        if ph not in (1, 2, 4) or pv not in (1, 2, 4):
            return None
        return ph, pv


def _packbits(data: bytes, size: int, partial: bool = False) -> bytes:
    """``size`` bytes of PackBits; with ``partial`` the bytes before the
    data end, else ValueError there."""
    out, pos = bytearray(), 0
    while len(out) < size and pos < len(data):
        n = data[pos]
        if n < 128:
            out += data[pos + 1:pos + 2 + n]
            pos += 2 + n
        elif n > 128 and pos + 1 < len(data):
            out += data[pos + 1:pos + 2] * (257 - n)
            pos += 2
        else:
            pos += 1
    if len(out) < size and not partial:
        raise ValueError("TIFF PackBits data ends early (truncated file)")
    return bytes(out[:size])


def _unxz(data: bytes, size: int) -> bytes:
    """libtiff's LZMA decode of a strip: up to ``size`` bytes.  libtiff asks
    liblzma for the strip's bytes in one call and keeps them if they all
    came, even when that call then reports damage (io/xz.py); the clean
    path is Python's ``lzma``, and where it raises io/xz.py gives the bytes
    liblzma wrote before its error."""
    try:
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(data, size)
    except lzma.LZMAError as exc:
        got = xz.decode_until_error(data, size)
        if len(got) >= size:
            return got
        raise ValueError(f"corrupt TIFF LZMA data ({exc})") from None


def _inflate(data: bytes, comp: int, size: int) -> np.ndarray:
    """One LZW, PackBits, Deflate, LZMA or Zstandard strip or tile -> its
    ``size`` bytes, as libtiff."""
    if comp == 5:
        if len(data) >= 2 and data[0] == 0 and data[1] & 1:
            raise ValueError("unsupported TIFF (old-style LZW)")
        out, status = decode_lzw(data, 8, True, size)
        if status != OK:
            raise ValueError("corrupt TIFF LZW data" if status == 2 else
                             "TIFF LZW data ends early (truncated file)")
    elif comp == 32773:
        out = np.frombuffer(_packbits(data, size), np.uint8)
    elif comp == 34925:
        out = np.frombuffer(_unxz(data, size), np.uint8)
    elif comp == 50000:
        try:
            out = np.frombuffer(zstd.decode(data, size), np.uint8)
        except zstd.ZstdError as exc:
            raise ValueError(f"corrupt TIFF Zstandard data ({exc})") from None
    else:
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(data, size), np.uint8)
        except zlib.error as exc:
            raise ValueError(f"corrupt TIFF Deflate data ({exc})") from None
    if out.size < size:
        raise ValueError("TIFF image data ends early (truncated file)")
    return out


def _jpeg_chunk(data: bytes, tables: bytes, photo: int, spp: int, sub: tuple,
                seg: tuple, last_strip: bool, state: dict) -> np.ndarray:
    """One JPEG strip or tile -> ((rows, columns, spp) uint8, the rows and
    columns the stream wrote), after libtiff's JPEGPreDecode checks of its
    size, components and sampling factors: a stream smaller than its strip
    or tile only warns, and leaves the rest of libtiff's buffer as it was."""
    out, factors = decode_jpeg_stream(data, tables, ycc=photo == 6, state=state)
    sh, sw = out.shape[:2]
    gw, gh = seg
    if sw > gw or (sh > gh and not (last_strip and sw == gw)):
        raise ValueError(f"unsupported TIFF (a JPEG stream of {sw}x{sh} for a strip or tile "
                         f"of {gw}x{gh})")
    if out.shape[2] != spp:
        raise ValueError(f"unsupported TIFF (a JPEG stream of {out.shape[2]} components for "
                         f"{spp} samples a pixel)")
    if factors[0] != sub or any(f != (1, 1) for f in factors[1:]):
        raise ValueError(f"unsupported TIFF (JPEG sampling factors {factors} where "
                         f"YCbCrSubsampling is {sub})")
    rows = np.zeros((gh, gw, spp), np.uint8)
    rows[:min(sh, gh), :sw] = out[:gh]
    return rows, (min(sh, gh), sw)


def _predict_float(rows: np.ndarray, stride: int) -> np.ndarray:
    """libtiff's fpAcc on (h, row bytes): the bytes summed along the row
    ``stride`` apart, then the row's four byte planes (the most
    significant first) put back together -> (h, row bytes // 4) uint32."""
    h, n = rows.shape
    acc = rows.astype(np.int64).reshape(h, n // stride, stride).cumsum(axis=1) & 0xFF
    planes = acc.reshape(h, 4, n // 4)
    return (planes[:, 0] << 24 | planes[:, 1] << 16 | planes[:, 2] << 8
            | planes[:, 3]).astype(np.uint32)


def _samples(rows: np.ndarray, w: int, n: int, bits: int, big: bool) -> np.ndarray:
    """(h, row bytes) -> (h, w, n) int64 samples at their own depth."""
    h = rows.shape[0]
    if bits in (16, 32):
        k = bits // 8
        s = rows[:, :k * w * n].reshape(h, w * n, k).astype(np.int64)
        order = range(k) if big else range(k - 1, -1, -1)
        v = np.zeros(s.shape[:2], np.int64)
        for i in order:
            v = v << 8 | s[..., i]
        s = v
    elif bits == 12:
        b = rows[:, :-(-w * n * 12 // 8)].astype(np.int64)
        pairs = np.zeros((h, 3 * -(-(w * n) // 2)), np.int64)
        pairs[:, :b.shape[1]] = b
        t = pairs.reshape(h, -1, 3)
        s = np.stack([t[..., 0] << 4 | t[..., 1] >> 4, (t[..., 1] & 15) << 8 | t[..., 2]],
                     axis=-1).reshape(h, -1)[:, :w * n]
    else:
        s = unpack_bits(rows, w * n, bits)
    return s.reshape(h, w, n)


def decode_tiff(blob: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA of its first image, row 0 the top."""
    e, bigtiff, ifd_at = _header(blob)
    big = e == ">"
    tags = _ifd(blob, e, ifd_at, bigtiff)

    def get(tag, default=None):
        v = tags.get(tag, default)
        return v[0] if isinstance(v, tuple) and len(v) == 1 else v

    comp, planar, photo = get(259, 1), get(284, 1), get(262, 0)
    if comp not in _READ:
        raise ValueError(f"unsupported TIFF (compression {_COMPRESSIONS.get(comp, comp)})")
    # libtiff finds a compressed file's strips in its own reading of the
    # directory; Pillow's decides the mode
    layout = tags if comp == 1 else {**tags, **{
        k: v for k, v in _ifd(blob, e, ifd_at, bigtiff, skip=True).items()
        if k in (292, 317, 347)}}

    def lay(tag, default=None):
        v = layout.get(tag, default)
        return v[0] if isinstance(v, tuple) and len(v) == 1 else v

    if comp != 1 and (blob[3] == 0x2B or (bigtiff and blob[4:8] != b"\x08\0\0\0")):
        raise ValueError("unsupported TIFF (a BigTIFF header libtiff reads otherwise than "
                         "Pillow)")
    if comp != 1:  # libtiff's TIFFFetchDirectory reads the whole directory
        count_fmt, entry = ("Q", 20) if bigtiff else ("H", 12)
        n = struct.unpack_from(e + count_fmt, blob, ifd_at)[0]
        if n > 4096:
            raise ValueError("TIFF directory of more than 4096 entries (libtiff's sanity check "
                             "on the directory count)")
        if ifd_at + struct.calcsize(count_fmt) + entry * n > len(blob):
            raise ValueError("TIFF directory past the end of the file (libtiff cannot read it)")
    lt = _Libtiff(blob, e, ifd_at, bigtiff) if comp != 1 else None
    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF without its dimensions")
    w, h = get(256), get(257)
    if not isinstance(w, int) or not isinstance(h, int):
        raise ValueError("TIFF with invalid dimensions")
    check_size("TIFF", w, h)
    fill = get(266, 1)
    orientation = tags.get(274, (1,))[0]  # Pillow keeps the first of several values
    if isinstance(tags.get(274), bytes):
        orientation = 1  # exif_transpose finds no orientation it knows
    fmt = _ints(tags.get(339, (1,)))
    if len(fmt) > 1 and fmt == (1,) * len(fmt):
        fmt = (1,)
    bps, extra = _ints(tags.get(258, (1,))), _ints(tags.get(338, ()))
    spp = get(277, 1)
    if not isinstance(spp, int):  # several values: Pillow's mode lookup fails
        raise ValueError("TIFF with a SamplesPerPixel of several values")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    key = (big, photo, fmt, fill, bps, extra)
    if len(bps) != spp or key not in _MODES:
        raise ValueError(f"unsupported TIFF (photometric {photo}, sample format {fmt}, fill "
                         f"order {fill}, bits per sample {bps}, extra samples {extra})")
    kind, rawmode = _MODES[key]
    if kind in ("P", "PA") and 320 not in tags:  # fault C-10: Pillow's _setup raises
        # KeyError reading the ColorMap, and no later plugin takes the file
        raise ValueError("TIFF palette image without its ColorMap (tag 320): Pillow cannot "
                         "identify the file")
    if lt is not None and kind in ("P", "PA") and lt.palette_refused():  # fault C-12
        raise ValueError(f"TIFF palette of {lt.bits} bits whose ColorMap libtiff does not "
                         "take: libtiff refuses the directory")
    if comp != 1 and fill == 2:  # libtiff undoes the fill order: Pillow's fill order 1 key
        kind, rawmode = _MODES[(big, photo, fmt, 1, bps, extra)]
    elif rawmode in ("L;IR", "P;1R", "P;2R", "P;4R") and planar != 2:
        raise ValueError(f"unsupported TIFF (Pillow has no raw mode {rawmode})")
    bits = bps[0]
    # the bytes of a pixel as Pillow's raw mode reads them, for YCbCr's RGBX
    n_read = 4 if rawmode == "RGBX" and spp == 3 and comp == 1 else spp
    jpeg = comp == 7
    # YCbCr under a coding other than JPEG or none: libtiff's RGBA interface
    rgba = photo == 6 and comp not in (1, 7)
    if rgba and (lt.spp != 3 or lt.bits != 8 or extra or kind not in ("RGB", "L")):
        raise ValueError(f"unsupported TIFF (YCbCr of {lt.spp} samples of {lt.bits} bits "
                         f"under compression {_COMPRESSIONS.get(comp, comp)}; libtiff's RGBA "
                         "interface has no routine for it)")
    if (lt is not None and not rgba and planar == 1
            and lt.spp * lt.bits > sum(bps)):  # Pillow's libtiff decoder: TIFFStripSize
        # over the rows its mode reads
        raise ValueError(f"TIFF whose strips libtiff reads as {lt.spp} samples of {lt.bits} "
                         f"bits, more than Pillow's mode {kind} reads (Pillow refuses it)")
    if jpeg:
        if bits != 8 or planar != 1 or (photo == 6 and spp != 3):
            raise ValueError(f"unsupported TIFF (JPEG with {bits}-bit samples, planar "
                             f"configuration {planar}, photometric {photo})")
        if photo == 6:
            kind = "RGB"  # libjpeg's YCbCr -> RGB, Pillow's raw mode RGB
    fax = comp in (2, 3, 4)
    if fax and (bits != 1 or spp != 1):
        raise ValueError(f"unsupported TIFF (CCITT with {spp} samples of {bits} bits; libtiff "
                         "reads bilevel only)")
    # libtiff undoes the predictor for LZW, Deflate, LZMA and Zstandard only
    predictor = lay(317, 1) if comp in (5, 8, 32946, 34925, 50000) else 1
    if (predictor not in (1, 2, 3) or (predictor == 2 and bits not in (8, 16, 32))
            or (predictor == 3 and (fmt != (3,) or bits != 32))):
        raise ValueError(f"unsupported TIFF (predictor {predictor} at {bits} bits, sample "
                         f"format {fmt})")
    if lt is not None:  # libtiff's layout
        tiled = 322 in lt.ents or 323 in lt.ents
        if tiled:
            cw, ch = lt.one(322, _U32, 0), lt.one(323, _U32, 0)
        else:
            rows = lt.one(278, _U32, _U32)
            if not rgba and rows != _U32 and rows > 0x7FFFFFFF // -(-w * sum(bps) // 8):
                # fault C-14: Pillow's strip decoder checks RowsPerStrip, as libtiff
                # holds it, times a row's bytes against INT_MAX before it clamps
                raise ValueError(f"TIFF of {rows} rows a strip (Pillow's decoder: out of "
                                 "memory)")
            cw, ch = w, min(rows, h)
    else:
        if 273 not in layout and 324 not in layout:
            raise ValueError("TIFF without strip or tile offsets (unknown data organization)")
        tiled = 324 in layout
        if tiled:
            cw, ch = lay(322), lay(323)
            offsets, counts = layout[324], layout.get(325, ())
        else:
            rows = lay(278, h)
            if not isinstance(rows, int):  # several values: Pillow's strip setup fails
                raise ValueError("TIFF with a RowsPerStrip of several values")
            cw, ch = w, min(rows or h, h)
            offsets, counts = layout.get(273, ()), layout.get(279, ())
    if not cw or not ch or not isinstance(cw, int) or not isinstance(ch, int):
        raise ValueError("TIFF strips or tiles of no size")
    planes = spp if planar == 2 else 1
    across, down = -(-w // cw), -(-h // ch)
    per_plane = across * down
    if lt is not None:
        offsets, counts = lt.strips(planes * per_plane, tiled, planar)
    elif len(offsets) < planes * per_plane and planar == 2:
        raise ValueError("TIFF with fewer strip or tile offsets than its image needs")
    # a compressed strip's bits are reversed as libtiff reads FillOrder (fault
    # C-11: Pillow may stop reading the directory before the tag)
    reverse = (lt.fill_order() if lt is not None else fill) == 2
    if comp == 1 and planar == 2:
        # Pillow reads each plane with one letter of its raw mode, never reversed
        if (kind in ("LA", "PA") or len(offsets) != planes * per_plane
                or not all(c in "1LPRGBACMYKIF" for c in rawmode[:planes])):
            raise ValueError(f"unsupported TIFF (uncompressed, planar configuration 2, "
                             f"Pillow's raw mode {rawmode})")
        letter = rawmode[0]
        if letter in "IF" and kind != letter:
            raise ValueError(f"unsupported TIFF (uncompressed, planar configuration 2, "
                             f"Pillow's raw mode {letter} for its mode {kind})")
        bits = 1 if kind[0] == "1" else 32 if letter in "IF" else 8
        n_read, big, reverse = spp, False, False
        if letter in "IF":
            rawmode = "I;32S" if letter == "I" else "F;32F"
        else:
            kind = kind.rstrip("I")
    elif planar == 2 and "X" in rawmode and (not tiled or kind == "P") and not rgba:
        # strips: Pillow's libtiff decoder refuses them; palette tiles: its PX
        # unpacker reads two bytes a pixel from the one-byte plane, so the
        # lower half of a tile comes from past libtiff's tile buffer
        raise ValueError(f"unsupported TIFF ({'tiles' if tiled else 'strips'} in planar "
                         f"configuration 2 with unused samples, Pillow's raw mode {rawmode})")
    elif planar == 2 and photo == 2 and not extra and spp == 4:
        kind = "RGBa"  # libtiff's reading of an unlabelled fourth plane
    tables = bytes(layout.get(347, ()))
    sub = (1, 1)
    if photo == 6:
        sub = (lt.ycbcr_subsampling(jpeg, offsets, counts) if lt is not None else
               tuple(layout.get(530, (2, 2)))[:2])
        if (lt is not None and spp == 3 and planar == 1
                and not {*sub} <= {1, 2, 4}):  # TIFFScanlineSize64's check
            raise ValueError(f"TIFF with YCbCrSubsampling {sub} (libtiff refuses it)")
    if rgba:
        rgba_px = np.full((h, w, 4), 255, np.uint8)
        rgba_px[..., :3] = _ycbcr_rgba(blob, comp, lt.fill_order(), predictor, planar, sub, lt,
                                       (w, h), (tiled, cw, ch, across, down), offsets, counts)
        if kind == "L":  # Pillow's mode of one sample: its L unpacker takes the first
            # w bytes of each row of libtiff's RGBA raster
            rgba_px[..., :3] = rgba_px.reshape(h, 4 * w)[:, :w, None]
            rgba_px[..., 3] = 255
        return _orient_rgba(rgba_px, orientation)
    fax_state = FaxState(cw, comp, lay(292, 0) or 0) if fax else None
    jpeg_state: dict = {}  # the tables libtiff's one decompressor keeps across strips
    # (index of the strip or tile in the file's list, its region): libtiff
    # reads those the image needs; Pillow reads every offset of an
    # uncompressed file, a strip or tile past the image's last one again
    # over the first, in the order of the offsets, so the largest offset of
    # a region wins
    chunks = [(i, i) for i in range(planes * per_plane)]
    covered = np.zeros((down * ch, across * cw), bool)
    if comp == 1 and planar != 2:
        last = {}
        for i, off in enumerate(offsets):
            r = i % per_plane
            if r not in last or off >= offsets[last[r]]:
                last[r] = i
        chunks = sorted((i, r) for r, i in last.items())
    n = n_read if planar != 2 else 1
    # Pillow's stride of a raw tile at the right edge, in bytes
    expected = (3 if photo in (2, 6) else 4 if photo == 5 else 1) + len(extra)
    step = int(cw * sum(bps) / 8 / (expected if planar == 2 else 1))
    s = np.zeros((down * ch, across * cw, n_read), np.int64)
    for i, r in chunks:
        p, (ty, tx) = r // per_plane, divmod(r % per_plane, across)
        x, y, off = tx * cw, ty * ch, offsets[i]
        rh = min(ch, h - y) if comp == 1 or not tiled else ch
        rw = min(cw, w - x) if comp == 1 else cw
        row = -(-rw * n * bits // 8)
        if comp == 1:
            rows = raw_rows(blob, off, rh, row, step if x + cw > w else 0, False, "TIFF")
            if reverse:
                rows = _REVERSED[rows]
        else:
            if not counts[i]:
                raise ValueError("TIFF strip or tile of 0 bytes (libtiff refuses it)")
            if len(blob) < off + counts[i]:
                raise ValueError("TIFF strip or tile past the end of the file "
                                 "(truncated file)")
            data = blob[off:off + counts[i]]
            if reverse and not fax and not jpeg:  # libtiff's fax and JPEG codecs read
                # the data as stored (the fax decoder honours the fill order itself)
                data = _REVERSED[np.frombuffer(data, np.uint8)].tobytes()
            if jpeg:
                rows, (dh, dw) = _jpeg_chunk(data, tables, photo, spp, sub, (cw, rh),
                                             not tiled and y + ch >= h, jpeg_state)
                if dh < min(rh, h - y) or dw < min(cw, w - x):
                    raise ValueError(f"TIFF JPEG stream of {dw}x{dh} in strip or tile {i} of "
                                     f"{cw}x{rh}: Pillow shows bytes of libtiff's buffer "
                                     "that no decoder wrote (fault C-9)")
                rows = rows.reshape(rh, row)
            elif fax:
                rows = decode_fax(data, fax_state, rh, reverse)
            else:
                rows = _inflate(data, comp, rh * row)[:rh * row].reshape(rh, row)
        if predictor == 3:
            v = _predict_float(rows, n).astype(np.int64).reshape(rh, rw, n)
        else:
            v = _samples(rows, rw, n, bits, big)
        if predictor == 2:
            v = np.cumsum(v, axis=1) & ((1 << bits) - 1)
        s[y:y + rh, x:x + rw, p:p + n] = v
        covered[y:y + rh, x:x + rw] = True
    s, covered = s[:h, :w], covered[:h, :w]
    if comp != 1 and big and rawmode[-2:] in ("BS", "BF"):
        # libtiff hands Pillow native (little-endian) order; the raw mode
        # reads it big-endian
        k = bits // 8
        s = sum(((s >> (8 * j)) & 0xFF) << (8 * (k - 1 - j)) for j in range(k))
    if kind == "LAB" and planar == 2:  # Pillow's band unpackers "L", "A", "B"
        rawmode = "L"
    rgba = _convert(s[..., :spp] if n_read != spp else s, kind, bits, rawmode, tags)
    if planar == 2 and comp != 1 and kind in ("LA", "PA"):
        rgba[..., 3] = 0
    if not covered.all():  # an uncompressed file that lists too few strips or tiles:
        # the rest is Pillow's new image, zero in its mode
        rgba[~covered] = (_convert(np.zeros((1, 1, s.shape[2]), np.int64), kind, bits, rawmode,
                                   tags)[0, 0] if kind in ("P", "PA") else
                          (*lab_to_rgb(np.zeros((1, 3), np.uint8))[0], 0) if kind == "LAB" else
                          (255, 255, 255, 255) if kind == "CMYK" else
                          (0, 0, 0, 0) if kind in ("RGBA", "RGBa", "LA") else (0, 0, 0, 255))
    if orientation in _TRANSPOSES:
        rgba = np.ascontiguousarray(_TRANSPOSES[orientation](rgba))
    return rgba


def _inflate_partial(data: bytes, comp: int, size: int) -> np.ndarray:
    """One strip or tile as libtiff's codec writes it into the buffer: at
    most ``size`` bytes of LZW, PackBits, Deflate, LZMA or Zstandard, where
    the data are damaged the bytes it wrote before its error (libtiff zeroes
    the rest).  libtiff's LZW table starts below its first entry, so a first
    code other than Clear fails before any output; ZSTDDecode keeps nothing
    after an error of libzstd, and what libzstd flushed where the data ran
    out (io/zstd.decode_kept)."""
    if comp == 5:
        if len(data) >= 2 and data[0] == 0 and data[1] & 1:
            raise ValueError("unsupported TIFF (old-style LZW)")
        if len(data) < 2 or (data[0] << 1 | data[1] >> 7) != 256:
            return np.zeros(0, np.uint8)
        return decode_lzw(data, 8, True, size)[0][:size]
    if comp == 32773:
        return np.frombuffer(_packbits(data, size, partial=True), np.uint8)
    if comp == 34925:
        return np.frombuffer(xz.decode_until_error(data, size), np.uint8)[:size]
    if comp == 50000:
        return np.frombuffer(zstd.decode_kept(data, size), np.uint8)
    d, out = zlib.decompressobj(), bytearray()
    try:
        out += d.decompress(data, size)
    except zlib.error:  # the bytes inflate wrote before the error, fed a byte at a time
        d, out = zlib.decompressobj(), bytearray()
        try:
            for i in range(len(data)):
                out += d.decompress(data[i:i + 1], size - len(out))
                if len(out) >= size:
                    break
        except zlib.error:
            pass
    return np.frombuffer(bytes(out[:size]), np.uint8)


def _ycbcr_rgba(blob: bytes, comp: int, fill: int, predictor: int, planar: int, sub: tuple,
                lt: _Libtiff, size: tuple, grid: tuple, offsets, counts) -> np.ndarray:
    """A YCbCr TIFF under LZW, Deflate, PackBits, LZMA or Zstandard as Pillow
    reads it through libtiff's TIFFRGBAImageGet -> (H, W, 3) uint8, before
    the orientation: Pillow asks for a strip or a row of tiles at a time, and
    libtiff reads each strip (the rows it asks for: whole blocks, at most
    ``TIFFScanlineSize`` times their rows) or tile into a buffer it zeroes
    at the first and reuses for the rest of the row (one a plane in planar
    configuration 2, 1x1 only); io/tiff_rgba.py converts the blocks.  A
    strip or tile libtiff cannot read fails the first read of a row and
    reads as zeros after it; one whose data are damaged reads as what its
    codec wrote before the error, then zeros, undifferenced
    (``_inflate_partial``)."""
    w, h = size
    tiled, cw, ch, across, down = grid
    if planar != 1 and sub != (1, 1):
        raise ValueError(f"unsupported TIFF (YCbCr in planar configuration {planar} with "
                         f"subsampling {sub}; libtiff's RGBA interface has no routine for it)")
    if sub not in tiff_rgba.SUBSAMPLINGS:
        raise ValueError(f"unsupported TIFF (YCbCr subsampling {sub}; libtiff's RGBA "
                         "interface has no routine for it)")
    tables = tiff_rgba.ycbcr_tables(lt.floats(529, 3, tiff_rgba.DEFAULT_COEFFICIENTS),
                                    lt.floats(532, 6, tiff_rgba.DEFAULT_REFERENCE))
    hs, vs = sub
    planes = 3 if planar == 2 else 1
    block = 1 if planes == 3 else hs * vs + 2
    srs = -(-cw // hs) * block  # a row of blocks
    # the predictor's rows (PredictorDecodeTile) and its step (horAcc8)
    rowsize = (cw * (1 if planes == 3 else 3)) if tiled else srs // vs
    step = 1 if planes == 3 else 3
    out = np.zeros((h, w, 3), np.uint8)
    bufs: list = []
    for i in range(across * down):
        ty, tx = divmod(i, across)
        x, y = tx * cw, ty * ch
        rows, cols = min(ch, h - y), min(cw, w - x)
        want = (-(-ch // vs) * srs if tiled else
                min(-(-rows // vs) * vs * (srs // vs), -(-rows // vs) * srs))
        if tx == 0 or not tiled:  # Pillow's next TIFFRGBAImageGet: a strip, a row of tiles
            bufs = []
        for p in range(planes):
            off, count = offsets[p * across * down + i], counts[p * across * down + i]
            if not bufs and not (count and off + count <= len(blob)):  # TIFFFillStrip
                raise ValueError("TIFF strip or tile libtiff cannot read (the first of one "
                                 "of Pillow's RGBA reads)")
            if not bufs:
                bufs = [np.zeros(-(-ch // vs) * srs, np.uint8) for _ in range(planes)]
            bufs[p][:want] = 0  # libtiff zeroes what it was asked for where it fails
            if not (count and off + count <= len(blob)):
                continue
            data = blob[off:off + count]
            if fill == 2:
                data = _REVERSED[np.frombuffer(data, np.uint8)].tobytes()
            got = _inflate_partial(data, comp, want)
            if (got.size == want and predictor == 2 and comp != 32773
                    and not (want % rowsize or rowsize % step)):
                got = (got.reshape(-1, rowsize // step, step).astype(np.int64).cumsum(axis=1)
                       & 0xFF).astype(np.uint8).reshape(-1)
            bufs[p][:got.size] = got
        if planes == 3:
            ycc = [b[:rows * cw].reshape(rows, cw)[:, :cols] for b in bufs]
            out[y:y + rows, x:x + cols] = tiff_rgba.ycbcr_to_rgb(*ycc, tables)
        else:
            out[y:y + rows, x:x + cols] = tiff_rgba.blocks_to_rgb(
                bufs[0], rows, cols, tiff_rgba.row_bytes(cols, cw, sub), sub, tables)
    return out


def _orient_rgba(rgba: np.ndarray, orientation: int) -> np.ndarray:
    if orientation in _TRANSPOSES:
        rgba = np.ascontiguousarray(_TRANSPOSES[orientation](rgba))
    return rgba


# Pillow's exif_transpose of an orientation, applied after the decode at the
# file's own size: FLIP_LEFT_RIGHT, ROTATE_180, FLIP_TOP_BOTTOM, and for 5-8,
# which swap the axes, TRANSPOSE, ROTATE_270, TRANSVERSE and ROTATE_90
_TRANSPOSES = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
               5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a[::-1].transpose(1, 0, 2),
               7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
               8: lambda a: a[:, ::-1].transpose(1, 0, 2)}


def _convert(s: np.ndarray, kind: str, bits: int, rawmode: str, tags: dict) -> np.ndarray:
    h, w, _ = s.shape
    rgba = np.full((h, w, 4), 255, np.uint8)
    v8 = s >> 8 if bits == 16 else s
    if kind in ("I", "F"):
        g = s[..., 0]
        if kind == "F":  # the bits of an IEEE single, truncated toward zero and clipped
            f = g.astype(np.uint32).view(np.float32).astype(np.float64)
            g = np.where(f >= 255, 255, np.where(f > 0, np.trunc(np.nan_to_num(f)), 0))
        elif "S" in rawmode or "N" in rawmode:  # two's complement at the sample's width
            g = np.where(g >= 1 << (bits - 1), g - (1 << bits), g)
        rgba[..., :3] = np.clip(g, 0, 255).astype(np.uint8)[..., None]
    elif kind in ("1", "1I", "L", "LI", "I16", "LA"):
        g = s[..., 0]
        if kind == "I16":
            g = np.minimum(g, 255)
        else:
            top = (1 << bits) - 1
            g = (top - g if kind.endswith("I") else g) * (255 // top)
        rgba[..., :3] = g[..., None]
        if kind == "LA":
            rgba[..., 3] = s[..., 1]
    elif kind in ("P", "PA"):
        cmap = np.asarray(list(tags[320]), np.int64) // 256
        k = len(cmap) // 3
        if k > 256:  # Pillow's putpalette of "RGB;L"
            raise ValueError(f"TIFF ColorMap of {len(cmap)} values: invalid palette size")
        palette = np.zeros((256, 3), np.uint8)
        palette[:k] = cmap[:3 * k].reshape(3, k).T
        rgba[..., :3] = palette[s[..., 0]]
        if kind == "PA":
            rgba[..., 3] = s[..., 1]
    elif kind == "CMYK":
        rgba[..., :3] = cmyk_to_rgb([255 - s[..., c] for c in range(4)], ycck=False)
    elif kind == "LAB":  # Pillow's LAB unpacker flips a* and b* to littleCMS's offset
        # bytes and sets the pixel's fourth byte, which the conversion copies
        # to alpha; a plane a band (planar configuration 2) is copied as
        # stored and leaves that byte 0
        contig = rawmode == "LAB"
        rgba[..., :3] = lab_to_rgb(s[..., :3].astype(np.uint8) ^ np.uint8(128) * contig * _AB)
        rgba[..., 3] = 255 if contig else 0
    else:
        rgba[..., :3] = v8[..., :3]
        if kind == "RGBA":
            rgba[..., 3] = v8[..., 3]
        elif kind == "RGBa":
            a = v8[..., 3:4]
            c = np.where(a == 255, v8[..., :3],
                         np.minimum(255, v8[..., :3] * 255 // np.maximum(a, 1)))
            rgba[..., :3] = np.where(a == 0, 0, c)
            rgba[..., 3] = a[..., 0]
    return rgba
