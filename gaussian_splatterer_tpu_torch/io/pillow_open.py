"""How Pillow's ``Image.open`` picks the plugin that reads a file, for the
texture dispatch of io/image.py.

``Image.open`` tries its plugins in the order of ``Image.ID``.  A plugin
whose ``accept`` takes the file's first 16 bytes (or that has no
``accept``) runs its ``_open``.  If ``_open`` raises ``SyntaxError``,
``IndexError``, ``TypeError``, ``KeyError``, ``EOFError`` or
``struct.error``, or leaves the image without a mode or with a side of 0,
Pillow tries the next plugin; any other error (``OSError``,
``ValueError``, ...) is raised to the caller, and the file is refused.
A reader of the port says "try the next one" by raising ``NotThisFormat``
and refuses a file by raising ``ValueError``.

Pillow 12.1's order over the formats it registers, up to WebP, is
``ORDER`` (WMF, XBM, XPM and XVThumb follow; none of them takes a file of
a format the port reads, all of which come before them).  The
port reads BMP, DIB, GIF, JPEG, PPM, PNG, CUR, PCX, DDS, ICO, TIFF, PSD,
QOI, SGI, TGA and WebP; for the others this module holds ``FOREIGN``: each
one's ``accept`` and, where its ``_open`` could turn away a file of a
format the port reads later in the order, a mirror of the checks of that
``_open`` (``opens``, raising ``NotThisFormat`` where Pillow would try the
next plugin).  A file that a foreign format takes is refused: Pillow reads
it as that format, which the port does not read.

The formats before TGA whose ``accept`` could take a TGA's first bytes
(TGA has no signature: an ID length, a colour map type 0 or 1, an image
type 1, 2, 3, 9, 10 or 11):

  * CUR (``00 00 02 00``: a true-colour TGA with no ID and no map), ICO
    (``00 00 01 00``) and PCX (ID length 10, no map) are read by the port,
    whose ``opens`` keep their ``_open``'s checks: a TGA with no map
    entries counted is no cursor and no icon (Pillow's ``TypeError`` and
    ``IndexError``), and Pillow refuses a TGA with a 10-byte ID whose
    origin is (0, 0) as "unknown PCX mode", so the port does too;
  * AVIF takes "ftyp" and an AVIF brand at bytes 4-12; the port refuses
    such a file (Pillow reads it as AVIF or turns it away deeper in
    libavif, which the port does not tell apart);
  * FLI takes 0xAF11 or 0xAF12 at bytes 4-5 and 0 or 3 at bytes 14-15;
    the port mirrors its header check (zeros at bytes 20-21, 42-79 and
    88-127) and refuses a file that passes it;
  * GBR takes a big-endian header size of 20 or more and a version of 1
    or 2; its ``_open`` wants a colour depth of 1 or 4 at bytes 16-19,
    where a TGA holds its pixel depth (1, 8, 16, 24 or 32) and descriptor,
    so it never keeps a TGA; the port mirrors the check all the same;
  * IM, IMT, IPTC, PCD and SPIDER have no ``accept``.  IM needs a line
    feed in the first 100 bytes and header lines ``Key: value`` from the
    first byte on, which a TGA's (ID length, map type, image type) start
    cannot be unless its ID length is a letter and a ':' follows; IMT
    needs ``width``/``height``/``pixel n8`` lines; IPTC needs 0x1C (an ID
    of 28 bytes) and a map type in its record list, then raises
    ``OSError`` on a field length above 132 (the port refuses it too);
    PCD needs "PCD_" at byte 2048; SPIDER needs a float 1.0 at bytes
    16-19, where a TGA's pixel depth would be 0x3F or 0.  The port
    mirrors each of these ``_open`` checks and refuses a file that passes
    them (past those checks Pillow reads the file as that format or
    refuses it);
  * MPEG takes ``00 00 01 B3`` (an image type 1 TGA with no map, which
    Pillow's TGA plugin cannot decode) and opens it whenever its two
    12-bit sizes are not 0; the port refuses it;
  * BLP, BUFR, DCX, EPS, FITS, FTEX, GRIB, HDF5, JPEG2000, ICNS, MCIDAS,
    MSP, PIXAR and SUN take signatures whose second byte is not 0 or 1,
    or whose image type is 0, so they take no TGA (nor any file of the
    formats the port reads); the port refuses what they take.
"""

from __future__ import annotations

import re
import struct

ORDER = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX",
         "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO",
         "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
         "SGI", "SPIDER", "SUN", "TGA", "WEBP")

# the errors of an ``_open`` on which Image.open tries the next plugin
FALLS_THROUGH = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)
MAX_PIXELS = 2 * 89_478_485  # Image._decompression_bomb_check raises above this


class NotThisFormat(Exception):
    """Pillow's ``_open`` of this format turns the file away, and Pillow
    tries the next plugin."""


def falls_through(check, blob: bytes):
    """Run ``check(blob)``, a mirror of an ``_open`` written with Pillow's
    exceptions: those on which Pillow tries the next plugin become
    ``NotThisFormat``, the others ``ValueError``."""
    try:
        return check(blob)
    except NotThisFormat:
        raise
    except FALLS_THROUGH as exc:
        raise NotThisFormat(str(exc) or type(exc).__name__) from None
    except Exception as exc:  # noqa: BLE001 (Pillow raises whatever its _open raised)
        raise ValueError(f"{type(exc).__name__}: {exc}") from None


def check_size(fmt: str, w: int, h: int) -> None:
    """Pillow's decompression bomb check, which refuses the file."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{fmt} image of {w}x{h} pixels is above Pillow's limit of "
                         f"{MAX_PIXELS} (decompression bomb)")


def _i16(b: bytes, o: int = 0, e: str = "<") -> int:
    return struct.unpack_from(e + "H", b, o)[0]


def _i32(b: bytes, o: int = 0, e: str = "<") -> int:
    return struct.unpack_from(e + "I", b, o)[0]


# -- formats the port does not read that could take a file it reads --

def _avif_accept(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _fli_accept(p: bytes) -> bool:
    return len(p) >= 16 and _i16(p, 4) in (0xAF11, 0xAF12) and _i16(p, 14) in (0, 3)


def _fli_opens(blob: bytes) -> None:
    s = blob[:128]
    if not (_fli_accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    _i16(blob[128:144], 4)


def _gbr_accept(p: bytes) -> bool:
    return len(p) >= 8 and _i32(p, 0, ">") >= 20 and _i32(p, 4, ">") in (1, 2)


def _gbr_opens(blob: bytes) -> None:
    header, version, w, h, depth = (_i32(blob[o:o + 4], 0, ">") for o in range(0, 20, 4))
    if header < 20 or version not in (1, 2) or w == 0 or h == 0 or depth not in (1, 4):
        raise SyntaxError("not a GIMP brush")
    if version == 2 and blob[20:24] != b"GIMP":
        raise SyntaxError("not a GIMP brush, bad magic number")


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
_IM_NUMBERS = ("File size (no of images)", "Scale (x,y)", "Image size (x*y)")


def _im_opens(blob: bytes) -> None:
    """IM's header lines up to the image data's 0x1A."""
    if b"\n" not in blob[:100]:
        raise SyntaxError("not an IM file")
    pos, n, s = 0, 0, b""
    while True:
        s = blob[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = blob.find(b"\n", pos)
        end = len(blob) if end < 0 else end + 1
        s, pos = s + blob[pos:end], end
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in _IM_NUMBERS:
            for t in v.replace("*", ",").split(","):
                try:
                    int(t)
                except ValueError:
                    float(t)  # a ValueError here reaches the caller
        n += k in _IM_TAGS
    if not n:
        raise SyntaxError("Not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = blob[pos:pos + 1]
        pos += len(s)
    if not s:
        raise SyntaxError("File truncated")


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_opens(blob: bytes) -> None:
    buffer, pos = blob[:100], min(100, len(blob))
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode = (0, 0), ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = blob[pos:pos + 1]
            pos += len(s)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += blob[pos:pos + 100]
            pos = min(pos + 100, len(blob))
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")


def _iptc_opens(blob: bytes) -> None:
    pos, info = 0, {}

    def field():
        nonlocal pos
        s = blob[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            c = blob[pos:pos + size - 128]
            pos += len(c)
            size = _iptc_int(c)
        else:
            size = _i16(s, 3, ">")
        return tag, size

    while True:
        tag, size = field()
        if not tag or tag == (8, 10):
            break
        data = blob[pos:pos + size] if size else None
        pos += len(data) if data else 0
        if tag in info:
            info[tag] = (info[tag] + [data]) if isinstance(info[tag], list) else [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        if (3, 65) in info:
            _band = info[(3, 65)][0] - 1  # noqa: F841 (its errors are Pillow's)
    w, h = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    if _iptc_int(info[(3, 120)]) not in (1, 5):
        raise OSError("Unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")


def _iptc_int(c) -> int:
    return _i32((b"\0\0\0\0" + c)[-4:], 0, ">")


def _mcidas_opens(blob: bytes) -> None:
    s = blob[:256]
    if len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0, *struct.unpack("!64i", s))
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    if w[10] <= 0 or w[9] <= 0:
        raise SyntaxError("not identified by this driver")


def _mpeg_opens(blob: bytes) -> None:
    head = blob[:7]
    bits = int.from_bytes(head[4:7], "big") if len(head) == 7 else None
    if bits is None:
        raise IndexError("MPEG header ends early")
    if bits >> 12 == 0 or bits & 0xFFF == 0:
        raise SyntaxError("not identified by this driver")


def _pcd_opens(blob: bytes) -> None:
    s = blob[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    if len(s) < 1539:
        raise IndexError("PCD header ends early")


def _spider_is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    h = (99,) + t
    if not all(_spider_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_opens(blob: bytes) -> None:
    f = blob[:108]
    t = struct.unpack(">27f", f)
    if not _spider_header(t):
        t = struct.unpack("<27f", f)
        if not _spider_header(t):
            raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber > 0:
        raise AttributeError("SpiderImageFile has no stack offset")  # as Pillow 12.1 does
    if not (istack == 0 and imgnumber == 0 or istack > 0 and imgnumber == 0):
        raise SyntaxError("inconsistent stack header values")
    if int(h[12]) <= 0 or int(h[2]) <= 0:
        raise SyntaxError("not identified by this driver")


def _magic(*prefixes: bytes):
    return lambda p: p.startswith(prefixes)


def _dcx_accept(p: bytes) -> bool:
    return len(p) >= 4 and _i32(p) == 0x3ADE68B1


def _eps_accept(p: bytes) -> bool:
    return p.startswith(b"%!PS") or (len(p) >= 4 and _i32(p) == 0xC6D3D0C5)


def _grib_accept(p: bytes) -> bool:
    return len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1


def _sun_accept(p: bytes) -> bool:
    return len(p) >= 4 and _i32(p, 0, ">") == 0x59A66A95


def _always(p: bytes) -> bool:
    return True


def _mirror(check):
    return None if check is None else lambda blob: falls_through(check, blob)


# name -> (accept, opens or None); the formats after TGA take nothing the
# port reads before them and are left out
FOREIGN = {name: (accept, _mirror(check)) for name, (accept, check) in {
    "AVIF": (_avif_accept, None),
    "BLP": (_magic(b"BLP1", b"BLP2"), None),
    "BUFR": (_magic(b"BUFR", b"ZCZC"), None),
    "DCX": (_dcx_accept, None),
    "EPS": (_eps_accept, None),
    "FITS": (_magic(b"SIMPLE"), None),
    "FLI": (_fli_accept, _fli_opens),
    "FTEX": (_magic(b"FTEX"), None),
    "GBR": (_gbr_accept, _gbr_opens),
    "GRIB": (_grib_accept, None),
    "HDF5": (_magic(b"\x89HDF\r\n\x1a\n"), None),
    "JPEG2000": (_magic(b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"), None),
    "ICNS": (_magic(b"icns"), None),
    "IM": (_always, _im_opens),
    "IMT": (_always, _imt_opens),
    "IPTC": (_always, _iptc_opens),
    "MCIDAS": (_magic(b"\x00\x00\x00\x00\x00\x00\x00\x04"), _mcidas_opens),
    "MPEG": (_magic(b"\x00\x00\x01\xb3"), _mpeg_opens),
    "MSP": (_magic(b"DanM", b"LinS"), None),
    "PCD": (_always, _pcd_opens),
    "PIXAR": (_magic(b"\200\350\000\000"), None),
    "SPIDER": (_always, _spider_opens),
    "SUN": (_sun_accept, None),
}.items()}
