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

Pillow 12.1's order over the 43 formats it registers is ``ORDER``.  The
port reads 36 of them (TIFF is one, in every coding Pillow's libtiff
reads, Zstandard included; JPEG 2000 is one, JP2 or raw codestream);
``FOREIGN`` holds the other seven, each with its ``accept``: AVIF (ROADMAP
A-6c), and BUFR, EPS, GRIB, HDF5, MPEG and WMF, which give no pixels
without other software.  A file that a
foreign format takes is refused: Pillow reads it as that format, or turns
it away deeper in that software, which the port does not tell apart.

The formats before TGA whose ``accept`` could take a TGA's first bytes
(TGA has no signature: an ID length, a colour map type 0 or 1, an image
type 1, 2, 3, 9, 10 or 11), each read by the port but for two:

  * CUR (``00 00 02 00``: a true-colour TGA with no ID and no map), ICO
    (``00 00 01 00``) and PCX (ID length 10, no map), whose ``opens``
    keep their ``_open``'s checks: a TGA with no map entries counted is no
    cursor and no icon (Pillow's ``TypeError`` and ``IndexError``), and
    Pillow refuses a TGA with a 10-byte ID whose origin is (0, 0) as
    "unknown PCX mode", so the port does too;
  * AVIF takes "ftyp" and an AVIF brand at bytes 4-12; the port refuses
    such a file;
  * FLI takes 0xAF11 or 0xAF12 at bytes 4-5 and 0 or 3 at bytes 14-15, and
    its ``_open`` wants zeros at bytes 20-21, 42-79 and 88-127
    (io/fli.py);
  * GBR takes a big-endian header size of 20 or more and a version of 1
    or 2; its ``_open`` wants a colour depth of 1 or 4 at bytes 16-19,
    where a TGA holds its pixel depth (1, 8, 16, 24 or 32) and descriptor,
    so it never keeps a TGA (io/gbr.py);
  * IM, IMT, IPTC, PCD and SPIDER have no ``accept``.  IM needs a line
    feed in the first 100 bytes and header lines ``Key: value`` from the
    first byte on, which a TGA's (ID length, map type, image type) start
    cannot be unless its ID length is a letter and a ':' follows; IMT
    needs ``width``/``height``/``pixel n8`` lines; IPTC needs 0x1C (an ID
    of 28 bytes) and a map type in its record list, then raises
    ``OSError`` on a field length above 132 (the port refuses it too);
    PCD needs "PCD_" at byte 2048; SPIDER needs a float 1.0 at bytes
    16-19, where a TGA's pixel depth would be 0x3F or 0.  Each module's
    ``opens`` keeps these checks (io/im.py, io/imt.py, io/iptc.py,
    io/pcd.py, io/spider.py);
  * MPEG takes ``00 00 01 B3`` (an image type 1 TGA with no map, which
    Pillow's TGA plugin cannot decode) and opens it whenever its two
    12-bit sizes are not 0; the port refuses it;
  * BLP, BUFR, DCX, EPS, FITS, FTEX, GRIB, HDF5, JPEG2000, ICNS, MCIDAS,
    MSP, PIXAR and SUN take signatures whose second byte is not 0 or 1,
    or whose image type is 0, so they take no TGA (nor any file of the
    formats read before them).

WMF, XBM, XPM and XVThumb come after WebP; none of them takes a file of a
format before it.
"""

from __future__ import annotations

import struct

ORDER = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX",
         "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO",
         "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI",
         "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")

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


def _i32(b: bytes, o: int = 0, e: str = "<") -> int:
    return struct.unpack_from(e + "I", b, o)[0]


# -- the formats the port does not read --

def _avif_accept(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _mpeg_opens(blob: bytes) -> None:
    head = blob[:7]
    bits = int.from_bytes(head[4:7], "big") if len(head) == 7 else None
    if bits is None:
        raise IndexError("MPEG header ends early")
    if bits >> 12 == 0 or bits & 0xFFF == 0:
        raise SyntaxError("not identified by this driver")


def _magic(*prefixes: bytes):
    return lambda p: p.startswith(prefixes)


def _eps_accept(p: bytes) -> bool:
    return p.startswith(b"%!PS") or (len(p) >= 4 and _i32(p) == 0xC6D3D0C5)


def _grib_accept(p: bytes) -> bool:
    return len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1


def _mirror(check):
    return None if check is None else lambda blob: falls_through(check, blob)


# name -> (accept, opens or None)
FOREIGN = {name: (accept, _mirror(check)) for name, (accept, check) in {
    "AVIF": (_avif_accept, None),
    "BUFR": (_magic(b"BUFR", b"ZCZC"), None),
    "EPS": (_eps_accept, None),
    "GRIB": (_grib_accept, None),
    "HDF5": (_magic(b"\x89HDF\r\n\x1a\n"), None),
    "MPEG": (_magic(b"\x00\x00\x01\xb3"), _mpeg_opens),
    "WMF": (_magic(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), None),
}.items()}
