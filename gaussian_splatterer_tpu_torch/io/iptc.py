"""IPTC/NAA image decoding with numpy, for textures on hosts without
Pillow.

``decode_iptc(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the record list (``0x1C`` fields, short and extended lengths)
up to the first image data field (8, 10), then the data of that field
and the (8, 10) fields that follow it, joined: raw grey (compression 1,
read as Pillow reads it, a PGM of the record's size) or a JPEG
(compression 5, io/jpeg.py).  A one-layer image is that grey or that
JPEG; a three- or four-layer image (RGB, CMYK) holds only its band
(3, 65) from the data, the other bands 0.

Pillow's reading is kept with its quirks: a band number of 0 fills the
last band; a JPEG of a one-layer record keeps its colours.

Where Pillow refuses a file this module raises ValueError naming IPTC: a
field length over 132, a compression other than 1 and 5, a record list
without image data, a band past the image's, data of a three- or
four-layer image that is not grey, data Pillow does not read as PGM or
JPEG here (the port reads no other format inside a record, where Pillow
opens whatever the data holds), a file above Pillow's pixel limit.  A
field that is not an IPTC field, a record without the layer, size or
compression fields Pillow looks for, an unnamed mode or a side of 0
turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

COMPRESSION = {1: "raw", 5: "jpeg"}
TAGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _int(c) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


class _Fields:
    def __init__(self, blob: bytes, pos: int = 0):
        self.blob, self.pos = blob, pos

    def read(self, n: int) -> bytes:
        s = self.blob[self.pos:self.pos + max(n, 0)] if n >= 0 else self.blob[self.pos:]
        self.pos += len(s)
        return s

    def field(self):
        """IptcImageFile.field: (tag or None, size)."""
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in TAGS:
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _int(self.read(size - 128))
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        return tag, size


def _open(blob: bytes) -> dict:
    """IptcImageFile._open with Pillow's exceptions."""
    f, info = _Fields(blob), {}
    while True:
        offset = f.pos
        tag, size = f.field()
        if not tag or tag == (8, 10):
            break
        data = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] + [data]) if isinstance(info[tag], list) else [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    w, h = _int(info[(3, 20)]), _int(info[(3, 30)])
    try:
        compression = COMPRESSION[_int(info[(3, 120)])]
    except KeyError:
        raise OSError("Unknown IPTC image compression") from None
    if not mode or w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return {"mode": mode, "band": band, "w": w, "h": h, "compression": compression,
            "offset": offset if tag == (8, 10) else None}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


def _payload(blob: bytes, offset: int) -> bytes:
    f, out = _Fields(blob, offset), bytearray()
    while True:
        tag, size = f.field()
        if tag != (8, 10):
            return bytes(out)
        out += f.read(size)


def decode_iptc(blob: bytes) -> np.ndarray:
    """IPTC bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    from gaussian_splatterer_tpu_torch.io import jpeg, pnm

    head = opens(blob)
    w, h, mode, band = head["w"], head["h"], head["mode"], head["band"]
    check_size("IPTC", w, h)
    if head["offset"] is None:
        raise ValueError("IPTC record without image data (the image has no data)")
    try:
        data = _payload(blob, head["offset"])
    except (SyntaxError, OSError, IndexError, struct.error) as exc:
        raise ValueError(f"IPTC image data: {exc}") from None
    if head["compression"] == "raw":
        grey = pnm.decode_pnm(b"P5\n%d %d\n255\n" % (w, h) + data)
        single = True
    elif data[:3] == b"\xff\xd8\xff":
        grey = jpeg.decode_jpeg(data)
        try:
            single = len(jpeg._decode(data)[1]) == 1
        except (IndexError, KeyError, TypeError, struct.error):
            single = False
    else:
        raise ValueError("IPTC image data that is neither raw nor a JPEG (the port reads "
                         "no other format inside a record)")
    if band is None:
        return grey
    if not single:
        raise ValueError("IPTC band data that is not grey (Image.merge: mode mismatch)")
    bands = {"RGB": 3, "CMYK": 4}[mode]
    if not -bands <= band < bands:
        raise ValueError(f"IPTC band {band} past the image's {bands}")
    gh, gw = grey.shape[:2]
    v = np.zeros((gh, gw, bands), np.uint8)
    v[..., band] = grey[..., 0]
    return rawmode.to_rgba(mode, v)
