"""FITS decoding with numpy, for textures on hosts without Pillow.

``decode_fits(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the primary image (or the first extension holding one), BITPIX
8, 16, 32, -32 and -64, one or two axes, raw rows; a tile-compressed
image (a ``BINTABLE`` extension with ``ZIMAGE = T`` and ``ZCMPTYPE =
'GZIP_1  '``) through stdlib ``gzip``.  Converted to RGBA as Pillow
converts ``L``, ``I;16``, ``I`` and ``F`` (clipped, floats truncated).

Pillow's reading is kept with its quirks:

  * rows are read bottom-up;
  * Pillow reads the raw samples in its raw modes ``I;16``, ``I`` and
    ``F``, which are little-endian (the machine's order), not FITS's
    big-endian, so a 16-bit 0x0102 reads 0x0201, and BITPIX -64 reads
    each 8-byte double as two little-endian floats, the rows running on
    at half a row;
  * the header is 80-byte cards up to ``END``, then the next 2880-byte
    boundary; a card past it that starts ``SIMPLE`` or ``XTENSION`` is
    read as a header too, and the data must hold at least one byte;
  * a gzip tile's pixels are taken as 4 bytes each, of which the last
    1 (BITPIX 8), 2 (16) or 4 (32) are kept, rows reversed; BITPIX -32
    and -64 keep none, which refuses the file.

Where Pillow refuses a file this module raises ValueError naming FITS: a
header with no image ("No image data") or a file that ends in its header,
a number Pillow cannot read, data that ends early, a gzip stream that
does not inflate, a file above Pillow's pixel limit.  A first card other
than ``SIMPLE = T``, a missing keyword, a BITPIX Pillow does not read, or
a side of 0 or below turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import gzip
import io
import math
import zlib

import numpy as np

from gaussian_splatterer_tpu_torch.io import rawmode
from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        plain = _size(headers, prefix) or (0, 0)
        offset = plain[0] * plain[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return "", 0, None, None, None
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, MODES.get(bits, ""), bits


def _open(blob: bytes) -> dict:
    """FitsImageFile._open with Pillow's exceptions."""
    fp = io.BytesIO(blob)
    headers: dict = {}
    in_progress = False
    decoder = ""
    while True:
        card = fp.read(80)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not decoder:
                decoder, offset, size, mode, bits = _parse(headers)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError("No image data")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("not identified by this driver")
    return {"decoder": decoder, "offset": offset + fp.tell() - 80, "w": size[0], "h": size[1],
            "mode": mode, "bits": bits}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


def decode_fits(blob: bytes) -> np.ndarray:
    """FITS bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    w, h, mode, offset = head["w"], head["h"], head["mode"], head["offset"]
    check_size("FITS", w, h)
    raw = {"L": "L", "I;16": "I;16", "I": "I", "F": "F"}[mode]
    n = rawmode.row_bytes(raw, w)
    if head["decoder"] == "raw":
        rows = rawmode.raw_rows(blob, offset, h, n, bottom_up=True, fmt="FITS")
    else:
        if offset < 0:
            raise ValueError("FITS data at a negative offset")
        try:
            value = gzip.decompress(blob[offset:])
        except (OSError, EOFError, zlib.error) as exc:
            raise ValueError(f"FITS gzip tile does not inflate ({exc})") from None
        keep = min(head["bits"] // 8, 4)
        # each pixel's last ``keep`` of its 4 bytes, the rows reversed; a
        # stream short of 4 bytes a pixel leaves the last pixel short
        if keep <= 0 or len(value) < 4 * w * h:
            data = b""
        else:
            px = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
            data = px[::-1, :, 4 - keep:].tobytes()
        if len(data) < n * h:
            raise ValueError("FITS gzip tile is too short (not enough image data)")
        rows = np.frombuffer(data, np.uint8, n * h).reshape(h, n)
    return rawmode.to_rgba(mode, rawmode.unpack(raw, rows, w))
