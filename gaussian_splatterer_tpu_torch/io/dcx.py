"""Intel DCX (multi-page PCX) decoding with numpy, for textures on hosts
without Pillow.

``decode_dcx(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the first page, a PCX read as io/pcx.py reads one (every mode
it reads, with its quirks).

Pillow's reading is kept with its quirks: the page directory ends at its
first 0 or after 1024 entries; the page is read from its offset to the
end of the file, and an 8-bit page's 256-colour palette is sought 769
bytes from the end of the file, not of the page.

Where Pillow refuses a file this module raises ValueError naming PCX (the
page's faults, io/pcx.py).  A directory that ends early or holds no
page, or a page that is no PCX, turns the file away (``NotThisFormat``).
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io import pcx
from gaussian_splatterer_tpu_torch.io.pillow_open import falls_through

MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == MAGIC


def _open(blob: bytes) -> int:
    """DcxImageFile._open's directory with Pillow's exceptions -> the
    first page's offset."""
    offsets = []
    for i in range(1024):
        (offset,) = struct.unpack("<I", blob[4 + 4 * i:8 + 4 * i])
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise EOFError("attempt to seek outside sequence")
    return offsets[0]


def opens(blob: bytes) -> dict:
    """The directory and the first page's PCX header."""
    at = falls_through(_open, blob)
    return pcx.opens(blob[at:], blob)


def decode_dcx(blob: bytes) -> np.ndarray:
    """DCX bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the first page."""
    at = falls_through(_open, blob)
    return pcx.decode_pcx(blob[at:], blob)
