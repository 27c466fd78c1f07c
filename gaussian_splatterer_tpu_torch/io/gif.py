"""GIF decoding with numpy, for textures on hosts without Pillow.

``decode_gif(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12): the
first frame only, as Pillow opens an animated GIF.

Coverage: GIF87a and GIF89a; a global colour table, a local one, or
neither; interlaced or not; LZW (io/lzw.py) with clear codes, growing code
sizes and a full table; the Graphic Control Extension's transparent index;
comment, application and other extensions skipped.

Pillow's conversion is kept with its quirks:

  * a frame larger than the logical screen, or placed off its origin so
    that it reaches past it, grows the image to hold it; the pixels outside
    the frame take index 0, or the transparent index where there is one;
  * a colour table whose every entry i is (i, i, i), and a frame without
    one, read as grey: the index is the grey level; but a grey local table
    under a global one reads through the global one, and with a
    transparent index Pillow's conversion fails (refused by both);
  * an index past the colour table reads as opaque black; the transparent
    index reads as alpha 0 (its colour stays);
  * the frame ends at its last pixel: codes after it, the end code
    included, are not read.

Where Pillow refuses a file this module raises ValueError naming GIF: no
image, a minimum code size outside 2-8, a code the table does not hold,
image data that ends (or reaches its end code) before the frame's last
pixel.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch.io.lzw import BAD_CODE, decode_lzw


def _palette_needed(p: bytes) -> bool:
    """Pillow's test: a table is a palette unless entry i is (i, i, i)."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def _sub_blocks(blob: bytes, pos: int) -> bytes:
    """The data of the sub-blocks from ``pos`` as Pillow's decoder reads
    them: every whole block, empty ones skipped, until one does not fit in
    the file."""
    out = bytearray()
    while pos < len(blob) and pos + 1 + blob[pos] <= len(blob):
        out += blob[pos + 1:pos + 1 + blob[pos]]
        pos += 1 + blob[pos]
    return bytes(out)


def _skip_blocks(blob: bytes, pos: int) -> int:
    """Past the sub-blocks at ``pos`` and their terminator."""
    while pos < len(blob) and blob[pos]:
        pos += 1 + blob[pos]
    return pos + 1


def decode_gif(blob: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 4) uint8 RGBA of the first frame, row 0 the top."""
    if blob[:6] not in (b"GIF87a", b"GIF89a") or len(blob) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", blob, 6)
    pos = 13
    table = local = None  # a colour table, or None; the frame's: False if grey
    if flags & 0x80:
        p = blob[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        table = p if _palette_needed(p) else None
    transparency = frame = None
    while pos < len(blob) and blob[pos:pos + 1] != b";":
        kind = blob[pos:pos + 1]
        pos += 1
        if kind == b"!":
            if pos + 2 > len(blob):
                raise ValueError("GIF extension is cut short (truncated file)")
            label, size = blob[pos], blob[pos + 1]
            if label == 0xF9 and size:
                block = blob[pos + 2:pos + 2 + size]
                if len(block) < 4:
                    raise ValueError("GIF graphic control extension is cut short")
                if block[0] & 1:
                    transparency = block[3]
            pos = _skip_blocks(blob, pos + 1)
        elif kind == b",":
            if pos + 10 > len(blob):
                raise ValueError("GIF image descriptor is cut short (truncated file)")
            x0, y0, fw, fh, fflags = struct.unpack_from("<4HB", blob, pos)
            pos += 9
            if fflags & 0x80:
                p = blob[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(p)
                local = p if _palette_needed(p) else False
            if pos >= len(blob):
                raise ValueError("GIF image data is missing (truncated file)")
            frame = (x0, y0, fw, fh, bool(fflags & 0x40), blob[pos])
            pos += 1
            break
    if frame is None:
        raise ValueError("GIF without an image")
    x0, y0, fw, fh, interlace, min_bits = frame
    if not 2 <= min_bits <= 8:
        raise ValueError(f"unsupported GIF (LZW minimum code size {min_bits})")
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    idx = np.full((h, w), transparency or 0, np.uint8)
    if fw and fh:
        px, status = decode_lzw(_sub_blocks(blob, pos), min_bits, False, fw * fh)
        if status == BAD_CODE:
            raise ValueError("corrupt GIF image data (a code the table does not hold)")
        if px.size < fw * fh:
            raise ValueError("GIF image data ends early (truncated file)")
        px = px.reshape(fh, fw)
        if interlace:
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            px = px[np.argsort(order)]
        idx[y0:y0 + fh, x0:x0 + fw] = px
    if local is False and table is not None:
        # a grey frame under the global table: Pillow's image takes the
        # table's colours but keeps its grey mode, and its conversion of a
        # transparent index then fails (convert_transparent has no P -> RGBA)
        if transparency is not None:
            raise ValueError("unsupported GIF (a grey local table under a global one, "
                             "with a transparent index: Pillow cannot convert it)")
    elif local is not None:
        table = local or None
    if table is None:
        rgba = np.repeat(idx[..., None], 4, axis=2)
        rgba[..., 3] = 255
    else:
        n = len(table) // 3
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        palette[:n, :3] = np.frombuffer(table, np.uint8, 3 * n).reshape(n, 3)
        rgba = palette[idx]
    if transparency is not None:
        rgba[idx == transparency, 3] = 0
    return rgba
