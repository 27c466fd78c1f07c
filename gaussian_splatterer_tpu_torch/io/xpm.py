"""X11 pixmap (XPM) decoding, for textures on hosts without Pillow.

``decode_xpm(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12.1).

Coverage: the XPM 3 C array with colour keys ``c #rrggbb`` (any number of
hexadecimal digits, their low 24 bits) and ``c None``, any number of
characters a pixel; a palette image of up to 256 colours, RGB above.

Pillow's reading is kept with its quirks:

  * a colour line is cut at its first ``bpp`` characters after the quote
    and before its last two, so a line that does not end in ``",`` loses
    characters of its colour;
  * the ``None`` key gets no palette entry: a pixel of that key refuses
    the file, and where no pixel has it, the key's characters are set as
    the palette's first alphas (Pillow's ``putpalettealphas`` of the
    ``transparency`` bytes), so with a one-character key ``" "`` the
    first colour's alpha is 32;
  * pixel lines are read from the one after the colours on, the text
    between a line's first and last quotes, skipping one ``/* pixels */``
    line, until the pixels are enough; a line of more or fewer pixels
    than the width moves the rows after it.

Where Pillow refuses a file this module raises ValueError naming XPM: a
colour that is neither ``#...`` nor ``None`` or has no ``c`` key, a pixel
of a key the palette lacks, too few pixels, a number Pillow cannot read,
a file above Pillow's pixel limit.  A header line that never comes, a
colour line cut short, or a side of 0, turns the file away
(``NotThisFormat``).
"""

from __future__ import annotations

import io
import re

import numpy as np

from gaussian_splatterer_tpu_torch.io.pillow_open import check_size, falls_through

HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"/* XPM */")


def _open(blob: bytes) -> dict:
    """XpmImageFile._open with Pillow's exceptions."""
    fp = io.BytesIO(blob)
    fp.read(9)
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = HEAD.match(line)
        if m:
            break
    w, h = int(m.group(1)), int(m.group(2))
    palette_length, bpp = int(m.group(3)), int(m.group(4))
    palette, transparency = {}, None
    for _ in range(palette_length):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this driver")
    return {"w": w, "h": h, "bpp": bpp, "palette": palette, "transparency": transparency,
            "rgb": palette_length > 256, "pos": fp.tell()}


def opens(blob: bytes) -> dict:
    return falls_through(_open, blob)


def decode_xpm(blob: bytes) -> np.ndarray:
    """XPM bytes -> (H, W, 4) uint8 RGBA, row 0 the top of the picture."""
    head = opens(blob)
    w, h, bpp, palette = head["w"], head["h"], head["bpp"], head["palette"]
    check_size("XPM", w, h)
    keys = tuple(palette)
    fp = io.BytesIO(blob)
    fp.seek(head["pos"])
    need = w * h * (3 if head["rgb"] else 1)
    data = bytearray()
    pixel_header = False
    while len(data) < need:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if bpp == 0:
            raise ValueError("XPM of 0 characters a pixel (range() arg 3 must not be zero)")
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if head["rgb"]:
                if key not in palette:
                    raise ValueError(f"XPM pixel of a key {key!r} the colours lack (KeyError)")
                data += palette[key]
            elif key in palette:
                data.append(keys.index(key))
            else:
                raise ValueError(f"XPM pixel of a key {key!r} the palette lacks")
    if len(data) < need:
        raise ValueError("XPM pixels are too few (not enough image data)")
    rgba = np.full((h, w, 4), 255, np.uint8)
    v = np.frombuffer(bytes(data[:need]), np.uint8)
    if head["rgb"]:
        rgba[..., :3] = v.reshape(h, w, 3)
        return rgba
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    if keys:
        pal[:len(keys), :3] = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    if head["transparency"] is not None:
        t = np.frombuffer(head["transparency"], np.uint8)[:256]
        pal[:len(t), 3] = t
    return pal[v.reshape(h, w)]
