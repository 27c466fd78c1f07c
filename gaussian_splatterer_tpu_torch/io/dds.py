"""DDS decoding with numpy, for textures on hosts without Pillow.

``decode_dds(blob)`` gives the (H, W, 4) uint8 RGBA that Pillow's
``Image.open(path).convert("RGBA")`` gives, byte for byte (Pillow 12's
``DdsImagePlugin`` and its BCn decoder, rounding included).  The first
surface only, as Pillow reads it: mipmaps, cube faces and array slices
after it are ignored.

Coverage: the legacy header with uncompressed RGB or RGBA by their bit
masks, 8-bit luminance, 16-bit luminance and alpha, 8-bit palette (a
256-entry RGBA table), and the FourCCs ``DXT1``, ``DXT3``, ``DXT5``,
``ATI1`` and ``BC4U`` (BC4), ``ATI2`` and ``BC5U`` (BC5), ``BC5S``; the DX10
header with BC1-BC5 (``TYPELESS`` and ``UNORM``, ``BC5_SNORM``), BC6H
(``UF16`` and ``SF16``, opaque RGB), BC7 (``TYPELESS``, ``UNORM``,
``UNORM_SRGB``) and ``R8G8B8A8`` (``TYPELESS``, ``UNORM``, ``UNORM_SRGB``).
BC6H's blocks run in C++ (``native/src/codecs.cpp``) where the native
library is built, else in ``bc6h_python``, their plain twin.

Pillow's decoding is kept with its quirks:

  * BC1's endpoints expand as ``(v << 3) | (v >> 2)`` (and ``<< 2 | >> 4``
    for green); its third and fourth colours are ``(2 a + b) // 3`` and
    ``(a + 2 b) // 3``, or where the first endpoint is not above the second
    ``(a + b) // 2`` and transparent black (alpha 0, the punch-through
    texels); DXT3 and DXT5 always use the four-colour form;
  * BC4, BC5 and DXT5 alpha interpolate with truncating division by 7 or 5;
    BC5S adds 128 to its signed endpoints; BC4 is grey, BC5 is red and
    green with blue 0 (128 for BC5S);
  * BC7 weights at 6 bits, ``((64 - w) a + w b + 32) >> 6``; a block of the
    reserved mode (first byte 0) reads as opaque black;
  * BC6H: the fourteen modes of the format's bit layouts; its weights
    without the rounding term, ``((64 - w) a + w b) >> 6``; an SF16
    endpoint that a delta transforms at fewer than 16 bits is not sign
    extended again (so a negative one reads as a large positive); each half
    float clipped to [0, 1] and scaled to 8 bits by truncation,
    ``int(f * 255)`` in single precision; the reserved modes (first five
    bits 10011, 10111, 11011, 11111) read as black;
  * an uncompressed mask scales as ``int(v / max * 255)``; data that ends
    inside it reads as zeros.

Where Pillow refuses a file this module raises ValueError naming DDS: a
header other than 124 bytes, ``BC6H_TYPELESS`` and the other DXGI formats
and FourCCs, luminance at other depths, unknown pixel format flags, image
data that ends early.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io.bmp import raw_rows

_ALPHAPIXELS, _FOURCC, _PALETTE8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
_FOURCCS = {b"DXT1": 1, b"DXT3": 2, b"DXT5": 3, b"BC4U": 4, b"ATI1": 4, b"ATI2": 5,
            b"BC5U": 5, b"BC5S": -5}
# DXGI format -> BCn (negative: signed), "rgba" for R8G8B8A8
_DXGI = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 79: 4, 80: 4, 82: 5, 83: 5, 84: -5,
         95: 6, 96: -6, 97: 7, 98: 7, 99: 7, 27: "rgba", 28: "rgba", 29: "rgba"}

# BC7: (subsets, partition bits, rotation bits, index selection bits, colour
# bits, alpha bits, endpoint p-bits, shared p-bits, index bits, second index
# bits) of modes 0-7
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# the subset of each texel: two subsets one bit a texel, three two bits
_BC7_P2 = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_BC7_P3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254)
# the anchor texel of the second subset of two, and of the second and third of three
_BC7_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
           15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
           15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
           6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_BC7_A3B = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
            3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
            8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
            3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_BC7_A3C = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
            15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
            15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
            15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_BC7_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
                4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}


# BC6H: the header fields after the mode bits, in stream order, of each
# mode (by the value of its first two bits, or five where those are 10 or
# 11); "x[a:b]" holds bits b up to a of field x, "x[a:b]" with a < b its
# bits from b down to a
_BC6_LAYOUTS = {
    0: "gy[4] by[4] bz[4] rw[9:0] gw[9:0] bw[9:0] rx[4:0] gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] "
       "bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3] d[4:0]",
    1: "gy[5] gz[4] gz[5] rw[6:0] bz[0] bz[1] by[4] gw[6:0] by[5] bz[2] gy[4] bw[6:0] bz[3] "
       "bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] by[3:0] ry[5:0] rz[5:0] d[4:0]",
    2: "rw[9:0] gw[9:0] bw[9:0] rx[4:0] rw[10] gy[3:0] gx[3:0] gw[10] bz[0] gz[3:0] bx[3:0] "
       "bw[10] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3] d[4:0]",
    6: "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] gz[4] gy[3:0] gx[4:0] gw[10] gz[3:0] bx[3:0] "
       "bw[10] bz[1] by[3:0] ry[3:0] bz[0] bz[2] rz[3:0] gy[4] bz[3] d[4:0]",
    10: "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] by[4] gy[3:0] gx[3:0] gw[10] bz[0] gz[3:0] "
        "bx[4:0] bw[10] by[3:0] ry[3:0] bz[1] bz[2] rz[3:0] bz[4] bz[3] d[4:0]",
    14: "rw[8:0] by[4] gw[8:0] gy[4] bw[8:0] bz[4] rx[4:0] gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] "
        "bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3] d[4:0]",
    18: "rw[7:0] gz[4] by[4] gw[7:0] bz[2] gy[4] bw[7:0] bz[3] bz[4] rx[5:0] gy[3:0] gx[4:0] "
        "bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[5:0] rz[5:0] d[4:0]",
    22: "rw[7:0] bz[0] by[4] gw[7:0] gy[5] gy[4] bw[7:0] gz[5] bz[4] rx[4:0] gz[4] gy[3:0] "
        "gx[5:0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3] d[4:0]",
    26: "rw[7:0] bz[1] by[4] gw[7:0] by[5] gy[4] bw[7:0] bz[5] bz[4] rx[4:0] gz[4] gy[3:0] "
        "gx[4:0] bz[0] gz[3:0] bx[5:0] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3] d[4:0]",
    30: "rw[5:0] gz[4] bz[0] bz[1] by[4] gw[5:0] gy[5] by[5] bz[2] gy[4] bw[5:0] gz[5] bz[3] "
        "bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] by[3:0] ry[5:0] rz[5:0] d[4:0]",
    3: "rw[9:0] gw[9:0] bw[9:0] rx[9:0] gx[9:0] bx[9:0]",
    7: "rw[9:0] gw[9:0] bw[9:0] rx[8:0] rw[10] gx[8:0] gw[10] bx[8:0] bw[10]",
    11: "rw[9:0] gw[9:0] bw[9:0] rx[7:0] rw[10:11] gx[7:0] gw[10:11] bx[7:0] bw[10:11]",
    15: "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10:15] gx[3:0] gw[10:15] bx[3:0] bw[10:15]",
}
# mode value -> (endpoint bits, delta bits of red, green and blue, deltas
# from the first endpoint)
_BC6_MODES = {0: (10, 5, 5, 5, 1), 1: (7, 6, 6, 6, 1), 2: (11, 5, 4, 4, 1), 6: (11, 4, 5, 4, 1),
              10: (11, 4, 4, 5, 1), 14: (9, 5, 5, 5, 1), 18: (8, 6, 5, 5, 1),
              22: (8, 5, 6, 5, 1), 26: (8, 5, 5, 6, 1), 30: (6, 6, 6, 6, 0),
              3: (10, 10, 10, 10, 0), 7: (11, 9, 9, 9, 1), 11: (12, 8, 8, 8, 1),
              15: (16, 4, 4, 4, 1)}
_BC6_FIELDS = ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz", "d")


def _bc6_pack(layout: str) -> list:
    """A layout -> [(field index, bit)] in stream order."""
    out = []
    for tok in layout.split():
        name, bits = tok[:-1].split("[")
        if ":" in bits:
            a, b = map(int, bits.split(":"))
            order = range(b, a + 1) if a >= b else range(b, a - 1, -1)
        else:
            order = [int(bits)]
        out += [(_BC6_FIELDS.index(name), k) for k in order]
    return out


_BC6_PACK = {m: _bc6_pack(layout) for m, layout in _BC6_LAYOUTS.items()}


def bc6h_table() -> np.ndarray:
    """BC6H's modes, bit layouts, partitions and weights as one int32 table
    for the native loop: per mode value 0-31 (valid, endpoint bits, delta
    bits r g b, transformed, two subsets, header bits after the mode), then
    per mode value 80 entries field * 16 + bit, then BC7's first 32
    two-subset partitions and their anchors, the 3- and 4-bit weights."""
    head = np.zeros((32, 8), np.int32)
    pack = np.zeros((32, 80), np.int32)
    for m, (epb, dr, dg, db, tr) in _BC6_MODES.items():
        head[m] = (1, epb, dr, dg, db, tr, m not in (3, 7, 11, 15), len(_BC6_PACK[m]))
        pack[m, :len(_BC6_PACK[m])] = [f * 16 + b for f, b in _BC6_PACK[m]]
    return np.concatenate([head.ravel(), pack.ravel(), _BC7_P2[:32], _BC7_A2[:32],
                           _BC7_WEIGHTS[3], _BC7_WEIGHTS[4]]).astype(np.int32)


def _sext(v: np.ndarray, n: int) -> np.ndarray:
    return np.where(v & (1 << (n - 1)), v - (1 << n), v)


def _bc6_unquantize(v: np.ndarray, n: int, signed: bool) -> np.ndarray:
    if not signed:
        if n >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << n) - 1, 0xFFFF,
                                            ((v << 16) + 0x8000) >> n))
    if n >= 16:
        return v
    a = np.abs(v)
    u = np.where(a == 0, 0, np.where(a >= (1 << (n - 1)) - 1, 0x7FFF,
                                     ((a << 15) + 0x4000) >> (n - 1)))
    return np.where(v < 0, -u, u)


def bc6h_python(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(N, 16) uint8 BC6H blocks -> (N, 16, 3) uint8 RGB texels, as
    Pillow's decoder gives them (its quirks in the module's docstring)."""
    n = len(blocks)
    out = np.zeros((n, 16, 3), np.uint8)
    if not n:
        return out
    bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    low = blocks[:, 0] & 3
    mode_of = np.where(low < 2, low, blocks[:, 0] & 31).astype(np.int64)
    texel = np.arange(16)
    for mode, pack in _BC6_PACK.items():
        sel = np.nonzero(mode_of == mode)[0]
        if not sel.size:
            continue
        bb = bits[sel]
        f = np.zeros((len(sel), 13), np.int64)
        pos = 2 if mode < 2 else 5
        for i, (fi, k) in enumerate(pack):
            f[:, fi] |= bb[:, pos + i] << k
        pos += len(pack)
        epb, *delta, tr = _BC6_MODES[mode]
        two = mode not in (3, 7, 11, 15)
        ne = 4 if two else 2
        e = f[:, :3 * ne].reshape(-1, ne, 3).copy()
        if signed:
            e[:, 0] = _sext(e[:, 0], epb)
        for j in range(1, ne):
            for c in range(3):
                if tr:
                    v = (e[:, 0, c] + _sext(e[:, j, c], delta[c])) & ((1 << epb) - 1)
                    e[:, j, c] = _sext(v, epb) if signed and epb == 16 else v
                elif signed:
                    e[:, j, c] = _sext(e[:, j, c], epb)
        e = _bc6_unquantize(e, epb, signed)
        if two:
            part = f[:, 12]
            subset = (np.asarray(_BC7_P2)[part][:, None] >> texel) & 1
            anchor = texel == np.asarray(_BC7_A2)[part][:, None]
            ib = 3
        else:
            subset = np.zeros((len(sel), 16), np.int64)
            anchor = np.zeros((len(sel), 16), bool)
            ib = 4
        anchor[:, 0] = True
        width = ib - anchor
        start = pos + np.cumsum(width, axis=1) - width
        k = np.arange(ib)
        grab = np.minimum(start[..., None] + k, 127).reshape(len(sel), -1)
        picked = np.take_along_axis(bb, grab, axis=1)
        idx = (picked.reshape(len(sel), 16, ib) * ((1 << k) * (k < width[..., None]))).sum(-1)
        w = np.asarray(_BC7_WEIGHTS[ib])[idx][..., None]
        e0 = np.take_along_axis(e, (2 * subset)[..., None], axis=1)
        e1 = np.take_along_axis(e, (2 * subset + 1)[..., None], axis=1)
        v = ((64 - w) * e0 + w * e1) >> 6
        if signed:
            mag = (np.abs(v) * 31) >> 5
            half = np.where(v < 0, 0x8000 | mag, mag)
        else:
            half = (v * 31) >> 6
        fl = half.astype(np.uint16).view(np.float16).astype(np.float32)
        out[sel] = np.where(fl < 0, 0, np.where(fl > 1, 255, (fl * np.float32(255)).astype(
            np.int64)))
    return out


def _bc6h(b: np.ndarray, signed: bool) -> np.ndarray:
    got = native.bc6h_decode(b, signed)
    return got if got is not None else bc6h_python(b, signed)


def _unpack565(c: np.ndarray) -> np.ndarray:
    """(N,) 16-bit colours -> (N, 3) int64 at 8 bits."""
    r, g, b = (c & 0xF800) >> 8, (c & 0x7E0) >> 3, (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], axis=-1)


def _bc1(blocks: np.ndarray, four_colour: bool) -> np.ndarray:
    """(N, 8) uint8 BC1 colour blocks -> (N, 16, 4) int64 RGBA."""
    b = blocks.astype(np.int64)
    c0, c1 = b[:, 0] | b[:, 1] << 8, b[:, 2] | b[:, 3] << 8
    lut = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24
    e0, e1 = _unpack565(c0), _unpack565(c1)
    four = (c0 > c1)[:, None] | four_colour
    p = np.zeros((len(b), 4, 4), np.int64)
    p[:, 0, :3], p[:, 1, :3] = e0, e1
    p[:, 2, :3] = np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p[:, 3, :3] = np.where(four, (e0 + 2 * e1) // 3, 0)
    p[:, :3, 3] = 255
    p[:, 3, 3] = np.where(four[:, 0], 255, 0)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(p, idx[..., None], axis=1)


def _bc3_alpha(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(N, 8) uint8 BC3 alpha / BC4 blocks -> (N, 16) int64."""
    b = blocks.astype(np.int64)
    a0, a1 = b[:, 0], b[:, 1]
    if signed:
        a0, a1 = (a0 ^ 0x80), (a1 ^ 0x80)  # int8 + 128
    lut = sum(b[:, 2 + k] << (8 * k) for k in range(6))
    t = np.zeros((len(b), 8), np.int64)
    t[:, 0], t[:, 1] = a0, a1
    gt = a0 > a1
    for k in range(1, 7):
        t[:, k + 1] = np.where(gt, ((7 - k) * a0 + k * a1) // 7,
                               ((5 - k) * a0 + k * a1) // 5 if k < 5 else (0 if k == 5 else 255))
    idx = (lut[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(t, idx, axis=1)


def _bc7(blocks: np.ndarray) -> np.ndarray:
    """(N, 16) uint8 BC7 blocks -> (N, 16, 4) int64 RGBA."""
    n = len(blocks)
    out = np.zeros((n, 16, 4), np.int64)
    out[..., 3] = 255  # the reserved mode: opaque black
    bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    lowest = np.array([(v & -v).bit_length() - 1 for v in range(256)])  # -1 for 0
    mode_of = lowest[blocks[:, 0]]
    for mode, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(_BC7_MODES):
        sel = np.nonzero(mode_of == mode)[0]
        if not sel.size:
            continue
        bb = bits[sel]
        pos = [mode + 1]

        def take(count):
            v = (bb[:, pos[0]:pos[0] + count] << np.arange(count)).sum(axis=1)
            pos[0] += count
            return v

        part, rot, isel = take(pb), take(rb), take(isb)
        ne = 2 * ns
        ep = np.zeros((len(sel), ne, 4), np.int64)
        for c in range(3):
            for e in range(ne):
                ep[:, e, c] = take(cb)
        for e in range(ne):
            ep[:, e, 3] = take(ab) if ab else 255
        cbits, abits = cb, ab
        if epb or spb:
            cbits += 1
            abits += bool(ab)
            chans = 4 if ab else 3
            pbits = [take(1) for _ in range(ne if epb else ns)]
            for e in range(ne):
                p = pbits[e if epb else e // 2]
                ep[:, e, :chans] = (ep[:, e, :chans] << 1) | p[:, None]
        for c, nb in ((0, cbits), (1, cbits), (2, cbits), (3, abits)):
            if nb:
                v = (ep[:, :, c] << (8 - nb)) & 0xFF
                ep[:, :, c] = v | (v >> nb)
        # the subset and the index width of each texel
        texel = np.arange(16)
        if ns == 2:
            subset = (np.asarray(_BC7_P2)[part][:, None] >> texel) & 1
            anchor = texel == np.asarray(_BC7_A2)[part][:, None]
        elif ns == 3:
            subset = (np.asarray(_BC7_P3)[part][:, None] >> (2 * texel)) & 3
            anchor = (((subset == 1) & (texel == np.asarray(_BC7_A3B)[part][:, None]))
                      | ((subset == 2) & (texel == np.asarray(_BC7_A3C)[part][:, None])))
        else:
            subset = np.zeros((len(sel), 16), np.int64)
            anchor = np.zeros((len(sel), 16), bool)
        anchor[:, 0] = True
        width = ib - anchor
        start = pos[0] + np.cumsum(width, axis=1) - width
        k = np.arange(ib)
        grab = np.minimum(start[..., None] + k, 127)
        picked = np.take_along_axis(bb, grab.reshape(len(sel), -1), axis=1)
        i0 = (picked.reshape(len(sel), 16, ib) * ((1 << k) * (k < width[..., None]))).sum(-1)
        cw = np.asarray(_BC7_WEIGHTS[ib])[i0]
        wc = wa = cw
        if ab and ib2:
            width2 = ib2 - (texel == 0)
            start2 = pos[0] + 16 * ib - ns + np.cumsum(width2) - width2
            k2 = np.arange(ib2)
            grab2 = np.minimum(start2[:, None] + k2, 127)
            i1 = (bb[:, grab2] * ((1 << k2) * (k2 < width2[:, None]))).sum(-1)
            aw = np.asarray(_BC7_WEIGHTS[ib2])[i1]
            swap = isel[:, None].astype(bool)
            wc, wa = np.where(swap, aw, cw), np.where(swap, cw, aw)
        e0 = np.take_along_axis(ep, (2 * subset)[..., None], axis=1)
        e1 = np.take_along_axis(ep, (2 * subset + 1)[..., None], axis=1)
        w = np.concatenate([np.repeat(wc[..., None], 3, axis=-1), wa[..., None]], axis=-1)
        col = ((64 - w) * e0 + w * e1 + 32) >> 6
        for r, c in ((1, 0), (2, 1), (3, 2)):
            hit = rot == r
            col[hit, :, c], col[hit, :, 3] = col[hit, :, 3], col[hit, :, c].copy()
        out[sel] = col
    return out


def _blocks(blob: bytes, pos: int, w: int, h: int, size: int) -> np.ndarray:
    n = (-(-w // 4)) * (-(-h // 4))
    if len(blob) < pos + n * size:
        raise ValueError("DDS image data is too short (truncated file)")
    return np.frombuffer(blob, np.uint8, n * size, pos).reshape(n, size)


def _tile(px: np.ndarray, w: int, h: int) -> np.ndarray:
    """(blocks, 16, C) texels, blocks row-major -> (h, w, C)."""
    bw, bh = -(-w // 4), -(-h // 4)
    img = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, -1)
    return img[:h, :w]


def _bcn(blob: bytes, pos: int, w: int, h: int, n: int) -> np.ndarray:
    size = 8 if abs(n) in (1, 4) else 16
    b = _blocks(blob, pos, w, h, size)
    rgba = np.zeros((len(b), 16, 4), np.int64)
    rgba[..., 3] = 255
    if n == 1:
        rgba = _bc1(b, False)
    elif n == 2:
        rgba = _bc1(b[:, 8:], True)
        nib = (b[:, :8, None].astype(np.int64) >> np.array([0, 4])) & 0xF
        rgba[..., 3] = nib.reshape(len(b), 16) * 0x11
    elif n == 3:
        rgba = _bc1(b[:, 8:], True)
        rgba[..., 3] = _bc3_alpha(b[:, :8])
    elif n == 4:
        rgba[..., :3] = _bc3_alpha(b)[..., None]
    elif abs(n) == 5:
        rgba[..., 0] = _bc3_alpha(b[:, :8], n < 0)
        rgba[..., 1] = _bc3_alpha(b[:, 8:], n < 0)
        rgba[..., 2] = 128 if n < 0 else 0
    elif abs(n) == 6:
        rgba[..., :3] = _bc6h(b, n < 0)
    else:
        rgba = _bc7(b)
    return _tile(rgba.astype(np.uint8), w, h)


def _masked(blob: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """Pillow's DdsRgbDecoder: each channel ``int(v / max * 255)``."""
    nb = bitcount // 8
    if nb == 0:
        raise ValueError(f"unsupported DDS (uncompressed at {bitcount} bits a pixel)")
    data = np.frombuffer(blob[pos:pos + w * h * nb].ljust(w * h * nb, b"\0"), np.uint8)
    px = data.reshape(-1, nb).astype(np.uint64) << (8 * np.arange(nb, dtype=np.uint64))
    px = px.sum(axis=1, dtype=np.uint64)
    rgba = np.full((h * w, 4), 255, np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            rgba[:, c] = 0
            continue
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        v = ((px & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        rgba[:, c] = (v / top * 255).astype(np.int64)
    return rgba.reshape(h, w, 4)


def decode_dds(blob: bytes) -> np.ndarray:
    """DDS bytes -> (H, W, 4) uint8 RGBA of its first surface, row 0 the top."""
    if blob[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    if len(blob) < 8 or struct.unpack_from("<I", blob, 4)[0] != 124:
        raise ValueError("unsupported DDS header size")
    if len(blob) < 128:
        raise ValueError("DDS header is too short (truncated file)")
    h, w = struct.unpack_from("<II", blob, 12)
    flags, fourcc, bitcount = struct.unpack_from("<I4sI", blob, 80)
    masks = struct.unpack_from("<4I", blob, 92)
    pos = 128
    if flags & _RGB:
        return _masked(blob, pos, w, h, bitcount, masks if flags & _ALPHAPIXELS else masks[:3])
    if flags & _LUMINANCE:
        if bitcount == 8:
            rows = raw_rows(blob, pos, h, w, 0, False, "DDS")
            rgba = np.full((h, w, 4), 255, np.uint8)
            rgba[..., :3] = rows[..., None]
            return rgba
        if bitcount == 16 and flags & _ALPHAPIXELS:
            la = raw_rows(blob, pos, h, 2 * w, 0, False, "DDS").reshape(h, w, 2)
            return np.concatenate([np.repeat(la[..., :1], 3, axis=-1), la[..., 1:]], axis=-1)
        raise ValueError(f"unsupported DDS (luminance at {bitcount} bits a pixel)")
    if flags & _PALETTE8:
        table = blob[pos:pos + 1024]
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        k = len(table) // 4
        palette[:k] = np.frombuffer(table, np.uint8, 4 * k).reshape(k, 4)
        return palette[raw_rows(blob, pos + len(table), h, w, 0, False, "DDS")]
    if not flags & _FOURCC:
        raise ValueError(f"unsupported DDS (pixel format flags {flags:#x})")
    if fourcc == b"DX10":
        if len(blob) < 148:
            raise ValueError("DDS DX10 header is too short (truncated file)")
        dxgi = struct.unpack_from("<I", blob, 128)[0]
        pos = 148
        if dxgi not in _DXGI:
            raise ValueError(f"unsupported DDS (DXGI format {dxgi})")
        if _DXGI[dxgi] == "rgba":
            return raw_rows(blob, pos, h, 4 * w, 0, False, "DDS").reshape(h, w, 4)
        return _bcn(blob, pos, w, h, _DXGI[dxgi])
    if fourcc not in _FOURCCS:
        raise ValueError(f"unsupported DDS (FourCC {fourcc!r})")
    return _bcn(blob, pos, w, h, _FOURCCS[fourcc])
