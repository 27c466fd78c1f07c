"""The port's JPEG decoder (io/jpeg.py) against the JAX package's texture
loader, which decodes through Pillow: equal bytes on Pillow's encodings
(qualities, subsamplings, grey, progressive, restart markers, optimised
tables, RGB kept as stored, CMYK with and without its Adobe marker), on
streams of any sampling factors (and YCCK) written by a small baseline
encoder here, and on the committed fixtures; the variants it does not read
raise ValueError naming JPEG."""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch.io import image as timage
from gaussian_splatterer_tpu_torch.io.jpeg import decode_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")

ENCODINGS = {
    **{f"q{q}_{s}": dict(quality=q, subsampling=s)
       for q in (50, 90, 100) for s in ("4:4:4", "4:2:2", "4:2:0")},
    "progressive_420": dict(quality=90, subsampling="4:2:0", progressive=True),
    "progressive_444_q50": dict(quality=50, subsampling="4:4:4", progressive=True),
    "grey": dict(quality=90, mode="L"),
    "grey_progressive": dict(quality=75, mode="L", progressive=True),
    "restart": dict(quality=75, subsampling="4:2:0", restart_marker_blocks=1),
    "restart_progressive": dict(quality=75, subsampling="4:2:2", restart_marker_blocks=3,
                                progressive=True),
    "optimize": dict(quality=80, optimize=True),
    "optimize_progressive": dict(quality=80, optimize=True, progressive=True),
    "rgb_as_stored": dict(quality=85, keep_rgb=True),  # Adobe APP14, transform 0
    # four components: Pillow writes CMYK inverted under an Adobe APP14 marker of
    # transform 0; YCCK (transform 2) comes from the baseline encoder below
    "cmyk": dict(quality=90, mode="CMYK"),
    "cmyk_progressive_420": dict(quality=75, mode="CMYK", subsampling="4:2:0",
                                 progressive=True),
    "cmyk_without_app14": dict(quality=90, mode="CMYK", drop_app14=True),
    "ycck": dict(ycck=[(1, 1)] * 4),
    "ycck_420": dict(ycck=[(2, 2), (1, 1), (1, 1), (2, 2)]),
}


def _picture(w: int, h: int, seed: int) -> np.ndarray:
    """A gradient under seeded noise: smooth runs and busy blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(w + h - 2, 1)], axis=-1)
    return np.clip(base + rng.integers(-60, 61, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(29, 37), (64, 48), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(ENCODINGS))
def test_decode_equals_pillow(tmp_path, name, size):
    opts = dict(ENCODINGS[name])
    seed = size[0] + 7 * size[1]
    path = str(tmp_path / "t.jpg")
    if "ycck" in opts:
        with open(path, "wb") as fh:
            fh.write(encode_random_baseline(*size, opts["ycck"], seed, adobe_transform=2))
    else:
        drop_app14, mode = opts.pop("drop_app14", False), opts.pop("mode", "RGB")
        pic = _picture(*size, seed=seed)
        img = (Image.fromarray(np.concatenate([pic, pic[..., :1] ^ pic[..., 2:]], -1), "CMYK")
               if mode == "CMYK" else Image.fromarray(pic).convert(mode))
        img.save(path, "JPEG", **opts)
        if drop_app14:  # CMYK without the marker: libjpeg takes it as CMYK all the same
            blob = (tmp_path / "t.jpg").read_bytes()
            at = blob.index(b"\xff\xee")
            end = at + 2 + struct.unpack(">H", blob[at + 2:at + 4])[0]
            (tmp_path / "t.jpg").write_bytes(blob[:at] + blob[end:])
    got = timage.load_texture_rgba(path)
    assert got.shape == (size[1], size[0], 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    with open(path, "rb") as fh:
        np.testing.assert_array_equal(decode_jpeg(fh.read()),
                                      np.asarray(Image.open(path).convert("RGBA")))


# -- a baseline encoder of random quantised coefficients, for sampling factors
#    Pillow does not write (h1v2, 4:1:1, threefold, a luma smaller than chroma)

_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _segment(marker: int, body: bytes) -> bytes:
    return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body


def encode_random_baseline(width, height, sampling, seed, restart=0,
                           adobe_transform=None) -> bytes:
    """A baseline JPEG (SOF0) whose components have the (h, v) sampling
    factors given, their blocks seeded random quantised coefficients, coded
    with flat Huffman tables (4-bit DC codes, 8-bit AC codes); with an
    Adobe APP14 marker of ``adobe_transform`` if that is given."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    blocks = []
    for h, v in sampling:
        c = np.zeros((my * v, mx * h, 64), np.int64)
        c[..., 0] = rng.integers(-60, 60, c.shape[:2])
        c[..., 1:] = np.where(rng.random((my * v, mx * h, 63)) < 0.15,
                              rng.integers(-6, 7, (my * v, mx * h, 63)), 0)
        blocks.append(c)
    if len(sampling) == 1:  # a one-component scan walks the component's own blocks
        h, v = sampling[0]
        bw, bh = -(-(-(-width * h // hmax)) // 8), -(-(-(-height * v // vmax)) // 8)
        mcus = [[(0, by, bx)] for by in range(bh) for bx in range(bw)]
    else:
        mcus = [[(ci, y * v + bv, x * h + bh) for ci, (h, v) in enumerate(sampling)
                 for bv in range(v) for bh in range(h)] for y in range(my) for x in range(mx)]
    out, acc, nbits = bytearray(), 0, 0

    def put(value, n):
        nonlocal acc, nbits
        acc, nbits = (acc << n) | (value & ((1 << n) - 1)), nbits + n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
            if out[-1] == 0xFF:
                out.append(0)  # byte stuffing
        acc &= (1 << nbits) - 1

    def flush():
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)

    def category(x):
        s = abs(int(x)).bit_length()
        return s, (x if x >= 0 else x + (1 << s) - 1)

    pred = [0] * len(sampling)
    for i, mcu in enumerate(mcus):
        if restart and i and i % restart == 0:
            flush()
            out.extend(bytes([0xFF, 0xD0 + (i // restart - 1) % 8]))
            pred = [0] * len(sampling)
        for ci, by, bx in mcu:
            blk = blocks[ci][by, bx]
            s, bits = category(blk[0] - pred[ci])
            pred[ci] = blk[0]
            put(_DC_SYMBOLS.index(s), 4)
            put(bits, s)
            nonzero = np.flatnonzero(blk[1:]) + 1
            run = 0
            for k in range(1, (nonzero[-1] if len(nonzero) else 0) + 1):
                if not blk[k]:
                    run += 1
                    continue
                while run > 15:
                    put(_AC_SYMBOLS.index(0xF0), 8)
                    run -= 16
                s, bits = category(blk[k])
                put(_AC_SYMBOLS.index((run << 4) | s), 8)
                put(bits, s)
                run = 0
            if not len(nonzero) or nonzero[-1] < 63:
                put(_AC_SYMBOLS.index(0x00), 8)  # EOB
    flush()
    nf = len(sampling)
    counts = lambda n, length: bytes(n if i == length - 1 else 0 for i in range(16))  # noqa: E731
    head = b"\xff\xd8"
    if adobe_transform is not None:
        head += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    head += _segment(0xDB, bytes([0]) + bytes(rng.integers(1, 40, 64).tolist()))
    head += _segment(0xC0, struct.pack(">BHHB", 8, height, width, nf) + b"".join(
        bytes([i + 1, (h << 4) | v, 0]) for i, (h, v) in enumerate(sampling)))
    head += _segment(0xC4, b"\x00" + counts(12, 4) + bytes(_DC_SYMBOLS))
    head += _segment(0xC4, b"\x10" + counts(len(_AC_SYMBOLS), 8) + bytes(_AC_SYMBOLS))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    head += _segment(0xDA, bytes([nf]) + b"".join(bytes([i + 1, 0]) for i in range(nf))
                     + bytes([0, 63, 0]))
    return head + bytes(out) + b"\xff\xd9"


@pytest.mark.parametrize("sampling", [
    [(1, 2), (1, 1), (1, 1)],  # h1v2 chroma
    [(4, 1), (1, 1), (1, 1)],  # 4:1:1, box replication
    [(3, 1), (1, 1), (1, 1)],  # threefold
    [(2, 2), (1, 2), (1, 1)],  # h2v1 Cb, h2v2 Cr
    [(1, 1), (2, 2), (1, 1)],  # luma smaller than one chroma plane
    [(1, 4), (1, 2), (1, 1)],
    [(2, 2)],  # grey in 2x2 sampling
    [(2, 1), (1, 1), (1, 1)],
    [(2, 2), (1, 1), (1, 1)],
], ids=lambda s: "_".join(f"{h}x{v}" for h, v in s))
def test_any_sampling_factors_equal_pillow(sampling):
    """Widths 1-3 take the box paths of h2v1 and h2v2 (libjpeg's fancy
    upsampling wants a chroma width of 3 or more); random coefficients
    overflow the sample range, which exercises the IDCT's range limit."""
    for w, h in [(1, 1), (2, 3), (3, 2), (5, 4), (29, 37), (64, 48)]:
        for restart in (0, 2):
            blob = encode_random_baseline(w, h, sampling, seed=100 * w + h, restart=restart)
            ref = np.asarray(Image.open(io.BytesIO(blob)).convert("RGBA"))
            np.testing.assert_array_equal(decode_jpeg(blob), ref,
                                          err_msg=f"{w}x{h} restart {restart}")


@pytest.mark.parametrize("name", ["mushroom1024_q90_420", "mushroom1024_q90_420_progressive"])
def test_committed_fixtures_equal_their_pillow_decodes(name):
    """tests/data/jpeg: the 1024^2 mushroom texture at quality 90, 4:2:0,
    baseline and progressive (tests/data/jpeg/make_fixtures.py), against
    the PNGs of Pillow's decodes."""
    got = timage.load_texture_rgba(os.path.join(FIXTURES, f"{name}.jpg"))
    want = timage.load_texture_rgba(os.path.join(FIXTURES, f"{name}.png"))
    assert got.shape == (1024, 1024, 4)
    np.testing.assert_array_equal(got, want)


def _baseline_blob() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(16, 16, 1)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("case,match", [
    ("lossless", "lossless \\(SOF3\\) JPEG"),
    ("arithmetic", "arithmetic-coded sequential \\(SOF9\\) JPEG"),
    ("arithmetic_progressive", "arithmetic-coded progressive \\(SOF10\\) JPEG"),
    ("12bit", "JPEG with 12-bit samples \\(SOF1\\)"),
    ("truncated", "corrupt JPEG data"),
])
def test_unsupported_variants_raise(tmp_path, case, match):
    """A baseline file relabelled as another coding, a 12-bit one and a cut
    one, each refused as Pillow refuses it (the lossless and progressive
    labels, whose scan parameters libjpeg-turbo rejects); the relabelled
    arithmetic-coded sequential file Pillow reads, its Huffman bits
    decoded as arithmetic-coded data, and so does the port."""
    path = tmp_path / "t.jpg"
    if case == "truncated":
        path.write_bytes(_baseline_blob()[:400])
    else:
        blob = bytearray(_baseline_blob())
        sof = blob.index(b"\xff\xc0")
        blob[sof + 1] = {"lossless": 0xC3, "arithmetic": 0xC9,
                         "arithmetic_progressive": 0xCA, "12bit": 0xC1}[case]
        if case == "12bit":
            blob[sof + 4] = 12
        path.write_bytes(bytes(blob))
    if case == "arithmetic":
        np.testing.assert_array_equal(timage.load_texture_rgba(str(path)),
                                      jimage.load_texture_rgba(str(path)))
        return
    with pytest.raises(ValueError, match=match):
        timage.load_texture_rgba(str(path))


def test_cli_new_with_a_jpeg_texture(tmp_path, capsys):
    """``new --obj --texture x.jpg`` through the port's CLI on the CPU: the
    project's tracer holds the texture as Pillow decodes it."""
    import argparse

    import torch

    from gaussian_splatterer_tpu_torch.app import cli as tcli

    obj = tmp_path / "m.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                   "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\n")
    tex = str(tmp_path / "t.jpg")
    Image.fromarray(_picture(40, 24, 3)).save(tex, "JPEG", quality=90, subsampling="4:2:0")
    proj = str(tmp_path / "proj")
    assert tcli.main(["new", proj, "--obj", str(obj), "--texture", tex, "--init-field",
                      "model", "--resolution", "32", "--capacity", "64", "--device",
                      "cpu"]) == 0
    session = tcli._make_session(argparse.Namespace(project=proj, device="cpu"),
                                 require=True)
    assert session.project.pathTextureDiffuse == tex
    np.testing.assert_array_equal(session.rtx._texture.cpu().numpy(),
                                  jimage.load_texture_rgba(tex))
    assert torch.isfinite(session.rtx._texture).all()
