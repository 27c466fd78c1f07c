"""Writes the texture fixtures of tests/test_torch_textures.py and
chip_smoke.py phase 21 from the 256^2 mushroom texture of
gaussian_splatterer_tpu_torch.scripts.scenes (quantised as the port's
save_png quantises), and beside each its Pillow decode
(``Image.open(path).convert("RGBA")``) as an 8-bit RGBA PNG,
``<name>.pillow.png``:

  * mushroom256_palette_trns.png: 8-bit palette of the texture's colours
    and one more entry, transparent in the tRNS table, which every fourth
    band of 16 texel columns takes, so the mushroom has holes (zlib, the
    five row filters in turn);
  * mushroom256_rgba16.png: 16-bit RGBA, each sample the 8-bit value in the
    high byte and a pattern in the low one, the cap's spots half
    transparent (zlib, the five row filters in turn);
  * mushroom256_adam7.png: 8-bit RGB, Adam7 interlaced (zlib);
  * mushroom256_map_rle.tga: type 9, run-length encoded, 24-bit colour map
    (Pillow);
  * mushroom256_cmyk.jpg: CMYK JPEG with its Adobe APP14 marker (Pillow,
    quality 90).

    python tests/data/textures/make_fixtures.py
"""

import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

from texture_writers import png_bytes  # noqa: E402

from gaussian_splatterer_tpu_torch.io.image import float_image_to_u8  # noqa: E402
from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_texture  # noqa: E402

N = 256


def palette_trns(rgba: np.ndarray) -> None:
    colours, idx = np.unique(rgba[..., :3].reshape(-1, 3), axis=0, return_inverse=True)
    idx = idx.reshape(N, N, 1)
    hole = len(colours)  # one entry more, transparent
    idx[:, (np.arange(N) // 16) % 4 == 0] = hole
    plte = np.concatenate([colours, [[0, 0, 0]]]).astype(np.uint8).tobytes()
    with open(os.path.join(HERE, "mushroom256_palette_trns.png"), "wb") as fh:
        fh.write(png_bytes(idx, 8, 3, plte=plte, trns=bytes([255] * hole + [0])))


def rgba16(rgba: np.ndarray) -> None:
    yy, xx = np.mgrid[0:N, 0:N]
    low = ((xx * 7 + yy * 3) & 0xFF)[..., None]
    with open(os.path.join(HERE, "mushroom256_rgba16.png"), "wb") as fh:
        fh.write(png_bytes((rgba.astype(np.int64) << 8) | low, 16, 6))


def adam7(rgba: np.ndarray) -> None:
    with open(os.path.join(HERE, "mushroom256_adam7.png"), "wb") as fh:
        fh.write(png_bytes(rgba[..., :3].astype(np.int64), 8, 2, interlace=True))


def map_rle(rgba: np.ndarray) -> None:
    p = Image.fromarray(rgba[..., :3]).quantize(256, dither=Image.Dither.NONE)
    p.save(os.path.join(HERE, "mushroom256_map_rle.tga"), compression="tga_rle")


def cmyk(rgba: np.ndarray) -> None:
    rgb = rgba[..., :3].astype(np.int64)
    k = 255 - rgb.max(axis=-1, keepdims=True)
    c = np.where(k < 255, (255 - rgb - k) * 255 // np.maximum(255 - k, 1), 0)
    img = Image.fromarray(np.concatenate([c, k], axis=-1).astype(np.uint8), "CMYK")
    img.save(os.path.join(HERE, "mushroom256_cmyk.jpg"), quality=90)


def main() -> None:
    rgba = float_image_to_u8(mushroom_texture(n=N, spot_alpha=0.5))
    for write in (palette_trns, rgba16, adam7, map_rle, cmyk):
        write(rgba)
    for name in sorted(os.listdir(HERE)):
        if name.startswith("mushroom256_") and not name.endswith(".pillow.png"):
            path = os.path.join(HERE, name)
            Image.open(path).convert("RGBA").save(
                os.path.join(HERE, name.rsplit(".", 1)[0] + ".pillow.png"), optimize=True)


if __name__ == "__main__":
    main()
