"""Writes the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py
phase 21 with Pillow: the 1024^2 mushroom texture of
gaussian_splatterer_tpu_torch.scripts.scenes (quantised as the port's
save_png quantises) at quality 90, 4:2:0, baseline and progressive, and
each one's Pillow decode as an RGB PNG.

    python tests/data/jpeg/make_fixtures.py
"""

import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from gaussian_splatterer_tpu_torch.io.image import float_image_to_u8  # noqa: E402
from gaussian_splatterer_tpu_torch.scripts.scenes import mushroom_texture  # noqa: E402

FIXTURES = {"mushroom1024_q90_420.jpg": {}, "mushroom1024_q90_420_progressive.jpg":
            {"progressive": True}}


def main() -> None:
    rgb = Image.fromarray(float_image_to_u8(mushroom_texture(n=1024)[..., :3]))
    for name, extra in FIXTURES.items():
        path = os.path.join(HERE, name)
        rgb.save(path, "JPEG", quality=90, subsampling="4:2:0", **extra)
        Image.open(path).convert("RGB").save(path[:-4] + ".png", optimize=True)


if __name__ == "__main__":
    main()
