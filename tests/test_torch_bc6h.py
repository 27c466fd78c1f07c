"""The port's DDS BC6H input (io/dds.py's bc6h_python and its C++ twin in
native/src/codecs.cpp, behind io/image.load_texture_rgba) against the JAX
package's, which is Pillow's ``Image.open(path).convert("RGBA")``: seeded
random blocks of BC6H_UF16 and BC6H_SF16 (every 16 bytes are a valid block,
so random bytes reach all fourteen modes and the reserved ones), byte-equal,
sizes that are not whole blocks included; the committed fixtures; the C++
loop equal to its Python twin; BC6H_TYPELESS refused by both; seeded
mutants equal to Pillow or refused by both."""

import os
import shutil
import warnings

import numpy as np
import pytest
from texture_writers import dds_bytes

from gaussian_splatterer_tpu.io import image as jimage
from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import dds
from gaussian_splatterer_tpu_torch.io import image as timage

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "textures")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")
FORMATS = {"uf16": 95, "sf16": 96}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(name.encode()))


def _blocks(rng, n: int) -> np.ndarray:
    return rng.integers(0, 256, (n, 16)).astype(np.uint8)


def _mode(blocks: np.ndarray) -> np.ndarray:
    low = blocks[:, 0] & 3
    return np.where(low < 2, low, blocks[:, 0] & 31)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("size", [(256, 256), (37, 29), (4, 4), (1, 1)])
def test_random_blocks_equal_jax(tmp_path, fmt, size):
    """Seeded random blocks of each format at each size, loaded by path:
    the port's floats equal the JAX package's, byte for byte; the 256^2
    image's 4,096 blocks hold every mode and the reserved ones."""
    w, h = size
    rng = _rng(f"{fmt}{size}")
    blocks = _blocks(rng, (-(-w // 4)) * (-(-h // 4)))
    if size == (256, 256):
        modes = set(_mode(blocks).tolist())
        assert modes >= {0, 1, 2, 3, 6, 7, 10, 11, 14, 15, 18, 22, 26, 30, 19, 23, 27, 31}
    path = tmp_path / f"bc6h_{fmt}.dds"
    path.write_bytes(dds_bytes(blocks.tobytes(), w, h, dxgi=FORMATS[fmt]))
    got = timage.load_texture_rgba(str(path))
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(str(path)))
    assert got.shape == (h, w, 4)


def test_quirks_of_bc6h():
    """Values Pillow gives and the port keeps: a reserved mode reads as
    black; an SF16 block whose transformed endpoints are negative at 10
    bits reads them as large positives (white), not as black."""
    reserved = np.zeros((1, 16), np.uint8)
    reserved[0, 0] = 0x13
    assert dds.bc6h_python(reserved, False).max() == 0
    # mode 0: w = 0 for all channels, the deltas -1 (all five bits set)
    block = np.zeros(128, np.uint8)
    for p in range(35, 82):
        block[p] = 1
    blk = np.packbits(block.reshape(16, 8)[:, ::-1], axis=1).reshape(1, 16)
    out = dds.bc6h_python(blk, True)
    assert out.max() == 255


@needs_gxx
@pytest.mark.parametrize("signed", [False, True])
def test_native_bc6h_equals_python(signed):
    """The C++ blocks against the Python twin on 20,000 seeded blocks."""
    blocks = _blocks(_rng(f"native{signed}"), 20_000)
    assert native.lib() is not None
    np.testing.assert_array_equal(native.bc6h_decode(blocks, signed),
                                  dds.bc6h_python(blocks, signed))


@pytest.mark.parametrize("name", ["mushroom256_bc6h_uf16.dds", "mushroom256_bc6h_sf16.dds"])
def test_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py): each BC6H fixture equals the
    JAX package's load and the 8-bit RGBA PNG of its Pillow decode."""
    path = os.path.join(FIXTURES, name)
    got = timage.load_texture_rgba(path)
    np.testing.assert_array_equal(got, jimage.load_texture_rgba(path))
    decode = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, timage.load_texture_rgba(decode))


def test_typeless_refused_by_both(tmp_path):
    """BC6H_TYPELESS (DXGI 94), which Pillow does not read."""
    path = tmp_path / "typeless.dds"
    path.write_bytes(dds_bytes(bytes(64), 8, 8, dxgi=94))
    with pytest.raises(Exception):
        jimage.load_texture_rgba(str(path))
    with pytest.raises(ValueError, match="DXGI format 94"):
        timage.load_texture_rgba(str(path))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_mutants_agree_with_jax(tmp_path, fmt):
    """60 seeded mutants (truncations, byte flips, insertions) of a 37 x 29
    file of each format: each reads to the JAX package's bytes or is
    refused by both."""
    rng = _rng(f"mutants{fmt}")
    blob = dds_bytes(_blocks(rng, 80).tobytes(), 37, 29, dxgi=FORMATS[fmt])
    path = tmp_path / "m.dds"
    for i in range(60):
        b = bytearray(blob)
        kind = rng.integers(0, 3)
        if kind == 0:
            b = b[:rng.integers(1, len(b))]
        elif kind == 1:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
        else:
            at = rng.integers(0, len(b))
            b[at:at] = rng.integers(0, 256, rng.integers(1, 8)).astype(np.uint8).tobytes()
        path.write_bytes(bytes(b))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = jimage.load_texture_rgba(str(path))
        except Exception:  # noqa: BLE001 (Pillow raises what its plugin raises)
            want = None
        try:
            got = timage.load_texture_rgba(str(path))
        except ValueError:
            got = None
        assert (want is None) == (got is None), f"mutant {i}"
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f"mutant {i}")
