"""CIELab TIFFs and LAB PSDs (io/lab.py's littleCMS transform behind
io/tiff.py and io/psd.py) against the JAX package's reading, which is
Pillow's ``Image.open(path).convert("RGBA")`` through littleCMS: 2^20
seeded L*a*b* triples and every triple with L*, a* or b* at 0, 127, 128 or
255, as one TIFF; TIFFs in strips and tiles, raw and compressed, both byte
orders, planar configuration 2; PSDs raw and PackBits; the variants both
refuse; 60 seeded mutants equal to Pillow or refused by both."""

import os

import numpy as np
import pytest
from test_torch_tiff_codecs import FIXTURES, W, H, _both, _mutant, _rng, _runs
from texture_writers import psd_bytes, tiff_bytes

from gaussian_splatterer_tpu_torch.io import lab


def _sweep_triples() -> np.ndarray:
    """2^20 seeded triples, then every triple with a channel at 0, 127, 128
    or 255."""
    rng = np.random.default_rng(25)
    seeded = rng.integers(0, 256, (1 << 20, 3), dtype=np.uint8)
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1).reshape(-1, 2)
    edges = []
    for v in (0, 127, 128, 255):
        for c in range(3):
            t = np.insert(grid, c, v, axis=1)
            edges.append(t)
    return np.concatenate([seeded, np.concatenate(edges).astype(np.uint8)])


def test_sweep_equals_jax(tmp_path):
    """The triples as the stored bytes of one CIELab TIFF (a* and b* as
    two's-complement bytes), read by both."""
    t = _sweep_triples()
    side = int(np.ceil(np.sqrt(len(t))))
    px = np.zeros((side * side, 3), np.uint8)
    px[:len(t)] = t
    path = tmp_path / "sweep.tif"
    path.write_bytes(tiff_bytes(px.reshape(side, side, 3), 8, 8))
    want, got, why = _both(path)
    assert got is not None, why
    np.testing.assert_array_equal(got, want)


def _lab_tiff(comp=1, **kw):
    def make(rng):
        return tiff_bytes(_runs(rng, (H, W, 3)), 8, 8, comp, **kw)
    return make


def _lab_psd(channels=3, **kw):
    def make(rng):
        return psd_bytes(_runs(rng, (H, W, channels)).transpose(2, 0, 1), 9, **kw)
    return make


CASES = {
    **{f"tiff_{name}_strips": _lab_tiff(comp, rows_per_strip=8)
       for name, comp in (("raw", 1), ("lzw", 5), ("deflate", 8), ("packbits", 32773),
                          ("lzma", 34925))},
    **{f"tiff_{name}_tiles": _lab_tiff(comp, tile=(16, 16))
       for name, comp in (("raw", 1), ("lzw", 5), ("deflate", 32946))},
    "tiff_raw_big_endian": _lab_tiff(1, big_endian=True),
    "tiff_lzw_big_endian_tiles": _lab_tiff(5, big_endian=True, tile=(32, 16)),
    "tiff_lzw_predictor": _lab_tiff(5, predictor=2),
    "tiff_raw_planar_2": _lab_tiff(1, planar=2),
    "tiff_deflate_planar_2": _lab_tiff(8, planar=2, rows_per_strip=8),
    "tiff_raw_too_few_strips": _lab_tiff(1, rows_per_strip=8, tags={273: (4, [8])}),
    "tiff_lzw_orientation_6": _lab_tiff(5, tags={274: (3, [6])}),
    "psd_raw": _lab_psd(),
    "psd_packbits": _lab_psd(rle=True),
    "psd_packbits_four_channels": _lab_psd(4, rle=True),
}

REFUSED = {
    "tiff_icclab_9": lambda rng: tiff_bytes(_runs(rng, (H, W, 3)), 8, 9, 5),
    "tiff_itulab_10": lambda rng: tiff_bytes(_runs(rng, (H, W, 3)), 8, 10, 1),
    "tiff_16_bit": lambda rng: tiff_bytes(_runs(rng, (H, W, 3), 1 << 16), 16, 8, 5),
    "tiff_extra_sample": lambda rng: tiff_bytes(_runs(rng, (H, W, 4)), 8, 8, 5, extra=[2]),
    "tiff_one_sample": lambda rng: tiff_bytes(_runs(rng, (H, W, 1)), 8, 8, 5),
    "tiff_fill_order_2": _lab_tiff(5, fill_order=2),
    "psd_16_bit": lambda rng: psd_bytes(_runs(rng, (3, H, W), 1 << 16), 9, bits=16),
    "psd_two_channels": _lab_psd(2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lab_equals_jax(tmp_path, name):
    path = tmp_path / f"{name}.{name[:name.index('_')]}"
    path.write_bytes(CASES[name](_rng(name)))
    want, got, why = _both(path)
    assert want is not None, "the JAX package refuses the case"
    assert got is not None, why
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_by_both(tmp_path, name):
    path = tmp_path / f"{name}.{name[:name.index('_')]}"
    path.write_bytes(REFUSED[name](_rng(name)))
    want, got, why = _both(path)
    assert want is None and got is None and why


def test_table_is_built_not_read():
    """The table comes from the profiles' definitions: white (L* 100, a*
    and b* near 0) maps near 0xFFFF on all three channels, black near 0, and the
    sRGB colorant matrix's Y row sums to 1."""
    t = lab.lab_table()
    assert t.shape == (33, 33, 33, 3)
    assert t[0, 16, 16].max() < 0x200 and t[32, 16, 16].min() > 0xFE00
    assert abs(sum(lab.srgb_to_xyz()[1]) - 1.0) < 1e-12


MUTANT_SOURCES = ("tiff_lzw_strips", "tiff_deflate_tiles", "tiff_raw_strips", "psd_packbits")


def test_mutants_agree_with_jax(tmp_path):
    """60 seeded mutants (truncations, byte flips, insertions) of the
    cases above: each is read to the JAX package's bytes or refused by
    both."""
    rng = _rng("lab_mutants")
    sources = [CASES[n](_rng(n)) for n in MUTANT_SOURCES]
    path = tmp_path / "m.bin"
    bad = []
    for i in range(60):
        path.write_bytes(_mutant(rng, sources[i % len(sources)]))
        want, got, why = _both(path)
        if not ((want is None) == (got is None) and (want is None or np.array_equal(got, want))):
            bad.append((i, MUTANT_SOURCES[i % len(sources)], want is None, got is None, why))
    assert not bad


@pytest.mark.parametrize("name", ('mushroom256_cielab.tif', 'mushroom256_lab.psd'))
def test_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py's ``lab_ycbcr``): the fixture
    equals the JAX package's load and its Pillow decode's PNG."""
    path = os.path.join(FIXTURES, name)
    want, got, why = _both(path)
    assert got is not None, why
    np.testing.assert_array_equal(got, want)
    decode = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, _both(decode)[1])
