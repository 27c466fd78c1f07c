"""YCbCr TIFFs under LZW, Deflate, PackBits and LZMA (io/tiff.py's route
through io/tiff_rgba.py, libtiff's RGBA interface as Pillow drives it)
against the JAX package's reading, which is Pillow's
``Image.open(path).convert("RGBA")``: every subsampling libtiff has a
routine for, in strips and tiles, at sizes that are not whole blocks, with
explicit YCbCrCoefficients and ReferenceBlackWhite, the predictor,
planar configuration 2, orientations 1-8, byte-equal; the variants both
refuse; 60 seeded mutants equal to Pillow or refused by both."""

import os

import numpy as np
import pytest
from test_torch_tiff_codecs import FIXTURES, W, H, _both, _mutant, _rng, _runs
from texture_writers import tiff_bytes

from gaussian_splatterer_tpu_torch.io import tiff_rgba


def _ycbcr(comp, sub, w=W, h=H, **kw):
    """A YCbCr TIFF of seeded samples in libtiff's subsampled layout."""
    def make(rng):
        return tiff_bytes(_runs(rng, (h, w, 3)), 8, 6, comp, ycbcr_subsampling=sub, **kw)
    return make


_BT709 = (5, [2126, 10000, 7152, 10000, 722, 10000])
_STUDIO = (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])

CASES = {
    **{f"{name}_{hs}x{vs}_strips": _ycbcr(comp, (hs, vs), rows_per_strip=8)
       for name, comp in (("lzw", 5), ("deflate", 8), ("adobe_deflate", 32946),
                          ("packbits", 32773), ("lzma", 34925))
       for hs, vs in tiff_rgba.SUBSAMPLINGS},
    **{f"deflate_{hs}x{vs}_tiles": _ycbcr(8, (hs, vs), tile=(16, 16))
       for hs, vs in tiff_rgba.SUBSAMPLINGS},
    "lzw_2x2_one_strip": _ycbcr(5, (2, 2)),
    "lzw_2x2_odd_rows_per_strip": _ycbcr(5, (2, 2), rows_per_strip=3),
    "lzw_4x4_rows_per_strip_5": _ycbcr(5, (4, 4), rows_per_strip=5),
    "lzw_4x4_width_5": _ycbcr(5, (4, 4), w=5, rows_per_strip=8),
    "lzw_4x4_tiles_width_5": _ycbcr(8, (4, 4), w=5, tile=(16, 16)),
    "lzw_4x2_tiles_33x17": _ycbcr(5, (4, 2), w=33, h=17, tile=(16, 32)),
    "lzw_2x2_coefficients_and_reference": _ycbcr(5, (2, 2), tags={529: _BT709, 532: _STUDIO}),
    "lzw_2x1_bt709": _ycbcr(5, (2, 1), tags={529: _BT709}),
    "lzw_2x2_predictor": _ycbcr(5, (2, 2), predictor=2, rows_per_strip=8),
    "lzw_2x2_predictor_tiles": _ycbcr(5, (2, 2), predictor=2, tile=(16, 16)),
    "lzw_2x1_predictor_rows_not_whole": _ycbcr(5, (2, 1), rows_per_strip=8,
                                               tags={317: (3, [2])}),
    "lzw_2x2_without_subsampling_tag": _ycbcr(5, (2, 2), tags={530: None}),
    "deflate_2x2_big_endian": _ycbcr(8, (2, 2), big_endian=True),
    "lzw_planar_2": _ycbcr(5, None, planar=2, rows_per_strip=5, tags={530: (3, [1, 1])}),
    "deflate_planar_2_tiles": _ycbcr(8, None, planar=2, tile=(16, 16),
                                     tags={530: (3, [1, 1])}),
    **{f"orientation_{o}_strips": _ycbcr(5, (2, 2), rows_per_strip=8, tags={274: (3, [o])})
       for o in range(1, 9)},
    **{f"orientation_{o}_tiles": _ycbcr(8, (2, 1), tile=(16, 16), tags={274: (3, [o])})
       for o in range(1, 9)},
}

REFUSED = {
    "subsampling_2x4": _ycbcr(5, (2, 4)),
    "subsampling_1x4": _ycbcr(8, (1, 4), tile=(16, 16)),
    "subsampling_3x1": _ycbcr(5, (1, 1), tags={530: (3, [3, 1])}),
    "planar_2_subsampled": _ycbcr(5, None, planar=2, tags={530: (3, [2, 2])}),
    "one_sample": lambda rng: tiff_bytes(_runs(rng, (H, W, 1)), 8, 6, 5),
    "fill_order_2": _ycbcr(5, (2, 2), fill_order=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_compressed_ycbcr_equals_jax(tmp_path, name):
    path = tmp_path / f"{name}.tif"
    path.write_bytes(CASES[name](_rng(name)))
    want, got, why = _both(path)
    assert want is not None, "the JAX package refuses the case"
    assert got is not None, why
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_by_both(tmp_path, name):
    path = tmp_path / f"{name}.tif"
    path.write_bytes(REFUSED[name](_rng(name)))
    want, got, why = _both(path)
    assert want is None and got is None and why


def test_orientations_differ():
    """The orientation cases are not all one picture."""
    from gaussian_splatterer_tpu_torch.io.tiff import decode_tiff
    pics = {decode_tiff(CASES[f"orientation_{o}_strips"](_rng("orientation"))).tobytes()
            for o in range(1, 9)}
    assert len(pics) == 8


def test_tables_are_libtiffs():
    """TIFFYCbCrToRGBInit's defaults: Y as stored, Cr -> R by 1.402."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tiff_rgba.ycbcr_tables()
    assert y_tab.tolist() == list(range(256))
    assert (cr_r[255], cb_b[0], cr_r[128]) == (178, -227, 0)


MUTANT_SOURCES = ("lzw_2x2_strips", "deflate_2x1_tiles", "packbits_4x2_strips",
                  "lzma_1x1_strips", "lzw_2x2_predictor", "lzw_planar_2")


def test_mutants_agree_with_jax(tmp_path):
    """60 seeded mutants (truncations, byte flips, insertions) of the
    cases above: each is read to the JAX package's bytes or refused by
    both.  A damaged strip or tile reads as what libtiff's codec wrote
    before its error, then zeros."""
    rng = _rng("ycbcr_mutants")
    sources = [CASES[n](_rng(n)) for n in MUTANT_SOURCES]
    path = tmp_path / "m.tif"
    bad = []
    for i in range(60):
        path.write_bytes(_mutant(rng, sources[i % len(sources)]))
        want, got, why = _both(path)
        if not ((want is None) == (got is None) and (want is None or np.array_equal(got, want))):
            bad.append((i, want is None, got is None, why))
    assert not bad


@pytest.mark.parametrize("name", ('mushroom256_ycbcr420_lzw.tif', 'mushroom256_ycbcr422_tiles.tif'))
def test_fixture_equals_jax_and_its_pillow_decode(name):
    """tests/data/textures (make_fixtures.py's ``lab_ycbcr``): the fixture
    equals the JAX package's load and its Pillow decode's PNG."""
    path = os.path.join(FIXTURES, name)
    want, got, why = _both(path)
    assert got is not None, why
    np.testing.assert_array_equal(got, want)
    decode = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + ".pillow.png")
    np.testing.assert_array_equal(got, _both(decode)[1])
