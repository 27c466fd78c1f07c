"""The port's native C++ parsers (``native/``) against its pure-Python ones
and against the JAX package's loaders (as tests/test_native.py holds the
JAX package's), and the package data an installed port needs."""

import fnmatch
import os
import shutil
import tomllib
from pathlib import Path

import numpy as np
import pytest

from gaussian_splatterer_tpu_torch import native
from gaussian_splatterer_tpu_torch.io import gobj as tgobj
from gaussian_splatterer_tpu_torch.io import obj as tobj
from gaussian_splatterer_tpu_torch.models.splats import SplatModelHost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build with")

OBJ = """\
# comment line
v -1.5 -1.5 0
v 1.5 -1.5 0
v 1.5 1.5 0.25
v -1.5 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f 1/1/9 3/3/9 2/2/9
f 2 3 4
f -4/-4 -2/-2 -1/-1
v 2 2 2
f 1 2 -1
"""

MESH_FIELDS = ("vertices", "triangles", "tri_uv")
SPLAT_FIELDS = ("means", "shs", "scales", "opacities", "rotations")


@needs_gxx
def test_obj_native_matches_python_and_jax(tmp_path):
    """Quads, normals, a face without vt, relative indices: the native
    parser, the Python one and the JAX package's two give equal arrays."""
    from gaussian_splatterer_tpu.io import obj as jobj

    path = str(tmp_path / "m.obj")
    with open(path, "w") as fh:
        fh.write(OBJ)
    got = tobj.load_obj(path)
    assert tobj.last_path == "native"
    plain = tobj.load_obj_python(path)
    assert tobj.last_path == "python"
    assert got.num_triangles == 6
    np.testing.assert_array_equal(got.triangles[4], [0, 2, 3])  # -4 -2 -1 of four vertices
    np.testing.assert_array_equal(got.triangles[5], [0, 1, 4])  # -1: the vertex just above
    for ref in (plain, jobj.load_obj(path), jobj.load_obj(path, progress=lambda: None)):
        for name in MESH_FIELDS:
            a, b = getattr(got, name), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@needs_gxx
def test_obj_refused_by_native_raises_from_python(tmp_path):
    """An index past the vertices: the native parser refuses the file and
    the Python parser reads it and names the fault."""
    path = str(tmp_path / "bad.obj")
    with open(path, "w") as fh:
        fh.write("v 0 0 0\nf 1 2 3\n")
    assert native.load_obj(path) is None
    with pytest.raises(ValueError, match="out of range"):
        tobj.load_obj(path)
    assert tobj.last_path == "python"


@needs_gxx
@pytest.mark.parametrize("degree", [0, 1, 3])
def test_gobj_native_roundtrip_matches_python_and_jax(tmp_path, degree):
    """The native writer's text equals the Python writer's and the JAX
    package's; the native reader, the Python one and JAX's give equal
    arrays."""
    from gaussian_splatterer_tpu.io import gobj as jgobj
    from gaussian_splatterer_tpu.models.splats import SplatModelHost as JHost

    rng = np.random.default_rng(degree)
    k, n = (degree + 1) ** 2, 17
    arrays = [np.asarray(a, np.float32) for a in (
        rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, k, 3)), rng.uniform(0.1, 1, (n, 3)),
        rng.uniform(0, 1, n), rng.normal(0, 1, (n, 4)))]
    m = SplatModelHost.from_arrays(*arrays, capacity=64)
    native_path, py_path, jax_path = (str(tmp_path / f"{w}.gobj") for w in ("n", "p", "j"))
    tgobj.save_gobj(m, native_path)
    assert tgobj.last_path == "native"
    tgobj.save_gobj_python(m, py_path)
    assert tgobj.last_path == "python"
    jgobj.save_gobj(JHost.from_arrays(*arrays, capacity=64), jax_path)
    text = open(native_path).read()
    assert text == open(py_path).read() == open(jax_path).read()
    got = tgobj.load_gobj(native_path, capacity=32)
    assert tgobj.last_path == "native" and got.capacity == 32 and got.count == n
    assert (got.sh_degree, got.sh_coeffs) == (degree, k)
    plain = tgobj.load_gobj_python(native_path, capacity=32)
    ref = jgobj.load_gobj(native_path, capacity=32)
    for name in SPLAT_FIELDS:
        a = getattr(got, name)
        np.testing.assert_array_equal(a, getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.means[:n], arrays[0], rtol=1e-5)  # %g: 6 digits


@needs_gxx
def test_build_failure_prints_the_compiler_message(tmp_path, monkeypatch, capsys):
    """A source that does not compile: build() returns None and the
    compiler's message goes to standard error, not away."""
    bad = tmp_path / "parsers.cpp"
    bad.write_text("int gst_free( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.build() is None
    err = capsys.readouterr().err
    assert "g++ failed to build" in err and "error" in err
    assert not list((tmp_path / "build").glob("*.tmp"))


@needs_gxx
def test_library_is_built_under_build_native():
    """The library lands in build/native/ at the root of the checkout,
    named by a hash of its source and flags, and loads once a process."""
    assert native.lib() is not None and native.lib() is native.lib()
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR == Path(REPO, "build", "native")
    assert path.exists() and path.name.startswith("libgstparsers-")


def test_package_data_holds_every_kernel_and_parser_source():
    """An installed port builds its kernels and parsers from the package:
    every file under csrc/, scripts/variants/ and native/src/ matches a
    package-data glob of pyproject.toml."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"][
            "gaussian_splatterer_tpu_torch"]
    root = os.path.join(REPO, "gaussian_splatterer_tpu_torch")
    files = [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
             for sub in ("csrc", "scripts/variants", "native/src")
             for d, _, names in os.walk(os.path.join(root, sub)) for f in names]
    assert {"csrc/composite_common.cuh", "native/src/parsers.cpp"} <= set(files)
    assert any(f.startswith("scripts/variants/") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not in package data: {missing}"
