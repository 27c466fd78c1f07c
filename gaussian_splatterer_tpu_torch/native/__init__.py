"""Native C++ file parsers (the ``.obj`` mesh and ``.gobj`` splat formats),
the texture decoders' byte loops (PNG's row unfilter, GIF's and TIFF's
LZW, PSD's PackBits rows, SGI's, PCX's, SUN's, MSP's and ICNS's run-length
rows, QOI's ops, TIFF's CCITT fax decoder, DDS's BC6H blocks, FLI's frame
chunks, JPEG's arithmetic (QM) decoder and lossless loops, the xz decoder
of damaged LZMA strips, the Zstandard frame decoder of TIFF strips),
WebP's bit-serial decoders (VP8, VP8L, ALPH) and the JPEG 2000 codestream
decoder, loaded with ctypes (counterpart of gaussian_splatterer_tpu.native).

``src/parsers.cpp``, ``src/codecs.cpp``, ``src/jpeg.cpp``, ``src/xz.cpp``,
``src/zstd.cpp``, ``src/webp.cpp`` and ``src/j2k.cpp`` expose a plain C
interface (none links a codec library); they are built without
floating-point contraction, as j2k.cpp's 9/7 path needs. At first use they are
compiled with ``g++`` into one library in ``build/native/`` at the root of
the checkout, named by a hash of the sources and flags (an unchanged source
is reused across processes, a changed one builds anew), and loaded. Nothing
is built at import time. A failed build prints the compiler's message to
standard error; ``lib()`` then returns None and io/obj.py, io/gobj.py,
io/png.py, io/lzw.py, io/psd.py, io/sgi.py, io/pcx.py, io/qoi.py,
io/ccitt.py, io/dds.py, io/sun.py, io/msp.py, io/icns.py, io/fli.py,
io/jpeg_arith.py, io/jpeg_lossless.py, io/xz.py and io/zstd.py take their
pure-Python loops, which stay as the plain twins of these; io/webp.py and
io/jpeg2000.py have no Python twin and refuse WebP and JPEG 2000 files then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "parsers.cpp"
CODECS_SRC = SRC.with_name("codecs.cpp")
WEBP_SRC = SRC.with_name("webp.cpp")
JPEG_SRC = SRC.with_name("jpeg.cpp")
XZ_SRC = SRC.with_name("xz.cpp")
ZSTD_SRC = SRC.with_name("zstd.cpp")
J2K_SRC = SRC.with_name("j2k.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_state: dict = {}  # "lib": the loaded library or None, once tried


def sources() -> tuple[Path, ...]:
    """The C++ sources built into the library."""
    return SRC, CODECS_SRC, WEBP_SRC, JPEG_SRC, XZ_SRC, ZSTD_SRC, J2K_SRC


def lib_path() -> Path:
    text = b"".join(src.read_bytes() for src in sources()) + " ".join(CXX_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"libgstparsers-{digest}.so"


def build() -> Path | None:
    """Compile the library if it is not built yet; its path, or None when
    there is no ``g++`` or the build failed (the compiler's message goes
    to standard error)."""
    path = lib_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        print("gaussian_splatterer_tpu_torch.native: g++ not found; the pure-Python "
              "parsers run", file=sys.stderr)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, sources()), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        print(f"gaussian_splatterer_tpu_torch.native: g++ failed to build "
              f"{', '.join(map(str, sources()))}:\n"
              f"{proc.stdout}{proc.stderr}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)  # atomic: concurrent builds leave one whole file
    return path


def lib() -> ctypes.CDLL | None:
    """The loaded library (built at the first call), or None."""
    if "lib" not in _state:
        path = build()
        _state["lib"] = _bind(ctypes.CDLL(str(path))) if path is not None else None
    return _state["lib"]


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int32)
    ppf, ppi = ctypes.POINTER(pf), ctypes.POINTER(pi)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    cdll.gst_free.argtypes = [ctypes.c_void_p]
    cdll.gst_load_obj.argtypes = [ctypes.c_char_p, ppf, pi64, ppi, pi64, ppf]
    cdll.gst_load_obj.restype = ctypes.c_int
    cdll.gst_load_gobj.argtypes = [ctypes.c_char_p, ppf, ppf, ppf, ppf, ppf, pi64, pi64]
    cdll.gst_load_gobj.restype = ctypes.c_int
    cdll.gst_save_gobj.argtypes = [ctypes.c_char_p, pf, pf, pf, pf, pf,
                                   ctypes.c_int64, ctypes.c_int64]
    cdll.gst_save_gobj.restype = ctypes.c_int
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    cdll.gst_png_unfilter.argtypes = [pu8, pu8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    cdll.gst_png_unfilter.restype = ctypes.c_int
    cdll.gst_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                    pu8, ctypes.c_int64, pi64]
    cdll.gst_lzw_decode.restype = ctypes.c_int
    for name in ("gst_webp_vp8", "gst_webp_vp8l"):
        getattr(cdll, name).argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, pu8, ctypes.c_int64]
        getattr(cdll, name).restype = ctypes.c_int
    cdll.gst_webp_alpha.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                    pu8]
    cdll.gst_webp_alpha.restype = ctypes.c_int
    i64 = ctypes.c_int64
    cdll.gst_packbits_rows.argtypes = [ctypes.c_char_p, i64, i64, i64, pu8]
    cdll.gst_packbits_rows.restype = i64
    cdll.gst_sgi_rle.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, i64, pu8]
    cdll.gst_sgi_rle.restype = ctypes.c_int
    cdll.gst_pcx_rle.argtypes = [ctypes.c_char_p, i64, i64, i64, pu8]
    cdll.gst_pcx_rle.restype = ctypes.c_int
    cdll.gst_qoi_decode.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int, pu8]
    cdll.gst_qoi_decode.restype = ctypes.c_int
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    cdll.gst_fax_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, i64, i64, pu8, i64, pu32, i64, pi, pi, pi,
                                    pi64]
    cdll.gst_fax_decode.restype = ctypes.c_int
    cdll.gst_bc6h_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, pi, pu8]
    cdll.gst_bc6h_decode.restype = None
    cdll.gst_sun_rle.argtypes = [ctypes.c_char_p, i64, i64, i64, pu8]
    cdll.gst_sun_rle.restype = ctypes.c_int
    cdll.gst_msp_rle.argtypes = [ctypes.c_char_p, i64, i64, i64, pu8, i64, pi64]
    cdll.gst_msp_rle.restype = ctypes.c_int
    cdll.gst_icns_rle.argtypes = [ctypes.c_char_p, i64, i64, pu8]
    cdll.gst_icns_rle.restype = ctypes.c_int
    cdll.gst_fli_frame.argtypes = [ctypes.c_char_p, i64, i64, i64, pu8, pi]
    cdll.gst_fli_frame.restype = i64
    vp = ctypes.c_void_p
    cdll.gst_jpeg_arith_segment.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, vp, i64, i64, vp, vp, vp, vp, vp,
                                            pi64, pi]
    cdll.gst_jpeg_arith_segment.restype = ctypes.c_int
    cdll.gst_jpeg_lossless_diffs.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int,
                                             i64, i64, i64, pi, pi, pi, pi]
    cdll.gst_jpeg_lossless_diffs.restype = i64
    cdll.gst_jpeg_undifference.argtypes = [pi, pu8, i64, i64, ctypes.c_int, ctypes.c_int, pi]
    cdll.gst_jpeg_undifference.restype = None
    cdll.gst_xz_until_error.argtypes = [ctypes.c_char_p, i64, i64, pu8]
    cdll.gst_xz_until_error.restype = i64
    cdll.gst_zstd_decode.argtypes = [ctypes.c_char_p, i64, i64, pu8, ctypes.c_char_p, i64,
                                     pi64]
    cdll.gst_zstd_decode.restype = i64
    cdll.gst_j2k_decode.argtypes = [ctypes.c_char_p, i64, i64, ctypes.c_uint32, ctypes.c_uint32,
                                    pi64, ctypes.POINTER(pi), pi64, ctypes.c_char_p, i64]
    cdll.gst_j2k_decode.restype = ctypes.c_int
    return cdll


def _take(cdll, ptr, shape, dtype) -> np.ndarray:
    """Copy a malloc'd C buffer into a numpy array and free it."""
    n = int(np.prod(shape))
    out = (np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True) if n
           else np.zeros((0,), dtype))
    cdll.gst_free(ptr)
    return out.reshape(shape)


def load_obj(path: str):
    """(vertices (V, 3) float32, triangles (T, 3) int32, tri_uv (T, 3, 2)
    float32), or None when the library is missing or the parser refused
    the file (the Python parser then reads it and names the fault)."""
    cdll = lib()
    if cdll is None:
        return None
    pf, pi = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    verts, tris, uv = pf(), pi(), pf()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = cdll.gst_load_obj(os.fsencode(path), ctypes.byref(verts), ctypes.byref(nv),
                           ctypes.byref(tris), ctypes.byref(nt), ctypes.byref(uv))
    if rc != 0:
        return None
    return (_take(cdll, verts, (nv.value, 3), np.float32),
            _take(cdll, tris, (nt.value, 3), np.int32),
            _take(cdll, uv, (nt.value, 3, 2), np.float32))


def load_gobj(path: str):
    """(means, shs (N, K, 3), scales, opacities, rotations) as float32, or
    None when the library is missing or the parser refused the file."""
    cdll = lib()
    if cdll is None:
        return None
    pf = ctypes.POINTER(ctypes.c_float)
    means, shs, scales, opac, rot = pf(), pf(), pf(), pf(), pf()
    n, shv = ctypes.c_int64(), ctypes.c_int64()
    rc = cdll.gst_load_gobj(os.fsencode(path), ctypes.byref(means), ctypes.byref(shs),
                            ctypes.byref(scales), ctypes.byref(opac), ctypes.byref(rot),
                            ctypes.byref(n), ctypes.byref(shv))
    if rc != 0:
        return None
    count, k3 = n.value, shv.value
    return (_take(cdll, means, (count, 3), np.float32),
            _take(cdll, shs, (count, k3 // 3, 3), np.float32),
            _take(cdll, scales, (count, 3), np.float32),
            _take(cdll, opac, (count,), np.float32),
            _take(cdll, rot, (count, 4), np.float32))


def save_gobj(path: str, means, shs, scales, opacities, rotations) -> bool:
    """Write the .gobj text; False when the library is missing or the
    file could not be opened."""
    cdll = lib()
    if cdll is None:
        return False
    n = means.shape[0]
    k3 = int(np.prod(shs.shape[1:]))
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in
              (means, shs.reshape(n, k3), scales, opacities, rotations)]
    ptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrays]
    return cdll.gst_save_gobj(os.fsencode(path), *ptrs, n, k3) == 0


def png_unfilter(buf: np.ndarray, h: int, stride: int, bpp: int):
    """The first ``h * (stride + 1)`` bytes of uint8 ``buf``, ``h`` filtered
    PNG rows -> ((h, stride) uint8 raw rows, -1 or the first filter type
    that is not 0-4), or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    src = np.ascontiguousarray(buf[:h * (stride + 1)], dtype=np.uint8)
    if src.size < h * (stride + 1):
        raise ValueError(f"png_unfilter: {src.size} bytes for {h} rows of {stride + 1}")
    out = np.empty((h, stride), np.uint8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    bad = cdll.gst_png_unfilter(src.ctypes.data_as(pu8), out.ctypes.data_as(pu8), h, stride, bpp)
    return out, bad


def lzw_decode(data: bytes, min_bits: int, tiff: bool, limit: int):
    """io/lzw.decode_lzw_python's (bytes, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    if not 2 <= min_bits <= 8:
        raise ValueError(f"lzw_decode: literal size {min_bits} bits (2 to 8)")
    out = np.empty(max(limit, 0), np.uint8)
    n = ctypes.c_int64()
    status = cdll.gst_lzw_decode(bytes(data), len(data), min_bits, int(tiff),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 max(limit, 0), ctypes.byref(n))
    return out[:n.value], status


def webp_image(lossless: bool, data: bytes, out: np.ndarray):
    """A ``VP8 `` (lossy) or ``VP8L`` chunk's payload decoded into ``out``,
    an (H, W, 4) uint8 view whose rows may be strided (a frame on its
    canvas): RGBA, alpha 255 for VP8.  The status of native/src/webp.cpp
    (0 when the image was written), or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    h, w = out.shape[:2]
    if out.dtype != np.uint8 or out.shape[2] != 4 or out.strides[1:] != (4, 1):
        raise ValueError("webp_image wants an (H, W, 4) uint8 view with whole pixels")
    decode = cdll.gst_webp_vp8l if lossless else cdll.gst_webp_vp8
    return decode(bytes(data), len(data), w, h,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.strides[0])


def webp_alpha(data: bytes, w: int, h: int):
    """An ``ALPH`` chunk's payload -> ((h, w) uint8 alpha plane, status),
    or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    plane = np.zeros((h, w), np.uint8)
    status = cdll.gst_webp_alpha(bytes(data), len(data), w, h,
                                 plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return plane, status


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def packbits_rows(data: bytes, row: int, rows: int):
    """io/psd.packbits_rows_python's (rows, rows completed) from the native
    loop, or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((rows, row), np.uint8)
    done = cdll.gst_packbits_rows(bytes(data), len(data), row, rows, _u8(out))
    return out, int(done)


def sgi_rle(data: bytes, w: int, h: int, z: int, bpc: int):
    """io/sgi.rle_rows_python's (rows, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((h, w * z * bpc), np.uint8)
    return out, cdll.gst_sgi_rle(bytes(data), len(data), w, h, z, bpc, _u8(out))


def pcx_rle(data: bytes, line: int, rows: int):
    """io/pcx.rle_lines_python's (lines, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((rows, line), np.uint8)
    return out, cdll.gst_pcx_rle(bytes(data), len(data), line, rows, _u8(out))


def qoi_decode(data: bytes, pixels: int, channels: int):
    """io/qoi.decode_ops_python's (pixels, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((pixels, channels), np.uint8)
    return out, cdll.gst_qoi_decode(bytes(data), len(data), pixels, channels, _u8(out))


def fax_decode(data: bytes, st, rows: int, lsb_first: bool):
    """io/ccitt.decode_fax_python's (rows, status, rows written) from the
    native loop, into and with ``st``'s buffer and run arrays, or None
    when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    from gaussian_splatterer_tpu_torch.io import ccitt

    out = st.rows(rows)[:rows]
    end = ctypes.c_int64()
    pi = ctypes.POINTER(ctypes.c_int32)
    tables = [ccitt.native_table(t) for t in ("main", "white", "black")]
    status = cdll.gst_fax_decode(
        bytes(data), len(data), st.comp, int(st.two_d), int(lsb_first), st.width, rows,
        _u8(out), out.shape[1], st.runs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        st.nruns, *(t.ctypes.data_as(pi) for t in tables), ctypes.byref(end))
    return out, status, end.value


def bc6h_decode(blocks: np.ndarray, signed: bool):
    """io/dds.bc6h_python's (N, 16, 3) uint8 texels of (N, 16) uint8 BC6H
    blocks from the native loop, or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    from gaussian_splatterer_tpu_torch.io import dds

    if "bc6h_table" not in _state:
        _state["bc6h_table"] = dds.bc6h_table()
    table = _state["bc6h_table"]
    src = np.ascontiguousarray(blocks, dtype=np.uint8)
    out = np.zeros((len(src), 16, 3), np.uint8)
    cdll.gst_bc6h_decode(src.tobytes(), len(src), int(signed),
                         table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8(out))
    return out


def sun_rle(data: bytes, line: int, rows: int):
    """io/sun.rle_rows_python's (rows, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((rows, line), np.uint8)
    return out, cdll.gst_sun_rle(bytes(data), len(data), line, rows, _u8(out))


def msp_rle(data: bytes, w: int, h: int):
    """io/msp.rle_rows_python's (bytes, status) from the native loop, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    blank = (w + 7) // 8
    out = np.zeros(blank * h, np.uint8)
    written = ctypes.c_int64()
    status = cdll.gst_msp_rle(bytes(data), len(data), h, blank, _u8(out), out.size,
                              ctypes.byref(written))
    return out[:min(written.value, out.size)].tobytes(), status


def icns_rle(data: bytes, pixels: int):
    """io/icns.rle_channels_python's (channels, status) from the native
    loop, or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros((3, pixels), np.uint8)
    return out, cdll.gst_icns_rle(bytes(data), len(data), pixels, _u8(out))


def fli_frame(buf: bytes, img: np.ndarray):
    """io/fli.frame_python's (consumed, error) from the native loop, into
    the (H, W) uint8 C-contiguous ``img``, or None when the library is
    missing."""
    cdll = lib()
    if cdll is None:
        return None
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError("fli_frame wants a C-contiguous uint8 image")
    err = ctypes.c_int()
    n = cdll.gst_fli_frame(bytes(buf), len(buf), img.shape[1], img.shape[0], _u8(img),
                           ctypes.byref(err))
    return int(n), err.value


def jpeg_arith_prepare(data: bytes, units: np.ndarray, slots: np.ndarray, dc_tbl: np.ndarray,
                       ac_tbl: np.ndarray, cond: np.ndarray, coef: np.ndarray):
    """One arithmetic-coded scan's arrays checked and laid out for
    ``jpeg_arith_run`` (io/jpeg_arith.decode_segment_python's arguments
    but the interval's), or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    if coef.dtype != np.int16 or not coef.flags.c_contiguous:
        raise ValueError("jpeg_arith_prepare wants a C-contiguous int16 coefficient array")
    u = np.ascontiguousarray(units, dtype=np.int64)
    if u.ndim != 2 or (u.size and (u.min() < 0 or u.max() + 64 > coef.size)):
        raise ValueError("jpeg_arith_prepare: block offsets outside the coefficients")
    arrays = [u, *(np.ascontiguousarray(a, dtype=np.int32) for a in (slots, dc_tbl, ac_tbl,
                                                                       cond)), coef]
    return cdll, bytes(data), arrays, [a.ctypes.data for a in arrays]


def jpeg_arith_run(prep, pos: int, stop: int, marker: int, kind: int, ss: int, se: int,
                   al: int, first: int, count: int) -> tuple[int, int, int]:
    """The restart interval of MCUs ``first`` to ``first + count`` of a
    prepared scan through the native loop -> (end, marker, status)."""
    cdll, data, arrays, addr = prep
    n = max(0, min(count, arrays[0].shape[0] - first))
    bpm = arrays[0].shape[1]
    end, mark = ctypes.c_int64(), ctypes.c_int()
    status = cdll.gst_jpeg_arith_segment(data, pos, min(stop, len(data)), marker, kind, ss, se,
                                         al, addr[0] + 8 * first * bpm, n, bpm, *addr[1:],
                                         ctypes.byref(end), ctypes.byref(mark))
    return end.value, mark.value, status


def jpeg_lossless_diffs(seg: bytes, terminated: bool, flag: bool, rows: int, per_row: int,
                        tabsel: np.ndarray, luts: np.ndarray):
    """io/jpeg_lossless.decode_diffs_python's result from the native loop,
    or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    sel = np.ascontiguousarray(tabsel, dtype=np.int32)
    lut = np.ascontiguousarray(luts, dtype=np.int32)
    if lut.ndim != 2 or lut.shape[1] != 65536 or (sel.size and (sel.min() < 0 or
                                                                 sel.max() >= len(lut))):
        raise ValueError("jpeg_lossless_diffs: tables of 65,536 entries and indices into them")
    out = np.zeros((rows, per_row, len(sel)), np.int32)
    pi = ctypes.POINTER(ctypes.c_int32)
    flag_out = ctypes.c_int()
    got = cdll.gst_jpeg_lossless_diffs(bytes(seg), len(seg), int(terminated), int(flag), rows,
                                       per_row, len(sel), sel.ctypes.data_as(pi),
                                       lut.ctypes.data_as(pi), out.ctypes.data_as(pi),
                                       ctypes.byref(flag_out))
    return (out, rows, bool(flag_out.value), True) if got < 0 else (
        out, int(got), bool(flag_out.value), False)


def jpeg_undifference(diffs: np.ndarray, first: np.ndarray, predictor: int, initial: int):
    """io/jpeg_lossless.undifference_python's result from the native loop,
    or None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    d = np.ascontiguousarray(diffs, dtype=np.int32)
    f = np.ascontiguousarray(first, dtype=np.uint8)
    if d.ndim != 2 or f.shape != (d.shape[0],):
        raise ValueError("jpeg_undifference wants (rows, w) differences and (rows,) flags")
    out = np.zeros_like(d)
    pi = ctypes.POINTER(ctypes.c_int32)
    cdll.gst_jpeg_undifference(d.ctypes.data_as(pi), _u8(f), d.shape[0], d.shape[1],
                               predictor, initial, out.ctypes.data_as(pi))
    return out.astype(np.int64)


def xz_until_error(data: bytes, size: int):
    """io/xz.decode_until_error_python's bytes from the native decoder, or
    None when the library is missing."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros(max(size, 0), np.uint8)
    n = cdll.gst_xz_until_error(bytes(data), len(data), max(size, 0), _u8(out))
    return out[:n].tobytes()


def zstd_decode(data: bytes, size: int):
    """io/zstd.decode_python's ``size`` bytes from the native decoder, or
    None when the library is missing.  Where it refuses the strip it raises
    a ValueError with libzstd's or libtiff's reason, whose ``kept`` is the
    bytes libtiff keeps."""
    cdll = lib()
    if cdll is None:
        return None
    out = np.zeros(max(size, 1), np.uint8)
    reason = ctypes.create_string_buffer(256)
    kept = ctypes.c_int64()
    if cdll.gst_zstd_decode(bytes(data), len(data), max(size, 0), _u8(out), reason, 256,
                            ctypes.byref(kept)) < 0:
        exc = ValueError(reason.value.decode())
        exc.kept = out[:kept.value].tobytes()
        raise exc
    return out[:max(size, 0)].tobytes()


def j2k_decode(data: bytes, start: int, ihdr_w: int = 0, ihdr_h: int = 0):
    """native/src/j2k.cpp's decode of the codestream at ``data[start:]``:
    (info, tiles).  info: the image's ``x0``, ``y0``, ``x1``, ``y1``, the
    stream position after the last read (``end``) and ``comps``, a
    (dx, dy, prec, sgnd) a component; tiles: for each decoded tile, in
    decoding order, ((tileno, x0, y0, x1, y1), [an (h, w) int32 plane a
    component]).  Raises ValueError with OpenJPEG's reason where it fails
    the stream; the library must be built (``lib()`` not None)."""
    cdll = lib()
    info = (ctypes.c_int64 * 24)()
    out = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    reason = ctypes.create_string_buffer(256)
    status = cdll.gst_j2k_decode(bytes(data), len(data), start, ihdr_w, ihdr_h, info,
                                 ctypes.byref(out), ctypes.byref(n), reason, 256)
    if status:
        raise ValueError(reason.value.decode(errors="replace"))
    buf = _take(cdll, out, (n.value,), np.int32)
    nc = info[4]
    comps = [tuple(info[8 + 4 * c:12 + 4 * c]) for c in range(nc)]
    tiles, at = [], 0
    for _ in range(info[6]):
        head = tuple(int(v) for v in buf[at:at + 5])
        at += 5
        planes = []
        for _ in range(nc):
            w, h = int(buf[at]), int(buf[at + 1])
            planes.append(buf[at + 2:at + 2 + w * h].reshape(h, w))
            at += 2 + w * h
        tiles.append((head, planes))
    return {"x0": info[0], "y0": info[1], "x1": info[2], "y1": info[3], "end": info[5],
            "comps": comps}, tiles
