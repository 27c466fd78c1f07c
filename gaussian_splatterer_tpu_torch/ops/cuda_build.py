"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout, named by a hash of its
source, the local headers it includes (``#include "x.cuh"``, as the three
compositors include ``composite_common.cuh``) and the flags (a changed
source or header builds anew, an unchanged one is reused across
processes), and loaded with ``ctypes``.  No PyTorch header is compiled,
which keeps a build to seconds.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# every kernel source of the package, csrc/<name>.cu: the compositors K1-K3,
# the intersectors K5 (brute force) and K9 (culled), the scan K4 and the
# probes' kernels K6-K8
KERNELS = ("composite_fwd", "composite_train", "mt_intersect", "composite_bwd", "cumsum_frames",
           "peak_fma", "gather_cols", "smem_gather", "mt_culled")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# per kernel source: {"seconds": build time (0.0 when reused), "ptxas": log}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of gaussian_splatterer_tpu_torch are built at first use"
    )


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"[ \t]*$', re.M)
_PRAGMA_ONCE = re.compile(r"^[ \t]*#[ \t]*pragma[ \t]+once[ \t]*\n", re.M)


def source_text(src: Path) -> str:
    """What nvcc compiles from ``src``: its text with each local header
    (``#include "x"``, found beside the including file) inlined once, in
    place of its first include, recursively."""
    seen: set[Path] = set()

    def expand(path: Path) -> str:
        def include(m):
            header = (path.parent / m.group(1)).resolve()
            if header in seen:
                return ""
            seen.add(header)
            return _PRAGMA_ONCE.sub("", expand(header))

        return _LOCAL_INCLUDE.sub(include, path.read_text())

    return expand(Path(src))


def _lib_path(name: str) -> Path:
    text = source_text(CSRC_DIR / f"{name}.cu")
    digest = hashlib.sha256((text + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Compile the sources of ``names`` that have no library yet: one
    ``nvcc`` per source, all started together."""
    jobs = []
    for name in names:
        lib_path = _lib_path(name)
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": "", "path": str(lib_path)})
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        src = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, src, tmp, lib_path, proc, time.perf_counter()))
    failed = []
    for name, src, tmp, lib_path, proc, t0 in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib_path)
        build_info[name].update(seconds=time.perf_counter() - t0, ptxas=err.strip())
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(build_info[name]["path"])
    return _loaded[name]
