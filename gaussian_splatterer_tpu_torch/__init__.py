"""PyTorch/CUDA port of gaussian_splatterer_tpu.

Module names follow the JAX package one for one (``config``,
``models.camera``, ``ops.transforms``, ``ops.binning``, ...), so each piece
has an obvious counterpart to be held against.  This package imports
``torch`` and never ``jax``.

Hand-written CUDA kernels live in ``csrc/`` and are compiled with ``nvcc``
for ``sm_90a`` at first use (``ops/cuda_build.py``, whose ``KERNELS`` lists
them): the compositors, their backward and the fused training compositor,
the tracer's two intersectors and the per-frame scan of the cumsum reduction
route, and the kernels of the H100 probes in ``scripts``
(``python -m gaussian_splatterer_tpu_torch.scripts.<name>``).  A tensor on a
CUDA device goes through the kernel; a tensor on the CPU goes through the
plain PyTorch version of the same function.
"""

import torch

# Every float32 product in this package is meant as full float32: the
# reference's parity gates assume it.  PyTorch leaves cuBLAS matmuls in
# float32 by default but lets cuDNN take TF32, so both are pinned here,
# once, where the package initialises.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device without CUDA raises (there is
    no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    return dev
