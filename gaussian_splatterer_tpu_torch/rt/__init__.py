"""Path tracer of the PyTorch/CUDA port (counterpart of gaussian_splatterer_tpu.rt)."""

from gaussian_splatterer_tpu_torch.rt.tracer import RtxHost, render_rtx  # noqa: F401
