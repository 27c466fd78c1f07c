"""H100 probes of the port (counterparts of the JAX package's
scripts/*_probe.py), each runnable as ``python -m
gaussian_splatterer_tpu_torch.scripts.<name>``:

  peak_probe          FP32 FMA, exp and log rates (kernel csrc/peak_fma.cu)
  gather_probe        the feature gather at the bench scale (csrc/gather_cols.cu)
  smem_gather_probe   the gather from a table staged in shared memory
                      (csrc/smem_gather.cu)

Each module also exposes ``run(device)``, which chip_smoke.py calls in
process.  Nothing runs at import.
"""
