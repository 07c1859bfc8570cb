"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

- ``cov_accum``      — one-pass {XᵀX, XᵀX', X'ᵀX'} calibration triple
  (replaces ``src/repro/kernels/cov_accum.py``)
- ``lowrank_matmul`` — factorized linear (x@V)@U with fused bias/residual
  epilogue (replaces ``src/repro/kernels/lowrank_matmul.py``)

``ops`` holds the dispatch wrappers (kernel on CUDA, plain version on the
CPU), ``ref`` the plain versions, ``build`` the nvcc build and ctypes binding.
Nothing is compiled or loaded at import.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
