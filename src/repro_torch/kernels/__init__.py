"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

- ``cov_accum``      — one-pass {XᵀX, XᵀX', X'ᵀX'} calibration triple, and
  with a bank axis every expert bank's triple in one launch (replaces
  ``src/repro/kernels/cov_accum.py`` and its vmap in
  ``src/repro/kernels/ops.py::_cov_triple_banked``)
- ``lowrank_matmul`` — factorized linear (x@V)@U with fused bias/residual
  epilogue (replaces ``src/repro/kernels/lowrank_matmul.py``)
- ``flash_attention`` — blockwise online-softmax attention with causal,
  window and key-padding masks, soft cap and per-slot query offsets
  (replaces ``src/repro/kernels/flash_attention.py``)
- ``flash_decode`` — one decode step against the factorized latent KV
  cache (replaces ``src/repro/kernels/flash_decode.py``)
- ``grouped_matmul`` — ragged expert GEMM over rows sorted by expert, for
  the drop-free MoE dispatch (replaces
  ``src/repro/kernels/grouped_matmul.py``)

``ops`` holds the dispatch wrappers (kernel on CUDA, plain version on the
CPU), ``ref`` the plain versions, ``build`` the nvcc build and ctypes binding,
``autotune`` the wrappers' launch plans (measured and cached on the card),
``contracts`` what every candidate plan must satisfy, checked on the host.
Nothing is compiled or loaded at import.
"""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
from repro_torch.kernels import ops, ref  # noqa: F401
