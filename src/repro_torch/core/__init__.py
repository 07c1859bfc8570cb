"""AA-SVD core of the port: the paper's contribution on torch.

- ``lowrank``     — Thm 3.2 closed-form anchored solve (torch.linalg)
- ``calibration`` — streaming covariance accumulation (``cov_accum`` kernel)
- ``streaming``   — per-unit calibration engine (tap registry)
- ``ranks``       — ratio→rank math (verbatim copy of the JAX package's)
- ``refine``      — block-level local refinement (AdamW, torch.autograd)
- ``pipeline``    — Algorithm 2 end-to-end block-wise driver
"""
