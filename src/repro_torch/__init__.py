"""AA-SVD in PyTorch and CUDA for an NVIDIA H100 — the port of ``repro``.

Modules keep the JAX package's names (``configs``, ``models.layers``,
``core.pipeline``, ...) so each has an obvious counterpart.  The package
imports torch and numpy only, never jax and nothing of ``repro``.

Float32 parity with the JAX reference needs float32 products to run in full
float32 on the card, so importing the package turns TF32 off for both
matmuls and cuDNN convolutions (PyTorch's cuDNN default is TF32 on).
"""

import torch

# fp32 parity: no TF32 anywhere on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.core.pipeline import (  # noqa: E402,F401
    CompressConfig, compress_model, compress_ratio_report)
