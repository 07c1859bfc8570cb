"""Float32 parity with the JAX reference needs float32 products to run in
full float32 on the card, so importing this module turns TF32 off for both
matmuls and cuDNN convolutions (PyTorch's cuDNN default is TF32 on).

Every module of the package that imports torch loads it first: each
subpackage's ``__init__`` imports it, and so do the top-level ``bridge``,
``device`` and ``tree``.  The package root imports no torch, so
``repro_torch.analysis`` loads without it.
"""

import torch

# fp32 parity: no TF32 anywhere on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
