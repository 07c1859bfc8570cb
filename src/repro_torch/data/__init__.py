"""The port's synthetic data pipeline (``repro_torch.data.synthetic``)."""

import repro_torch._fp32  # noqa: F401  (TF32 off before any torch work)
from repro_torch.data import synthetic  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    calibration_set,
    make_batch_iterator,
    synthetic_tokens,
)
