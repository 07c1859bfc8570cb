"""AA-SVD in PyTorch and CUDA for an NVIDIA H100 — the port of ``repro``.

Modules keep the JAX package's names (``configs``, ``models.layers``,
``core.pipeline``, ...) so each has an obvious counterpart.  The package
imports torch and numpy only, never jax and nothing of ``repro``.

Importing any module that computes turns TF32 off on the card
(``repro_torch._fp32``: float32 parity with the JAX reference).  The root
itself imports no torch — ``CompressConfig``, ``compress_model`` and
``compress_ratio_report`` load ``core.pipeline`` on first use — so the
static checker ``repro_torch.analysis`` runs without torch.
"""

_PIPELINE = ("CompressConfig", "compress_model", "compress_ratio_report")
__all__ = list(_PIPELINE)


def __getattr__(name):
    if name in _PIPELINE:
        from repro_torch.core import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
