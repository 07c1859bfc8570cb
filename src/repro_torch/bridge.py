"""Move parameter trees between numpy (the JAX package's leaves) and torch.

The JAX package's params are nested dicts / lists with ``None`` slots;
scanned stages stack every leaf on a leading ``num_layers`` axis (llama's
``params["stages"][0][0]["attn"]["wq"]["v"]`` is ``(L, n, k)`` after
compression).  Both directions keep that layout, dense ``{"w"}`` and
factorized ``{"u", "v"}`` linears alike, and are bit-exact: fp32 moves as
is, bf16 (``ml_dtypes.bfloat16`` on the numpy side) moves through 16-bit
integer views.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only needed to hand bf16 back to numpy
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, device="cpu") -> Any:
    """numpy (or anything ``np.asarray`` takes) tree -> torch tree."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None:
        return None
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """torch tree -> numpy tree (bf16 as ``ml_dtypes.bfloat16``)."""
    return tree_map(_leaf_to_numpy, tree)
